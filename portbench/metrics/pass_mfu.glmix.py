"""The whole pass's share of the card's float32 peak: the operations of the
window's passes (costs.glmix_pass_flops, from the shapes and the iterations
and launches the program reported) over the window's seconds, in percent."""

from portbench import peaks


def read(ctx):
    if ctx.get("config") != "glmix" or ctx["wall_s"] <= 0:
        return None
    return 100.0 * ctx["flops"] / (ctx["wall_s"] * peaks.F32_FLOPS_PER_S)
