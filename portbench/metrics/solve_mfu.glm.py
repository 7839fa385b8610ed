"""The whole solve's share of the card's float32 peak: the operations of the
window's TRON solves (costs.tron_solve_flops) over its seconds, in percent."""

from portbench import peaks


def read(ctx):
    if ctx.get("config") != "glm" or ctx["wall_s"] <= 0:
        return None
    return 100.0 * ctx["flops"] / (ctx["wall_s"] * peaks.F32_FLOPS_PER_S)
