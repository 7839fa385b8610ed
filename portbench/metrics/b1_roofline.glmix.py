"""Kernel B1's share of its roofline in a GLMix pass: the least time for its
bytes and operations (costs.b1_cost) at the card's peaks, times its launches
in the traced window, over its device seconds there, in percent."""

from portbench import kernels, peaks, trace


def read(ctx):
    if ctx.get("config") != "glmix" or ctx.get("trace") is None:
        return None
    launches = ctx["trace_counts"]["b1_launches"]
    _, seconds = trace.kernel_seconds(ctx["trace"], kernels.is_b1)
    if launches == 0 or seconds <= 0:
        return None
    return 100.0 * launches * peaks.least_seconds(*ctx["b1_cost"]) / seconds
