"""Kernel B1's share of its roofline in a GLM solve, in percent."""

from portbench import kernels, peaks, trace


def read(ctx):
    if ctx.get("config") != "glm" or ctx.get("trace") is None:
        return None
    launches = ctx["trace_counts"]["b1_launches"]
    _, seconds = trace.kernel_seconds(ctx["trace"], kernels.is_b1)
    if launches == 0 or seconds <= 0:
        return None
    return 100.0 * launches * peaks.least_seconds(*ctx["b1_cost"]) / seconds
