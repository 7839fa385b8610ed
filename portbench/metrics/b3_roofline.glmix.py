"""Kernel B3's share of its roofline in a GLMix pass (operations at the TF32
rate, costs.b3_cost), over the device seconds of its kernels in the traced
window, in percent."""

from portbench import kernels, peaks, trace


def read(ctx):
    if ctx.get("config") != "glmix" or ctx.get("trace") is None:
        return None
    launches = ctx["trace_counts"]["b3_launches"]
    _, seconds = trace.kernel_seconds(ctx["trace"], kernels.is_b3)
    if launches == 0 or seconds <= 0:
        return None
    return 100.0 * launches * peaks.least_seconds(*ctx["b3_cost"], peaks.TF32_FLOPS_PER_S) / seconds
