"""The share of the traced units' time in which no device operation ran, in
percent (glmix cells): one less the device's busy seconds in the trace over
the time the same units take untraced (the window's mean unit), since the
profiler slows the host loop it records and so lengthens the traced window."""


def read(ctx):
    if ctx.get("config") != "glmix" or ctx.get("trace") is None:
        return None
    return 100.0 * (1.0 - ctx["trace"]["busy_s"] / ctx["untraced_s"])
