"""Host syncs of the solvers' loops (optimization.common.any_lane.syncs) per
coordinate-descent pass over the window."""


def read(ctx):
    if ctx.get("config") != "glmix" or not ctx.get("passes"):
        return None
    return ctx["counts"]["host_syncs"] / ctx["passes"]
