"""Host syncs of the solver's loop (optimization.common.any_lane.syncs) per
solve over the window."""


def read(ctx):
    if ctx.get("config") != "glm" or not ctx.get("solves"):
        return None
    return ctx["counts"]["host_syncs"] / ctx["solves"]
