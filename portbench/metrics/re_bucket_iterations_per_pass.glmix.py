"""Random-effect bucket iterations per pass: the sum over coordinates and
buckets of the iterations each bucket's lanes ran (the step's
re_iterations_max), over the window."""


def read(ctx):
    if ctx.get("config") != "glmix" or not ctx.get("passes"):
        return None
    return ctx["re_iterations"] / ctx["passes"]
