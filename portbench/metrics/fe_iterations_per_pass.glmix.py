"""Fixed-effect solver iterations per pass (the step's fe_iterations), over
the window."""


def read(ctx):
    if ctx.get("config") != "glmix" or not ctx.get("passes"):
        return None
    return ctx["fe_iterations"] / ctx["passes"]
