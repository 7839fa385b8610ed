"""Conjugate-gradient steps per TRON solve
(optimization.tron.truncated_conjugate_gradient.steps), over the window."""


def read(ctx):
    if ctx.get("config") != "glm" or not ctx.get("solves"):
        return None
    return ctx["counts"]["cg_steps"] / ctx["solves"]
