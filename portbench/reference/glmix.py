"""Plain reference of a GLMix training job: block coordinate descent over a
logistic fixed effect and per-entity random effects, every coordinate solved
to its optimum by Newton's method (reference/newton.py).

It follows the program's job from the same inputs: from zero coefficients,
``passes`` passes, each solving the fixed effect with the random effects'
scores as offsets, then each random effect in order with the others' scores
as offsets. Each random effect groups its rows by entity id itself. L2
weighs every coefficient, the intercept included, as in the program.
"""

from __future__ import annotations

import torch

from portbench.reference import newton

ROWS = 1 << 20  # rows per block of the float64 reads


def run(inputs: dict, cfg: dict, traffic: dict, prec: str = "f64", weights=None) -> dict:
    """{"fixed": [D], "re": ([E_u, K], [E_i, K]) indexed by entity id,
    "total_scores": [N], "iterations": [...]} in ``prec``. ``weights``
    replaces the rows' unit weights (the planted half-batch fault)."""
    X, y = inputs["fe_X"], inputs["labels"]
    Xr = inputs["re_X"]
    ents = [inputs["users"], inputs["items"]]
    n_ent = [int(cfg["num_users"]), int(cfg["num_items"])]
    lam = float(cfg["l2_weight"])
    dt = newton.dtype_of(prec)
    dev = X.device
    wts = torch.ones(X.shape[0], dtype=dt, device=dev) if weights is None else weights.to(dt)
    zero = torch.zeros(X.shape[0], dtype=dt, device=dev)
    fixed = torch.zeros(X.shape[1], dtype=dt, device=dev)
    tables = [torch.zeros((e, Xr.shape[1]), dtype=dt, device=dev) for e in n_ent]
    fe_score = zero
    re_scores = [zero, zero]
    iterations = []
    for _ in range(int(traffic["passes"])):
        fixed, it = newton.newton_dense(X, y, sum(re_scores), wts, lam, fixed, prec, ROWS)
        iterations.append(it)
        fe_score = newton.matvec(X, fixed, prec, ROWS)
        for i in range(len(tables)):
            off = fe_score + sum(s for j, s in enumerate(re_scores) if j != i)
            tables[i], it = newton.newton_grouped(Xr, ents[i], n_ent[i], y, off, wts, lam,
                                                  tables[i], prec, ROWS)
            iterations.append(it)
            re_scores[i] = newton.grouped_score(Xr, ents[i], tables[i], prec, ROWS)
    return {"fixed": fixed, "re": tuple(tables), "total_scores": fe_score + sum(re_scores),
            "iterations": iterations}


def scores_of(inputs: dict, fixed: torch.Tensor, tables, prec: str = "f64") -> torch.Tensor:
    """The [N] total scores that ``fixed`` and the entity-indexed ``tables``
    give, in ``prec``."""
    s = newton.matvec(inputs["fe_X"], fixed, prec, ROWS)
    for ent, table in zip((inputs["users"], inputs["items"]), tables):
        s = s + newton.grouped_score(inputs["re_X"], ent, table, prec, ROWS)
    return s
