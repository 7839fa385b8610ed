"""Plain reference of a single logistic GLM fit: Newton's method to the
optimum of the L2-regularized objective (reference/newton.py)."""

from __future__ import annotations

import torch

from portbench.reference import newton

ROWS = 1 << 16  # rows per block of the float64 reads


def run(inputs: dict, cfg: dict, traffic: dict, prec: str = "f64", weights=None) -> dict:
    """{"coef": [D], "value" and "gradient" at coef, "iterations"} in ``prec``;
    ``weights`` replaces the rows' unit weights (the planted half-batch
    fault)."""
    X, y = inputs["X"], inputs["labels"]
    dt = newton.dtype_of(prec)
    wts = torch.ones(X.shape[0], dtype=dt, device=X.device) if weights is None else weights.to(dt)
    off = torch.zeros(X.shape[0], dtype=dt, device=X.device)
    lam = float(cfg["l2_weight"])
    coef, it = newton.newton_dense(X, y, off, wts, lam, torch.zeros(X.shape[1], device=X.device),
                                   prec, ROWS)
    value, grad = newton.dense_objective(X, y, off, wts, lam, coef, prec, ROWS)
    return {"coef": coef, "value": value, "gradient": grad, "iterations": [it]}


def objective(inputs: dict, cfg: dict, coef: torch.Tensor, prec: str = "f64"):
    """(value, gradient) of the configuration's objective at ``coef``."""
    X, y = inputs["X"], inputs["labels"]
    dt = newton.dtype_of(prec)
    ones = torch.ones(X.shape[0], dtype=dt, device=X.device)
    zero = torch.zeros(X.shape[0], dtype=dt, device=X.device)
    return newton.dense_objective(X, y, zero, ones, float(cfg["l2_weight"]), coef, prec, ROWS)
