"""Plain logistic GLM solves for the benchmark's reference, in PyTorch alone.

Every function works on row blocks, so an [N, D] design in float32 on the
card is read in float64 (or TF32) one block at a time and the reference
fits beside the inputs. Nothing here imports the program.

``prec`` names the arithmetic:

- ``"f64"``: every product and sum in float64, the reference itself;
- ``"tf32"``: float32 sums of products whose operands are first rounded to
  TF32 (10 mantissa bits, round to nearest even), which is what a float32
  matrix product with TF32 switched on computes. It is the precision below
  the float32 that the configurations state, and the control runs in it.

The solves are Newton's method on the exact gradient and Hessian with a
backtracking line search in every lane, run until the largest step is below
``TOL[prec]`` times the largest coefficient (or 1), or, in TF32, until the
steps stop shrinking at the precision's floor: their optimum does not
depend on the start.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

# the largest step, against the largest coefficient, at which a solve stops:
# Newton's last steps shrink quadratically, so the float64 solves end within
# rounding of their optimum
TOL = {"f64": 1e-12, "tf32": 1e-6}
# TF32's rounding leaves a floor of steps that no longer shrink (about 1e-3
# of the largest coefficient): a TF32 solve stops at the first step under
# this share that is not below half of the step before it
FLOOR = {"f64": 0.0, "tf32": 1e-2}


def tf32(x: Tensor) -> Tensor:
    """``x`` (float32) rounded to TF32's 10 mantissa bits, to nearest even."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & -8192
    return b.view(torch.float32)


def dtype_of(prec: str) -> torch.dtype:
    if prec not in ("f64", "tf32"):
        raise ValueError(f"unknown precision {prec!r}")
    return torch.float64 if prec == "f64" else torch.float32


def operand(x: Tensor, prec: str) -> Tensor:
    """``x`` as an operand of a product in ``prec``."""
    if prec == "f64":
        return x.to(torch.float64)
    return tf32(x.to(torch.float32))


def blocks(n: int, rows: int):
    for a in range(0, n, rows):
        yield a, min(n, a + rows)


def log1pexp(z: Tensor) -> Tensor:
    """log(1 + exp(z)) without overflow."""
    return torch.clamp(z, min=0) + torch.log1p(torch.exp(-z.abs()))


def logistic_terms(z: Tensor, y: Tensor, w: Tensor):
    """(weighted loss, weighted dloss/dz, weighted d2loss/dz2) per row."""
    p = torch.sigmoid(z)
    return w * (log1pexp(z) - y * z), w * (p - y), w * p * (1.0 - p)


def matvec(X: Tensor, coef: Tensor, prec: str, rows: int) -> Tensor:
    """X @ coef in ``prec``, X read in row blocks."""
    c = operand(coef, prec)
    out = torch.empty(X.shape[0], dtype=dtype_of(prec), device=X.device)
    for a, b in blocks(X.shape[0], rows):
        out[a:b] = operand(X[a:b], prec) @ c
    return out


def _solve(H: Tensor, g: Tensor) -> Tensor:
    return torch.linalg.solve(H, g.unsqueeze(-1)).squeeze(-1)


def _newton(objective, grad_hess, coef: Tensor, prec: str, max_iter: int):
    """Newton's method over a leading lane axis of ``coef`` [L, K], with a
    backtracking line search in every lane: the step is halved (up to 40
    times) until the lane's objective falls by a sufficient share of the
    step's slope, rounding allowed for. Without it, Newton's step can cycle
    far from the optimum of a logistic lane with few rows; with it, it
    converges from any start on these strongly convex objectives. Returns
    (coefficients, iterations)."""
    eps = torch.finfo(coef.dtype).eps
    f = objective(coef)
    last = float("inf")
    for it in range(1, max_iter + 1):
        g, H = grad_hess(coef)
        step = _solve(H, g)
        slope = (g * step).sum(dim=-1)
        tol = TOL[prec] * max(1.0, float(coef.abs().max()))
        # close to the optimum the whole step is safe, and the objective's
        # rounding would hide the decrease that the search asks for
        done = step.abs().amax(dim=-1) <= tol ** 0.5
        t = torch.ones_like(f)
        for _ in range(40):
            trial = objective(coef - t.unsqueeze(-1) * step)
            done |= trial <= f - 1e-4 * t * slope + 8.0 * eps * f.abs()
            if bool(done.all()):
                break
            t = torch.where(done, t, 0.5 * t)
        move = torch.where(done, t, torch.zeros_like(t)).unsqueeze(-1) * step
        coef = coef - move
        f = objective(coef)
        size = float(move.abs().max())
        floor = FLOOR[prec] * max(1.0, float(coef.abs().max()))
        if size <= tol or (size <= floor and size > 0.5 * last):
            return coef, it
        last = size
    return coef, max_iter


def newton_dense(X: Tensor, y: Tensor, off: Tensor, wts: Tensor, lam: float, coef0: Tensor,
                 prec: str, rows: int, max_iter: int = 50):
    """The L2-regularized logistic GLM on the dense [N, D] design ``X``:
    returns (coefficients, iterations)."""
    dt = dtype_of(prec)
    d = X.shape[1]
    eye = torch.eye(d, dtype=dt, device=X.device)

    def objective(c):
        return torch.tensor([dense_objective(X, y, off, wts, lam, c[0], prec, rows, grad=False)[0]],
                            dtype=dt, device=X.device)

    def grad_hess(c):
        g, H = lam * c[0], lam * eye
        cc = operand(c[0], prec)
        for a, b in blocks(X.shape[0], rows):
            Xb = operand(X[a:b], prec)
            _, r, h = logistic_terms(Xb @ cc + off[a:b].to(dt), y[a:b].to(dt), wts[a:b].to(dt))
            g = g + Xb.T @ operand(r, prec)
            H = H + Xb.T @ operand(h.unsqueeze(1) * Xb, prec)
        return g.unsqueeze(0), H.unsqueeze(0)

    coef, it = _newton(objective, grad_hess, coef0.to(dt).reshape(1, d).clone(), prec, max_iter)
    return coef[0], it


def dense_objective(X: Tensor, y: Tensor, off: Tensor, wts: Tensor, lam: float, coef: Tensor,
                    prec: str, rows: int, grad: bool = True):
    """(objective value, gradient or None) of the L2-regularized logistic GLM."""
    dt = dtype_of(prec)
    c = operand(coef, prec)
    value = 0.5 * lam * (coef.to(dt) ** 2).sum()
    g = lam * coef.to(dt) if grad else None
    for a, b in blocks(X.shape[0], rows):
        Xb = operand(X[a:b], prec)
        l, r, _ = logistic_terms(Xb @ c + off[a:b].to(dt), y[a:b].to(dt), wts[a:b].to(dt))
        value = value + l.sum()
        if grad:
            g = g + Xb.T @ operand(r, prec)
    return float(value), g


def grouped_score(Xr: Tensor, ent: Tensor, table: Tensor, prec: str, rows: int) -> Tensor:
    """Per-row x . table[entity] over the [N, K] random-effect features."""
    out = torch.empty(Xr.shape[0], dtype=dtype_of(prec), device=Xr.device)
    t = operand(table, prec)
    for a, b in blocks(Xr.shape[0], rows):
        out[a:b] = (operand(Xr[a:b], prec) * t[ent[a:b]]).sum(dim=1)
    return out


def newton_grouped(Xr: Tensor, ent: Tensor, n_ent: int, y: Tensor, off: Tensor, wts: Tensor,
                   lam: float, table0: Tensor, prec: str, rows: int, max_iter: int = 50):
    """One L2-regularized logistic GLM per entity on its rows of the [N, K]
    features ``Xr`` (row i belongs to entity ``ent[i]``), all solved together:
    returns ([n_ent, K] coefficients, iterations)."""
    dt = dtype_of(prec)
    k = Xr.shape[1]
    eye = torch.eye(k, dtype=dt, device=Xr.device)

    def objective(table):
        f = 0.5 * lam * (table * table).sum(dim=1)
        t = operand(table, prec)
        for a, b in blocks(Xr.shape[0], rows):
            e = ent[a:b]
            z = (operand(Xr[a:b], prec) * t[e]).sum(dim=1) + off[a:b].to(dt)
            f.index_add_(0, e, logistic_terms(z, y[a:b].to(dt), wts[a:b].to(dt))[0])
        return f

    def grad_hess(table):
        g = lam * table
        H = lam * eye.expand(n_ent, k, k).clone()
        t = operand(table, prec)
        for a, b in blocks(Xr.shape[0], rows):
            xb = operand(Xr[a:b], prec)
            e = ent[a:b]
            z = (xb * t[e]).sum(dim=1) + off[a:b].to(dt)
            _, r, h = logistic_terms(z, y[a:b].to(dt), wts[a:b].to(dt))
            g.index_add_(0, e, xb * operand(r, prec).unsqueeze(1))
            hx = operand(h.unsqueeze(1) * xb, prec)
            H.index_add_(0, e, xb.unsqueeze(2) * hx.unsqueeze(1))
        return g, H

    return _newton(objective, grad_hess, table0.to(dt).clone(), prec, max_iter)
