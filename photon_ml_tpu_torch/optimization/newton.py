"""Damped Newton-Cholesky over a batch of lanes. Port of photon_ml_tpu/optimization/newton.py.

A TPU-first addition of the JAX package with no reference counterpart: for
problems whose d x d Hessian is cheap to build (the random-effect inner
solves, and fixed effects of modest width), direct Newton steps with a
Cholesky solve converge in a few iterations. Each step picks the smallest
ridge of an escalating damping ladder that gives a finite factor AND a
finite direction (Levenberg style), falling back to steepest descent when
none does; the step is validated by the same strong-Wolfe line search as
L-BFGS, with alpha = 1 tried first. Convergence follows the shared
reference contract (common.convergence_check).

The JAX solver is one ``lax.while_loop``, vmapped over entities in the
random-effect solves. Here it is a host loop over a leading lane axis that
freezes converged lanes and passes the ``active`` mask into the line
search, so per-lane iterations and reasons equal the vmapped ones. All
ladder levels factor as one batched call, and the first usable level is
chosen on the device (``argmax``), never by a host branch.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from photon_ml_tpu_torch.ops import small_linalg
from photon_ml_tpu_torch.optimization import linesearch
from photon_ml_tpu_torch.optimization.common import (
    OptResult,
    any_lane,
    convergence_check,
    init_tracking,
    norm,
    record_tracking,
)
from photon_ml_tpu_torch.optimization.lbfgs import project
from photon_ml_tpu_torch.types import ConvergenceReason

Tensor = torch.Tensor

# Relative ridge ladder: multiples of mean|diag(H)| tried in order until the
# factorization and the solve are finite. Level 0 (no damping) wins for
# every well-posed GLM Hessian.
_DAMPING_LADDER = (0.0, 1e-8, 1e-5, 1e-2, 1.0)


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return torch.sum(a * b, dim=-1)


def _newton_direction(H: Tensor, g: Tensor) -> Tensor:
    """Per lane, solve (H + tau I) p = -g with the smallest usable ladder tau.

    H [B, d, d], g [B, d]. Every level factors and solves in one batched
    call; the first level whose factor AND direction are finite wins (a
    near-singular pivot can give a finite factor whose solve explodes). If
    no level is usable (a non-finite H), the direction is -g. Systems up to
    ``MAX_UNROLL_DIM`` use the unrolled small_linalg factorization, larger
    ones ``cholesky_ex`` with failed factors set to NaN.
    """
    d = H.shape[-1]
    dtype, dev = H.dtype, H.device
    eye = torch.eye(d, dtype=dtype, device=dev)
    scale = torch.mean(torch.abs(torch.diagonal(H, dim1=-2, dim2=-1)), dim=-1) + 1e-30  # [B]
    taus = torch.tensor(_DAMPING_LADDER, dtype=dtype, device=dev)
    Hs = H.unsqueeze(1) + (taus[None, :] * scale[:, None])[..., None, None] * eye  # [B, L, d, d]
    unroll = d <= small_linalg.MAX_UNROLL_DIM
    Ls = small_linalg.small_cholesky(Hs) if unroll else small_linalg.cholesky_or_nan(Hs)
    finite_L = torch.isfinite(Ls).all(dim=-1).all(dim=-1)  # [B, L]
    Ls_safe = torch.where(finite_L[..., None, None], Ls, eye)
    negg = (-g).unsqueeze(1).expand(-1, len(_DAMPING_LADDER), -1)  # [B, L, d]
    if unroll:
        cands = small_linalg.small_solve_upper_t(Ls_safe, small_linalg.small_solve_lower(Ls_safe, negg))
    else:
        ys = torch.linalg.solve_triangular(Ls_safe, negg.unsqueeze(-1), upper=False)
        cands = torch.linalg.solve_triangular(Ls_safe.transpose(-1, -2), ys, upper=True).squeeze(-1)
    good = finite_L & torch.isfinite(cands).all(dim=-1)  # [B, L]
    idx = torch.argmax(good.to(torch.int32), dim=-1)  # first usable level
    chosen = torch.gather(cands, 1, idx.view(-1, 1, 1).expand(-1, 1, d)).squeeze(1)
    return torch.where(good.any(dim=-1, keepdim=True), chosen, -g)


def minimize_newton(
    value_and_grad: Callable[[Tensor], tuple[Tensor, Tensor]],
    hessian: Callable[[Tensor], Tensor],
    x0: Tensor,
    *,
    max_iterations: int = 100,
    tolerance: float = 1e-7,
    max_line_search_iterations: int = 10,
    lower_bounds: Optional[Tensor] = None,
    upper_bounds: Optional[Tensor] = None,
    track_states: bool = False,
) -> OptResult:
    """Minimize a twice-differentiable function by damped Newton-Cholesky,
    one problem per lane.

    ``value_and_grad`` maps [B, d] to ([B], [B, d]) and ``hessian`` maps
    [B, d] to the [B, d, d] Hessians of the same objective (regularization
    included in both); with a 1-D ``x0`` both take one problem and the
    result has no lane axis. Box bounds are applied by post-step projection.
    """
    if x0.dim() == 1:
        def vg1(x):
            f, g = value_and_grad(x[0])
            return f.unsqueeze(0), g.unsqueeze(0)

        return minimize_newton(
            vg1, lambda x: hessian(x[0]).unsqueeze(0), x0.unsqueeze(0),
            max_iterations=max_iterations, tolerance=tolerance,
            max_line_search_iterations=max_line_search_iterations,
            lower_bounds=lower_bounds, upper_bounds=upper_bounds, track_states=track_states,
        ).first_lane()

    NOT_CONVERGED = int(ConvergenceReason.NOT_CONVERGED)
    bounded = lower_bounds is not None or upper_bounds is not None
    x = project(x0, lower_bounds, upper_bounds)
    f, g = value_and_grad(x)
    loss_abs_tol = torch.abs(f) * tolerance
    grad_abs_tol = norm(g) * tolerance
    tv, tg = init_tracking(max_iterations, f, norm(g), track_states)
    reason = torch.where(
        norm(g) == 0.0, int(ConvergenceReason.GRADIENT_CONVERGED), NOT_CONVERGED
    ).to(torch.int32)
    k = torch.zeros_like(reason)
    one = torch.ones_like(f)

    while True:
        active = reason == NOT_CONVERGED
        if not any_lane(active):
            break
        direction = _newton_direction(hessian(x), g)
        dphi0 = _dot(g, direction)
        bad = dphi0 >= 0
        direction = torch.where(bad.unsqueeze(-1), -g, direction)
        dphi0 = torch.where(bad, -_dot(g, g), dphi0)

        def phi(a, x=x, direction=direction):
            ft, gt = value_and_grad(x + a.unsqueeze(-1) * direction)
            return ft, gt, _dot(gt, direction)

        ls = linesearch.strong_wolfe(
            phi, f, g, dphi0, one, max_iters=max_line_search_iterations, active=active,
        )
        x_new = project(x + ls.alpha.unsqueeze(-1) * direction, lower_bounds, upper_bounds)
        if bounded:
            f_new, g_new = value_and_grad(x_new)
        else:
            f_new, g_new = ls.value, ls.grad

        k_new = k + 1
        reason_n = convergence_check(
            value=f_new, prev_value=f, grad=g_new, iteration=k_new,
            max_iterations=max_iterations, loss_abs_tol=loss_abs_tol,
            grad_abs_tol=grad_abs_tol, objective_failed=~ls.success,
        )
        ok = ls.success.unsqueeze(-1)
        x_new, g_new = torch.where(ok, x_new, x), torch.where(ok, g_new, g)
        f_new = torch.where(ls.success, f_new, f)
        tv, tg = record_tracking(tv, tg, k_new, f_new, norm(g_new), active)

        # a lane that had already converged keeps its state
        a1 = active.unsqueeze(-1)
        x, g = torch.where(a1, x_new, x), torch.where(a1, g_new, g)
        f = torch.where(active, f_new, f)
        k, reason = torch.where(active, k_new, k), torch.where(active, reason_n, reason)

    return OptResult(coefficients=x, value=f, gradient=g, iterations=k, convergence_reason=reason,
                     tracked_values=tv, tracked_grad_norms=tg)
