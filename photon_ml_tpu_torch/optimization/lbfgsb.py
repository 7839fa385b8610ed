"""Box-constrained L-BFGS over a batch of lanes (the reference's LBFGSB,
photon-lib optimization/LBFGSB.scala:40-95).

Port of photon_ml_tpu/optimization/lbfgsb.py, a projected quasi-Newton
method rather than the Byrd-Lu-Nocedal Cauchy point and subspace
minimization:

1. the two-loop L-BFGS direction with active-set masking: a coordinate
   pinned at a bound with the gradient pushing outward is frozen;
2. Armijo backtracking over the PROJECTED path x(a) = clip(x + a d, l, u);
3. curvature pairs from the realized (projected) steps; a pair with
   s.y <= 1e-10 is skipped, and the buffers and their count stay together.

Convergence is measured on the projected gradient, the box-constrained
optimality measure. As the other solvers of the port, the JAX
``lax.while_loop`` becomes a host loop over a leading lane axis that
freezes converged lanes, one :func:`common.any_lane` check per trip plus the
Armijo search's own. A 1-D ``x0`` is solved as a single lane.
"""

from __future__ import annotations

from typing import Callable

import torch

from photon_ml_tpu_torch.optimization import linesearch
from photon_ml_tpu_torch.optimization.common import (
    OptResult,
    any_lane,
    convergence_check,
    init_tracking,
    norm,
    record_tracking,
)
from photon_ml_tpu_torch.optimization.lbfgs import push_history, two_loop_direction
from photon_ml_tpu_torch.types import ConvergenceReason

Tensor = torch.Tensor


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return torch.sum(a * b, dim=-1)


def projected_gradient(x: Tensor, g: Tensor, lower: Tensor, upper: Tensor) -> Tensor:
    """The gradient of the box-constrained problem: zero where a bound blocks descent."""
    blocked = ((x <= lower) & (g > 0)) | ((x >= upper) & (g < 0))
    return torch.where(blocked, torch.zeros((), dtype=g.dtype, device=g.device), g)


def minimize_lbfgsb(
    value_and_grad: Callable[[Tensor], tuple[Tensor, Tensor]],
    x0: Tensor,
    lower_bounds,
    upper_bounds,
    *,
    max_iterations: int = 100,
    tolerance: float = 1e-7,
    history_length: int = 10,
    max_line_search_iterations: int = 10,
    track_states: bool = False,
) -> OptResult:
    """Minimize a smooth function inside the box [lower, upper], one problem
    per lane. Bounds broadcast against ``x0`` (use +-inf where a coordinate
    is free); the start point is clipped into the box first."""
    if x0.dim() == 1:
        def vg1(x):
            f, g = value_and_grad(x[0])
            return f.unsqueeze(0), g.unsqueeze(0)

        return minimize_lbfgsb(
            vg1, x0.unsqueeze(0), lower_bounds, upper_bounds, max_iterations=max_iterations,
            tolerance=tolerance, history_length=history_length,
            max_line_search_iterations=max_line_search_iterations, track_states=track_states,
        ).first_lane()

    m = history_length
    B, d = x0.shape
    dtype, dev = x0.dtype, x0.device
    NOT_CONVERGED = int(ConvergenceReason.NOT_CONVERGED)
    lower = torch.broadcast_to(torch.as_tensor(lower_bounds, dtype=dtype, device=dev), x0.shape)
    upper = torch.broadcast_to(torch.as_tensor(upper_bounds, dtype=dtype, device=dev), x0.shape)
    zero = torch.zeros((), dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)

    def clip(x):
        return torch.minimum(torch.maximum(x, lower), upper)

    x = clip(x0)
    f, g = value_and_grad(x)
    pg0 = projected_gradient(x, g, lower, upper)
    loss_abs_tol = torch.abs(f) * tolerance
    grad_abs_tol = norm(pg0) * tolerance
    tv, tg = init_tracking(max_iterations, f, norm(pg0), track_states)
    # already stationary in the box-constrained sense
    reason = torch.where(
        norm(pg0) == 0.0, int(ConvergenceReason.GRADIENT_CONVERGED), NOT_CONVERGED
    ).to(torch.int32)
    S = torch.zeros((B, m, d), dtype=dtype, device=dev)
    Y = torch.zeros((B, m, d), dtype=dtype, device=dev)
    rho = torch.zeros((B, m), dtype=dtype, device=dev)
    k = torch.zeros((B,), dtype=torch.int32, device=dev)
    n_written = torch.zeros((B,), dtype=torch.int32, device=dev)

    while True:
        active = reason == NOT_CONVERGED
        if not any_lane(active):
            break
        pg = projected_gradient(x, g, lower, upper)
        direction = two_loop_direction(pg, S, Y, rho, n_written)
        # freeze active coordinates so the direction stays feasible to first order
        direction = torch.where(pg == 0.0, zero, direction)
        dphi0 = _dot(pg, direction)
        bad = dphi0 >= 0
        direction = torch.where(bad.unsqueeze(-1), -pg, direction)
        dphi0 = torch.where(bad, -_dot(pg, pg), dphi0)

        def phi(a, x=x, direction=direction):
            return value_and_grad(clip(x + a.unsqueeze(-1) * direction))

        gnorm = norm(pg)
        init_alpha = torch.where(
            k == 0, torch.minimum(one, 1.0 / torch.where(gnorm > 0, gnorm, one)), one
        )
        ls = linesearch.backtracking_armijo(
            phi, f, dphi0, init_alpha, max_iters=max_line_search_iterations, active=active,
        )

        ok = ls.success.unsqueeze(-1)
        x_new = torch.where(ok, clip(x + ls.alpha.unsqueeze(-1) * direction), x)
        f_new = torch.where(ls.success, ls.value, f)
        g_new = torch.where(ok, ls.grad, g)

        s = x_new - x
        y = g_new - g
        sy = _dot(s, y)
        S_n, Y_n, rho_n, nw_n = push_history(S, Y, rho, n_written, s, y, sy, sy > 1e-10)

        k_new = k + 1
        pg_new = projected_gradient(x_new, g_new, lower, upper)
        reason_n = convergence_check(
            value=f_new, prev_value=f, grad=pg_new, iteration=k_new,
            max_iterations=max_iterations, loss_abs_tol=loss_abs_tol,
            grad_abs_tol=grad_abs_tol, objective_failed=~ls.success,
        )
        tv, tg = record_tracking(tv, tg, k_new, f_new, norm(pg_new), active)

        # a lane that had already converged keeps its state
        a1, a2 = active.unsqueeze(-1), active.view(-1, 1, 1)
        x, g = torch.where(a1, x_new, x), torch.where(a1, g_new, g)
        f = torch.where(active, f_new, f)
        S, Y = torch.where(a2, S_n, S), torch.where(a2, Y_n, Y)
        rho = torch.where(a1, rho_n, rho)
        k, n_written = torch.where(active, k_new, k), torch.where(active, nw_n, n_written)
        reason = torch.where(active, reason_n, reason)

    return OptResult(coefficients=x, value=f, gradient=projected_gradient(x, g, lower, upper),
                     iterations=k, convergence_reason=reason,
                     tracked_values=tv, tracked_grad_norms=tg)
