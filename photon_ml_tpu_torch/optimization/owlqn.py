"""OWL-QN over a batch of lanes: L1 and elastic-net regularized problems.

Port of photon_ml_tpu/optimization/owlqn.py (photon-lib
optimization/OWLQN.scala:40-86, which bridges to breeze's OWLQN). The smooth
part f may already hold an L2 term (elastic net splits the weight through
RegularizationContext); this solver adds the non-smooth l1 * ||x||_1:

- the pseudo-gradient of F(x) = f(x) + l1 ||x||_1 (one-sided derivatives at 0);
- the two-loop direction from the SMOOTH-gradient history, applied to the
  pseudo-gradient and sign-aligned with the descent orthant;
- orthant projection of every Armijo trial point and of the accepted one:
  coordinates that cross their orthant are set to exactly 0;
- convergence on F and the pseudo-gradient, as in the reference.

The JAX solver is one ``lax.while_loop``, vmapped over entities in the
random-effect solves. Here it is a host loop over a leading lane axis that
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


def pseudo_gradient(x: Tensor, g: Tensor, l1: Tensor) -> Tensor:
    """One-sided subgradient of f + l1 ||.||_1 with the minimum-norm convention."""
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    at_zero_neg = g + l1  # right derivative at x == 0
    at_zero_pos = g - l1  # left derivative at x == 0
    pg_zero = torch.where(at_zero_pos > 0, at_zero_pos, torch.where(at_zero_neg < 0, at_zero_neg, zero))
    return torch.where(x > 0, g + l1, torch.where(x < 0, g - l1, pg_zero))


def minimize_owlqn(
    smooth_value_and_grad: Callable[[Tensor], tuple[Tensor, Tensor]],
    x0: Tensor,
    l1_weight,
    *,
    max_iterations: int = 100,
    tolerance: float = 1e-7,
    history_length: int = 10,
    max_line_search_iterations: int = 10,
    track_states: bool = False,
) -> OptResult:
    """Minimize f(x) + l1_weight * ||x||_1, one problem per lane.

    ``smooth_value_and_grad`` maps [B, d] to ([B], [B, d]); ``l1_weight`` is
    a scalar (or [B]). The result's value is the TOTAL objective, L1 term
    included, and its gradient the pseudo-gradient, as in the reference.
    """
    if x0.dim() == 1:
        def vg1(x):
            f, g = smooth_value_and_grad(x[0])
            return f.unsqueeze(0), g.unsqueeze(0)

        return minimize_owlqn(
            vg1, x0.unsqueeze(0), l1_weight, max_iterations=max_iterations,
            tolerance=tolerance, history_length=history_length,
            max_line_search_iterations=max_line_search_iterations, track_states=track_states,
        ).first_lane()

    m = history_length
    B, d = x0.shape
    dtype, dev = x0.dtype, x0.device
    NOT_CONVERGED = int(ConvergenceReason.NOT_CONVERGED)
    l1 = torch.as_tensor(l1_weight, dtype=dtype, device=dev)
    l1_lane = l1.unsqueeze(-1) if l1.dim() else l1  # broadcasts against [B, d]

    def full_value(x, f_smooth):
        return f_smooth + l1 * torch.sum(torch.abs(x), dim=-1)

    x = x0
    fs, g = smooth_value_and_grad(x)
    f = full_value(x, fs)
    pg = pseudo_gradient(x, g, l1_lane)
    loss_abs_tol = torch.abs(f) * tolerance
    grad_abs_tol = norm(pg) * tolerance
    tv, tg = init_tracking(max_iterations, f, norm(pg), track_states)
    # already stationary (zero pseudo-gradient, e.g. a warm start at the optimum)
    reason = torch.where(
        norm(pg) == 0.0, int(ConvergenceReason.GRADIENT_CONVERGED), NOT_CONVERGED
    ).to(torch.int32)
    S = torch.zeros((B, m, d), dtype=dtype, device=dev)
    Y = torch.zeros((B, m, d), dtype=dtype, device=dev)
    rho = torch.zeros((B, m), dtype=dtype, device=dev)
    k = torch.zeros((B,), dtype=torch.int32, device=dev)
    n_written = torch.zeros((B,), dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)

    while True:
        active = reason == NOT_CONVERGED
        if not any_lane(active):
            break
        direction = two_loop_direction(pg, S, Y, rho, n_written)
        # orthant alignment: zero the components whose sign disagrees with -pg
        direction = torch.where(direction * pg < 0, direction, zero)
        dphi0 = _dot(pg, direction)
        bad = dphi0 >= 0
        direction = torch.where(bad.unsqueeze(-1), -pg, direction)
        dphi0 = torch.where(bad, -_dot(pg, pg), dphi0)

        # search orthant: sign(x), or sign(-pg) where x == 0
        xi = torch.where(x != 0, torch.sign(x), torch.sign(-pg))

        def phi(a, x=x, direction=direction, xi=xi):
            xt = x + a.unsqueeze(-1) * direction
            xt = torch.where(xt * xi < 0, zero, xt)  # orthant projection
            fts, gt = smooth_value_and_grad(xt)
            return full_value(xt, fts), gt

        gnorm = norm(pg)
        init_alpha = torch.where(
            k == 0, torch.minimum(one, 1.0 / torch.where(gnorm > 0, gnorm, one)), one
        )
        ls = linesearch.backtracking_armijo(
            phi, f, dphi0, init_alpha, max_iters=max_line_search_iterations, active=active,
        )

        ok = ls.success.unsqueeze(-1)
        x_new = x + ls.alpha.unsqueeze(-1) * direction
        x_new = torch.where(x_new * xi < 0, zero, x_new)
        x_new = torch.where(ok, x_new, x)
        f_new = torch.where(ls.success, ls.value, f)
        g_new = torch.where(ok, ls.grad, g)
        pg_new = pseudo_gradient(x_new, g_new, l1_lane)

        s = x_new - x
        y = g_new - g
        sy = _dot(s, y)
        S_n, Y_n, rho_n, nw_n = push_history(S, Y, rho, n_written, s, y, sy, sy > 1e-10)

        k_new = k + 1
        reason_n = convergence_check(
            value=f_new, prev_value=f, grad=pg_new, iteration=k_new,
            max_iterations=max_iterations, loss_abs_tol=loss_abs_tol,
            grad_abs_tol=grad_abs_tol, objective_failed=~ls.success,
        )
        tv, tg = record_tracking(tv, tg, k_new, f_new, norm(pg_new), active)

        # a lane that had already converged keeps its state
        a1, a2 = active.unsqueeze(-1), active.view(-1, 1, 1)
        x, g, pg = torch.where(a1, x_new, x), torch.where(a1, g_new, g), torch.where(a1, pg_new, pg)
        f = torch.where(active, f_new, f)
        S, Y = torch.where(a2, S_n, S), torch.where(a2, Y_n, Y)
        rho = torch.where(a1, rho_n, rho)
        k, n_written = torch.where(active, k_new, k), torch.where(active, nw_n, n_written)
        reason = torch.where(active, reason_n, reason)

    return OptResult(coefficients=x, value=f, gradient=pg, iterations=k, convergence_reason=reason,
                     tracked_values=tv, tracked_grad_norms=tg)
