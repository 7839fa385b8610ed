"""L-BFGS over a batch of lanes. Port of photon_ml_tpu/optimization/lbfgs.py.

Two-loop recursion over fixed-size NEWEST-FIRST (s, y) buffers, strong-Wolfe
line search and the reference's convergence reasons (LBFGS.scala:39-157).
``two_loop_direction`` and ``push_history`` are shared with OWL-QN and
LBFGSB.

The JAX solver is one ``lax.while_loop``, vmapped over entities in the
random-effect solves. Here it is a host loop over a leading lane axis: each
trip updates every lane, a converged lane keeps its state frozen (as a
vmapped while_loop selects it), and the loop ends when no lane is active.
A 1-D ``x0`` is solved as a single lane.
"""

from __future__ import annotations

from typing import Callable, Optional

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
from photon_ml_tpu_torch.types import ConvergenceReason

Tensor = torch.Tensor


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return torch.sum(a * b, dim=-1)


def project(x: Tensor, lower_bounds: Optional[Tensor], upper_bounds: Optional[Tensor]) -> Tensor:
    """Clamp into the box (the reference's post-step constraint projection)."""
    if lower_bounds is not None:
        x = torch.maximum(x, lower_bounds)
    if upper_bounds is not None:
        x = torch.minimum(x, upper_bounds)
    return x


def two_loop_direction(g: Tensor, S: Tensor, Y: Tensor, rho: Tensor, n_written: Tensor) -> Tensor:
    """-H.g per lane via the two-loop recursion, newest-first layout.

    g [B, d]; S, Y [B, m, d]; rho [B, m]; n_written [B]. Slot 0 is the
    newest pair; min(n_written, m) leading slots are valid.
    """
    m = S.shape[1]
    n_pairs = torch.clamp_max(n_written, m)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)

    q = g
    alphas = []
    for i in range(m):  # newest -> oldest
        a = torch.where(i < n_pairs, rho[:, i] * _dot(S[:, i], q), zero)
        q = q - a.unsqueeze(-1) * Y[:, i]
        alphas.append(a)

    # initial Hessian scaling gamma = s.y / y.y from the newest pair
    ydoty = _dot(Y[:, 0], Y[:, 0])
    one = torch.ones((), dtype=g.dtype, device=g.device)
    gamma = torch.where(
        (n_pairs > 0) & (ydoty > 0),
        _dot(S[:, 0], Y[:, 0]) / torch.where(ydoty > 0, ydoty, one),
        one,
    )
    r = gamma.unsqueeze(-1) * q

    for i in range(m - 1, -1, -1):  # oldest -> newest
        beta = rho[:, i] * _dot(Y[:, i], r)
        upd = (alphas[i] - beta).unsqueeze(-1) * S[:, i]
        r = r + torch.where(i < n_pairs, one, zero).unsqueeze(-1) * upd
    return -r


def push_history(S, Y, rho, n_written, s, y, sy, good_pair):
    """Store a curvature pair newest-first in the lanes where ``good_pair``;
    other lanes keep their buffers and count. Returns (S, Y, rho, n_written)."""
    S_new = torch.cat([s.unsqueeze(1), S[:, :-1]], dim=1)
    Y_new = torch.cat([y.unsqueeze(1), Y[:, :-1]], dim=1)
    rho0 = 1.0 / torch.where(good_pair, sy, torch.ones_like(sy))
    rho_new = torch.cat([rho0.unsqueeze(1), rho[:, :-1]], dim=1)
    keep = good_pair.view(-1, 1, 1)
    return (
        torch.where(keep, S_new, S),
        torch.where(keep, Y_new, Y),
        torch.where(good_pair.unsqueeze(-1), rho_new, rho),
        n_written + good_pair.to(n_written.dtype),
    )


def minimize_lbfgs(
    value_and_grad: Callable[[Tensor], tuple[Tensor, Tensor]],
    x0: Tensor,
    *,
    max_iterations: int = 100,
    tolerance: float = 1e-7,
    history_length: int = 10,
    max_line_search_iterations: int = 10,
    lower_bounds: Optional[Tensor] = None,
    upper_bounds: Optional[Tensor] = None,
    track_states: bool = False,
) -> OptResult:
    """Minimize a smooth function with L-BFGS, one problem per lane.

    ``value_and_grad`` maps [B, d] to ([B], [B, d]); with a 1-D ``x0`` it
    maps [d] to ([], [d]) and the result has no lane axis. Bounds, when
    given, project the iterate after each accepted step (the reference's
    post-step constraint projection, LBFGS.scala:120-130); the value and
    gradient are then evaluated again at the projected point. For fully
    constrained optimization use ``lbfgsb.minimize_lbfgsb``.
    """
    if x0.dim() == 1:
        def vg1(x):
            f, g = value_and_grad(x[0])
            return f.unsqueeze(0), g.unsqueeze(0)

        return minimize_lbfgs(
            vg1, x0.unsqueeze(0), max_iterations=max_iterations, tolerance=tolerance,
            history_length=history_length,
            max_line_search_iterations=max_line_search_iterations,
            lower_bounds=lower_bounds, upper_bounds=upper_bounds, track_states=track_states,
        ).first_lane()

    st = lbfgs_init(value_and_grad, x0, history_length, tolerance, lower_bounds, upper_bounds)
    tv, tg = init_tracking(max_iterations, st["f"], norm(st["g"]), track_states)
    while True:
        active = lbfgs_active(st)
        if not any_lane(active):
            break
        direction, dphi0, init_alpha = lbfgs_direction(st)
        phi = line_function(value_and_grad, st["x"], direction)
        ls = linesearch.strong_wolfe(
            phi, st["f"], st["g"], dphi0, init_alpha,
            max_iters=max_line_search_iterations,
            # frozen lanes must not set the line search's trip count
            active=active,
        )
        st = lbfgs_tail(value_and_grad, st, direction, ls, active, max_iterations,
                        lower_bounds, upper_bounds)
        tv, tg = record_tracking(tv, tg, st["k"], st["f"], norm(st["g"]), active)

    return OptResult(coefficients=st["x"], value=st["f"], gradient=st["g"], iterations=st["k"],
                     convergence_reason=st["reason"], tracked_values=tv, tracked_grad_norms=tg)


# The solve's steps. minimize_lbfgs runs them in a host loop; the graphed
# random-effect solve (optimization/bucket_graphs.py) replays the same steps
# from CUDA graphs over static buffers, so both compute the same bits. The
# state passed between steps is a dict of [B, ...] tensors:
# x, f, g, S, Y, rho, k, n_written, reason, loss_abs_tol, grad_abs_tol.


def lbfgs_init(value_and_grad, x0: Tensor, history_length: int, tolerance: float,
               lower_bounds: Optional[Tensor] = None,
               upper_bounds: Optional[Tensor] = None) -> dict:
    """The first value and gradient, the tolerances made absolute from them,
    the lanes already stationary, and an empty history."""
    m = history_length
    B, d = x0.shape
    dtype, dev = x0.dtype, x0.device
    x = project(x0, lower_bounds, upper_bounds)
    f, g = value_and_grad(x)
    # already stationary (exact zero gradient, e.g. a warm start at the optimum)
    reason = torch.where(
        norm(g) == 0.0,
        int(ConvergenceReason.GRADIENT_CONVERGED),
        int(ConvergenceReason.NOT_CONVERGED),
    ).to(torch.int32)
    return dict(
        x=x, f=f, g=g,
        S=torch.zeros((B, m, d), dtype=dtype, device=dev),
        Y=torch.zeros((B, m, d), dtype=dtype, device=dev),
        rho=torch.zeros((B, m), dtype=dtype, device=dev),
        k=torch.zeros((B,), dtype=torch.int32, device=dev),
        n_written=torch.zeros((B,), dtype=torch.int32, device=dev),
        reason=reason,
        loss_abs_tol=torch.abs(f) * tolerance,
        grad_abs_tol=norm(g) * tolerance,
    )


def lbfgs_active(st: dict) -> Tensor:
    """[B] the lanes that take another iteration."""
    return st["reason"] == int(ConvergenceReason.NOT_CONVERGED)


def lbfgs_direction(st: dict) -> tuple[Tensor, Tensor, Tensor]:
    """(direction, dphi0, init_alpha): the two-loop direction, steepest
    descent where it does not descend, its slope, and the first trial step."""
    g = st["g"]
    direction = two_loop_direction(g, st["S"], st["Y"], st["rho"], st["n_written"])
    dphi0 = _dot(g, direction)
    # safeguard: steepest descent when not a descent direction
    bad = dphi0 >= 0
    direction = torch.where(bad.unsqueeze(-1), -g, direction)
    dphi0 = torch.where(bad, -_dot(g, g), dphi0)
    gnorm = norm(g)
    one = torch.ones((), dtype=g.dtype, device=g.device)
    init_alpha = torch.where(
        st["k"] == 0, torch.minimum(one, 1.0 / torch.where(gnorm > 0, gnorm, one)), one
    )
    return direction, dphi0, init_alpha


def line_function(value_and_grad, x: Tensor, direction: Tensor):
    """phi(a) = (f, grad, slope) at x + a * direction, per lane."""

    def phi(a):
        ft, gt = value_and_grad(x + a.unsqueeze(-1) * direction)
        return ft, gt, _dot(gt, direction)

    return phi


def lbfgs_tail(value_and_grad, st: dict, direction: Tensor, ls, active: Tensor,
               max_iterations: int, lower_bounds: Optional[Tensor] = None,
               upper_bounds: Optional[Tensor] = None) -> dict:
    """The state after the line search ``ls``: the step, the history push,
    the convergence check, the previous iterate where the search failed,
    and every lane outside ``active`` frozen."""
    x, f, g, k = st["x"], st["f"], st["g"], st["k"]
    x_new = project(x + ls.alpha.unsqueeze(-1) * direction, lower_bounds, upper_bounds)
    s = x_new - x
    if lower_bounds is not None or upper_bounds is not None:
        # the line search's value belongs to the unprojected point
        f_new, g_new = value_and_grad(x_new)
    else:
        f_new, g_new = ls.value, ls.grad
    y = g_new - g
    sy = _dot(s, y)
    S_n, Y_n, rho_n, nw_n = push_history(st["S"], st["Y"], st["rho"], st["n_written"], s, y, sy,
                                         sy > 1e-10)

    k_new = k + 1
    reason_n = convergence_check(
        value=f_new, prev_value=f, grad=g_new, iteration=k_new,
        max_iterations=max_iterations, loss_abs_tol=st["loss_abs_tol"],
        grad_abs_tol=st["grad_abs_tol"], objective_failed=~ls.success,
    )
    # on line-search failure keep the previous iterate
    ok = ls.success.unsqueeze(-1)
    x_new = torch.where(ok, x_new, x)
    f_new = torch.where(ls.success, f_new, f)
    g_new = torch.where(ok, g_new, g)

    # a lane that had already converged keeps its state
    a1, a2, a3 = active.unsqueeze(-1), active.view(-1, 1, 1), active
    return dict(
        x=torch.where(a1, x_new, x), f=torch.where(a3, f_new, f), g=torch.where(a1, g_new, g),
        S=torch.where(a2, S_n, st["S"]), Y=torch.where(a2, Y_n, st["Y"]),
        rho=torch.where(a1, rho_n, st["rho"]),
        k=torch.where(a3, k_new, k), n_written=torch.where(a3, nw_n, st["n_written"]),
        reason=torch.where(a3, reason_n, st["reason"]),
        loss_abs_tol=st["loss_abs_tol"], grad_abs_tol=st["grad_abs_tol"],
    )
