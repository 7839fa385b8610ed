"""TRON over a batch of lanes: trust-region Newton with truncated conjugate gradient.

Port of photon_ml_tpu/optimization/tron.py (TRON.scala:80-338, from
LIBLINEAR / Lin-Weng-Keerthi): an inner CG solve of the trust-region
subproblem that uses only Hessian-vector products, and an outer loop whose
trip is one attempt; accepted attempts advance the iteration, rejected ones
shrink the trust region, up to ``max_improvement_failures`` in a row.

The JAX solver nests two ``lax.while_loop``s, vmapped over entities in the
random-effect solves. Here both are host loops over a leading lane axis,
each trip ending on one device-to-host check (:func:`common.any_lane`):

- the outer loop runs while any lane is unconverged; a converged lane keeps
  its state frozen, as a vmapped while_loop selects it;
- CG runs while any lane is still in CG, with a per-lane ``done`` mask, so
  lanes leave CG at different steps. Under ``jax.vmap`` a frozen outer lane
  still runs its CG and throws the result away; here such lanes start CG
  done and are skipped. Every active lane's step, residual, trust radius,
  failure count and reason are the ones JAX computes.

A 1-D ``x0`` is solved as a single lane. Hyperparameters, the trust-region
cascade, the CG boundary handling and delta = ||g0|| follow the reference.
``truncated_conjugate_gradient.steps`` counts CG trips (one batched HVP
each) across calls.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

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

ETA0, ETA1, ETA2 = 1e-4, 0.25, 0.75
SIGMA1, SIGMA2, SIGMA3 = 0.25, 0.5, 4.0
DEFAULT_MAX_CG_ITERATIONS = 20
DEFAULT_MAX_IMPROVEMENT_FAILURES = 5
DEFAULT_TRON_TOLERANCE = 1e-5  # TRON.DEFAULT_TOLERANCE
DEFAULT_TRON_MAX_ITER = 15  # TRON.DEFAULT_MAX_ITER


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return torch.sum(a * b, dim=-1)


def _safe_div(a: Tensor, b: Tensor) -> Tensor:
    return a / torch.where(b == 0.0, torch.ones_like(b), b)


def truncated_conjugate_gradient(
    hvp: Callable[[Tensor], Tensor],
    gradient: Tensor,
    delta: Tensor,
    max_cg_iterations: int,
    active: Optional[Tensor] = None,
) -> tuple[Tensor, Tensor, Tensor]:
    """Per lane, approximately solve min_s g.s + 1/2 s.H.s subject to ||s|| <= delta.

    ``gradient`` [B, d], ``delta`` [B]; ``hvp`` maps [B, d] to [B, d].
    Returns (step, residual, cg_iterations [B]). Plain CG until the step
    hits the trust-region boundary, then the boundary crossing
    ||step + alpha*d|| = delta and stop (TRON.scala:278-338). Lanes outside
    ``active`` start done and keep step 0.
    """
    cg_tol = 0.1 * norm(gradient)
    step = torch.zeros_like(gradient)
    r = -gradient
    d = r
    rtr = _dot(r, r)
    i = torch.zeros(gradient.shape[:-1], dtype=torch.int32, device=gradient.device)
    done = torch.zeros_like(i, dtype=torch.bool) if active is None else ~active
    while True:
        running = ~done & (i < max_cg_iterations)
        if not any_lane(running):
            break
        truncated_conjugate_gradient.steps += 1
        converged = norm(r) <= cg_tol
        hd = hvp(d)
        alpha = _safe_div(rtr, _dot(d, hd))
        step_try = step + alpha.unsqueeze(-1) * d
        hit_boundary = norm(step_try) > delta

        # boundary crossing: alpha_b >= 0 with ||step + alpha_b d|| = delta
        std, sts, dtd = _dot(step, d), _dot(step, step), _dot(d, d)
        dsq = delta * delta
        rad = torch.sqrt(torch.clamp_min(std * std + dtd * (dsq - sts), 0.0))
        alpha_b = torch.where(std >= 0, _safe_div(dsq - sts, std + rad), _safe_div(rad - std, dtd))

        alpha_eff = torch.where(hit_boundary, alpha_b, alpha).unsqueeze(-1)
        step_new = step + alpha_eff * d
        r_new = r - alpha_eff * hd
        rtr_new = _dot(r_new, r_new)
        d_new = _safe_div(rtr_new, rtr).unsqueeze(-1) * d + r_new

        take = running & ~converged  # this lane's trip actually ran
        t1 = take.unsqueeze(-1)
        step, r, d = torch.where(t1, step_new, step), torch.where(t1, r_new, r), torch.where(t1, d_new, d)
        rtr = torch.where(take, rtr_new, rtr)
        i = i + take.to(torch.int32)
        done = torch.where(running, converged | (take & hit_boundary), done)
    return step, r, i


truncated_conjugate_gradient.steps = 0


def minimize_tron(
    value_and_grad: Callable[[Tensor], tuple[Tensor, Tensor]],
    hvp: Callable[[Tensor, Tensor], Tensor],
    x0: Tensor,
    *,
    max_iterations: int = DEFAULT_TRON_MAX_ITER,
    tolerance: float = DEFAULT_TRON_TOLERANCE,
    max_cg_iterations: int = DEFAULT_MAX_CG_ITERATIONS,
    max_improvement_failures: int = DEFAULT_MAX_IMPROVEMENT_FAILURES,
    lower_bounds: Optional[Tensor] = None,
    upper_bounds: Optional[Tensor] = None,
    track_states: bool = False,
) -> OptResult:
    """Minimize a twice-differentiable function with TRON, one problem per lane.

    ``value_and_grad`` maps [B, d] to ([B], [B, d]) and ``hvp(x, v)`` maps
    two [B, d] to the [B, d] Hessian-vector products at x; with a 1-D
    ``x0`` both take and return one problem and the result has no lane
    axis. Box bounds are applied by projection of the trial point
    (TRON.scala:216-221).
    """
    if x0.dim() == 1:
        def vg1(x):
            f, g = value_and_grad(x[0])
            return f.unsqueeze(0), g.unsqueeze(0)

        return minimize_tron(
            vg1, lambda x, v: hvp(x[0], v[0]).unsqueeze(0), x0.unsqueeze(0),
            max_iterations=max_iterations, tolerance=tolerance,
            max_cg_iterations=max_cg_iterations,
            max_improvement_failures=max_improvement_failures,
            lower_bounds=lower_bounds, upper_bounds=upper_bounds, track_states=track_states,
        ).first_lane()

    NOT_CONVERGED = int(ConvergenceReason.NOT_CONVERGED)
    x = project(x0, lower_bounds, upper_bounds)
    f, g = value_and_grad(x)
    g0_norm = norm(g)
    loss_abs_tol = torch.abs(f) * tolerance
    grad_abs_tol = g0_norm * tolerance
    tv, tg = init_tracking(max_iterations, f, g0_norm, track_states)
    # already stationary (a warm start at the optimum): delta = ||g0|| = 0
    # would otherwise reject every attempt until OBJECTIVE_NOT_IMPROVING
    reason = torch.where(
        g0_norm == 0.0, int(ConvergenceReason.GRADIENT_CONVERGED), NOT_CONVERGED
    ).to(torch.int32)
    delta = g0_norm  # TRON.init: delta = ||g0||
    k = torch.zeros_like(reason)
    fails = torch.zeros_like(reason)

    while True:
        active = reason == NOT_CONVERGED
        if not any_lane(active):
            break
        step, residual, _ = truncated_conjugate_gradient(
            lambda v: hvp(x, v), g, delta, max_cg_iterations, active=active
        )
        gs = _dot(g, step)
        predicted = -0.5 * (gs - _dot(step, residual))

        # evaluate at the PROJECTED trial point, so the stored value and
        # gradient always belong to the iterate
        x_try = project(x + step, lower_bounds, upper_bounds)
        f_try, g_try = value_and_grad(x_try)
        actual = f - f_try
        step_norm = norm(step)

        # first-iteration initial step-bound adjustment (TRON.scala:152-154)
        delta_n = torch.where(k == 0, torch.minimum(delta, step_norm), delta)

        denom = f_try - f - gs
        alpha = torch.where(
            denom <= 0,
            torch.full_like(denom, SIGMA3),
            torch.clamp_min(-0.5 * _safe_div(gs, denom), SIGMA1),
        )
        # trust-region update cascade (TRON.scala:158-171)
        delta_n = torch.where(
            actual < ETA0 * predicted,
            torch.minimum(torch.clamp_min(alpha, SIGMA1) * step_norm, SIGMA2 * delta_n),
            torch.where(
                actual < ETA1 * predicted,
                torch.maximum(SIGMA1 * delta_n, torch.minimum(alpha * step_norm, SIGMA2 * delta_n)),
                torch.where(
                    actual < ETA2 * predicted,
                    torch.maximum(SIGMA1 * delta_n, torch.minimum(alpha * step_norm, SIGMA3 * delta_n)),
                    torch.maximum(delta_n, torch.minimum(alpha * step_norm, SIGMA3 * delta_n)),
                ),
            ),
        )

        accept = actual > ETA0 * predicted
        a1 = accept.unsqueeze(-1)
        x_new, g_new = torch.where(a1, x_try, x), torch.where(a1, g_try, g)
        f_new = torch.where(accept, f_try, f)
        k_new = k + accept.to(torch.int32)
        fails_n = torch.where(accept, torch.zeros_like(fails), fails + 1)
        reason_accept = convergence_check(
            value=f_new, prev_value=f, grad=g_new, iteration=k_new,
            max_iterations=max_iterations, loss_abs_tol=loss_abs_tol,
            grad_abs_tol=grad_abs_tol,
        )
        reason_n = torch.where(
            accept,
            reason_accept,
            torch.where(
                fails_n >= max_improvement_failures,
                torch.full_like(reason, int(ConvergenceReason.OBJECTIVE_NOT_IMPROVING)),
                torch.full_like(reason, NOT_CONVERGED),
            ),
        )

        tv, tg = record_tracking(tv, tg, k_new, f_new, norm(g_new), active)

        # a lane that had already converged keeps its state
        v1 = active.unsqueeze(-1)
        x, g = torch.where(v1, x_new, x), torch.where(v1, g_new, g)
        f, delta = torch.where(active, f_new, f), torch.where(active, delta_n, delta)
        k, fails = torch.where(active, k_new, k), torch.where(active, fails_n, fails)
        reason = torch.where(active, reason_n, reason)

    return OptResult(coefficients=x, value=f, gradient=g, iterations=k, convergence_reason=reason,
                     tracked_values=tv, tracked_grad_norms=tg)
