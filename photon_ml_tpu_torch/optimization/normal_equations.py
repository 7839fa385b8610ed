"""Batched direct solves for the small dense random-effect buckets.

Port of photon_ml_tpu/optimization/normal_equations.py (the Snap ML local
second-order solver, PAPERS.md 1803.06333, recast on the bucket's lane axis):
each entity's GLM subproblem is solved with a few exact Newton steps over
the assembled Gram/Hessian matrix instead of a quasi-Newton iteration.

- **Linear regression**: the subproblem is quadratic, so ONE Newton step from
  the warm start lands on the optimum of the normal equations,
  ``w* = w0 - (X^T W X + diag(l2))^{-1} g(w0)``.
- **Logistic / Poisson / smoothed hinge**: a capped Newton/IRLS loop. Each
  iteration assembles ``X^T diag(w l'') X + l2 I`` once (the L2 term is the
  damping), solves it by Cholesky (``ops/small_linalg`` for
  K <= MAX_UNROLL_DIM) and tries the step, halving it without re-assembling
  while it does not improve the objective. A step that stays rejected
  freezes the lane (monotone, no line search).

Failure is loud: a singular Gram matrix or NaN-poisoned inputs give
non-finite coefficients that the coordinate's divergence guard rejects.
There is no ridge ladder; the only repair is the unit diagonal on exactly
zero diagonal slots (padding columns and lanes), as ``compute_variances``
applies.

The JAX solves are vmapped ``lax.while_loop``s. Here both loops are host
loops over a leading lane axis that freeze finished lanes, one
:func:`common.any_lane` check per trip. The Gram assembly is the objective's
``hessian_matrix`` (a batched matmul); TF32 must stay off for it, as it is
for every f32 product of the port.

``re_solver`` ("lbfgs" | "direct" | "auto") selects the bucket solver:
"lbfgs" keeps the configured optimizer, "direct" forces these solves (and
rejects L1), "auto" is MEASURED per bucket shape on the host-loop paths
(:class:`AutoSolverDecision`, recorded by
``algorithm.random_effect.measure_auto_solvers`` and carried through the
checkpoint manifest's ``extra``); the static ``K <= DIRECT_AUTO_K_MAX``
prior of :func:`use_direct` remains where no measurement exists (the
flagship pass).
"""

from __future__ import annotations

import dataclasses

import torch

from photon_ml_tpu_torch.ops import small_linalg
from photon_ml_tpu_torch.optimization.common import (
    OptResult,
    any_lane,
    convergence_check,
    norm,
)
from photon_ml_tpu_torch.types import ConvergenceReason

Tensor = torch.Tensor

RE_SOLVERS = ("lbfgs", "direct", "auto")

# "auto" takes the direct path only where the unrolled Cholesky applies
DIRECT_AUTO_K_MAX = 32

# Newton-step cap for the non-quadratic families; step halvings run in an
# inner loop and do not consume it
DIRECT_MAX_NEWTON_ITERATIONS = 8

# a lane whose step was halved this far without improving is frozen
# (OBJECTIVE_NOT_IMPROVING)
DIRECT_MIN_STEP_SCALE = 1.0 / 256.0


def validate_re_solver(re_solver: str, has_l1: bool) -> str:
    """Canonicalize and validate an ``re_solver`` value."""
    solver = str(re_solver).lower()
    if solver not in RE_SOLVERS:
        raise ValueError(
            f"unknown re_solver {re_solver!r}; expected one of {RE_SOLVERS}"
        )
    if solver == "direct" and has_l1:
        raise ValueError(
            "re_solver='direct' cannot solve an L1-regularized subproblem "
            "(the normal equations have no L1 subgradient); use 'auto' "
            "(falls back to the configured optimizer) or 'lbfgs'"
        )
    return solver


def use_direct(re_solver: str, *, k: int, has_l1: bool) -> bool:
    """Static per-bucket-shape choice: "direct" always, "auto" for
    K <= DIRECT_AUTO_K_MAX without L1 (the prior where nothing was measured),
    "lbfgs" never."""
    if re_solver == "direct":
        return True
    if re_solver == "auto":
        return not has_l1 and k <= DIRECT_AUTO_K_MAX
    return False


def _shape_key(s: int, k: int) -> str:
    # string keys, so that the record round-trips through the JSON manifest
    return f"{int(s)}x{int(k)}"


@dataclasses.dataclass
class AutoSolverDecision:
    """Measured per-bucket-shape record behind ``re_solver="auto"``.

    ``per_shape`` maps ``"SxK"`` (a bucket's padded sample and feature
    widths) to ``{"choice", "lbfgs_iters", "direct_iters", "direct_clean"}``:
    each solver's mean iterations over real lanes, and whether every direct
    lane converged cleanly. Direct wins when it converged cleanly in no more
    iterations than the quasi-Newton loop. The record rides the checkpoint
    manifest's ``extra`` so a resumed run replays the same choices bitwise;
    it never enters the fingerprint.
    """

    per_shape: dict = dataclasses.field(default_factory=dict)

    def record(self, s: int, k: int, lbfgs_iters: float, direct_iters: float,
               direct_clean: bool) -> str:
        choice = "direct" if direct_clean and direct_iters <= lbfgs_iters else "lbfgs"
        self.per_shape[_shape_key(s, k)] = {
            "choice": choice,
            "lbfgs_iters": float(lbfgs_iters),
            "direct_iters": float(direct_iters),
            "direct_clean": bool(direct_clean),
        }
        return choice

    def choice_for(self, s: int, k: int) -> str:
        entry = self.per_shape.get(_shape_key(s, k))
        # an unmeasured shape keeps the status-quo solver
        return entry["choice"] if entry else "lbfgs"

    def to_dict(self) -> dict:
        return {"per_shape": {k: dict(v) for k, v in self.per_shape.items()}}

    @classmethod
    def from_dict(cls, d: dict) -> "AutoSolverDecision":
        return cls(per_shape={k: dict(v) for k, v in (d.get("per_shape") or {}).items()})


def _unit_diag_guard(H: Tensor) -> Tensor:
    """Set exactly-zero diagonal slots (padding columns, empty lanes) to 1 so
    the factorization stays well-posed for them. Real singularity is not
    repaired: it must surface as non-finite output."""
    d = torch.diagonal(H, dim1=-2, dim2=-1)
    return H + torch.diag_embed((d == 0.0).to(H.dtype))


def _posdef_solve(H: Tensor, b: Tensor) -> Tensor:
    """x = H^{-1} b by Cholesky, batched: the unrolled factorization up to
    MAX_UNROLL_DIM, ``cholesky_ex`` with failures as NaN above."""
    if H.shape[-1] <= small_linalg.MAX_UNROLL_DIM:
        return small_linalg.small_posdef_solve(H, b)
    L = small_linalg.cholesky_or_nan(H)
    return torch.cholesky_solve(b.unsqueeze(-1), L).squeeze(-1)


def minimize_direct(
    obj,
    data,
    x0: Tensor,
    l2,
    *,
    quadratic: bool,
    max_iterations: int = DIRECT_MAX_NEWTON_ITERATIONS,
    tolerance: float = 1e-7,
) -> OptResult:
    """Direct Newton/IRLS solve of a bucket of GLM subproblems, one per lane.

    ``obj`` is a GLMObjective with identity normalization (random-effect
    blocks are materialized in the solve space), ``data`` the bucket's
    LabeledData over [B, S, K] and ``x0`` the [B, K] warm start.
    ``quadratic=True`` is the linear-regression closed form (one exact
    step), else the capped monotone Newton loop. Returns the same OptResult
    as the iterative minimizers.
    """
    dtype, dev = x0.dtype, x0.device
    NOT_CONVERGED = int(ConvergenceReason.NOT_CONVERGED)
    nan = torch.full((), float("nan"), dtype=dtype, device=dev)

    def vg(w):
        return obj.value_and_gradient(data, w, l2)

    def newton_direction(x, g):
        H = _unit_diag_guard(obj.hessian_matrix(data, x, l2))
        return -_posdef_solve(H, g)

    f0, g0 = vg(x0)
    if quadratic:
        # one Newton step from anywhere IS the optimum of a quadratic, written
        # as a warm-start correction
        x = x0 + newton_direction(x0, g0)
        f, g = vg(x)
        finite = torch.isfinite(f) & torch.isfinite(x).all(dim=-1)
        reason = torch.where(finite, int(ConvergenceReason.GRADIENT_CONVERGED),
                             NOT_CONVERGED).to(torch.int32)
        return OptResult(coefficients=x, value=f, gradient=g,
                         iterations=torch.ones_like(reason), convergence_reason=reason)

    loss_abs_tol = torch.abs(f0) * tolerance
    grad_abs_tol = norm(g0) * tolerance
    reason = torch.where(norm(g0) == 0.0, int(ConvergenceReason.GRADIENT_CONVERGED),
                         NOT_CONVERGED).to(torch.int32)
    x, f, g = x0, f0, g0
    k = torch.zeros_like(reason)

    def accepted(f_c, f):
        return torch.isfinite(f_c) & (f_c <= f)

    def is_plateau(f_c, f):
        # a rejected candidate within the objective tolerance is converged to
        # the data's resolution, not an overshoot
        return torch.isfinite(f_c) & (torch.abs(f_c - f) <= loss_abs_tol)

    while True:
        active = reason == NOT_CONVERGED
        if not any_lane(active):
            break
        p = newton_direction(x, g)
        # a non-finite direction means the factorization failed: surface NaN
        # coefficients for the divergence guard instead of a silent revert
        solve_failed = ~torch.isfinite(p).all(dim=-1)
        alpha = torch.ones_like(f)
        x_c = x + p
        f_c, g_c = vg(x_c)
        # halve the step, reusing the factored direction, while it neither
        # improves nor plateaus; a NaN objective or a failed factorization
        # skips the ladder
        while True:
            halving = (active & ~accepted(f_c, f) & ~is_plateau(f_c, f) & torch.isfinite(f)
                       & ~solve_failed & (alpha * 0.5 >= DIRECT_MIN_STEP_SCALE))
            if not any_lane(halving):
                break
            alpha = torch.where(halving, alpha * 0.5, alpha)
            x_t = x + alpha.unsqueeze(-1) * p
            f_t, g_t = vg(x_t)
            h1 = halving.unsqueeze(-1)
            x_c, f_c, g_c = torch.where(h1, x_t, x_c), torch.where(halving, f_t, f_c), torch.where(h1, g_t, g_c)
        improved = accepted(f_c, f) & ~solve_failed
        k_new = k + 1
        reason_n = convergence_check(
            value=f_c, prev_value=f, grad=g_c, iteration=k_new,
            max_iterations=max_iterations, loss_abs_tol=loss_abs_tol,
            grad_abs_tol=grad_abs_tol,
            objective_failed=((~improved) & (~is_plateau(f_c, f))) | solve_failed,
        )
        i1 = improved.unsqueeze(-1)
        x_new = torch.where(i1, x_c, x)
        # failed factorization: poison the lane so the guard rejects the update
        x_new = torch.where(solve_failed.unsqueeze(-1), x + nan, x_new)
        f_new = torch.where(improved, f_c, f)
        g_new = torch.where(i1, g_c, g)

        a1 = active.unsqueeze(-1)
        x, g = torch.where(a1, x_new, x), torch.where(a1, g_new, g)
        f = torch.where(active, f_new, f)
        k, reason = torch.where(active, k_new, k), torch.where(active, reason_n, reason)

    # a lane whose first state was non-finite never improved: surface the
    # poison instead of a clean revert
    poisoned = ~(torch.isfinite(f0) & torch.isfinite(g0).all(dim=-1))
    x = torch.where(poisoned.unsqueeze(-1), x0 + nan, x)
    return OptResult(coefficients=x, value=f, gradient=g, iterations=k, convergence_reason=reason)
