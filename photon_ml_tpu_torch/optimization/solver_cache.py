"""GLM solver factories. Port of photon_ml_tpu/optimization/solver_cache.py.

The JAX module caches one compiled program per static solver configuration.
PyTorch runs eagerly, so nothing is cached here; the factories keep the JAX
names and signatures so that callers read the same:

- :func:`glm_solver` returns ``solve(data, x0, l2, l1, lower, upper, norm)
  -> (OptResult, variances)`` for one fixed-effect problem;
- :func:`re_bucket_solver` returns ``solve(X, y, w, offsets, w0, l2, l1)
  -> (coefs, reasons, iters, variances)`` for a bucket of per-entity
  problems, X [E, S, K], solved as E lanes of one batched solve.
- :func:`re_coordinate_update_program` returns ``update(...)``, a whole
  random-effect coordinate update (every bucket solve, the table scatter,
  the [N] score and the divergence guard's select) as one call.

The configured optimizer (LBFGS, OWLQN, LBFGSB, TRON or NEWTON) runs both;
TRON gets the objective's Hessian-vector product, NEWTON its full Hessian
and OWLQN the L1 weight, per bucket for the random effects; box bounds
reach the fixed-effect minimizer. ``re_solver="direct"`` / ``"auto"``
replace a bucket's optimizer by the Gram/Cholesky Newton solves of
normal_equations.py. Variances NONE, SIMPLE and FULL are ported.
"""

from __future__ import annotations

import torch

from photon_ml_tpu_torch.data.dataset import LabeledData
from photon_ml_tpu_torch.data.matrix import DenseDesignMatrix
from photon_ml_tpu_torch.function.losses import loss_for_task
from photon_ml_tpu_torch.function.objective import GLMObjective
from photon_ml_tpu_torch.models.game import random_effect_view_score
from photon_ml_tpu_torch.ops import small_linalg
from photon_ml_tpu_torch.optimization import normal_equations
from photon_ml_tpu_torch.optimization.common import OptimizerConfig
from photon_ml_tpu_torch.optimization.factory import build_minimizer
from photon_ml_tpu_torch.types import OptimizerType, TaskType, VarianceComputationType

Tensor = torch.Tensor


def compute_variances(obj: GLMObjective, data, coef: Tensor, l2, variance, dtype) -> Tensor:
    """SIMPLE: 1/diag(H); FULL: diag(H^-1) via Cholesky
    (DistributedOptimizationProblem.computeVariances:84-108), batched over
    leading lanes. The unit-diagonal guard keeps the factorization
    well-posed for all-zero padding slots of entity buckets."""
    variance = VarianceComputationType(variance)
    if variance == VarianceComputationType.SIMPLE:
        diag = obj.hessian_diagonal(data, coef, l2)
        return 1.0 / torch.where(diag == 0.0, torch.full_like(diag, float("inf")), diag)
    if variance == VarianceComputationType.FULL:
        H = obj.hessian_matrix(data, coef, l2)
        diag = torch.diagonal(H, dim1=-2, dim2=-1)
        H = H + torch.diag_embed((diag == 0.0).to(H.dtype))
        if H.shape[-1] <= small_linalg.MAX_UNROLL_DIM:
            return small_linalg.small_spd_inverse_diag(H)
        L = small_linalg.cholesky_or_nan(H)
        eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
        Linv = torch.linalg.solve_triangular(L, eye.expand(H.shape), upper=False)
        return torch.diagonal(Linv.transpose(-1, -2) @ Linv, dim1=-2, dim2=-1)
    # NONE: an empty vector per lane, as a vmapped JAX solve returns
    return torch.zeros(coef.shape[:-1] + (0,), dtype=dtype, device=coef.device)


def _second_order(opt_config: OptimizerConfig) -> tuple[bool, bool]:
    """(use_hvp, use_hess): TRON takes the HVP, NEWTON the full Hessian."""
    opt = OptimizerType(opt_config.optimizer_type)
    return opt == OptimizerType.TRON, opt == OptimizerType.NEWTON


def _minimize(minimize, obj: GLMObjective, data, x0: Tensor, l2, use_hvp: bool, use_hess: bool,
              **kwargs):
    if use_hvp:
        kwargs["hvp"] = lambda w, v: obj.hessian_vector(data, w, v, l2)
    if use_hess:
        kwargs["hess"] = lambda w: obj.hessian_matrix(data, w, l2)
    return minimize(lambda w: obj.value_and_gradient(data, w, l2), x0, **kwargs)


def glm_solver(
    task: TaskType,
    opt_config: OptimizerConfig,
    has_l1: bool,
    has_lower: bool,
    has_upper: bool,
    variance: VarianceComputationType,
    allow_fused: bool = True,
):
    """``solve(data, x0, l2, l1, lower, upper, norm) -> (OptResult, variances)``.

    ``allow_fused`` lets the objective take kernels B1, B2 and B3 when their
    gate is open (ops/fused_glm.should_fuse). Absent optional terms (decided
    by the flags) still occupy their argument slot and are not passed on,
    as in the JAX signature.
    """
    loss = loss_for_task(TaskType(task))
    minimize = build_minimizer(opt_config)
    use_hvp, use_hess = _second_order(opt_config)
    variance = VarianceComputationType(variance)

    def solve(data: LabeledData, x0: Tensor, l2, l1, lower, upper, norm):
        obj = GLMObjective(loss, norm, allow_fused=allow_fused)
        kwargs = {}
        if has_l1:
            kwargs["l1_weight"] = l1
        if has_lower:
            kwargs["lower_bounds"] = lower
        if has_upper:
            kwargs["upper_bounds"] = upper
        result = _minimize(minimize, obj, data, x0, l2, use_hvp, use_hess, **kwargs)
        variances = compute_variances(obj, data, result.coefficients, l2, variance, x0.dtype)
        return result, variances

    return solve


def _re_bucket_solve_fn(
    task: TaskType,
    opt_config: OptimizerConfig,
    has_l1: bool,
    variance: VarianceComputationType,
    re_solver: str = "lbfgs",
):
    """The batched bucket solve: every entity of the bucket is one lane of
    the same run (the JAX package vmaps the single solve). ``re_solver``
    picks the solver per bucket shape (normal_equations.use_direct):
    "direct" runs the batched Gram/Cholesky Newton solves, "auto" does so
    for K <= DIRECT_AUTO_K_MAX, "lbfgs" runs the configured optimizer, which
    for TRON and NEWTON gets the bucket's batched HVP or Hessian and for
    OWLQN the L1 weight."""
    task = TaskType(task)
    loss = loss_for_task(task)
    minimize = build_minimizer(opt_config)
    use_hvp, use_hess = _second_order(opt_config)
    variance = VarianceComputationType(variance)
    re_solver = normal_equations.validate_re_solver(re_solver, has_l1)
    obj = GLMObjective(loss, allow_fused=False)  # batched lanes: no fused kernel

    def solve(X, y, w, offsets, w0, l2, l1):
        data = LabeledData(X=DenseDesignMatrix(X), labels=y, offsets=offsets, weights=w)
        if normal_equations.use_direct(re_solver, k=X.shape[-1], has_l1=has_l1):
            res = normal_equations.minimize_direct(
                obj, data, w0, l2, quadratic=task == TaskType.LINEAR_REGRESSION,
                tolerance=opt_config.tolerance,
            )
        else:
            kwargs = {"l1_weight": l1} if has_l1 else {}
            res = _minimize(minimize, obj, data, w0, l2, use_hvp, use_hess, **kwargs)
        variances = compute_variances(obj, data, res.coefficients, l2, variance, w0.dtype)
        return res.coefficients, res.convergence_reason, res.iterations, variances

    return solve


def re_bucket_solver(
    task: TaskType,
    opt_config: OptimizerConfig,
    has_l1: bool,
    variance: VarianceComputationType,
    re_solver: str = "lbfgs",
):
    """Per-entity bucket solve ``solve(X, y, w, offsets, w0, l2, l1) ->
    (coefs, reasons, iters, variances)`` with X [E, S, K], l2 a per-entity
    [E] vector and l1 a scalar."""
    return _re_bucket_solve_fn(task, opt_config, has_l1, variance, re_solver)


def bucket_solves(task, opt_config: OptimizerConfig, has_l1: bool, variance, re_solver,
                  n_buckets: int) -> list:
    """One bucket solve per bucket: ``re_solver`` is a string for every
    bucket or a per-bucket tuple plan (the measured ``"auto"``), one solve
    body built per distinct solver."""
    if isinstance(re_solver, (tuple, list)):
        if len(re_solver) != n_buckets:
            raise ValueError(
                f"per-bucket re_solver plan covers {len(re_solver)} buckets, "
                f"dataset has {n_buckets}"
            )
        bodies = {s: re_bucket_solver(task, opt_config, has_l1, variance, s)
                  for s in sorted(set(re_solver))}
        return [bodies[s] for s in re_solver]
    return [re_bucket_solver(task, opt_config, has_l1, variance, re_solver)] * n_buckets


def to_transformed_rows(w: Tensor, factors, shifts, icpt_mask) -> Tensor:
    """Per-entity rows from the original to the transformed space
    (NormalizationContext modelToTransformedSpace: b' = b + w.shift;
    w' = w / factor), the JAX package's ``random_effect._to_transformed``."""
    if shifts is not None:
        w = w + icpt_mask * torch.sum(w * shifts, dim=-1, keepdim=True)
    if factors is not None:
        w = w / factors
    return w


def to_original_rows(w: Tensor, factors, shifts, icpt_mask) -> Tensor:
    """Transformed -> original (w = w' * factor; b -= w.shift), the JAX
    package's ``random_effect._to_original``."""
    if factors is not None:
        w = w * factors
    if shifts is not None:
        w = w - icpt_mask * torch.sum(w * shifts, dim=-1, keepdim=True)
    return w


def solve_buckets(solves, buckets, coeffs: Tensor, variances, offsets_plus_scores: Tensor,
                  l2_rows: Tensor, l1, norm_tables=None) -> tuple[list, list]:
    """Every bucket's batched solve, in bucket order, warm-started from and
    written back into the [E, K] table ``coeffs`` (and ``variances``) in
    place. ``solves`` is one solve for every bucket or a per-bucket list
    (:func:`bucket_solves`). Each bucket gathers its samples'
    offsets-plus-scores (0 on padding slots) and its entities' L2 weights;
    with per-bucket normalization tables ``(factors, shifts, intercept
    mask)`` the warm start enters the transformed space and the solution
    leaves it, variances scaled by factor^2. The one bucket loop of the
    port: the per-bucket path (algorithm/random_effect.train_random_effect),
    the update program and the flagship pass all run it, so they run the
    same ops in the same order. Returns the per-bucket (reasons, iterations)
    tensors."""
    reasons, iters = [], []
    zero = torch.zeros((), dtype=coeffs.dtype, device=coeffs.device)
    if callable(solves):
        solves = [solves] * len(buckets)
    if norm_tables is None:
        norm_tables = [None] * len(buckets)
    for b, solve, tbl in zip(buckets, solves, norm_tables):
        K = b.X.shape[2]
        rows = b.entity_rows.long()
        off_b = offsets_plus_scores[torch.clamp_min(b.sample_ids, 0).long()]
        off_b = torch.where(b.sample_ids >= 0, off_b, zero)
        l2_b = l2_rows[torch.clamp_max(rows, l2_rows.shape[0] - 1)]
        init_b = coeffs[rows, :K]
        if tbl is not None:
            init_b = to_transformed_rows(init_b, *tbl)
        w_b, reasons_b, iters_b, var_b = solve(b.X, b.labels, b.weights, off_b, init_b, l2_b, l1)
        if tbl is not None:
            w_b = to_original_rows(w_b, *tbl)
            if variances is not None and tbl[0] is not None:
                # Var(w) = Var(w') * factor^2 (the reference's diagonal output)
                var_b = var_b * tbl[0] ** 2
        coeffs[rows, :K] = w_b
        if variances is not None:
            variances[rows, :K] = var_b
        reasons.append(reasons_b)
        iters.append(iters_b)
    return reasons, iters


def check_precision(precision) -> None:
    """The port stores random-effect tables at the dataset dtype (f32 or
    f64), the JAX package's reference policy; reduced storage waits."""
    if precision not in (None, "f32", "float32"):
        raise NotImplementedError(
            f"random-effect storage precision {precision!r} is not ported yet: ROADMAP A13"
        )


def re_coordinate_update_program(
    task: TaskType,
    opt_config: OptimizerConfig,
    has_l1: bool,
    variance: VarianceComputationType,
    n_entities: int,
    re_solver="lbfgs",
    precision=None,
):
    """A whole random-effect coordinate update as one call:

    ``update(coeffs_prev, score_prev, var_prev, offsets_plus_scores, l2_rows,
    l1, buckets, norm_tables, view) -> (coeffs, score, variances, ok,
    reasons_per_bucket, iters_per_bucket)``

    - every bucket's batched solve (:func:`solve_buckets`, with the
      per-bucket normalization tables or None) into a copy of
      ``coeffs_prev`` [E, K] (and ``var_prev`` or None), rows past
      ``n_entities`` kept at zero; ``re_solver`` is a string or a per-bucket
      tuple plan;
    - the coordinate's [N] score through ``view`` (the dataset's entity rows,
      local cols and values) with ``random_effect_view_score``;
    - the divergence guard on the device: ``ok`` says every updated
      coefficient is finite, and when it is not the outputs are the previous
      table, score and variances (a ``torch.where`` select, no host read).

    The table stays on the device and nothing is read to the host between
    buckets beyond the bucket solves' own ``any_lane`` syncs. The JAX
    package's program donates its inputs and caches a compiled program; here
    the previous table is copied (the select needs it) and nothing is cached.
    """
    check_precision(precision)

    def update(coeffs_prev, score_prev, var_prev, offsets_plus_scores, l2_rows, l1,
               buckets, norm_tables, view):
        solves = bucket_solves(task, opt_config, has_l1, variance, re_solver, len(buckets))
        coeffs = coeffs_prev.clone()
        variances = None if var_prev is None else var_prev.clone()
        reasons, iters = solve_buckets(solves, buckets, coeffs, variances,
                                       offsets_plus_scores, l2_rows, l1, norm_tables)
        if coeffs.shape[0] > n_entities:
            coeffs[n_entities:] = 0.0
            if variances is not None:
                variances[n_entities:] = 0.0
        score = random_effect_view_score(coeffs, *view)
        # variances are left out of the guard: a singular-Hessian variance
        # must not discard a converged mean update
        ok = torch.isfinite(coeffs).all()
        coeffs_out = torch.where(ok, coeffs, coeffs_prev)
        score_out = torch.where(ok, score, score_prev)
        var_out = None if variances is None else torch.where(ok, variances, var_prev)
        return coeffs_out, score_out, var_out, ok, tuple(reasons), tuple(iters)

    return update
