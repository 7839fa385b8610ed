"""GLM solver factories. Port of photon_ml_tpu/optimization/solver_cache.py.

The JAX module caches one compiled program per static solver configuration.
PyTorch runs eagerly, so the factories cache nothing; the one cache is a
resident random-effect bucket's CUDA graphs (bucket_graphs.py), which the
buckets' owner holds and :func:`solve_buckets` hands to the bucket solve.
The factories keep the JAX names and signatures so that callers read the
same:

- :func:`glm_solver` returns ``solve(data, x0, l2, l1, lower, upper, norm)
  -> (OptResult, variances)`` for one fixed-effect problem;
- :func:`re_bucket_solver` returns ``solve(X, y, w, offsets, w0, l2, l1)
  -> (coefs, reasons, iters, variances)`` for a bucket of per-entity
  problems, X [E, S, K], solved as E lanes of one batched solve.
- :func:`re_coordinate_update_program` returns ``update(...)``, a whole
  random-effect coordinate update (every bucket solve, the table scatter,
  the [N] score and the divergence guard's select) as one call, with the
  tables at a reduced storage precision when asked (precision.py: bf16 or
  f16 tables and features, every solve and score at f32);
- :func:`re_chunk_update_program` and :func:`re_chunk_score_program` solve
  and score one streamed chunk of the random-effect working set
  (data/working_set.py) through the same bucket solve and view score;
- :func:`sharded_glm_solver` and :func:`shard_mapped_glm_solver` solve one
  fixed effect over sample-sharded data on a mesh (one all_reduce per
  objective evaluation), the former on the stock route as in the JAX
  package, the latter (:func:`glm_solver`'s route) with the kernels on
  each rank's block;
  :func:`fe_coordinate_update_program` is a fixed-effect coordinate update
  (solve, score and divergence select) as one call;
- :func:`re_population_update_program` and :func:`fe_population_update_program`
  update P hyperparameter settings at once (sweep/population.py): the
  random-effect update body with a leading population axis (P x E_b lanes
  per bucket over the shared block), and the fixed-effect lanes through
  ``GLMObjective.population_value_and_gradient`` (products in fixed
  blocks of lanes), each with per-lane rejects and, ``with_active``, the
  early-exit mask (:func:`_masked_value_and_grad`).

The configured optimizer (LBFGS, OWLQN, LBFGSB, TRON or NEWTON) runs both;
TRON gets the objective's Hessian-vector product, NEWTON its full Hessian
and OWLQN the L1 weight, per bucket for the random effects; box bounds
reach the fixed-effect minimizer. ``re_solver="direct"`` / ``"auto"``
replace a bucket's optimizer by the Gram/Cholesky Newton solves of
normal_equations.py. Variances NONE, SIMPLE and FULL are ported.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from photon_ml_tpu_torch.data.dataset import LabeledData
from photon_ml_tpu_torch.data.matrix import DenseDesignMatrix
from photon_ml_tpu_torch.function.losses import loss_for_task
from photon_ml_tpu_torch.function.objective import GLMObjective, lane_products
from photon_ml_tpu_torch.models.game import random_effect_view_score
from photon_ml_tpu_torch.normalization import NO_NORMALIZATION
from photon_ml_tpu_torch.ops import small_linalg
from photon_ml_tpu_torch.optimization import bucket_graphs, normal_equations
from photon_ml_tpu_torch.optimization.common import OptimizerConfig, any_lane
from photon_ml_tpu_torch.optimization.factory import build_minimizer
from photon_ml_tpu_torch.optimization.precision import FLOAT32, resolve_precision
from photon_ml_tpu_torch.types import OptimizerType, TaskType, VarianceComputationType
from photon_ml_tpu_torch.util.timed import count, recording, span

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


def _masked_value_and_grad(vg, active: Tensor):
    """The population early-exit lever: wrap a value-and-gradient so that an
    INACTIVE lane's objective reads exactly stationary (f = 0, g = 0). Every
    minimizer's zero-gradient init check then converges that lane in zero
    iterations, so a batched solve's trip count follows the slowest ACTIVE
    lane: frozen lanes still ride the batched body but no longer extend it.
    Callers select-freeze the lane's outputs to its previous state. OWLQN
    needs the L1 weight masked too (the pseudo-gradient of a zero smooth
    gradient is still ``l1 * sign(x)``): see the call sites."""

    def masked(w):
        f, g = vg(w)
        zero = torch.zeros((), dtype=f.dtype, device=f.device)
        return torch.where(active, f, zero), torch.where(active.unsqueeze(-1), g, zero)

    return masked


def _minimize(minimize, obj: GLMObjective, data, x0: Tensor, l2, use_hvp: bool, use_hess: bool,
              active: Optional[Tensor] = None, **kwargs):
    if use_hvp:
        kwargs["hvp"] = lambda w, v: obj.hessian_vector(data, w, v, l2)
    if use_hess:
        kwargs["hess"] = lambda w: obj.hessian_matrix(data, w, l2)
    def vg(w):
        return obj.value_and_gradient(data, w, l2)

    if active is not None:
        vg = _masked_value_and_grad(vg, active)
    return minimize(vg, x0, **kwargs)


class _PopulationLanes:
    """A bucket objective over P x E_b lanes: the minimizers see [P * E_b, K]
    lanes, the objective sees [P, E_b, K] coefficients against the bucket's
    [E_b, S, K] block, broadcast across the population and never copied P
    times (data/matrix.py's lane products take the leading axis as it is)."""

    def __init__(self, obj: GLMObjective, lead: tuple):
        self.obj, self.lead = obj, tuple(lead)

    def _lanes(self, w: Tensor) -> Tensor:
        return w.reshape(self.lead + w.shape[-1:])

    def value_and_gradient(self, data, w: Tensor, l2):
        f, g = self.obj.value_and_gradient(data, self._lanes(w), l2)
        return f.reshape(-1), g.reshape(w.shape)

    def hessian_vector(self, data, w: Tensor, v: Tensor, l2):
        return self.obj.hessian_vector(data, self._lanes(w), self._lanes(v), l2).reshape(w.shape)

    def hessian_matrix(self, data, w: Tensor, l2):
        return self.obj.hessian_matrix(data, self._lanes(w), l2).reshape(w.shape + w.shape[-1:])

    def hessian_diagonal(self, data, w: Tensor, l2):
        return self.obj.hessian_diagonal(data, self._lanes(w), l2).reshape(w.shape)


def glm_solver(
    task: TaskType,
    opt_config: OptimizerConfig,
    has_l1: bool,
    has_lower: bool,
    has_upper: bool,
    variance: VarianceComputationType,
    allow_fused: bool = True,
    psum_axis=None,
):
    """``solve(data, x0, l2, l1, lower, upper, norm) -> (OptResult, variances)``.

    ``allow_fused`` lets the objective take kernels B1, B2 and B3 when their
    gate is open (ops/fused_glm.should_fuse). Absent optional terms (decided
    by the flags) still occupy their argument slot and are not passed on,
    as in the JAX signature. ``psum_axis`` (parallel/mesh.SampleAxis) solves
    over this rank's block of sample-sharded data
    (``GLMObjective.psum_axis``); the JAX package gets the same from GSPMD.
    """
    loss = loss_for_task(TaskType(task))
    minimize = build_minimizer(opt_config)
    use_hvp, use_hess = _second_order(opt_config)
    variance = VarianceComputationType(variance)

    def solve(data: LabeledData, x0: Tensor, l2, l1, lower, upper, norm):
        with span("solver.glm"):
            obj = GLMObjective(loss, norm, allow_fused=allow_fused, psum_axis=psum_axis)
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
    with_active: bool = False,
):
    """The batched bucket solve: every entity of the bucket is one lane of
    the same run (the JAX package vmaps the single solve). ``re_solver``
    picks the solver per bucket shape (normal_equations.use_direct):
    "direct" runs the batched Gram/Cholesky Newton solves, "auto" does so
    for K <= DIRECT_AUTO_K_MAX, "lbfgs" runs the configured optimizer, which
    for TRON and NEWTON gets the bucket's batched HVP or Hessian and for
    OWLQN the L1 weight.

    A [P, E_b, K] warm start (with [P, E_b, S] offsets, [P, E_b] L2 weights
    and an L1 weight per lane of the population) solves P settings of the
    bucket at once: P x E_b lanes over the bucket's block
    (:class:`_PopulationLanes`), outputs with the same leading axes.

    ``with_active=True`` appends an ``active`` flag (a scalar, or [P] over a
    population) to the signature, the population early-exit path: inactive
    lanes see a masked stationary objective, solve in zero iterations and
    report zero iterations.

    ``graphs`` is a resident bucket's graphed solves (``graphs(key, make)``,
    :meth:`bucket_graphs.BucketGraphs.driver` of the bucket, handed over by
    :func:`solve_buckets`): an L-BFGS solve that
    :func:`bucket_graphs.engages` then replays its trips from CUDA graphs."""
    task = TaskType(task)
    loss = loss_for_task(task)
    minimize = build_minimizer(opt_config)
    use_hvp, use_hess = _second_order(opt_config)
    variance = VarianceComputationType(variance)
    re_solver = normal_equations.validate_re_solver(re_solver, has_l1)
    obj = GLMObjective(loss, allow_fused=False)  # batched lanes: no fused kernel

    def solve(X, y, w, offsets, w0, l2, l1, active=None, graphs=None):
        data = LabeledData(X=DenseDesignMatrix(X), labels=y, offsets=offsets, weights=w)
        lead = w0.shape[:-1]
        lanes, x0 = obj, w0
        if w0.dim() == 3:
            lanes, x0 = _PopulationLanes(obj, lead), w0.reshape(-1, w0.shape[-1])
            if has_l1 and torch.is_tensor(l1) and l1.dim():
                l1 = l1.unsqueeze(-1).expand(lead).reshape(-1)
        if active is not None:
            active = active.unsqueeze(-1).expand(lead).reshape(-1)
        if normal_equations.use_direct(re_solver, k=X.shape[-1], has_l1=has_l1):
            # reduced-precision features floor the tolerance at their dtype's
            # epsilon: objective evaluations carry storage-level noise, and
            # Newton steps chasing a finer tolerance through it only revert
            tolerance = opt_config.tolerance
            if X.dtype != w0.dtype:
                tolerance = max(tolerance, float(torch.finfo(X.dtype).eps))
            res = normal_equations.minimize_direct(
                lanes, data, x0, l2, quadratic=task == TaskType.LINEAR_REGRESSION,
                tolerance=tolerance, active=active,
            )
        elif graphs is not None and bucket_graphs.engages(opt_config, has_l1, w0, active):
            key = (task, opt_config, x0.dtype, offsets.dtype, l2.dtype)
            res = graphs(key, lambda capture: bucket_graphs.GraphedLbfgs(
                obj, X, y, w, opt_config, offsets, x0, l2, capture)).solve(x0, offsets, l2)
        else:
            kwargs = {}
            if has_l1:
                # the OWLQN pseudo-gradient of a masked (zero) smooth gradient
                # is l1 * sign(x): a frozen lane would still iterate
                kwargs["l1_weight"] = l1 if active is None else torch.where(
                    active, torch.as_tensor(l1, dtype=x0.dtype, device=x0.device), 0.0)
            res = _minimize(minimize, lanes, data, x0, l2, use_hvp, use_hess, active, **kwargs)
        variances = compute_variances(lanes, data, res.coefficients, l2, variance, w0.dtype)
        iters = res.iterations
        if active is not None:
            iters = torch.where(active, iters, torch.zeros_like(iters))
        if w0.dim() == 3:
            return (res.coefficients.reshape(w0.shape), res.convergence_reason.reshape(lead),
                    iters.reshape(lead), variances.reshape(lead + variances.shape[-1:]))
        return res.coefficients, res.convergence_reason, iters, variances

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


def bucket_solver_plan(re_solver, n_buckets: int) -> tuple:
    """``re_solver`` as one solver name per bucket: a tuple or list is a
    measured per-bucket plan (random_effect.measure_auto_solvers), a string
    applies to every bucket."""
    if isinstance(re_solver, (tuple, list)):
        if len(re_solver) != n_buckets:
            raise ValueError(
                f"per-bucket re_solver plan covers {len(re_solver)} buckets, "
                f"dataset has {n_buckets}"
            )
        return tuple(re_solver)
    return (re_solver,) * n_buckets


def bucket_solves(task, opt_config: OptimizerConfig, has_l1: bool, variance, re_solver,
                  n_buckets: int, with_active: bool = False) -> list:
    """One bucket solve per bucket (:func:`bucket_solver_plan`), one solve
    body built per distinct solver."""
    plan = bucket_solver_plan(re_solver, n_buckets)
    bodies = {s: _re_bucket_solve_fn(task, opt_config, has_l1, variance, s, with_active)
              for s in set(plan)}
    return [bodies[s] for s in plan]


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
                  l2_rows: Tensor, l1, norm_tables=None, solve_dtype=None,
                  active: Optional[Tensor] = None,
                  graphs: Optional[bucket_graphs.BucketGraphs] = None) -> tuple[list, list]:
    """Every bucket's batched solve, in bucket order, warm-started from and
    written back into the [E, K] table ``coeffs`` (and ``variances``) in
    place. ``solves`` is one solve for every bucket or a per-bucket list
    (:func:`bucket_solves`). Each bucket gathers its samples'
    offsets-plus-scores (0 on padding slots) and its entities' L2 weights;
    with per-bucket normalization tables ``(factors, shifts, intercept
    mask)`` the warm start enters the transformed space and the solution
    leaves it, variances scaled by factor^2. The one bucket loop of the
    port: the per-bucket path (algorithm/random_effect.train_random_effect),
    the update program, the population update and the flagship pass all
    run it, so they run the same ops in the same order. ``solve_dtype`` (a
    reduced-precision table's accumulation dtype) is the dtype every solve
    runs at: the warm start and offsets are cast up to it and the solution
    down to the table's.

    A population carries a leading axis P on ``coeffs`` [P, E, K],
    ``offsets_plus_scores`` [P, N], ``l2_rows`` [P, rows] and ``l1`` [P];
    the bucket data is shared. ``active`` (with the with_active solves) is
    handed to every solve. ``graphs``, the buckets' owner's
    :class:`bucket_graphs.BucketGraphs`, marks them resident: each solve
    that :func:`bucket_graphs.engages` replays its trips from the bucket's
    CUDA graphs. Returns the per-bucket (reasons, iterations) tensors.

    Under a profiler it counts ``re.trips``, the solver trips (host syncs)
    of every bucket solve, beside the lane counters."""
    reasons, iters = [], []
    reduced = solve_dtype is not None and solve_dtype != coeffs.dtype
    zero = torch.zeros((), dtype=coeffs.dtype, device=coeffs.device)
    if callable(solves):
        solves = [solves] * len(buckets)
    if norm_tables is None:
        norm_tables = [None] * len(buckets)
    extra = () if active is None else (active,)
    for b, solve, tbl in zip(buckets, solves, norm_tables):
        with span("solver.re_bucket"):
            K = b.X.shape[2]
            rows = b.entity_rows.long()
            off_b = offsets_plus_scores[..., torch.clamp_min(b.sample_ids, 0).long()]
            off_b = torch.where(b.sample_ids >= 0, off_b, zero)
            l2_b = l2_rows[..., torch.clamp_max(rows, l2_rows.shape[-1] - 1)]
            init_b = coeffs[..., rows, :K]
            if reduced:
                off_b = off_b.to(solve_dtype)
                init_b = init_b.to(solve_dtype)
            if tbl is not None:
                init_b = to_transformed_rows(init_b, *tbl)
            kw = {} if graphs is None else {"graphs": functools.partial(graphs.driver, b)}
            syncs = any_lane.syncs
            w_b, reasons_b, iters_b, var_b = solve(b.X, b.labels, b.weights, off_b, init_b, l2_b,
                                                   l1, *extra, **kw)
            count("re.trips", any_lane.syncs - syncs)
            if tbl is not None:
                w_b = to_original_rows(w_b, *tbl)
                if variances is not None and tbl[0] is not None:
                    # Var(w) = Var(w') * factor^2 (the reference's diagonal output)
                    var_b = var_b * tbl[0] ** 2
            if reduced:
                w_b = w_b.to(coeffs.dtype)
                if variances is not None:
                    var_b = var_b.to(variances.dtype)
            coeffs[..., rows, :K] = w_b
            if variances is not None:
                variances[..., rows, :K] = var_b
            reasons.append(reasons_b)
            iters.append(iters_b)
            if recording():
                _count_lanes(b, iters_b)
    return reasons, iters


def _count_lanes(bucket, iters_b: Tensor) -> None:
    """The bucket's lane counters, summed on the device: ``re.lane_iterations``
    the iterations its real entity lanes ran (a padding lane, one with no
    sample, is left out), ``re.lane_slots`` every lane of the batch times the
    trip count the batch executed, its slowest lane's."""
    real = (bucket.sample_ids >= 0).any(dim=-1)
    count("re.lane_iterations", torch.sum(torch.where(real, iters_b, 0), dtype=torch.int64))
    count("re.lane_slots", iters_b.numel() * torch.max(iters_b).to(torch.int64))


def _re_coordinate_update_fn(
    task: TaskType,
    opt_config: OptimizerConfig,
    has_l1: bool,
    variance: VarianceComputationType,
    n_entities: int,
    re_solver="lbfgs",
    precision=FLOAT32,
    with_active: bool = False,
    graphs: Optional[bucket_graphs.BucketGraphs] = None,
):
    """The whole-coordinate update body shared by
    :func:`re_coordinate_update_program` (one model) and
    :func:`re_population_update_program` (a leading population axis on the
    tables, scores, L2 rows and L1 weights): one body, so the two stay
    interchangeable per lane. See the program docstrings for the contract.

    ``with_active=True`` (the population early-exit form) takes an
    ``active`` flag after ``l1``: a frozen (inactive) lane's bucket solves
    run zero iterations (masked stationary objective, see
    :func:`_masked_value_and_grad`) and its outputs are select-frozen to the
    PREVIOUS table, score and variances bit for bit. The select matters: a
    zero-iteration solve alone would round-trip the warm start through the
    normalization space conversion, which is not a bitwise identity. The
    lane's ``ok`` reads True (carrying committed state is not a reject) and
    its iteration counts zero."""
    precision = resolve_precision(precision)
    solve_dtype = None if precision.is_reference else precision.accum_dtype

    def update_core(coeffs_prev, score_prev, var_prev, offsets_plus_scores, l2_rows, l1,
                    buckets, norm_tables, view, active=None):
        solves = bucket_solves(task, opt_config, has_l1, variance, re_solver, len(buckets),
                               with_active)
        coeffs = coeffs_prev.clone()
        variances = None if var_prev is None else var_prev.clone()
        reasons, iters = solve_buckets(solves, buckets, coeffs, variances,
                                       offsets_plus_scores, l2_rows, l1, norm_tables,
                                       solve_dtype, active, graphs)
        if coeffs.shape[-2] > n_entities:
            coeffs[..., n_entities:, :] = 0.0
            if variances is not None:
                variances[..., n_entities:, :] = 0.0
        if solve_dtype is None:
            score = random_effect_view_score(coeffs, *view)
        else:
            # storage-width tables and values, the products and sums at f32
            rows, cols, vals = view
            score = random_effect_view_score(coeffs.to(solve_dtype), rows, cols,
                                             vals.to(solve_dtype))
        # variances are left out of the guard: a singular-Hessian variance
        # must not discard a converged mean update
        population = coeffs.dim() == 3
        ok = torch.isfinite(coeffs).flatten(1).all(dim=1) if population else (
            torch.isfinite(coeffs).all())
        keep = ok if active is None else ok & active
        k3, k2 = (keep.view(-1, 1, 1), keep.view(-1, 1)) if population else (keep, keep)
        coeffs_out = torch.where(k3, coeffs, coeffs_prev)
        score_out = torch.where(k2, score, score_prev)
        var_out = None if variances is None else torch.where(k3, variances, var_prev)
        if active is not None:
            ok = ok | ~active
        return coeffs_out, score_out, var_out, ok, tuple(reasons), tuple(iters)

    if with_active:
        def update(coeffs_prev, score_prev, var_prev, offsets_plus_scores, l2_rows, l1, active,
                   buckets, norm_tables, view):
            return update_core(coeffs_prev, score_prev, var_prev, offsets_plus_scores, l2_rows,
                               l1, buckets, norm_tables, view, active)

        return update

    def update(coeffs_prev, score_prev, var_prev, offsets_plus_scores, l2_rows, l1, buckets,
               norm_tables, view):
        return update_core(coeffs_prev, score_prev, var_prev, offsets_plus_scores, l2_rows, l1,
                           buckets, norm_tables, view)

    return update


def re_coordinate_update_program(
    task: TaskType,
    opt_config: OptimizerConfig,
    has_l1: bool,
    variance: VarianceComputationType,
    n_entities: int,
    re_solver="lbfgs",
    precision=FLOAT32,
    graphs: Optional[bucket_graphs.BucketGraphs] = None,
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

    ``precision`` (optimization/precision.py) splits storage from
    accumulation: under a reduced policy the tables ``coeffs_prev`` and
    ``var_prev``, the buckets' X blocks and the view's values come in at the
    storage dtype (bf16 or f16, cast by the caller), every solve and the
    score run at the accumulation dtype (f32), and the solutions are rounded
    to the storage dtype for the table. The reference f32 policy makes every
    cast an identity.

    The table stays on the device and nothing is read to the host between
    buckets beyond the bucket solves' own ``any_lane`` syncs. The JAX
    package's program donates its inputs and caches a compiled program; here
    the previous table is copied (the select needs it), and ``graphs``, the
    coordinate's :class:`bucket_graphs.BucketGraphs` for ``buckets``, holds
    the bucket solves' CUDA graphs (:func:`solve_buckets`).
    """
    return _re_coordinate_update_fn(task, opt_config, has_l1, variance, n_entities, re_solver,
                                    precision, graphs=graphs)


def re_population_update_program(
    task: TaskType,
    opt_config: OptimizerConfig,
    has_l1: bool,
    variance: VarianceComputationType,
    n_entities: int,
    re_solver="lbfgs",
    precision=FLOAT32,
    with_active: bool = False,
):
    """:func:`re_coordinate_update_program` with a LEADING POPULATION AXIS:
    P hyperparameter settings' random-effect updates at once over shared
    device-resident data (photon_ml_tpu_torch/sweep/).

    ``update(coeffs_prev [P,E,K], score_prev [P,N], var_prev ([P,E,K] or
    None), offsets_plus_scores [P,N], l2_rows [P,rows], l1 [P], buckets,
    norm_tables, view) -> (coeffs [P,E,K], score [P,N], variances, ok [P],
    reasons, iters)``, reasons and iterations [P, E_b] per bucket.

    The body is the single-model one: each bucket solves P x E_b lanes in
    one batched solve over the bucket block, which is broadcast, never
    copied P times; normalization tables and the scoring view are shared;
    the divergence reject applies per lane. A lane's output depends on that
    lane's inputs alone (every product is per lane, converged lanes are
    select-frozen), which is what makes the sequential path of
    sweep/population.py bitwise the vmapped one at the same P.

    ``with_active=True`` adds a per-lane ``[P]`` bool ``active`` argument
    after ``l1`` (the early-exit family): inactive lanes solve in zero
    iterations and carry their previous state bitwise."""
    return _re_coordinate_update_fn(task, opt_config, has_l1, variance, n_entities, re_solver,
                                    precision, with_active)


def _fe_population_update_fn(
    task: TaskType,
    opt_config: OptimizerConfig,
    has_l1: bool,
    down_sampling: bool = False,
    with_active: bool = False,
):
    """The fixed-effect population update body, shared by
    :func:`fe_population_update_program` (one call per update) and the fused
    whole-sweep pass (parallel/game.population_sweep_fn), so the two stay
    interchangeable per lane. ``with_active=True`` inserts a per-lane
    ``active [P]`` argument after ``keep_u`` (inactive lanes: zero-iteration
    masked solve, outputs select-frozen to the previous state bitwise, flags
    report no reject, iterations report zero)."""
    from photon_ml_tpu_torch.function.losses import POSITIVE_RESPONSE_THRESHOLD

    task = TaskType(task)
    loss = loss_for_task(task)
    minimize = build_minimizer(opt_config)
    use_hvp, use_hess = _second_order(opt_config)
    classification = task.is_classification

    def update_core(coeffs_prev, score_prev, offsets_pop, l2, l1, rates, keep_u, active,
                    data: LabeledData, norm):
        weights = data.weights
        if down_sampling:
            keep = keep_u < rates.unsqueeze(-1)
            if classification:
                pos = data.labels > POSITIVE_RESPONSE_THRESHOLD
                weights = torch.where(pos, weights,
                                      torch.where(keep, weights / rates.unsqueeze(-1), 0.0))
            else:
                weights = torch.where(keep, weights, 0.0)
        obj = GLMObjective(loss, norm, allow_fused=False)  # lanes: no fused kernel
        x0 = norm.to_transformed_space_device(coeffs_prev)

        def vg(w):
            return obj.population_value_and_gradient(data, w, l2, offsets_pop, weights)

        if active is not None:
            vg = _masked_value_and_grad(vg, active)
        kwargs = {}
        if use_hvp:
            kwargs["hvp"] = lambda w, v: obj.population_hessian_vector(
                data, w, v, l2, offsets_pop, weights)
        if use_hess:
            kwargs["hess"] = lambda w: obj.population_hessian_matrix(
                data, w, l2, offsets_pop, weights)
        if has_l1:
            kwargs["l1_weight"] = l1 if active is None else torch.where(active, l1, 0.0)
        res = minimize(vg, x0, **kwargs)
        means = norm.to_original_space_device(res.coefficients)
        score = population_matvec(data.X, means)
        # the same two checks, in the same order, as the host loop's
        # divergence guard (coordinate_descent._guard_cause)
        value_ok = torch.isfinite(res.value)
        coefs_ok = torch.isfinite(means).all(dim=-1)
        ok = value_ok & coefs_ok
        iters = res.iterations
        if active is not None:
            # a frozen lane carries its state bitwise (the normalization
            # round trip is not an identity, so the select is load-bearing),
            # reports no reject and no iterations
            ok = ok & active
            value_ok = value_ok | ~active
            coefs_ok = coefs_ok | ~active
            iters = torch.where(active, iters, torch.zeros_like(iters))
        means_out = torch.where(ok.unsqueeze(-1), means, coeffs_prev)
        score_out = torch.where(ok.unsqueeze(-1), score, score_prev)
        return (means_out, score_out, coefs_ok, value_ok, res.value, iters,
                res.convergence_reason)

    if with_active:
        return update_core

    def update(coeffs_prev, score_prev, offsets_pop, l2, l1, rates, keep_u, data, norm):
        return update_core(coeffs_prev, score_prev, offsets_pop, l2, l1, rates, keep_u, None,
                           data, norm)

    return update


def fe_population_update_program(
    task: TaskType,
    opt_config: OptimizerConfig,
    has_l1: bool,
    down_sampling: bool = False,
    with_active: bool = False,
):
    """Population fixed-effect coordinate update: P settings' fixed-effect
    solves over ONE shared design matrix, each lane's [N] training score and
    divergence flags, the reject applied in the call (photon_ml_tpu_torch/
    sweep/).

    ``update(coeffs_prev [P,D], score_prev [P,N], offsets_plus_scores [P,N],
    l2 [P], l1 [P], rates [P], keep_u [N], data, norm) -> (coeffs [P,D],
    score [P,N], coefs_ok [P], value_ok [P], values [P], iters [P],
    reasons [P])``; ``with_active=True`` inserts a per-lane ``active [P]``
    bool argument after ``keep_u`` (the early-exit family).

    - ``coeffs_prev`` are ORIGINAL-space warm starts; the conversion to the
      solver's transformed space and back mirrors
      ``GLMOptimizationProblem.run``.
    - The lanes' objective is ``GLMObjective.population_value_and_gradient``
      (with its HVP and Hessian for TRON and NEWTON): the products X C^T and
      X^T (W * dz) in fixed blocks of lanes, never a fused kernel.
    - ``down_sampling=True`` adds a per-lane rate: the caller supplies ONE
      shared uniform draw ``keep_u [N]`` (sampling/down_sampler.
      per_sample_uniform, a pure function of seed, call and sample position)
      and each lane derives its weights by the task's rule (classification:
      positives kept, negatives kept below the rate at weight 1/rate;
      regression: uniform keep, no re-scaling), the ``DownSampler``
      semantics as a lane axis.
    - The divergence guard mirrors the host loop's two checks
      (``_guard_cause``): a non-finite final objective, then non-finite
      coefficients; either keeps the lane's previous coefficients and score
      bit for bit.
    """
    return _fe_population_update_fn(task, opt_config, has_l1, down_sampling, with_active)


def population_matvec(X, W: Tensor) -> Tensor:
    """Every lane's score [P, N] of lane coefficients W [P, D] over one
    design matrix, lane-major (``objective.lane_products``: fixed blocks of
    lanes)."""
    return lane_products(X, W)


def _chunk_view_score(w_rows: Tensor, sample_ids: Tensor, view_cols: Tensor,
                      view_vals: Tensor) -> Tensor:
    """The [C * S] scores of a chunk's samples: its C lanes stand in as a
    C-row table for ``random_effect_view_score``, so each sample gathers,
    multiplies and sums exactly as the all-resident score does."""
    C = w_rows.shape[0]
    lanes = torch.arange(C, dtype=torch.int32, device=w_rows.device)[:, None]
    lane_rows = torch.where(sample_ids >= 0, lanes, -1).reshape(-1)
    safe = torch.clamp_min(sample_ids.reshape(-1), 0).long()
    return random_effect_view_score(w_rows, lane_rows, view_cols[safe], view_vals[safe])


def _scatter_scores(score_partial: Tensor, sample_ids: Tensor, contrib: Tensor) -> Tensor:
    """Write a chunk's sample scores into the running [N + 1] partial, IN
    PLACE, and return it: the partial is the caller's running buffer, so a
    pass holds one [N + 1] score (the torch form of the JAX program's
    donated score partial; the program audit records the alias). Its last
    slot takes every padding slot's write (sample id -1), so the scatter
    needs no mask, and no host read."""
    n = score_partial.shape[0] - 1
    sid = sample_ids.reshape(-1).long()
    idx = torch.where(sid >= 0, sid, n)
    return score_partial.index_copy_(0, idx, contrib.to(score_partial.dtype))


def re_chunk_update_program(
    task: TaskType,
    opt_config: OptimizerConfig,
    has_l1: bool,
    variance: VarianceComputationType,
    k_all: int,
    re_solver: str = "lbfgs",
):
    """The update of one STREAMED working-set chunk (data/working_set.py):

    ``update(init_chunk, score_partial, X, y, w, sample_ids, l2, l1,
    norm_rows, offsets_plus_scores, view_cols, view_vals) -> (w_out,
    var_out, score_partial, ok, reasons, iters)``

    - ``[C, S, K]`` entity lanes solved by the same batched bucket solve as
      the all-resident program, warm-started from ``init_chunk`` [C, K];
    - their samples' scores through the same ``random_effect_view_score``
      as the all-resident score, the chunk's lanes standing in as a C-row
      table padded to ``k_all`` columns (the view's local columns stay below
      the bucket's K); they are written IN PLACE into ``score_partial``
      [N + 1], which is returned, and whose last slot takes the padding
      lanes' writes (sample ids -1);
    - ``ok``, the chunk's divergence flag (every solved coefficient finite),
      a device scalar for the caller's commit decision.

    The coefficients and scores equal the all-resident program's bit for bit
    when the batched solve gives each lane the same bits at every lane count
    (tests/test_torch_working_set.py holds it on the CPU, chip_smoke.py
    phase 15a on the card); the working set gives a bucket that fits one
    chunk its exact entity count as lane count.
    """
    solve = re_bucket_solver(task, opt_config, has_l1, variance, re_solver)
    variance_on = VarianceComputationType(variance) != VarianceComputationType.NONE

    def update(init_chunk, score_partial, X, y, w, sample_ids, l2, l1, norm_rows,
               offsets_plus_scores, view_cols, view_vals):
        K = X.shape[2]
        off = offsets_plus_scores[torch.clamp_min(sample_ids, 0).long()]
        off = torch.where(sample_ids >= 0, off, 0.0).to(init_chunk.dtype)
        init = init_chunk
        if norm_rows is not None:
            init = to_transformed_rows(init, *norm_rows)
        w_out, reasons, iters, var_out = solve(X, y, w, off, init, l2, l1)
        if norm_rows is not None:
            w_out = to_original_rows(w_out, *norm_rows)
            if variance_on and norm_rows[0] is not None:
                var_out = var_out * norm_rows[0] ** 2
        ok = torch.isfinite(w_out).all()
        w_table = torch.zeros((X.shape[0], k_all), dtype=w_out.dtype, device=w_out.device)
        w_table[:, :K] = w_out
        contrib = _chunk_view_score(w_table, sample_ids, view_cols, view_vals)
        score_out = _scatter_scores(score_partial, sample_ids, contrib)
        return w_out, var_out if variance_on else None, score_out, ok, reasons, iters

    return update


def re_chunk_score_program():
    """Scoring for a host table one chunk at a time (the working set's
    initial score): ``score(score_partial, w_rows, sample_ids, view_cols,
    view_vals) -> score_partial``, a chunk's full-width rows ``w_rows``
    [C, K_all] through the same view score as the all-resident path, so
    the assembled [N + 1] partial equals the full-table score bitwise."""

    def score_chunk(score_partial, w_rows, sample_ids, view_cols, view_vals):
        contrib = _chunk_view_score(w_rows, sample_ids, view_cols, view_vals)
        return _scatter_scores(score_partial, sample_ids, contrib)

    return score_chunk


def fe_coordinate_update_program(
    task: TaskType,
    opt_config: OptimizerConfig,
    has_l1: bool,
    shardings=None,
    allow_fused: bool = True,
):
    """A fixed-effect coordinate update as one call: the GLM solve, the
    original-space conversion, this coordinate's score and the divergence
    guard's select (algorithm/coordinate.FixedEffectCoordinate.
    update_and_score).

    ``update(coeffs_prev, score_prev, offsets_plus_scores, l2, l1, data,
    norm) -> (coeffs, score, ok, value, iters, reason)``

    - ``coeffs_prev`` [D] is the ORIGINAL-space warm start (converted as in
      ``GLMOptimizationProblem.run``) and ``score_prev`` the previous score
      of ``data``'s rows; a non-finite final objective or non-finite
      coefficients return both unchanged (``ok`` False, the host loop's two
      checks in its order), with no host read;
    - ``data`` may be dense or sparse: the objective's products dispatch on
      the storage;
    - ``shardings``: None on one device; a ``parallel.mesh.Mesh`` when
      ``data`` is this rank's block of a placed dataset (1-D or the 2-D
      feature-sharded block): the objective then reduces over the mesh
      (``Mesh.sample_axis``) and the score is this rank's block. The JAX
      program pins its donated state's shardings there;
    - ``allow_fused``: the kernel switch; mesh callers of the JAX package
      pass False (GSPMD cannot partition a pallas_call), and sparse storage
      never fuses.
    """
    task = TaskType(task)
    loss = loss_for_task(task)
    minimize = build_minimizer(opt_config)
    use_hvp, use_hess = _second_order(opt_config)
    psum_axis = None if shardings is None else shardings.sample_axis()

    def update(coeffs_prev, score_prev, offsets_plus_scores, l2, l1, data, norm):
        d2 = data.with_offsets(offsets_plus_scores)
        obj = GLMObjective(loss, norm, allow_fused=allow_fused, psum_axis=psum_axis)
        x0 = norm.to_transformed_space_device(coeffs_prev)
        kwargs = {"l1_weight": l1} if has_l1 else {}
        res = _minimize(minimize, obj, d2, x0, l2, use_hvp, use_hess, **kwargs)
        means = norm.to_original_space_device(res.coefficients)
        score = data.X.matvec(means)
        # the host loop's divergence guard: the same two checks, same order
        ok = torch.isfinite(res.value) & torch.isfinite(means).all()
        coeffs_out = torch.where(ok, means, coeffs_prev)
        score_out = torch.where(ok, score, score_prev)
        return coeffs_out, score_out, ok, res.value, res.iterations, res.convergence_reason

    return update


def sharded_glm_solver(
    task: TaskType,
    opt_config: OptimizerConfig,
    has_l1: bool,
    mesh,
    has_lower: bool = False,
    has_upper: bool = False,
):
    """``solve(data, x0, l2, l1, lower, upper, norm) -> OptResult`` over
    ``data``, this rank's block of a sample-sharded problem on ``mesh``
    (parallel/glm.shard_labeled_data): coefficients replicated on every
    rank, the data sums of every objective evaluation in one all_reduce
    (the treeAggregate of ValueAndGradientAggregator.scala:240-255). Absent
    bounds occupy their argument slot, as in :func:`glm_solver`.

    The kernels stay off (``allow_fused=False``), as in the JAX package,
    whose GSPMD lowering cannot partition a pallas_call: each rank takes the
    stock route. :func:`shard_mapped_glm_solver` is the form with them."""
    solve_v = glm_solver(task, opt_config, has_l1, has_lower, has_upper,
                         VarianceComputationType.NONE, allow_fused=False,
                         psum_axis=mesh.sample_axis())

    def solve(data, x0, l2, l1, lower, upper, norm):
        return solve_v(data, x0, l2, l1, lower, upper, norm)[0]

    return solve


def shard_mapped_glm_solver(
    task: TaskType,
    opt_config: OptimizerConfig,
    has_l1: bool,
    mesh,
    axis_name: str = "data",
):
    """``solve(data, x0, l2, l1) -> OptResult``: the JAX package's name for
    :func:`glm_solver` over this rank's dense [N/m, D] block with the
    kernels allowed, the data sums of each evaluation combined by one
    all_reduce over ``axis_name`` (``GLMObjective.psum_axis``, JAX's
    ``shard_map`` + ``lax.psum``). The [D] optimizer state is the same on
    every rank because it only ever consumes summed quantities.

    Kernels B1 (every value+gradient), B2 (TRON's Hessian-vector products)
    and B3 (NEWTON's Hessian, one all_reduce of the [D, D] block) run on
    each rank's block when their gate is open (``fused_glm.should_fuse``).
    Identity normalization, no bounds or variances (the fused GAME pass's
    regime); a sparse design raises ``TypeError`` as in the JAX package,
    where an nnz-sharded matrix gives each device partial margins."""
    from photon_ml_tpu_torch.parallel.mesh import SampleAxis

    solve_v = glm_solver(task, opt_config, has_l1, False, False, VarianceComputationType.NONE,
                         allow_fused=True, psum_axis=SampleAxis(mesh.axis(axis_name)))

    def solve(data, x0, l2, l1):
        if not isinstance(data.X, DenseDesignMatrix):
            raise TypeError(
                "shard_mapped_glm_solver requires a dense sample-sharded "
                "design matrix; sparse problems take the GSPMD path"
            )
        return solve_v(data, x0, l2, l1, None, None, NO_NORMALIZATION)[0]

    return solve
