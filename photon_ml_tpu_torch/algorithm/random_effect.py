"""The random-effect solver: many independent per-entity GLM fits as batched
bucket solves.

Port of photon_ml_tpu/algorithm/random_effect.py (photon-api algorithm/
RandomEffectCoordinate.scala:104-153 and
RandomEffectOptimizationProblem.scala:42-182). Each EntityBucket is one
batched solve over a dense [E, S, K] block, one lane per entity
(``solver_cache.re_bucket_solver``); :func:`train_random_effect` runs the
buckets one after the other (``solver_cache.solve_buckets``) and reads the
per-entity convergence stats to the host once, after the last bucket.

Warm start and normalization: blocks are materialized in the (optionally)
normalized space; initial models arrive in the original space and are
converted per entity with factor, shift and intercept vectors gathered
through the projection table, and solutions are converted back, so the
stored RandomEffectModel is always in the original feature space.

``re_solver="auto"`` is measured: :func:`measure_auto_solvers` probes both
bucket solvers once per bucket shape and records the choice
(normal_equations.AutoSolverDecision).

Continuous training (continuous/) adds two entry points:
:func:`train_random_effect_delta` re-solves only the entities of an active
set, warm-started from the previous generation, and leaves every other row
bitwise as it was; :func:`random_effect_gradient_norms` is the active-set
screen's signal, each entity's subproblem gradient norm at its current
coefficients.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.data.random_effect import RandomEffectDataset, _next_pow2
from photon_ml_tpu_torch.device import to_host
from photon_ml_tpu_torch.function.losses import loss_for_task
from photon_ml_tpu_torch.models.game import RandomEffectModel
from photon_ml_tpu_torch.optimization.bucket_graphs import BucketGraphs
from photon_ml_tpu_torch.optimization.config import GLMOptimizationConfiguration
from photon_ml_tpu_torch.optimization.normal_equations import AutoSolverDecision
from photon_ml_tpu_torch.optimization.solver_cache import (
    bucket_solver_plan,
    bucket_solves,
    re_bucket_solver,
    solve_buckets,
    to_original_rows,
    to_transformed_rows,
)
from photon_ml_tpu_torch.types import (
    ConvergenceReason,
    OptimizerType,
    TaskType,
    VarianceComputationType,
)

Tensor = torch.Tensor


@dataclasses.dataclass
class RandomEffectTracker:
    """Aggregate per-entity convergence stats (RandomEffectOptimizationTracker.scala:158)."""

    convergence_reason_counts: dict[str, int]
    iterations_mean: float
    iterations_max: int
    n_entities: int

    @staticmethod
    def from_arrays(reasons: np.ndarray, iterations: np.ndarray) -> "RandomEffectTracker":
        counts: dict[str, int] = {}
        for code, cnt in zip(*np.unique(reasons, return_counts=True)):
            counts[ConvergenceReason(int(code)).name] = int(cnt)
        return RandomEffectTracker(
            convergence_reason_counts=counts,
            iterations_mean=float(iterations.mean()) if len(iterations) else 0.0,
            iterations_max=int(iterations.max()) if len(iterations) else 0,
            n_entities=len(reasons),
        )

    @staticmethod
    def from_parts(reasons_parts, iters_parts, real_masks=None) -> "RandomEffectTracker":
        """The tracker of per-bucket device tensors, read in one transfer;
        ``real_masks`` (a host bool array per part) leaves padding lanes out."""
        host = to_host(*reasons_parts, *iters_parts)
        n = len(reasons_parts)
        if not n:
            return RandomEffectTracker.from_arrays(np.zeros(0, np.int32), np.zeros(0, np.int32))
        arrays = [t.numpy() for t in host]
        if real_masks is not None:
            arrays = [a[m] for a, m in zip(arrays, list(real_masks) * 2)]
        return RandomEffectTracker.from_arrays(np.concatenate(arrays[:n]),
                                               np.concatenate(arrays[n:]))

    def summary(self) -> str:
        return (
            f"entities={self.n_entities} reasons={self.convergence_reason_counts} "
            f"iters mean={self.iterations_mean:.1f} max={self.iterations_max}"
        )


class LazyRandomEffectTracker:
    """RandomEffectTracker whose per-entity stats stay ON DEVICE until first
    read: the update program returns its reasons and iterations as device
    tensors, and reading them eagerly would put a host sync back between
    coordinate updates. Attribute access (``summary()``,
    ``iterations_mean``...) triggers one batched transfer.

    ``guard_ok`` is the update's device-side divergence flag (all updated
    coefficients finite, computed before the update's reject select).
    ``real_masks`` (a host bool array per part, or None) leaves the working
    set's padding lanes out of the stats."""

    def __init__(self, reasons_parts, iters_parts, guard_ok=None, real_masks=None):
        self.guard_ok = guard_ok
        self._pending = (tuple(reasons_parts), tuple(iters_parts), real_masks)
        self._inner: Optional[RandomEffectTracker] = None

    def _materialize(self) -> RandomEffectTracker:
        if self._inner is None:
            self._inner = RandomEffectTracker.from_parts(*self._pending)
            self._pending = None
        return self._inner

    def summary(self) -> str:
        return self._materialize().summary()

    def __getattr__(self, name):
        # only reached for names not set in __init__ (materialized fields)
        return getattr(self._materialize(), name)


def build_l2_rows(
    dataset: RandomEffectDataset,
    l2: float,
    per_entity_reg_weights,
    dtype,
    table_rows: int,
) -> Tensor:
    """Row-aligned per-entity L2 table on the dataset's device, shared by the
    per-bucket loop and the update program so the two gather identical
    weights. ``per_entity_reg_weights`` is {entity_id: l2} (absent entities
    keep ``l2``) or an [E] array in entity-row order."""
    E = dataset.n_entities
    l2_table = np.full(max(table_rows, E + 1), float(l2))
    if per_entity_reg_weights is not None:
        if isinstance(per_entity_reg_weights, dict):
            row_by_entity = {e: i for i, e in enumerate(dataset.entity_ids)}
            for e_id, w_e in per_entity_reg_weights.items():
                row = row_by_entity.get(e_id, -1)
                if row >= 0:
                    l2_table[row] = float(w_e)
        else:
            arr = np.asarray(per_entity_reg_weights, dtype=np.float64)
            if arr.shape[0] != E:
                raise ValueError(
                    f"per_entity_reg_weights has {arr.shape[0]} entries for "
                    f"{E} entities"
                )
            l2_table[:E] = arr
    return torch.as_tensor(l2_table).to(device=dataset.proj_indices.device, dtype=dtype)


def gather_norm_vectors(normalization, proj: Tensor, dtype):
    """Per-entity (factors [E, K], shifts [E, K], intercept mask [E, K])
    gathered from the global normalization vectors through the projection
    table; padding slots get factor 1 and shift 0. An entity whose
    projection lacks the intercept column cannot carry a shift between the
    spaces, so it raises (the JAX package's ``_gather_norm_vectors``)."""
    if normalization is None or normalization.is_identity:
        return None, None, None
    pad = proj < 0
    safe = torch.clamp_min(proj, 0).long()
    one = torch.ones((), dtype=dtype, device=proj.device)
    factors = shifts = icpt_mask = None
    if normalization.factors is not None:
        f = torch.as_tensor(np.asarray(normalization.factors)).to(device=proj.device, dtype=dtype)
        factors = torch.where(pad, one, f[safe])
    if normalization.shifts is not None:
        sh = torch.as_tensor(np.asarray(normalization.shifts)).to(device=proj.device, dtype=dtype)
        shifts = torch.where(pad, torch.zeros_like(one), sh[safe])
    if normalization.intercept_index is not None:
        icpt_mask = (proj == normalization.intercept_index).to(dtype)
    if shifts is not None:
        if icpt_mask is None:
            raise ValueError(
                "Normalization with shifts requires intercept_index so per-entity "
                "coefficients can be converted between spaces"
            )
        missing = np.flatnonzero(~to_host(icpt_mask.any(dim=-1))[0].numpy())
        if len(missing):
            raise ValueError(
                f"{len(missing)} entities lack the intercept column in their "
                "projection; cannot apply shift normalization (ensure the intercept "
                "survives feature selection, e.g. pass intercept_index to the "
                "dataset builder)"
            )
    return factors, shifts, icpt_mask


def precompute_norm_tables(dataset: RandomEffectDataset, normalization, dtype) -> tuple:
    """Per-bucket (factors, shifts, intercept mask) triples, gathered once per
    (dataset, normalization); None per bucket without normalization."""
    if normalization is None or normalization.is_identity:
        return tuple(None for _ in dataset.buckets)
    # mesh-padded lanes point at the junk row E: they gather a real row's
    # vectors, which their all-zero weights never use
    last = max(dataset.n_entities - 1, 0)
    return tuple(
        gather_norm_vectors(
            normalization,
            dataset.proj_indices[torch.clamp_max(b.entity_rows.long(), last), : b.X.shape[2]],
            dtype)
        for b in dataset.buckets
    )


def check_trainable(task: TaskType, configuration: GLMOptimizationConfiguration) -> None:
    """What every random-effect update refuses up front: a second-order
    optimizer on a loss without a Hessian."""
    loss = loss_for_task(TaskType(task))
    opt_type = OptimizerType(configuration.optimizer_config.optimizer_type)
    if opt_type in (OptimizerType.TRON, OptimizerType.NEWTON) and not loss.has_hessian:
        raise ValueError(f"{opt_type.value} requires a twice-differentiable loss")


def bucket_shape(bucket) -> tuple:
    """A bucket's (S, K) shape class."""
    return int(bucket.X.shape[1]), int(bucket.X.shape[2])


_AUTO_CLEAN_REASONS = (
    int(ConvergenceReason.FUNCTION_VALUES_CONVERGED),
    int(ConvergenceReason.GRADIENT_CONVERGED),
)


def measure_auto_solvers(
    dataset: RandomEffectDataset,
    task: TaskType,
    configuration: GLMOptimizationConfiguration,
    offsets_plus_scores: Tensor,
    *,
    initial_model: Optional[RandomEffectModel] = None,
    normalization=None,
    per_entity_reg_weights=None,
    dtype=None,
) -> AutoSolverDecision:
    """The one-shot probe behind ``re_solver="auto"``: both bucket solvers
    run once per bucket SHAPE on the actual first-pass inputs (warm start,
    offsets-plus-scores, per-entity L2, normalization space), and each
    one's mean iteration count over the bucket's lanes is recorded
    (normal_equations.AutoSolverDecision). The first bucket of each shape
    goes through ``solve_buckets``, the pass's own bucket loop, on a scratch
    copy of the table, with variances off; the outputs are discarded and
    the pass re-runs under the chosen plan. An L1 configuration returns an
    empty record (every shape keeps the configured optimizer). One host
    read for the whole probe."""
    task = TaskType(task)
    decision = AutoSolverDecision()
    if configuration.l1_weight:
        return decision
    E = dataset.n_entities
    if dtype is None:
        dtype = dataset.sample_vals.dtype
    if initial_model is None:
        coeffs = torch.zeros((E, dataset.max_k), dtype=dtype, device=dataset.proj_indices.device)
    else:
        coeffs = initial_model.aligned_to(dataset).coeffs.to(
            device=dataset.proj_indices.device, dtype=dtype
        )
    rows = getattr(dataset, "coeffs_rows", None)
    if rows is not None:
        # mesh placement: padded lanes scatter into the junk row E
        coeffs = torch.cat([coeffs, coeffs.new_zeros((rows - coeffs.shape[0], coeffs.shape[1]))])
    l2_rows = build_l2_rows(dataset, configuration.l2_weight, per_entity_reg_weights, dtype, E)
    norm_tables = precompute_norm_tables(dataset, normalization, dtype)
    first = {}
    for i, bucket in enumerate(dataset.buckets):
        first.setdefault(bucket_shape(bucket), i)
    dev = dataset.proj_indices.device
    # a working set keeps the buckets on the host: the probe's go to the device
    buckets = [
        dataclasses.replace(dataset.buckets[i], **{
            f: getattr(dataset.buckets[i], f).to(dev)
            for f in ("entity_rows", "X", "labels", "weights", "sample_ids")
        })
        for i in first.values()
    ]
    tables = [norm_tables[i] for i in first.values()]
    solvers = ("lbfgs", "direct")
    parts = []
    for name in solvers:
        solve = re_bucket_solver(task, configuration.optimizer_config, False,
                                 VarianceComputationType.NONE, name)
        reasons, iters = solve_buckets(solve, buckets, coeffs.clone(), None, offsets_plus_scores,
                                       l2_rows, 0.0, tables)
        parts += [*reasons, *iters]
    real = [b.entity_rows < E for b in buckets]  # mesh padding lanes stay out of the stats
    host = iter(t.numpy() for t in to_host(*parts, *real))
    measured = {}
    for name in solvers:
        reasons_h = [next(host) for _ in buckets]
        iters_h = [next(host) for _ in buckets]
        measured[name] = (reasons_h, iters_h)
    masks = [next(host) for _ in buckets]
    for name, (reasons_h, iters_h) in measured.items():
        measured[name] = [(float(it[m].mean()) if m.any() else 0.0,
                           bool(np.isin(r[m], _AUTO_CLEAN_REASONS).all()))
                          for r, it, m in zip(reasons_h, iters_h, masks)]
    for j, (S, K) in enumerate(first):
        if not masks[j].any():
            continue  # a bucket of padding lanes alone measures nothing, as in JAX
        decision.record(S, K, lbfgs_iters=measured["lbfgs"][j][0],
                        direct_iters=measured["direct"][j][0],
                        direct_clean=measured["direct"][j][1])
    return decision


def train_random_effect(
    dataset: RandomEffectDataset,
    task: TaskType,
    configuration: GLMOptimizationConfiguration,
    offsets_plus_scores: Tensor,
    *,
    initial_model: Optional[RandomEffectModel] = None,
    normalization=None,
    variance_computation: VarianceComputationType = VarianceComputationType.NONE,
    dtype=None,
    per_entity_reg_weights=None,
    re_solver="lbfgs",
) -> tuple[RandomEffectModel, RandomEffectTracker]:
    """Fit one GLM per entity over all buckets, one batched solve per bucket.

    ``offsets_plus_scores`` is the [N] tensor of base offsets plus the other
    coordinates' scores (the reference's addScoresToOffsets join becomes a
    gather through each bucket's sample ids). ``per_entity_reg_weights``
    ({entity_id: l2} or an [E] array) overrides the configuration's L2
    weight per entity. ``re_solver`` is "lbfgs", "direct", "auto" or a
    per-bucket tuple of "lbfgs"/"direct" (the measured "auto" plan). The
    tracker's stats are read to the host once, after every bucket has been
    solved.
    """
    task = TaskType(task)
    check_trainable(task, configuration)
    variance_computation = VarianceComputationType(variance_computation)
    E, K_all = dataset.n_entities, dataset.max_k
    if dtype is None:
        dtype = dataset.sample_vals.dtype
    dev = dataset.proj_indices.device
    if initial_model is None:
        coeffs = torch.zeros((E, K_all), dtype=dtype, device=dev)
    else:
        coeffs = initial_model.aligned_to(dataset).coeffs.to(dtype=dtype).clone()
    variances = (
        torch.zeros((E, K_all), dtype=dtype, device=dev)
        if variance_computation != VarianceComputationType.NONE
        else None
    )
    l2_rows = build_l2_rows(dataset, configuration.l2_weight, per_entity_reg_weights, dtype, E)
    solves = bucket_solves(task, configuration.optimizer_config, bool(configuration.l1_weight),
                           variance_computation, re_solver, len(dataset.buckets))
    if dataset.graphs is None:
        dataset.graphs = BucketGraphs()
    reasons, iters = solve_buckets(solves, dataset.buckets, coeffs, variances,
                                   offsets_plus_scores, l2_rows,
                                   configuration.l1_weight or 0.0,
                                   precompute_norm_tables(dataset, normalization, dtype),
                                   None, None, dataset.graphs)
    tracker = RandomEffectTracker.from_parts(reasons, iters)
    model = RandomEffectModel(
        re_type=dataset.re_type,
        feature_shard_id=dataset.feature_shard_id,
        task=task,
        entity_ids=dataset.entity_ids,
        coeffs=coeffs,
        proj_indices=dataset.proj_indices,
        variances=variances,
        projector=dataset.projector,
    )
    return model, tracker


# The continuous-training delta pass (continuous/): re-solve ONLY the
# entities of an active set, warm-started from the previous generation's
# table. Active lanes are gathered out of each bucket into a pow2-padded
# sub-bucket on the table's device, solved by the same batched bucket solve
# as the full path, and scattered back into a copy of the table; rows of
# inactive entities keep the previous generation's bits.


@dataclasses.dataclass
class ActiveSetStats:
    """What one delta update solved."""

    n_entities: int  # dataset entities (the denominator)
    n_active: int  # entities selected for re-solve
    n_solved_lanes: int  # batched lanes dispatched (pow2 padding included)
    buckets_touched: int
    buckets_total: int

    @property
    def active_fraction(self) -> float:
        return self.n_active / self.n_entities if self.n_entities else 0.0


def _gather_rows(table: Tensor, idx: np.ndarray, device) -> Tensor:
    """``table[idx]`` on ``device``: a table on another device (the working
    set's host tier) is gathered where it lives and only the slice moves."""
    index = torch.as_tensor(idx, dtype=torch.long, device=table.device)
    return table.index_select(0, index).to(device)


def train_random_effect_delta(
    dataset: RandomEffectDataset,
    task: TaskType,
    configuration: GLMOptimizationConfiguration,
    offsets_plus_scores: Tensor,
    prev_model: RandomEffectModel,
    active_mask: np.ndarray,
    *,
    normalization=None,
    variance_computation: VarianceComputationType = VarianceComputationType.NONE,
    dtype=None,
    per_entity_reg_weights=None,
    min_entities_pad: int = 8,
    re_solver="lbfgs",
) -> tuple[RandomEffectModel, RandomEffectTracker, ActiveSetStats]:
    """Active-set counterpart of :func:`train_random_effect`.

    ``active_mask`` is a host bool array over the dataset's entity rows;
    only masked entities are re-solved (over their FULL accumulated data),
    everything else keeps the previous generation's coefficients bit for
    bit. ``prev_model`` must cover the dataset's entities (build the dataset
    with ``entity_order`` so that growth appends at the tail).

    A partly active bucket is gathered into a sub-bucket of the next power
    of two of lanes (at least ``min_entities_pad``, at most the bucket's),
    the padding lanes duplicating the first active lane; a fully active
    bucket solves as it is. The solved blocks of every bucket are padded to
    the table's width and written with one row scatter into a copy of the
    table, padding lanes left out. A table that lives on another device
    than the data (the working set's host tier) is gathered and written
    where it lives, and only the solved blocks move, in one read. The
    tracker's per-lane stats are read in one transfer.

    On a mesh-placed dataset (parallel/placement.py) each rank re-solves the
    active entities it owns, from its own bucket blocks, with no
    collective. Every rank pads its sub-bucket of a bucket to the lane
    count of the busiest rank (known to all from ``block_rows``), so all
    ranks solve one shape and the lanes solved in all add up to a multiple
    of the rank count (``n_solved_lanes``, counted over every rank); a rank
    with no active entity there solves padding lanes only. The returned
    table holds this rank's solved rows and the warm table elsewhere: the
    coordinate's exchange (``RandomEffectCoordinate.update_model_active``)
    makes it whole on every rank. The tracker counts this rank's real
    lanes.
    """
    task = TaskType(task)
    check_trainable(task, configuration)
    variance_computation = VarianceComputationType(variance_computation)
    variance_on = variance_computation != VarianceComputationType.NONE
    E, K_all = dataset.n_entities, dataset.max_k
    if dtype is None:
        dtype = dataset.sample_vals.dtype
    dev = dataset.proj_indices.device
    active_mask = np.asarray(active_mask, dtype=bool)
    if active_mask.shape != (E,):
        raise ValueError(f"active_mask shape {active_mask.shape} != ({E},) entities")

    aligned = prev_model.aligned_to(dataset)
    coeffs_global = aligned.coeffs.to(dtype)
    if variance_on and aligned.variances is None and not active_mask.all():
        # only active entities receive solved variances; everything else
        # would export variance exactly 0.0, which reads as infinite
        # confidence
        raise ValueError(
            "variance computation is enabled but the warm-start model "
            "carries no variances: inactive entities would keep variance "
            "0.0 in the exported model. Run one variance-bearing full pass "
            "first (or disable variance computation for delta passes)."
        )
    variances_global = None
    if variance_on:
        variances_global = (
            torch.zeros((E, K_all), dtype=dtype, device=coeffs_global.device)
            if aligned.variances is None
            else aligned.variances.to(dtype)
        )

    l2_rows = build_l2_rows(dataset, configuration.l2_weight, per_entity_reg_weights, dtype, E)
    l1 = configuration.l1_weight or 0.0
    plan = bucket_solver_plan(re_solver, len(dataset.buckets))
    norm_on = normalization is not None and not normalization.is_identity

    reasons_parts, iters_parts, real_counts = [], [], []
    row_parts, coef_updates, var_updates = [], [], []
    n_lanes = buckets_touched = 0
    mesh = getattr(dataset, "mesh", None)
    blocks = None if mesh is None else dataset.block_rows

    def active_lanes(rows):
        return (rows < E) & active_mask[np.minimum(rows, E - 1)]

    # the buckets' entity rows pick the lanes on the host: one read for all
    rows_by_bucket = [t.numpy() for t in to_host(*[b.entity_rows for b in dataset.buckets])]
    for b_i, (bucket, solver, rows_host) in enumerate(zip(dataset.buckets, plan, rows_by_bucket)):
        sel = np.flatnonzero(active_lanes(rows_host))
        Eb = bucket.X.shape[0]
        # the lane count to pad to: this bucket's active lanes, or on a mesh
        # those of the rank with the most
        most = (len(sel) if blocks is None
                else max(int(np.count_nonzero(active_lanes(r))) for r in blocks[b_i]))
        if most == 0:
            continue
        buckets_touched += 1
        solve = re_bucket_solver(task, configuration.optimizer_config, bool(l1),
                                 variance_computation, solver)
        K = bucket.X.shape[2]
        if len(sel) == Eb:
            # every lane active: the bucket's own tensors are the inputs
            idx = np.arange(Eb)
            X_b, y_b, w_b, sid_b = bucket.X, bucket.labels, bucket.weights, bucket.sample_ids
            X_b, y_b, w_b, sid_b = (t.to(dev) for t in (X_b, y_b, w_b, sid_b))
        else:
            pad_to = min(_next_pow2(most, min_entities_pad), Eb)
            idx = np.concatenate([sel, np.full(pad_to - len(sel), sel[0] if len(sel) else 0)])
            X_b, y_b, w_b, sid_b = (
                _gather_rows(t, idx, dev)
                for t in (bucket.X, bucket.labels, bucket.weights, bucket.sample_ids)
            )
        # a mesh block's padding lanes carry the junk row E: their solves
        # read row E - 1 and are never written back
        rows_b = np.minimum(rows_host[idx], E - 1)
        n_lanes += len(idx)
        rows_dev = torch.as_tensor(rows_b, dtype=torch.long, device=dev)
        tbl = None
        if norm_on:
            tbl = gather_norm_vectors(normalization, dataset.proj_indices[rows_dev, :K], dtype)
        off_b = offsets_plus_scores[torch.clamp_min(sid_b, 0).long()]
        off_b = torch.where(sid_b >= 0, off_b, 0.0).to(dtype)
        init_b = _gather_rows(coeffs_global, rows_b, dev)[:, :K]
        if tbl is not None:
            init_b = to_transformed_rows(init_b, *tbl)
        coefs_b, reasons_b, iters_b, var_b = solve(
            X_b, y_b, w_b, off_b, init_b,
            l2_rows[torch.clamp_max(rows_dev, l2_rows.shape[0] - 1)], l1,
        )
        if tbl is not None:
            coefs_b = to_original_rows(coefs_b, *tbl)
            if variances_global is not None and tbl[0] is not None:
                var_b = var_b * tbl[0] ** 2
        row_parts.append(rows_b[: len(sel)])
        coef_updates.append(coefs_b[: len(sel)])
        if variances_global is not None:
            var_updates.append(var_b[: len(sel)])
        reasons_parts.append(reasons_b)
        iters_parts.append(iters_b)
        real_counts.append(len(sel))

    if coef_updates:
        # ONE row scatter per pass into a copy of the table: each bucket's
        # [L, K] block padded to K_all (an active entity's columns beyond its
        # bucket width are zero in the warm table, the invariant the full
        # path's [:K] scatter relies on too); the padding lanes were left out
        rows_np = np.concatenate(row_parts).astype(np.int64)

        def pad_blocks(blocks):
            return torch.cat([
                b if b.shape[1] == K_all
                else torch.nn.functional.pad(b, (0, K_all - b.shape[1]))
                for b in blocks
            ])

        blocks = [pad_blocks(coef_updates)]
        if variances_global is not None:
            blocks.append(pad_blocks(var_updates))
        if coeffs_global.device != dev:
            # the working set's host tier: the solved blocks come down in
            # one read and are written there
            blocks = to_host(*blocks)
        rows_t = torch.as_tensor(rows_np, device=coeffs_global.device)
        coeffs_global = coeffs_global.clone()
        coeffs_global[rows_t] = blocks[0].to(coeffs_global.dtype)
        if variances_global is not None:
            variances_global = variances_global.clone()
            variances_global[rows_t] = blocks[1].to(variances_global.dtype)

    if reasons_parts:
        host = [t.numpy() for t in to_host(*reasons_parts, *iters_parts)]
        n = len(reasons_parts)
        reasons_all = np.concatenate([a[:k] for a, k in zip(host[:n], real_counts)])
        iters_all = np.concatenate([a[:k] for a, k in zip(host[n:], real_counts)])
    else:
        reasons_all = iters_all = np.zeros(0, np.int32)
    tracker = RandomEffectTracker.from_arrays(reasons_all, iters_all)
    if variance_on and aligned.variances is None and not reasons_parts:
        variances_global = None  # nothing solved: no zero table invented
    model = RandomEffectModel(
        re_type=dataset.re_type,
        feature_shard_id=dataset.feature_shard_id,
        task=task,
        entity_ids=dataset.entity_ids,
        coeffs=coeffs_global,
        proj_indices=dataset.proj_indices,
        variances=variances_global,
        projector=dataset.projector,
    )
    stats = ActiveSetStats(
        n_entities=E,
        n_active=int(active_mask.sum()),
        n_solved_lanes=n_lanes * (1 if mesh is None else mesh.size),
        buckets_touched=buckets_touched,
        buckets_total=len(dataset.buckets),
    )
    return model, tracker, stats


def bucket_gradient_norms(loss, X: Tensor, y: Tensor, w: Tensor, off: Tensor, coefs: Tensor,
                          l2: Tensor) -> Tensor:
    """Per-entity L2 norm of the regularized subproblem gradient at
    ``coefs``: g_e = X_e^T (w * dl/dz) + l2_e * coefs_e over one [E, S, K]
    bucket."""
    z = torch.einsum("esk,ek->es", X, coefs) + off
    _, dz = loss.loss_and_dz(z, y)
    g = torch.einsum("es,esk->ek", w * dz, X) + l2[:, None] * coefs
    return torch.sqrt(torch.sum(g * g, dim=-1))


def random_effect_gradient_norms(
    dataset: RandomEffectDataset,
    model: RandomEffectModel,
    offsets_plus_scores: Tensor,
    task: TaskType,
    *,
    l2: float = 0.0,
    per_entity_reg_weights=None,
    normalization=None,
    dtype=None,
) -> Tensor:
    """[E] per-entity gradient norms of the random-effect subproblem at the
    model's current coefficients, on the dataset's device: the active-set
    screen's signal (continuous/active_set.py). An entity whose norm exceeds
    the caller's threshold has drifted from its optimum (its residual moved
    because OTHER coordinates updated) and earns a re-solve without new
    rows. One forward and backward product per bucket, no solver iteration
    and no host read; the caller reads the vector once."""
    task = TaskType(task)
    loss = loss_for_task(task)
    E = dataset.n_entities
    if dtype is None:
        dtype = dataset.sample_vals.dtype
    dev = dataset.proj_indices.device
    coeffs = model.aligned_to(dataset).coeffs.to(device=dev, dtype=dtype)
    l2_rows = build_l2_rows(dataset, l2, per_entity_reg_weights, dtype, E)
    norms = torch.zeros(E + 1, dtype=dtype, device=dev)
    for bucket in dataset.buckets:
        K = bucket.X.shape[2]
        rows = bucket.entity_rows.to(dev).long()
        sid = bucket.sample_ids.to(dev)
        factors, shifts, icpt_mask = gather_norm_vectors(
            normalization, dataset.proj_indices[rows, :K], dtype
        )
        off_b = offsets_plus_scores[torch.clamp_min(sid, 0).long()]
        off_b = torch.where(sid >= 0, off_b, 0.0).to(dtype)
        w_init = coeffs[rows, :K]
        if normalization is not None and not normalization.is_identity:
            w_init = to_transformed_rows(w_init, factors, shifts, icpt_mask)
        g = bucket_gradient_norms(
            loss, bucket.X.to(dev), bucket.labels.to(dev), bucket.weights.to(dev), off_b,
            w_init, l2_rows[torch.clamp_max(rows, l2_rows.shape[0] - 1)],
        )
        # padding rows (row E) land in the extra slot, dropped below
        norms[torch.clamp_max(rows, E)] = g.to(dtype)
    return norms[:E]
