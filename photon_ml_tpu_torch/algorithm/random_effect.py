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

Not ported yet, each raising with its ROADMAP item: the active-set delta
update (A13, continuous training) and the per-entity gradient norms of the
active-set screen (A13).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.data.random_effect import RandomEffectDataset
from photon_ml_tpu_torch.device import to_host
from photon_ml_tpu_torch.function.losses import loss_for_task
from photon_ml_tpu_torch.models.game import RandomEffectModel
from photon_ml_tpu_torch.optimization.config import GLMOptimizationConfiguration
from photon_ml_tpu_torch.optimization.normal_equations import AutoSolverDecision
from photon_ml_tpu_torch.optimization.solver_cache import (
    bucket_solves,
    re_bucket_solver,
    solve_buckets,
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
    def from_parts(reasons_parts, iters_parts) -> "RandomEffectTracker":
        """The tracker of per-bucket device tensors, read in one transfer."""
        host = to_host(*reasons_parts, *iters_parts)
        n = len(reasons_parts)
        if not n:
            return RandomEffectTracker.from_arrays(np.zeros(0, np.int32), np.zeros(0, np.int32))
        return RandomEffectTracker.from_arrays(
            np.concatenate([t.numpy() for t in host[:n]]),
            np.concatenate([t.numpy() for t in host[n:]]),
        )

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
    coefficients finite, computed before the update's reject select)."""

    def __init__(self, reasons_parts, iters_parts, guard_ok=None):
        self.guard_ok = guard_ok
        self._pending = (tuple(reasons_parts), tuple(iters_parts))
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
    return tuple(
        gather_norm_vectors(normalization,
                            dataset.proj_indices[b.entity_rows.long(), : b.X.shape[2]], dtype)
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
        coeffs = initial_model.aligned_to(dataset).coeffs.to(dtype)
    l2_rows = build_l2_rows(dataset, configuration.l2_weight, per_entity_reg_weights, dtype, E)
    norm_tables = precompute_norm_tables(dataset, normalization, dtype)
    first = {}
    for i, bucket in enumerate(dataset.buckets):
        first.setdefault(bucket_shape(bucket), i)
    buckets = [dataset.buckets[i] for i in first.values()]
    tables = [norm_tables[i] for i in first.values()]
    solvers = ("lbfgs", "direct")
    parts = []
    for name in solvers:
        solve = re_bucket_solver(task, configuration.optimizer_config, False,
                                 VarianceComputationType.NONE, name)
        reasons, iters = solve_buckets(solve, buckets, coeffs.clone(), None, offsets_plus_scores,
                                       l2_rows, 0.0, tables)
        parts += [*reasons, *iters]
    host = iter(t.numpy() for t in to_host(*parts))
    measured = {}
    for name in solvers:
        reasons_h = [next(host) for _ in buckets]
        iters_h = [next(host) for _ in buckets]
        measured[name] = [(float(it.mean()), bool(np.isin(r, _AUTO_CLEAN_REASONS).all()))
                          for r, it in zip(reasons_h, iters_h)]
    for j, (S, K) in enumerate(first):
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
    reasons, iters = solve_buckets(solves, dataset.buckets, coeffs, variances,
                                   offsets_plus_scores, l2_rows,
                                   configuration.l1_weight or 0.0,
                                   precompute_norm_tables(dataset, normalization, dtype))
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


def train_random_effect_delta(*args, **kwargs):
    """The active-set delta update of continuous training."""
    raise NotImplementedError(
        "active-set random-effect updates are not ported yet: ROADMAP A13 (continuous/)"
    )


def random_effect_gradient_norms(*args, **kwargs):
    """Per-entity gradient norms, the active-set screening signal."""
    raise NotImplementedError(
        "random-effect gradient norms are not ported yet: ROADMAP A13 (continuous/)"
    )
