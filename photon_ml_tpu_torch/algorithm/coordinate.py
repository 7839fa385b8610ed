"""GAME coordinates: one optimization sub-problem per (effect, feature shard).

Port of photon_ml_tpu/algorithm/coordinate.py (photon-lib
algorithm/Coordinate.scala:28-81, photon-api FixedEffectCoordinate.scala:35-166,
RandomEffectCoordinate.scala:39-232 and the model coordinates of partial
retraining). Every coordinate's score is a dense [N] tensor over the global
sample axis, so "adding scores to offsets" is an elementwise add.

- ``FixedEffectCoordinate`` solves its GLM through
  ``GLMOptimizationProblem.run`` (kernels B1, B2 and B3 when the fused switch
  is on) and takes the descent loop's generic path: ``update_model`` then
  ``score``.
- ``RandomEffectCoordinate`` runs each update through
  ``solver_cache.re_coordinate_update_program`` (every bucket solve, the
  table scatter, the [N] score and the divergence select in one call), or
  bucket by bucket with ``use_update_program=False``. It stores its tables
  at a reduced ``precision`` (bf16 or f16, solves and scores at f32) when
  asked; with ``working_set_rows`` it keeps the tables on the host and
  streams chunks of entities through a bounded device working set
  (data/working_set.py); ``update_model_active`` re-solves an active set of
  entities only (continuous training).
- ``ModelCoordinate`` is a locked, score-only coordinate.

A fixed effect takes per-feature box bounds (``box_constraints``, refused
together with normalization as in the reference) and a ``down_sampler``
(sampling/), which re-weights the offset-shifted data of every update with
a fresh draw; a random effect takes
per-entity normalization and ``re_solver`` "lbfgs", "direct" or "auto",
the last measured once per coordinate and carried across a resume through
``re_solver_stats`` / ``seed_solver_decision``.

``RandomEffectCoordinate.compiled_update_hlo`` and
``FixedEffectCoordinate.compiled_update_hlo`` return the audit records of
their update programs (analysis/program_audit.py). The fixed-effect update
program (``solver_cache.fe_coordinate_update_program``) serves
feature-sharded datasets by default, as in the JAX package; it cannot
express a down-sampler, box bounds or variances, which take the generic
``update_model`` then ``score`` path.

On a mesh (datasets placed by parallel/placement.py) every rank runs the
same coordinates over its blocks: the fixed effect's solve sums its data
terms over the ranks and its [N] score is the ranks' blocks gathered; the
random effect solves its entity blocks and one all_reduce per update
returns the whole [N] score, the whole table and the divergence verdict.
Scores and models are the same on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.algorithm.random_effect import (
    LazyRandomEffectTracker,
    RandomEffectTracker,
    bucket_shape,
    build_l2_rows,
    check_trainable,
    measure_auto_solvers,
    precompute_norm_tables,
    train_random_effect,
    train_random_effect_delta,
)
from photon_ml_tpu_torch.analysis.fallbacks import log_fallback_once
from photon_ml_tpu_torch.data.dataset import FixedEffectDataset
from photon_ml_tpu_torch.data.matrix import SparseDesignMatrix
from photon_ml_tpu_torch.data.random_effect import RandomEffectDataset
from photon_ml_tpu_torch.device import to_host
from photon_ml_tpu_torch.models.game import (
    FixedEffectModel,
    RandomEffectModel,
    fixed_effect_view_score,
)
from photon_ml_tpu_torch.models.glm import model_class_for_task
from photon_ml_tpu_torch.normalization import NO_NORMALIZATION, NormalizationContext
from photon_ml_tpu_torch.optimization.bucket_graphs import BucketGraphs
from photon_ml_tpu_torch.optimization.config import GLMOptimizationConfiguration
from photon_ml_tpu_torch.optimization.normal_equations import (
    AutoSolverDecision,
    validate_re_solver,
)
from photon_ml_tpu_torch.optimization.problem import GLMOptimizationProblem
from photon_ml_tpu_torch.optimization.precision import resolve_precision
from photon_ml_tpu_torch.optimization.solver_cache import (
    bucket_solver_plan,
    re_chunk_score_program,
    re_chunk_update_program,
    re_coordinate_update_program,
)
from photon_ml_tpu_torch.types import ConvergenceReason, TaskType, VarianceComputationType

Tensor = torch.Tensor


@dataclasses.dataclass
class FixedEffectOptimizationTracker:
    """The single OptResult of a fixed-effect solve
    (FixedEffectOptimizationTracker.scala:31).

    Fields hold DEVICE scalars until ``materialize()`` (called by
    ``summary()``, and by run_coordinate_descent on every tracker before its
    result is returned) reads them in one transfer and turns them into a
    reason name, an int and a float."""

    convergence_reason: object  # str once materialized; device code before
    iterations: object
    final_value: object
    # the update program's device flag (update_and_score): the divergence
    # guard already applied on the device
    guard_ok: object = None

    def materialize(self) -> "FixedEffectOptimizationTracker":
        if not isinstance(self.convergence_reason, str):
            reason, iters, value = to_host(
                self.convergence_reason, self.iterations, self.final_value
            )
            self.convergence_reason = ConvergenceReason(int(reason)).name
            self.iterations = int(iters)
            self.final_value = float(value)
        return self

    def summary(self) -> str:
        self.materialize()
        return (
            f"reason={self.convergence_reason} iters={self.iterations} "
            f"value={self.final_value:.6g}"
        )


class Coordinate:
    """Abstract GAME coordinate (Coordinate.scala:28-81).

    ``update_model(initial, partial_scores)`` trains against offsets + the other
    coordinates' scores; ``score(model)`` returns this coordinate's [N] score
    (margins WITHOUT base offsets, so scores sum across coordinates).
    """

    coordinate_id: str

    @property
    def is_locked(self) -> bool:
        return False

    def update_model(self, initial_model, partial_scores: Tensor):
        raise NotImplementedError

    def update_and_score(self, initial_model, partial_scores: Tensor, prev_score: Tensor):
        """Train AND produce this coordinate's new [N] score in one call, with
        the divergence guard applied on the device (the returned model and
        score already hold the previous values when the update diverged; the
        tracker's ``guard_ok`` device flag says which).

        Returns ``(model, score, tracker)``, or None when this coordinate has
        no such path: the descent loop then calls ``update_model`` and
        ``score``."""
        return None

    def score(self, model) -> Tensor:
        raise NotImplementedError

    def initialize_model(self):
        raise NotImplementedError

    def prepare_initial_model(self, model):
        """Adapt an externally supplied warm-start model to this coordinate's
        dataset. Default: unchanged."""
        return model


def pad_fixed_effect_model(model: FixedEffectModel, dataset: FixedEffectDataset):
    """The fixed-effect model with its means on the dataset's device and
    dtype (a warm start built on the host, or read from the JAX package,
    meets data on the card), zero-padded to a feature-padded dataset's dim
    (the 2-D mesh, parallel/feature_sharded.py)."""
    labels = dataset.data.labels
    means = model.model.coefficients.means
    short = means.shape[0] < dataset.dim
    if means.device == labels.device and means.dtype == labels.dtype and not short:
        return model
    means = means.to(device=labels.device, dtype=labels.dtype)
    if short:
        means = torch.cat([means, means.new_zeros(dataset.dim - means.shape[0])])
    coef = dataclasses.replace(model.model.coefficients, means=means)
    if short and coef.variances is not None:
        var = coef.variances.to(device=labels.device, dtype=labels.dtype)
        coef = dataclasses.replace(
            coef, variances=torch.cat([var, var.new_zeros(dataset.dim - var.shape[0])]))
    glm = model_class_for_task(model.model.task)(coef)
    return dataclasses.replace(model, model=glm)


@dataclasses.dataclass
class FixedEffectCoordinate(Coordinate):
    """Global GLM over one feature shard (FixedEffectCoordinate.scala:35-166):
    one optimizer run through ``GLMOptimizationProblem.run``; on a mesh over
    this rank's block, its data sums added across the ranks."""

    coordinate_id: str
    dataset: FixedEffectDataset
    task: TaskType
    configuration: GLMOptimizationConfiguration
    normalization: NormalizationContext = NO_NORMALIZATION
    variance_computation: VarianceComputationType = VarianceComputationType.NONE
    # sampling.DownSampler: each update trains on a fresh weight mask
    down_sampler: Optional[object] = None
    # (lower[D], upper[D]) per-feature box bounds (constraint maps), enforced
    # by the optimizers (LBFGS projection, LBFGSB, TRON, NEWTON)
    box_constraints: Optional[tuple] = None
    # the single-call update (solver_cache.fe_coordinate_update_program):
    # None = auto, on for feature-sharded (2-D mesh) datasets and off
    # otherwise, as in the JAX package; True is refused with a knob the
    # program cannot express (down-sampling, box bounds, variances)
    use_update_program: object = None

    def __post_init__(self):
        self.task = TaskType(self.task)
        if self.box_constraints is not None and not self.normalization.is_identity:
            # the reference rejects this combination outright (Params.scala:211-214):
            # bounds are specified in original feature space, solves run in
            # normalized space, and the clamp cannot be guaranteed in both
            raise ValueError("Box constraints and normalization cannot be combined")
        if self.use_update_program:
            blockers = [name for name, bad in (
                ("down_sampler", self.down_sampler is not None),
                ("box_constraints", self.box_constraints is not None),
                ("variance_computation", VarianceComputationType(self.variance_computation)
                 != VarianceComputationType.NONE),
            ) if bad]
            if blockers:
                raise ValueError(
                    "use_update_program=True: the fused fixed-effect update "
                    "program cannot express " + ", ".join(blockers)
                    + "; leave use_update_program unset (auto) or False"
                )
        self._mesh = getattr(self.dataset, "mesh", None)
        norm = self.normalization
        if self._mesh is not None and not norm.is_identity:
            norm = norm.padded_to(self.dataset.dim)
        self._norm = norm
        self._problem = GLMOptimizationProblem(
            task=self.task,
            configuration=self.configuration,
            normalization=norm,
            variance_computation=VarianceComputationType(self.variance_computation),
            psum_axis=None if self._mesh is None else self._mesh.sample_axis(),
        )

    def initialize_model(self) -> FixedEffectModel:
        labels = self.dataset.data.labels
        model = self._problem.initialize_zero_model(
            self.dataset.dim, dtype=labels.dtype, device=labels.device
        )
        return FixedEffectModel(model=model, feature_shard_id=self.dataset.feature_shard_id)

    def prepare_initial_model(self, model: FixedEffectModel) -> FixedEffectModel:
        return pad_fixed_effect_model(model, self.dataset)

    def _local(self, scores: Tensor) -> Tensor:
        """This rank's block of a whole [N] vector (the vector itself on one
        device)."""
        if self._mesh is None:
            return scores
        from photon_ml_tpu_torch.parallel.mesh import local_rows

        return local_rows(scores, self._mesh, self.dataset.data.n * self._mesh.data_axis.size)

    def _whole(self, block: Tensor) -> Tensor:
        return whole_score(self.dataset, block)

    def _bounds(self):
        lower, upper = self.box_constraints or (None, None)
        dim = self.dataset.dim
        if lower is not None and len(lower) < dim:
            # padded feature columns are unconstrained
            lower = np.concatenate([np.asarray(lower, dtype=np.float64),
                                    np.full(dim - len(lower), -np.inf)])
        if upper is not None and len(upper) < dim:
            upper = np.concatenate([np.asarray(upper, dtype=np.float64),
                                    np.full(dim - len(upper), np.inf)])
        return lower, upper

    def update_model(
        self, initial_model: Optional[FixedEffectModel], partial_scores: Tensor
    ) -> tuple[FixedEffectModel, FixedEffectOptimizationTracker]:
        """Train with offsets := base offsets + other coordinates' scores
        (Coordinate.scala:60-63 / FixedEffectCoordinate.updateModel:91-147),
        on the down-sampled weights when there is a down-sampler (drawn by
        each row's global position). The tracker's scalars stay on the
        device."""
        data = self.dataset.data.add_scores_to_offsets(self._local(partial_scores))
        if self.down_sampler is not None:
            ids = None
            if self._mesh is not None:
                from photon_ml_tpu_torch.parallel.mesh import block_slice

                rows = block_slice(self._mesh, data.n * self._mesh.data_axis.size)
                ids = torch.arange(rows.start, rows.stop, device=data.weights.device)
            data = self.down_sampler.down_sample(data, ids)
        lower, upper = self._bounds()
        glm, result = self._problem.run(
            data,
            self.prepare_initial_model(initial_model).model
            if initial_model is not None
            else None,
            lower_bounds=lower,
            upper_bounds=upper,
        )
        tracker = FixedEffectOptimizationTracker(
            convergence_reason=result.convergence_reason,
            iterations=result.iterations,
            final_value=result.value,
        )
        return (
            FixedEffectModel(model=glm, feature_shard_id=self.dataset.feature_shard_id),
            tracker,
        )

    def _update_program_enabled(self) -> bool:
        if self.use_update_program is not None:
            return bool(self.use_update_program)
        # auto: feature-sharded datasets take the program, as in the JAX
        # package; knobs it cannot express keep the generic path
        if self._mesh is None or self._mesh.ndim != 2:
            return False
        return (
            self.down_sampler is None
            and self.box_constraints is None
            and VarianceComputationType(self.variance_computation)
            == VarianceComputationType.NONE
        )

    def _resolve_update_program(self):
        """The update program at this coordinate's configuration and
        placement: the one owner of its resolution, shared by
        ``update_and_score`` and ``compiled_update_hlo``."""
        from photon_ml_tpu_torch.optimization.solver_cache import fe_coordinate_update_program

        return fe_coordinate_update_program(
            self.task,
            self.configuration.optimizer_config,
            bool(self.configuration.l1_weight),
            self._mesh,
            # the JAX package keeps the kernels off under a mesh (GSPMD
            # cannot partition a pallas_call); the port follows its routes
            self._mesh is None,
        )

    def _program_args(self, means: Tensor, score_block: Tensor, partial_block: Tensor):
        data = self.dataset.data
        dtype, dev = data.labels.dtype, data.labels.device
        cfg = self.configuration
        return (means, score_block, data.offsets + partial_block,
                torch.full((), cfg.l2_weight, dtype=dtype, device=dev),
                torch.full((), cfg.l1_weight or 0.0, dtype=dtype, device=dev),
                data, self._norm)

    def update_and_score(
        self,
        initial_model: Optional[FixedEffectModel],
        partial_scores: Tensor,
        prev_score: Tensor,
    ):
        """One call per update (solver_cache.fe_coordinate_update_program):
        the solve, the original-space conversion, this coordinate's [N]
        score and the divergence select, with no host read between them; on
        a mesh the score block is gathered after the select (the verdict is
        the same on every rank). Returns None (update_model + score) when
        the program path is off or the warm start carries variances the
        program does not thread."""
        if not self._update_program_enabled() or initial_model is None:
            return None
        if initial_model.model.coefficients.variances is not None:
            log_fallback_once(
                "fe_coordinate_update_program",
                f"coordinate {self.coordinate_id!r} ({self.dataset.feature_shard_id}, "
                f"{self.dataset.n} samples x {self.dataset.dim} features)",
                "warm-start model carries variances the fused program does "
                "not thread; using update_model + score",
            )
            return None
        from photon_ml_tpu_torch.models.glm import Coefficients

        dtype = self.dataset.data.labels.dtype
        means = self.prepare_initial_model(initial_model).model.coefficients.means.to(dtype)
        program = self._resolve_update_program()
        coeffs, score_block, ok, value, iters, reason = program(*self._program_args(
            means, self._local(prev_score), self._local(partial_scores)))
        model = FixedEffectModel(
            model=self._problem.create_model(Coefficients(means=coeffs)),
            feature_shard_id=self.dataset.feature_shard_id,
        )
        tracker = FixedEffectOptimizationTracker(
            convergence_reason=reason, iterations=iters, final_value=value, guard_ok=ok)
        return model, self._whole(score_block), tracker

    def compiled_update_hlo(self) -> str:
        """The audit record of this coordinate's update program (analysis/
        program_audit.py): one dispatch of exactly the program
        ``update_and_score`` dispatches, from zero coefficients, scores and
        offsets. On a mesh the record counts the collectives by kind; run
        it inside ``parallel.mesh.tracing`` for each one's axis and region
        (``parallel/hlo_guards.assert_feature_axis_profile`` reads a 2-D
        trace)."""
        from photon_ml_tpu_torch.analysis.program_audit import record_program

        data = self.dataset.data
        dtype, dev = data.labels.dtype, data.labels.device
        zeros = torch.zeros((data.n,), dtype=dtype, device=dev)
        means = torch.zeros((self.dataset.dim,), dtype=dtype, device=dev)
        args = self._program_args(means, zeros, zeros)
        _, text = record_program("FixedEffectCoordinate.update_and_score",
                                 self._resolve_update_program(), args)
        return text

    def score(self, model: FixedEffectModel) -> Tensor:
        return self._whole(model.score_dataset(self.dataset))


_DELTA_NEEDS_MODEL = ("active-set updates need the previous generation's model to "
                      "warm-start from (initial_model is None)")


@dataclasses.dataclass
class RandomEffectCoordinate(Coordinate):
    """Per-entity GLMs (RandomEffectCoordinate.scala:39-232) as batched
    bucket solves."""

    coordinate_id: str
    dataset: RandomEffectDataset
    task: TaskType
    configuration: GLMOptimizationConfiguration
    base_offsets: Tensor  # [N] global base offsets (gathered per bucket at solve time)
    normalization: Optional[NormalizationContext] = None
    variance_computation: VarianceComputationType = VarianceComputationType.NONE
    # {entity_id: l2} or [E] array: per-entity L2 overrides
    per_entity_reg_weights: Optional[object] = None
    # one update program per update (True) or the per-bucket loop (False)
    use_update_program: bool = True
    re_solver: str = "lbfgs"
    # storage precision of the update program's tables and feature blocks
    # (optimization/precision.py): None/"f32" is the reference; "bf16" and
    # "f16" store them reduced with f32 solves and scores (needs the update
    # program)
    precision: object = None
    # device-resident working set (data/working_set.py): None = all-resident;
    # an int bounds the device table ROWS (hot entities resident across
    # passes, cold chunks streamed host -> device -> host); "auto" = all-
    # resident whenever the tables fit the card. Demotions are logged.
    working_set_rows: object = None
    # optional [E] admission priorities (the continuous trainer's gradient
    # screen); None ranks entities by data mass
    working_set_priorities: Optional[object] = None
    # False stages each chunk right before its solve: the unoverlapped
    # denominator of the overlap measurement, bitwise-neutral
    working_set_overlap: bool = True

    def __post_init__(self):
        self.task = TaskType(self.task)
        check_trainable(self.task, self.configuration)
        self.re_solver = validate_re_solver(self.re_solver, bool(self.configuration.l1_weight))
        self.precision = resolve_precision(self.precision)
        if not self.precision.is_reference and not self.use_update_program:
            raise ValueError(
                "reduced-precision storage rides the single-program update "
                "path; set use_update_program=True (the per-bucket loop "
                "stays f32-only)"
            )
        if self.working_set_rows is not None:
            if isinstance(self.working_set_rows, str):
                if self.working_set_rows != "auto":
                    raise ValueError(
                        f"working_set_rows={self.working_set_rows!r}: expected "
                        'None, a positive row budget, or "auto"'
                    )
            elif int(self.working_set_rows) < 1:
                raise ValueError(
                    f"working_set_rows={self.working_set_rows!r} must be a "
                    "positive row budget"
                )
            if not self.use_update_program:
                raise ValueError(
                    "the working set streams chunks through the update-program "
                    "machinery; working_set_rows requires use_update_program="
                    "True (the per-bucket loop has no streamed form)"
                )
            if not self.precision.is_reference:
                raise ValueError(
                    "working_set_rows keeps the host-authoritative tables at "
                    "reference precision; reduced storage precision is not "
                    "supported on the streamed path"
                )
        # the update program's iteration-invariant inputs, built at first use
        self._static = None
        self._ws = None
        self._ws_resolved = False
        # re_solver="auto": the measured record, filled by the first update's
        # probe or seeded from a restored checkpoint, so that a resumed run
        # never re-measures against warm tables
        self._auto_decision: Optional[AutoSolverDecision] = None
        self.last_active_stats = None

    def initialize_model(self) -> RandomEffectModel:
        ds = self.dataset
        shape = (ds.n_entities, ds.max_k)
        dtype = ds.sample_vals.dtype
        if self._working_set() is not None:
            # a working-set coordinate never holds the [E, K] table on the
            # device: the initial zeros live on the host tier
            coeffs = torch.zeros(shape, dtype=dtype)
        else:
            coeffs = torch.zeros(shape, dtype=dtype, device=ds.proj_indices.device)
        return RandomEffectModel(
            re_type=ds.re_type,
            feature_shard_id=ds.feature_shard_id,
            task=self.task,
            entity_ids=ds.entity_ids,
            coeffs=coeffs,
            proj_indices=ds.proj_indices,
            projector=ds.projector,
        )

    def prepare_initial_model(self, model: RandomEffectModel) -> RandomEffectModel:
        # re-align entity rows to this dataset (warm start across rebuilt or
        # differently ordered datasets)
        return model.aligned_to(self.dataset)

    def _solver_plan(self, offsets_plus_scores: Tensor, initial_model):
        """``re_solver`` for this update: an explicit string passes through;
        "auto" becomes the per-bucket plan of the measured record, probed
        on this update's inputs the first time (measure_auto_solvers)."""
        if self.re_solver != "auto":
            return self.re_solver
        if self._auto_decision is None:
            self._auto_decision = measure_auto_solvers(
                self.dataset, self.task, self.configuration, offsets_plus_scores,
                initial_model=initial_model, normalization=self.normalization,
                per_entity_reg_weights=self.per_entity_reg_weights,
            )
            mesh = getattr(self.dataset, "mesh", None)
            if mesh is not None:
                # one measured plan for every rank: rank 0's
                self._auto_decision = AutoSolverDecision.from_dict(
                    mesh.broadcast_object(self._auto_decision.to_dict()))
        return tuple(self._auto_decision.choice_for(*bucket_shape(b)) for b in self.dataset.buckets)

    def re_solver_stats(self) -> Optional[dict]:
        """The measured "auto" record (dict form), None until the first
        update measured it or a restore seeded it. It rides the checkpoint
        manifest's ``extra``; the fingerprint pins only the string "auto"."""
        return None if self._auto_decision is None else self._auto_decision.to_dict()

    def seed_solver_decision(self, d: Optional[dict]) -> None:
        """Restore a measured "auto" record (``re_solver_stats`` form), so a
        resumed run replays the original choices instead of re-measuring."""
        if d is not None:
            self._auto_decision = AutoSolverDecision.from_dict(d)

    def update_model(
        self, initial_model: Optional[RandomEffectModel], partial_scores: Tensor
    ) -> tuple[RandomEffectModel, RandomEffectTracker]:
        offsets_plus_scores = self.base_offsets + partial_scores
        return train_random_effect(
            self.dataset,
            self.task,
            self.configuration,
            offsets_plus_scores,
            initial_model=initial_model,
            normalization=self.normalization,
            variance_computation=self.variance_computation,
            per_entity_reg_weights=self.per_entity_reg_weights,
            re_solver=self._solver_plan(offsets_plus_scores, initial_model),
        )

    def update_model_active(
        self,
        initial_model: RandomEffectModel,
        partial_scores: Tensor,
        active_mask,
    ) -> tuple[RandomEffectModel, RandomEffectTracker]:
        """Active-set delta update (continuous training): re-solve ONLY the
        entities in ``active_mask`` (host bool [E]) over their full
        accumulated data, warm-started from ``initial_model``; every inactive
        entity keeps its previous coefficients bit for bit
        (random_effect.train_random_effect_delta). The stats of the last
        delta update land on ``self.last_active_stats``.

        On a mesh-placed dataset each rank re-solves the active entities it
        owns, and ONE all_reduce (:meth:`_delta_on_mesh`) returns the whole
        table to every rank; the descent loop takes
        :meth:`update_and_score_active` there, which also returns the score
        from that exchange."""
        if getattr(self.dataset, "mesh", None) is not None:
            model, _score, tracker = self._delta_on_mesh(initial_model, partial_scores, None,
                                                         active_mask)
            return model, tracker
        if initial_model is None:
            raise ValueError(_DELTA_NEEDS_MODEL)
        offsets_plus_scores = self.base_offsets + partial_scores
        model, tracker, stats = train_random_effect_delta(
            self.dataset,
            self.task,
            self.configuration,
            offsets_plus_scores,
            initial_model,
            active_mask,
            normalization=self.normalization,
            variance_computation=self.variance_computation,
            per_entity_reg_weights=self.per_entity_reg_weights,
            re_solver=self._solver_plan(offsets_plus_scores, initial_model),
        )
        self.last_active_stats = stats
        return model, tracker

    def update_and_score_active(self, initial_model: RandomEffectModel, partial_scores: Tensor,
                                prev_score: Tensor, active_mask):
        """The active-set delta update with its [N] score and device-side
        reject in one call, on a mesh-placed dataset (:meth:`_delta_on_mesh`):
        (model, score, tracker with ``guard_ok``), as ``update_and_score``
        returns. None off a mesh, where the descent loop takes
        :meth:`update_model_active` and scores the model itself."""
        if getattr(self.dataset, "mesh", None) is None:
            return None
        return self._delta_on_mesh(initial_model, partial_scores, prev_score, active_mask)

    def _delta_on_mesh(self, initial_model, partial_scores: Tensor, prev_score, active_mask):
        """The delta over this rank's entity blocks: the rank re-solves the
        active entities it owns (no collective, region ``entity_solve``),
        scores its own samples with its table, and ONE all_reduce over the
        data axis sums the score blocks, the owned rows and the reject flags
        (:meth:`_exchange_owned`), as :meth:`_update_and_score_mesh` does for
        a full update. The table's active rows come from that sum, every
        other row is the warm table's, bit for bit. With ``prev_score`` a
        reject anywhere keeps the previous model and score on every rank;
        without it the whole table comes back unguarded (the caller's
        guard reads it). Returns (model, score, tracker)."""
        from photon_ml_tpu_torch.parallel.mesh import collective_region

        if initial_model is None:
            raise ValueError(_DELTA_NEEDS_MODEL)
        ds = self.dataset
        offsets_plus_scores = self.base_offsets + partial_scores
        with collective_region("entity_solve"):
            local, tracker, stats = train_random_effect_delta(
                ds, self.task, self.configuration, offsets_plus_scores, initial_model,
                active_mask, normalization=self.normalization,
                variance_computation=self.variance_computation,
                per_entity_reg_weights=self.per_entity_reg_weights,
                re_solver=self._solver_plan(offsets_plus_scores, initial_model),
            )
        self.last_active_stats = stats
        ok = torch.isfinite(local.coeffs).all()
        table, score, variances, ok_all = self._exchange_owned(
            local.coeffs, local.score_dataset(ds), ok, local.variances)
        prev = initial_model.aligned_to(ds)
        active = torch.as_tensor(np.asarray(active_mask, dtype=bool),
                                 device=table.device).unsqueeze(-1)
        coeffs = torch.where(active, table, local.coeffs)
        if variances is not None:
            variances = torch.where(active, variances, local.variances)
        if prev_score is not None:
            coeffs = torch.where(ok_all, coeffs, prev.coeffs.to(coeffs.dtype))
            if variances is not None:
                prev_var = (torch.zeros_like(variances) if prev.variances is None
                            else prev.variances.to(variances.dtype))
                variances = torch.where(ok_all, variances, prev_var)
            score = torch.where(ok_all, score, prev_score)
            tracker.guard_ok = ok_all  # what the descent loop reads of a fused update
        model = dataclasses.replace(local, coeffs=coeffs, variances=variances)
        return model, score, tracker

    def _exchange_owned(self, coeffs: Tensor, score: Tensor, ok: Tensor, variances):
        """ONE all_reduce over the data axis of this rank's [N] score (its
        samples only), its owned table rows (variances too) and its reject
        flag. Every sample and every row has one owner, so the score and
        the table come back exact. Returns (table [E, K], score [N],
        variances [E, K] or None, ok on every rank)."""
        from photon_ml_tpu_torch.parallel.mesh import all_reduce_many

        ds = self.dataset
        E = ds.n_entities

        def owned(t):
            mine = ds.owned_rows[:t.shape[0]].unsqueeze(-1)
            return torch.where(mine, t, torch.zeros((), dtype=t.dtype, device=t.device))

        parts = [score, owned(coeffs), (~ok).to(score.dtype).reshape(1)]
        if variances is not None:
            parts.append(owned(variances))
        summed = all_reduce_many(ds.mesh.data_axis, parts, "score")
        return (summed[1][:E], summed[0], summed[3][:E] if variances is not None else None,
                summed[2][0] == 0)

    def _working_set(self):
        """Resolve ONCE whether this coordinate streams through a working set
        (data/working_set.py), building the host tier at first engagement.
        Every demotion to the all-resident path is logged once through
        ``log_fallback_once``: a quiet demotion could fake the bounded-memory
        claim."""
        if self._ws_resolved:
            return self._ws
        self._ws_resolved = True
        knob = self.working_set_rows
        if knob is None:
            return None
        from photon_ml_tpu_torch.data.working_set import MIN_CHUNK_LANES, WorkingSet

        ds = self.dataset
        fingerprint = (
            f"coordinate {self.coordinate_id!r} ({ds.re_type}/"
            f"{ds.feature_shard_id}, {ds.n_entities} entities, "
            f"working_set_rows={knob!r})"
        )

        def demote(cause):
            log_fallback_once("re_working_set", fingerprint, cause)
            return None

        if getattr(ds, "mesh", None) is not None:
            return demote(
                "mesh-sharded dataset: the entity axis is already partitioned "
                "over the ranks — staying all-resident"
            )
        if ds.projector is not None:
            return demote(
                "projector-bearing coordinate: projected scoring addresses "
                "the full table on device — staying all-resident"
            )
        if ds.n_passive_samples > 0:
            return demote(
                "the active-data cap left passive samples outside the "
                "training buckets; the streamed score covers bucket samples "
                "only — staying all-resident"
            )
        variance_on = (
            VarianceComputationType(self.variance_computation)
            != VarianceComputationType.NONE
        )
        dtype = ds.sample_vals.dtype
        itemsize = torch.empty((), dtype=dtype).element_size()
        if knob == "auto":
            dev = ds.proj_indices.device
            if dev.type != "cuda":
                return demote(
                    "auto: the backend exposes no memory limit; assuming the "
                    "tables fit — staying all-resident"
                )
            limit = torch.cuda.mem_get_info(dev)[1]
            tables = 2 if variance_on else 1
            resident_bytes = ds.n_entities * ds.max_k * itemsize * tables
            for b in ds.buckets:
                resident_bytes += b.X.numel() * itemsize
            if resident_bytes <= 0.5 * limit:
                return demote(
                    "auto: tables + bucket blocks fit device memory — "
                    "staying all-resident"
                )
            row_bytes = max(ds.max_k * itemsize * tables, 1)
            budget = max(int(0.25 * limit) // row_bytes, 2 * MIN_CHUNK_LANES)
        else:
            budget = int(knob)
        if budget >= ds.n_entities:
            return demote(
                f"tables fit: the configured working set ({budget} rows) "
                f"covers every entity ({ds.n_entities}) — staying all-resident"
            )
        if not WorkingSet.schedule_feasible(budget, len(ds.buckets)):
            return demote(
                f"budget {budget} rows is below the minimal double-buffered "
                f"schedule (2 x {MIN_CHUNK_LANES} lanes) — staying "
                "all-resident"
            )
        l2_rows = build_l2_rows(ds, self.configuration.l2_weight, self.per_entity_reg_weights,
                                dtype, ds.n_entities)
        norm_tables = precompute_norm_tables(ds, self.normalization, dtype)
        flat = [a for tbl in norm_tables if tbl is not None for a in tbl if a is not None]
        host = iter(to_host(l2_rows, *flat))
        l2_host = next(host)
        norm_host = tuple(
            None if tbl is None else tuple(None if a is None else next(host) for a in tbl)
            for tbl in norm_tables
        )
        ws = WorkingSet(
            ds,
            budget,
            dtype,
            variance_on=variance_on,
            l2_host=l2_host,
            norm_host=norm_host,
            priorities=self.working_set_priorities,
            overlap=self.working_set_overlap,
        )
        # the host tier takes the bucket blocks over: re-pointing the dataset
        # at the host copies releases the device ones
        ds.buckets = list(ws.host_buckets)
        self._ws = ws
        return ws

    def reselect_working_set(self, priorities=None) -> bool:
        """Admission and eviction between descent runs: re-rank residency
        with fresh priorities (the continuous trainer's gradient screen).
        The host tables carry all state, so churn moves no coefficients.
        False when the working set is off or demoted."""
        ws = self._working_set()
        if ws is None:
            return False
        self.working_set_priorities = priorities
        ws.reselect(priorities)
        return True

    def working_set_stats(self) -> Optional[dict]:
        """The working set's live counters (data/working_set.py ``stats()``):
        measured peak device table bytes, staging and stall seconds, overlap
        efficiency. None when the coordinate is all-resident."""
        ws = self._working_set()
        return None if ws is None else ws.stats()

    def _update_static(self):
        """The update program's iteration-invariant inputs, built once: the
        per-entity L2 table, the per-bucket normalization gathers, under a
        reduced precision the buckets and scoring view with their feature
        values cast to the storage dtype, and the bucket solves' CUDA graphs
        (optimization/bucket_graphs.py)."""
        if self._static is None:
            ds = self.dataset
            dtype = ds.sample_vals.dtype
            buckets, view = list(ds.buckets), ds.scoring_view()
            if not self.precision.is_reference:
                to_storage = self.precision.to_storage
                buckets = [dataclasses.replace(b, X=to_storage(b.X)) for b in buckets]
                view = (view[0], view[1], to_storage(view[2]))
            self._static = dict(
                l2_rows=build_l2_rows(ds, self.configuration.l2_weight,
                                      self.per_entity_reg_weights, dtype, ds.n_entities),
                norm_tables=precompute_norm_tables(ds, self.normalization, dtype),
                buckets=buckets,
                view=view,
                graphs=BucketGraphs(),
            )
        return self._static

    def update_and_score(
        self,
        initial_model: Optional[RandomEffectModel],
        partial_scores: Tensor,
        prev_score: Tensor,
    ):
        """One update program per update (solver_cache.
        re_coordinate_update_program): every bucket solve, the table scatter,
        the [N] score and the divergence guard, with no host read beyond the
        solves' own. A working set streams the same update chunk by chunk.
        Returns None (the per-bucket path) when ``use_update_program`` is
        off; a mesh-placed dataset always takes the program
        (:meth:`_update_and_score_mesh`)."""
        if getattr(self.dataset, "mesh", None) is not None:
            return self._update_and_score_mesh(initial_model, partial_scores, prev_score)
        if not self.use_update_program:
            return None
        ws = self._working_set()
        if ws is not None:
            return self._update_and_score_streamed(ws, initial_model, partial_scores, prev_score)
        ds = self.dataset
        if initial_model is None:
            initial_model = self.initialize_model()
        program, args = self._resolve_update_program(
            initial_model, self.base_offsets + partial_scores, prev_score)
        coeffs, score, variances, ok, reasons, iters = program(*args)
        model = RandomEffectModel(
            re_type=ds.re_type,
            feature_shard_id=ds.feature_shard_id,
            task=self.task,
            entity_ids=ds.entity_ids,
            coeffs=coeffs,
            proj_indices=ds.proj_indices,
            variances=variances,
            projector=ds.projector,
        )
        return model, score, LazyRandomEffectTracker(reasons, iters, guard_ok=ok)

    def _update_and_score_mesh(self, initial_model, partial_scores: Tensor, prev_score: Tensor):
        """The update over this rank's entity blocks: the update program on
        the rank's buckets (no collective inside, region ``entity_solve``),
        then ONE all_reduce over the data axis of the rank's [N] score (its
        samples only), its owned table rows (variances too) and its reject
        flag. Every sample and every row has one owner, so the score and the
        tables come back exact; a reject anywhere keeps the previous model
        and score on every rank. The tracker's stats are this rank's
        entities'."""
        from photon_ml_tpu_torch.parallel.mesh import collective_region

        ds = self.dataset
        if initial_model is None:
            initial_model = self.initialize_model()
        offsets_plus_scores = self.base_offsets + partial_scores
        program, args = self._resolve_update_program(
            initial_model, offsets_plus_scores, torch.zeros_like(prev_score))
        with collective_region("entity_solve"):
            coeffs, score, variances, ok, reasons, iters = program(*args)
        table, score, new_var, ok_all = self._exchange_owned(coeffs, score, ok, variances)
        prev = initial_model.aligned_to(ds)
        coeffs_out = torch.where(ok_all, table, prev.coeffs.to(table.dtype))
        var_out = None
        if new_var is not None:
            prev_var = (torch.zeros_like(new_var) if prev.variances is None
                        else prev.variances.to(new_var.dtype))
            var_out = torch.where(ok_all, new_var, prev_var)
        model = RandomEffectModel(
            re_type=ds.re_type,
            feature_shard_id=ds.feature_shard_id,
            task=self.task,
            entity_ids=ds.entity_ids,
            coeffs=coeffs_out,
            proj_indices=ds.proj_indices,
            variances=var_out,
            projector=ds.projector,
        )
        score_out = torch.where(ok_all, score, prev_score)
        # the padded lanes of this rank's bucket blocks stay out of the stats
        return model, score_out, LazyRandomEffectTracker(reasons, iters, guard_ok=ok_all,
                                                         real_masks=ds.lane_masks)

    def _resolve_update_program(self, initial_model: RandomEffectModel,
                                offsets_plus_scores: Tensor, prev_score: Tensor):
        """(program, args) of one all-resident update: the one owner of the
        program's resolution, shared by ``update_and_score`` and
        ``compiled_update_hlo`` so the audit records exactly the program
        training dispatches."""
        ds = self.dataset
        variance = VarianceComputationType(self.variance_computation)
        st = self._update_static()
        # the tables live at the policy's storage dtype; the reference policy
        # keeps the dataset's
        dtype = (ds.sample_vals.dtype if self.precision.is_reference
                 else self.precision.storage_dtype)
        program = re_coordinate_update_program(
            self.task,
            self.configuration.optimizer_config,
            bool(self.configuration.l1_weight),
            variance,
            ds.n_entities,
            self._solver_plan(offsets_plus_scores, initial_model),
            self.precision,
            graphs=st["graphs"],
        )
        aligned = initial_model.aligned_to(ds)
        coeffs_prev = aligned.coeffs.to(dtype)
        var_prev = None
        if variance != VarianceComputationType.NONE:
            var_prev = (
                torch.zeros_like(coeffs_prev)
                if aligned.variances is None
                else aligned.variances.to(dtype)
            )
        rows = getattr(ds, "coeffs_rows", None)
        if rows is not None:
            # mesh placement: padded bucket lanes scatter into the junk row
            # E, so the table is E + 1 rounded up to the mesh size tall
            from photon_ml_tpu_torch.parallel.mesh import pad_rows_and_place

            coeffs_prev = pad_rows_and_place(coeffs_prev, rows)
            var_prev = None if var_prev is None else pad_rows_and_place(var_prev, rows)
        args = (coeffs_prev, prev_score, var_prev, offsets_plus_scores, st["l2_rows"],
                self.configuration.l1_weight or 0.0, st["buckets"], st["norm_tables"],
                st["view"])
        return program, args

    def _update_and_score_streamed(self, ws, initial_model, partial_scores, prev_score):
        """The update through the working set: the host tier stays
        authoritative, the device never holds more table rows than the
        budget, and every chunk runs ``solver_cache.re_chunk_update_program``,
        the same batched bucket solve and view score as the all-resident
        program. A divergence reject returns the PREVIOUS model and score and
        drops the staged commit; the tracker carries the device ``guard_ok``
        flag the descent loop requires. No failed chunk falls back to the
        all-resident program: its error propagates."""
        ds = self.dataset
        if initial_model is not None:
            # a foreign warm start (checkpoint restore, external model) seeds
            # the host tier; our own committed tables round-trip untouched
            aligned = initial_model.aligned_to(ds)
            if not ws.owns(aligned.coeffs):
                tables = [aligned.coeffs] + (
                    [] if aligned.variances is None else [aligned.variances]
                )
                host = to_host(*tables)
                ws.seed_tables(host[0], host[1] if len(host) > 1 else None)
        offsets_plus_scores = self.base_offsets + partial_scores
        # a measured "auto" plan gives each BUCKET a solver; every chunk of a
        # bucket solves with its bucket's
        plan = bucket_solver_plan(self._solver_plan(offsets_plus_scores, initial_model),
                                  len(ds.buckets))
        programs = {
            solver: re_chunk_update_program(
                self.task,
                self.configuration.optimizer_config,
                bool(self.configuration.l1_weight),
                VarianceComputationType(self.variance_computation),
                ds.max_k,
                solver,
            )
            for solver in sorted(set(plan))
        }
        view_cols, view_vals = ds.sample_local_cols, ds.sample_vals
        l1 = self.configuration.l1_weight or 0.0

        def solve_chunk(chunk, staged, score_partial):
            return programs[plan[chunk.bucket]](
                staged["init"], score_partial, *staged["data"], staged["l2"], l1,
                staged["norm"], offsets_plus_scores, view_cols, view_vals,
            )

        score0 = torch.zeros((ds.n_samples + 1,), dtype=ds.sample_vals.dtype,
                             device=ds.proj_indices.device)
        score_new, ok_dev, reasons, iters, masks = ws.stream_pass(solve_chunk, score0)
        if not ws.tail_ok:
            # the all-resident guard reads the WHOLE table, tail columns the
            # chunks never rewrite included: a non-finite warm start there
            # rejects here too
            ok_dev = torch.zeros_like(ok_dev)
        # the commit swaps or drops host tables, so the flag is read here;
        # the chunk harvests already waited for every solve
        ok_host = bool(to_host(ok_dev)[0])
        ws.commit_pass(ok_host)
        score_out = score_new[: ds.n_samples] if ok_host else prev_score
        model = RandomEffectModel(
            re_type=ds.re_type,
            feature_shard_id=ds.feature_shard_id,
            task=self.task,
            entity_ids=ds.entity_ids,
            coeffs=ws.host_coeffs,
            proj_indices=ds.proj_indices,
            variances=ws.host_vars,
            projector=ds.projector,
        )
        tracker = LazyRandomEffectTracker(reasons, iters, guard_ok=ok_dev, real_masks=masks)
        return model, score_out, tracker

    def compiled_update_hlo(self) -> str:
        """The audit record of this coordinate's all-resident update program
        (analysis/program_audit.py): one dispatch of exactly the program
        ``update_and_score`` dispatches (``_resolve_update_program``), from
        zero tables and scores over the coordinate's base offsets, as the
        JAX package lowers its program. The text is the port's program
        record (aliased outputs, widest float, host syncs, collectives,
        kernel launches), not HLO: the port compiles no module, so the
        program runs once to be recorded. A streamed (working-set)
        coordinate runs one program per chunk, audited as
        ``re_chunk_update``."""
        from photon_ml_tpu_torch.analysis.program_audit import record_program

        if (not self.use_update_program and getattr(self.dataset, "mesh", None) is None) or (
                self._working_set() is not None):
            raise ValueError(
                "compiled_update_hlo audits the all-resident update program; this "
                "coordinate runs the per-bucket loop or streams a working set"
            )
        ds = self.dataset
        score0 = torch.zeros((ds.n_samples,), dtype=ds.sample_vals.dtype,
                             device=ds.proj_indices.device)
        if getattr(ds, "mesh", None) is not None:
            # on a mesh the update is the program plus its one exchange
            _, text = record_program("RandomEffectCoordinate.update_and_score",
                                     self._update_and_score_mesh,
                                     (self.initialize_model(), score0, score0.clone()))
            return text
        program, args = self._resolve_update_program(self.initialize_model(),
                                                     self.base_offsets, score0)
        _, text = record_program("RandomEffectCoordinate.update_and_score", program, args)
        return text

    def score(self, model: RandomEffectModel) -> Tensor:
        if getattr(self.dataset, "mesh", None) is not None:
            # this rank scores its entities' samples; one sum makes it whole
            return whole_score(self.dataset, model.score_dataset(self.dataset))
        ws = self._working_set()
        if ws is None:
            return model.score_dataset(self.dataset)
        ds = self.dataset
        coeffs = model.aligned_to(ds).coeffs
        if coeffs.device.type != "cpu":
            coeffs = to_host(coeffs)[0]
        if not bool(coeffs.any()):
            # an all-zero table scores zero everywhere (the descent loop's
            # initial score), without streaming a pass
            return torch.zeros((ds.n_samples,), dtype=ds.sample_vals.dtype,
                               device=ds.proj_indices.device)
        return ws.score_streamed(re_chunk_score_program(), coeffs, ds.n_samples,
                                 ds.sample_local_cols, ds.sample_vals)


@dataclasses.dataclass
class ModelCoordinate(Coordinate):
    """Locked, score-only coordinate for partial retraining: never re-optimized
    (FixedEffectModelCoordinate.scala:44, RandomEffectModelCoordinate.scala:44,
    CoordinateDescent.scala:45)."""

    coordinate_id: str
    dataset: object  # FixedEffectDataset | RandomEffectDataset
    model: object  # FixedEffectModel | RandomEffectModel

    @property
    def is_locked(self) -> bool:
        return True

    def prepare_initial_model(self, model):
        if isinstance(model, FixedEffectModel):
            return pad_fixed_effect_model(model, self.dataset)
        if hasattr(model, "aligned_to") and hasattr(self.dataset, "entity_ids"):
            return model.aligned_to(self.dataset)
        return model

    def initialize_model(self):
        return self.model

    def update_model(self, initial_model, partial_scores: Tensor):
        raise RuntimeError(
            f"Coordinate {self.coordinate_id} is locked (partial retrain); "
            "updateModel must never be called on a ModelCoordinate"
        )

    def score(self, model=None) -> Tensor:
        return whole_score(self.dataset,
                           (model if model is not None else self.model).score_dataset(self.dataset))


def whole_score(dataset, score: Tensor) -> Tensor:
    """The whole [N] score from what this rank scored of a placed dataset:
    a fixed effect's row block gathered, a random effect's owned samples
    summed (one nonzero term per sample). Unchanged off a mesh."""
    mesh = getattr(dataset, "mesh", None)
    if mesh is None:
        return score
    from photon_ml_tpu_torch.parallel.mesh import all_reduce_many, gather_rows

    if isinstance(dataset, FixedEffectDataset):
        return gather_rows(score, mesh, dataset.n)
    return all_reduce_many(mesh.data_axis, [score], "score")[0]


def coefficient_arrays(model) -> list:
    """The tensors whose finiteness defines a healthy coordinate update (the
    divergence guard's input). Variances are left out: scoring never reads
    them, and a singular-Hessian variance must not discard an otherwise
    converged mean update."""
    if isinstance(model, FixedEffectModel):
        return [model.model.coefficients.means]
    if isinstance(model, RandomEffectModel):
        return [model.coeffs]
    raise TypeError(f"Unknown model type: {type(model).__name__}")


def score_model_on_dataset(model, dataset) -> Tensor:
    """Generic scoring dispatch used for validation data and by
    ``GameTransformer`` (DatumScoringModel.scoreForCoordinateDescent). A
    dense fixed effect scores through ``fixed_effect_view_score``, whose
    per-row bits do not depend on the number of rows (the serving engine's
    contract); a sparse one through its matvec (the engine's per-sample
    route agrees with it within rounding)."""
    if isinstance(model, FixedEffectModel):
        if not isinstance(dataset, FixedEffectDataset):
            raise TypeError("FixedEffectModel requires a FixedEffectDataset")
        X = dataset.data.X
        means = model.model.coefficients.means
        if means.shape[0] > X.n_cols:
            # a feature-sharded fit pads its coefficients with zeros to a
            # model-axis multiple; an unpadded dataset reads the real ones
            means = means[: X.n_cols]
        if isinstance(X, SparseDesignMatrix):
            return X.matvec(means)
        return fixed_effect_view_score(X.values, means)
    if isinstance(model, RandomEffectModel):
        if not isinstance(dataset, RandomEffectDataset):
            raise TypeError("RandomEffectModel requires a RandomEffectDataset")
        return model.score_dataset(dataset)
    raise TypeError(f"Cannot score model of type {type(model).__name__}")
