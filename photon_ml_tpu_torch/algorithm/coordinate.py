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
  bucket by bucket with ``use_update_program=False``.
- ``ModelCoordinate`` is a locked, score-only coordinate.

A fixed effect takes per-feature box bounds (``box_constraints``, refused
together with normalization as in the reference); a random effect takes
per-entity normalization and ``re_solver`` "lbfgs", "direct" or "auto",
the last measured once per coordinate and carried across a resume through
``re_solver_stats`` / ``seed_solver_decision``.

Not ported yet, each raising with its ROADMAP item: down-sampling (A14),
reduced storage precision, the working set and the active-set update (A13),
and the compiled-program audit hook (A13, analysis).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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
)
from photon_ml_tpu_torch.data.dataset import FixedEffectDataset
from photon_ml_tpu_torch.data.random_effect import RandomEffectDataset
from photon_ml_tpu_torch.device import to_host
from photon_ml_tpu_torch.models.game import (
    FixedEffectModel,
    RandomEffectModel,
    fixed_effect_view_score,
)
from photon_ml_tpu_torch.models.glm import model_class_for_task
from photon_ml_tpu_torch.normalization import NO_NORMALIZATION, NormalizationContext
from photon_ml_tpu_torch.optimization.config import GLMOptimizationConfiguration
from photon_ml_tpu_torch.optimization.normal_equations import (
    AutoSolverDecision,
    validate_re_solver,
)
from photon_ml_tpu_torch.optimization.problem import GLMOptimizationProblem
from photon_ml_tpu_torch.optimization.solver_cache import (
    check_precision,
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
    meets data on the card). The JAX form also pads the means for
    feature-sharded datasets, which wait for ROADMAP A12."""
    labels = dataset.data.labels
    means = model.model.coefficients.means
    if means.device == labels.device and means.dtype == labels.dtype:
        return model
    coef = dataclasses.replace(
        model.model.coefficients, means=means.to(device=labels.device, dtype=labels.dtype)
    )
    glm = model_class_for_task(model.model.task)(coef)
    return dataclasses.replace(model, model=glm)


@dataclasses.dataclass
class FixedEffectCoordinate(Coordinate):
    """Global GLM over one feature shard (FixedEffectCoordinate.scala:35-166):
    one optimizer run through ``GLMOptimizationProblem.run``."""

    coordinate_id: str
    dataset: FixedEffectDataset
    task: TaskType
    configuration: GLMOptimizationConfiguration
    normalization: NormalizationContext = NO_NORMALIZATION
    variance_computation: VarianceComputationType = VarianceComputationType.NONE
    down_sampler: Optional[object] = None
    # (lower[D], upper[D]) per-feature box bounds (constraint maps), enforced
    # by the optimizers (LBFGS projection, LBFGSB, TRON, NEWTON)
    box_constraints: Optional[tuple] = None

    def __post_init__(self):
        self.task = TaskType(self.task)
        if self.down_sampler is not None:
            raise NotImplementedError("down-sampling is not ported yet: ROADMAP A14")
        if self.box_constraints is not None and not self.normalization.is_identity:
            # the reference rejects this combination outright (Params.scala:211-214):
            # bounds are specified in original feature space, solves run in
            # normalized space, and the clamp cannot be guaranteed in both
            raise ValueError("Box constraints and normalization cannot be combined")
        self._problem = GLMOptimizationProblem(
            task=self.task,
            configuration=self.configuration,
            normalization=self.normalization,
            variance_computation=VarianceComputationType(self.variance_computation),
        )

    def initialize_model(self) -> FixedEffectModel:
        labels = self.dataset.data.labels
        model = self._problem.initialize_zero_model(
            self.dataset.dim, dtype=labels.dtype, device=labels.device
        )
        return FixedEffectModel(model=model, feature_shard_id=self.dataset.feature_shard_id)

    def prepare_initial_model(self, model: FixedEffectModel) -> FixedEffectModel:
        return pad_fixed_effect_model(model, self.dataset)

    def update_model(
        self, initial_model: Optional[FixedEffectModel], partial_scores: Tensor
    ) -> tuple[FixedEffectModel, FixedEffectOptimizationTracker]:
        """Train with offsets := base offsets + other coordinates' scores
        (Coordinate.scala:60-63 / FixedEffectCoordinate.updateModel:91-147).
        The tracker's scalars stay on the device."""
        data = self.dataset.data.add_scores_to_offsets(partial_scores)
        lower, upper = self.box_constraints or (None, None)
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

    def score(self, model: FixedEffectModel) -> Tensor:
        return model.score_dataset(self.dataset)


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
    precision: object = None
    working_set_rows: object = None

    def __post_init__(self):
        self.task = TaskType(self.task)
        check_trainable(self.task, self.configuration)
        self.re_solver = validate_re_solver(self.re_solver, bool(self.configuration.l1_weight))
        check_precision(self.precision)
        if self.working_set_rows is not None:
            raise NotImplementedError(
                "the random-effect working set is not ported yet: ROADMAP A13"
            )
        # the update program's iteration-invariant inputs, built at first use
        self._static = None
        # re_solver="auto": the measured record, filled by the first update's
        # probe or seeded from a restored checkpoint, so that a resumed run
        # never re-measures against warm tables
        self._auto_decision: Optional[AutoSolverDecision] = None

    def initialize_model(self) -> RandomEffectModel:
        ds = self.dataset
        return RandomEffectModel(
            re_type=ds.re_type,
            feature_shard_id=ds.feature_shard_id,
            task=self.task,
            entity_ids=ds.entity_ids,
            coeffs=torch.zeros((ds.n_entities, ds.max_k), dtype=ds.sample_vals.dtype,
                               device=ds.proj_indices.device),
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

    def update_model_active(self, initial_model, partial_scores, active_mask):
        raise NotImplementedError(
            "active-set random-effect updates are not ported yet: ROADMAP A13 (continuous/)"
        )

    def update_and_score(
        self,
        initial_model: Optional[RandomEffectModel],
        partial_scores: Tensor,
        prev_score: Tensor,
    ):
        """One update program per update (solver_cache.
        re_coordinate_update_program): every bucket solve, the table scatter,
        the [N] score and the divergence guard, with no host read beyond the
        solves' own. Returns None (the per-bucket path) when
        ``use_update_program`` is off."""
        if not self.use_update_program:
            return None
        ds = self.dataset
        dtype = ds.sample_vals.dtype
        variance = VarianceComputationType(self.variance_computation)
        if self._static is None:  # invariant across descent iterations
            self._static = (
                build_l2_rows(ds, self.configuration.l2_weight, self.per_entity_reg_weights,
                              dtype, ds.n_entities),
                precompute_norm_tables(ds, self.normalization, dtype),
            )
        l2_rows, norm_tables = self._static
        if initial_model is None:
            initial_model = self.initialize_model()
        offsets_plus_scores = self.base_offsets + partial_scores
        program = re_coordinate_update_program(
            self.task,
            self.configuration.optimizer_config,
            bool(self.configuration.l1_weight),
            variance,
            ds.n_entities,
            self._solver_plan(offsets_plus_scores, initial_model),
            self.precision,
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
        coeffs, score, variances, ok, reasons, iters = program(
            coeffs_prev,
            prev_score,
            var_prev,
            offsets_plus_scores,
            l2_rows,
            self.configuration.l1_weight or 0.0,
            ds.buckets,
            norm_tables,
            ds.scoring_view(),
        )
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

    def compiled_update_hlo(self) -> str:
        raise NotImplementedError(
            "the compiled-program audit is not ported: ROADMAP A13 (analysis/)"
        )

    def score(self, model: RandomEffectModel) -> Tensor:
        return model.score_dataset(self.dataset)


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
        return (model if model is not None else self.model).score_dataset(self.dataset)


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
    contract)."""
    if isinstance(model, FixedEffectModel):
        if not isinstance(dataset, FixedEffectDataset):
            raise TypeError("FixedEffectModel requires a FixedEffectDataset")
        return fixed_effect_view_score(dataset.data.X.values, model.model.coefficients.means)
    if isinstance(model, RandomEffectModel):
        if not isinstance(dataset, RandomEffectDataset):
            raise TypeError("RandomEffectModel requires a RandomEffectDataset")
        return model.score_dataset(dataset)
    raise TypeError(f"Cannot score model of type {type(model).__name__}")
