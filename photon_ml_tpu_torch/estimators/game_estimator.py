"""GameEstimator: the "fit like Spark ML" GAME training API.

Port of photon_ml_tpu/estimators/game_estimator.py (photon-api
estimators/GameEstimator.scala:55-801):

- GameInput (host arrays) -> per-coordinate datasets on ``device``, built
  ONCE and shared across every configuration of the sweep
  (prepareTrainingDatasets:454-557);
- per-configuration coordinates assembled by ``build_coordinate``
  (CoordinateFactory.scala:51-115);
- one ``run_coordinate_descent`` per expanded configuration, each
  warm-started from the previous configuration's best model
  (GameEstimator.fit:344-360);
- validation datasets and the EvaluationSuite prepared once
  (prepareValidationDatasetAndEvaluators:568-595).

``fused_pass=True`` hands each pass to the port's flagship pass
(parallel/game.py::game_train_step) through estimators/fused_backend.py.

The JAX estimator's ``mesh`` becomes ``device``: like every entry point of
the port it is ``"cuda"`` by default and raises where there is no CUDA,
unless the caller names the CPU. ``normalization_contexts`` (per feature
shard), L1 and elastic net (OWLQN), box constraints and ``re_solver`` in
{"lbfgs", "direct", "auto"} are accepted as in the JAX estimator. Knobs of
later slices raise ``NotImplementedError`` naming their ROADMAP item: bf16
storage (A8), reduced RE precision and the working set (A13), and
down-sampling (A14).

``checkpoint_directory`` saves every ``checkpoint_interval``-th iteration of
sweep configuration i under ``<checkpoint_directory>/config_<i>``
(io/checkpoint.py), through the host loop and through the fused pass alike; a
rerun resumes bit for bit from the last completed iteration. A run
fingerprint ties each checkpoint to its configuration and data size.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.algorithm.coordinate import (
    Coordinate,
    FixedEffectCoordinate,
    ModelCoordinate,
    RandomEffectCoordinate,
    pad_fixed_effect_model,
)
from photon_ml_tpu_torch.algorithm.coordinate_descent import (
    CoordinateDescentResult,
    run_coordinate_descent,
)
from photon_ml_tpu_torch.data.dataset import FixedEffectDataset, LabeledData
from photon_ml_tpu_torch.data.game_data import (
    GameInput,
    as_csr,
    build_fixed_effect_scoring_dataset,
    build_random_effect_scoring_dataset,
)
from photon_ml_tpu_torch.data.projector import make_projector
from photon_ml_tpu_torch.data.random_effect import build_random_effect_dataset
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.estimators.config import (
    CoordinateConfiguration,
    FixedEffectDataConfiguration,
    RandomEffectDataConfiguration,
    expand_game_configurations,
)
from photon_ml_tpu_torch.estimators.fused_backend import (
    fused_pass_ineligibilities,
    run_fused_game_descent,
)
from photon_ml_tpu_torch.evaluation.evaluators import (
    EvaluationSuite,
    EvaluatorType,
    evaluator_spec_name,
    resolve_evaluator,
)
from photon_ml_tpu_torch.io.checkpoint import CoordinateDescentCheckpointer
from photon_ml_tpu_torch.models.game import FixedEffectModel, GameModel, RandomEffectModel
from photon_ml_tpu_torch.normalization import NO_NORMALIZATION, NormalizationContext
from photon_ml_tpu_torch.optimization.config import GLMOptimizationConfiguration
from photon_ml_tpu_torch.optimization.precision import resolve_precision
from photon_ml_tpu_torch.optimization.solver_cache import check_precision
from photon_ml_tpu_torch.parallel.game import build_sharded_game_data
from photon_ml_tpu_torch.types import TaskType, VarianceComputationType

logger = logging.getLogger(__name__)


def default_evaluator_type(task: TaskType) -> EvaluatorType:
    """Task -> default validation evaluator (GameEstimator defaultEvaluator)."""
    task = TaskType(task)
    return {
        TaskType.LOGISTIC_REGRESSION: EvaluatorType.AUC,
        TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM: EvaluatorType.AUC,
        TaskType.LINEAR_REGRESSION: EvaluatorType.RMSE,
        TaskType.POISSON_REGRESSION: EvaluatorType.POISSON_LOSS,
    }[task]


@dataclasses.dataclass
class GameResult:
    """One trained configuration (reference GameResult: model, evaluations, configs)."""

    model: GameModel
    best_model: GameModel
    configuration: dict[str, GLMOptimizationConfiguration]
    evaluations: Optional[dict[str, float]]  # metrics of best_model
    best_metric: Optional[float]
    descent: CoordinateDescentResult


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP {item}")


@dataclasses.dataclass
class GameEstimator:
    """GAME training over an ordered set of coordinates.

    The order of ``coordinate_configurations`` IS the coordinate update
    sequence (GameEstimator coordinateUpdateSequence param).
    """

    task: TaskType
    coordinate_configurations: Mapping[str, CoordinateConfiguration]
    n_iterations: int = 1
    # feature shard id -> NormalizationContext; shards absent are not normalized
    normalization_contexts: Optional[Mapping[str, NormalizationContext]] = None
    variance_computation: VarianceComputationType = VarianceComputationType.NONE
    validation_evaluators: Sequence = ()
    partial_retrain_locked_coordinates: Sequence[str] = ()
    dtype: object = torch.float32
    # where every dataset, score and model lives (the JAX estimator's mesh)
    device: object = "cuda"
    # iteration-level failure recovery (io/checkpoint.py): per sweep config i,
    # the descent saves every checkpoint_interval-th iteration under
    # <checkpoint_directory>/config_<i>, and a rerun resumes from the last
    # completed iteration
    checkpoint_directory: Optional[str] = None
    checkpoint_interval: int = 1
    # how many generations restore can roll back through when the newest
    # fails integrity verification
    checkpoint_keep_generations: int = 3
    fe_storage_dtype: Optional[object] = None
    re_storage_dtype: Optional[object] = None
    # run each coordinate-descent pass through the flagship pass
    # (parallel/game.py) instead of the host loop; eligible configurations
    # only (estimators/fused_backend.py raises with the reasons otherwise);
    # validation and best-model tracking then happen per PASS
    fused_pass: bool = False
    # host-loop random-effect updates as one update program per coordinate
    # update (solver_cache.re_coordinate_update_program); False runs the
    # per-bucket loop
    re_update_program: bool = True
    re_solver: str = "lbfgs"
    re_precision: object = None
    re_working_set_rows: object = None

    def __post_init__(self):
        self.task = TaskType(self.task)
        self.variance_computation = VarianceComputationType(self.variance_computation)
        self.device = resolve_device(self.device)
        if self.fe_storage_dtype is not None or self.re_storage_dtype is not None:
            raise _not_ported("bf16 storage (fe_storage_dtype, re_storage_dtype)", "A8")
        check_precision(self.re_precision)
        if self.re_working_set_rows is not None:
            raise _not_ported("the random-effect working set (re_working_set_rows)", "A13")
        for cid, cfg in self.coordinate_configurations.items():
            if 0.0 < cfg.down_sampling_rate < 1.0:
                raise _not_ported(f"down-sampling (coordinate {cid!r})", "A14")
        locked = set(self.partial_retrain_locked_coordinates)
        unknown = locked - set(self.coordinate_configurations)
        if unknown:
            raise ValueError(f"Locked coordinates not in configurations: {sorted(unknown)}")
        if locked == set(self.coordinate_configurations) and locked:
            raise ValueError("All coordinates locked; nothing to train")

    @staticmethod
    def warm_up_backend():
        """A no-op in the port. The JAX estimator starts XLA's backend and a
        pilot compile on a background thread here; the port compiles no
        program per configuration, and its kernels build at first use."""
        return None

    # ------------------------------------------------------------- data prep

    def _normalization_for(self, shard: str) -> NormalizationContext:
        if not self.normalization_contexts:
            return NO_NORMALIZATION
        return self.normalization_contexts.get(shard, NO_NORMALIZATION)

    def prepare_training_datasets(self, data: GameInput) -> dict[str, object]:
        """GameInput -> per-coordinate datasets on ``device``
        (GameEstimator.prepareTrainingDatasets:454-557). Built once per fit."""
        if not data.has_labels:
            raise ValueError("Training data must carry labels")
        datasets: dict[str, object] = {}
        for cid, cfg in self.coordinate_configurations.items():
            dc = cfg.data_config
            if isinstance(dc, FixedEffectDataConfiguration):
                datasets[cid] = FixedEffectDataset(
                    LabeledData.build(
                        data.shard(dc.feature_shard_id),
                        data.labels,
                        offsets=data.offsets,
                        weights=data.weights,
                        dtype=self.dtype,
                        device=self.device,
                    ),
                    feature_shard_id=dc.feature_shard_id,
                )
            elif isinstance(dc, RandomEffectDataConfiguration):
                norm = self._normalization_for(dc.feature_shard_id)
                X = as_csr(data.shard(dc.feature_shard_id))
                datasets[cid] = build_random_effect_dataset(
                    X,
                    data.ids(dc.random_effect_type),
                    dc.random_effect_type,
                    feature_shard_id=dc.feature_shard_id,
                    active_data_upper_bound=dc.active_data_upper_bound,
                    active_data_lower_bound=dc.active_data_lower_bound,
                    features_max=dc.features_max,
                    labels=data.labels,
                    weights=data.weights,
                    intercept_index=None if norm.is_identity else norm.intercept_index,
                    normalization=None if norm.is_identity else norm,
                    dtype=self.dtype,
                    projector=self._projector_for(dc, X.shape[1]),
                    device=self.device,
                )
            else:
                raise TypeError(f"Unknown data configuration {type(dc).__name__}")
        return datasets

    def prepare_scoring_datasets(self, data: GameInput) -> dict[str, object]:
        """Validation/scoring datasets: same shapes, no caps or selection, no
        training buckets (the reference scores validation data without
        active-data policies)."""
        datasets: dict[str, object] = {}
        for cid, cfg in self.coordinate_configurations.items():
            dc = cfg.data_config
            if isinstance(dc, FixedEffectDataConfiguration):
                datasets[cid] = build_fixed_effect_scoring_dataset(
                    data, dc.feature_shard_id, dtype=self.dtype, device=self.device
                )
            else:
                datasets[cid] = build_random_effect_scoring_dataset(
                    data, dc.random_effect_type, dc.feature_shard_id, dtype=self.dtype,
                    projector=self._projector_for(dc, data.shard(dc.feature_shard_id).shape[1]),
                    device=self.device,
                )
        return datasets

    def _projector_for(self, dc, original_dim: int):
        """A RandomProjector for a RANDOM_PROJECTION coordinate, else None
        (index-map and identity projections are the dataset's own layout)."""
        if dc.projector is None:
            return None
        return make_projector(dc.projector, original_dim)

    def prepare_evaluation_suite(self, validation: GameInput) -> EvaluationSuite:
        """prepareValidationDatasetAndEvaluators:568-595: the task's default
        evaluator unless the caller supplied evaluators (first = primary)."""
        if not validation.has_labels:
            raise ValueError("Validation data must carry labels")
        specs = list(self.validation_evaluators) or [default_evaluator_type(self.task)]
        return EvaluationSuite(
            evaluators=[resolve_evaluator(s) for s in specs],
            labels=np.asarray(validation.labels, dtype=np.float64),
            offsets=np.asarray(validation.offsets, dtype=np.float64),
            weights=np.asarray(validation.weights, dtype=np.float64),
            id_columns={t: np.asarray(c) for t, c in validation.id_columns.items()},
        )

    # ------------------------------------------------------------ coordinates

    def build_coordinate(
        self,
        cid: str,
        dataset,
        opt_config: GLMOptimizationConfiguration,
        base_offsets,
        initial_model=None,
    ) -> Coordinate:
        """CoordinateFactory.build (photon-api algorithm/CoordinateFactory.scala:51-115)."""
        cfg = self.coordinate_configurations[cid]
        if cid in set(self.partial_retrain_locked_coordinates):
            if initial_model is None:
                raise ValueError(f"Locked coordinate {cid!r} needs a model from initial_model")
            if isinstance(initial_model, FixedEffectModel):
                initial_model = pad_fixed_effect_model(initial_model, dataset)
            return ModelCoordinate(coordinate_id=cid, dataset=dataset, model=initial_model)
        norm = self._normalization_for(cfg.data_config.feature_shard_id)
        if isinstance(cfg.data_config, FixedEffectDataConfiguration):
            return FixedEffectCoordinate(
                coordinate_id=cid,
                dataset=dataset,
                task=self.task,
                configuration=opt_config,
                normalization=norm,
                variance_computation=self.variance_computation,
                box_constraints=cfg.box_constraints,
            )
        return RandomEffectCoordinate(
            coordinate_id=cid,
            dataset=dataset,
            task=self.task,
            configuration=opt_config,
            base_offsets=base_offsets,
            normalization=None if norm.is_identity else norm,
            variance_computation=self.variance_computation,
            per_entity_reg_weights=cfg.per_entity_reg_weights,
            use_update_program=self.re_update_program,
            re_solver=self.re_solver,
            precision=self.re_precision,
        )

    # ---------------------------------------------------------------- fit

    def fit(
        self,
        data: GameInput,
        validation_data: Optional[GameInput] = None,
        initial_model: Optional[GameModel] = None,
    ) -> list[GameResult]:
        """Train one GAME model per expanded optimization configuration,
        chaining warm starts (GameEstimator.fit:299-380). Returns results in
        sweep order."""
        locked = set(self.partial_retrain_locked_coordinates)
        if locked and initial_model is None:
            raise ValueError("partial retrain requires initial_model")

        datasets = self.prepare_training_datasets(data)
        if self.fused_pass:
            return self._fit_fused(datasets, validation_data, initial_model)
        base_offsets = torch.as_tensor(np.asarray(data.offsets)).to(
            device=self.device, dtype=self.dtype
        )
        validation_datasets = suite = None
        if validation_data is not None:
            validation_datasets = self.prepare_scoring_datasets(validation_data)
            suite = self.prepare_evaluation_suite(validation_data)

        sweep = expand_game_configurations(self.coordinate_configurations)
        logger.info("GAME sweep: %d configurations x %d coordinates",
                    len(sweep), len(self.coordinate_configurations))
        results: list[GameResult] = []
        warm: Optional[GameModel] = initial_model
        for i, opt_configs in enumerate(sweep):
            coordinates: dict[str, Coordinate] = {}
            init_models: dict[str, object] = {}
            for cid in self.coordinate_configurations:
                init = warm.get_model(cid) if warm is not None else None
                coordinates[cid] = self.build_coordinate(
                    cid, datasets[cid], opt_configs[cid], base_offsets, initial_model=init
                )
                if init is not None:
                    # RE rows are matched by entity id, not by position
                    init_models[cid] = (
                        init.aligned_to(datasets[cid])
                        if isinstance(init, RandomEffectModel)
                        else init
                    )
            descent = run_coordinate_descent(
                coordinates,
                n_iterations=self.n_iterations,
                initial_models=init_models or None,
                validation_datasets=validation_datasets,
                evaluation_suite=suite,
                checkpointer=self.checkpointer(i, opt_configs, data.n, validation_data),
            )
            results.append(_result(descent, opt_configs, suite))
            warm = descent.best_model  # chain warm starts across the sweep
        return results

    def _fit_fused(
        self,
        datasets: dict[str, object],
        validation_data: Optional[GameInput],
        initial_model: Optional[GameModel],
    ) -> list[GameResult]:
        """Sweep through the flagship pass (estimators/fused_backend.py).

        Warm starts chain across sweep configurations as params: the
        datasets are the same across configurations, so the previous
        configuration's (best) parameters are the next one's starting point."""
        if initial_model is not None:
            raise ValueError("fused_pass does not support initial_model; use the host backend")
        sweep = expand_game_configurations(self.coordinate_configurations)
        for opt_configs in sweep:
            reasons = fused_pass_ineligibilities(self, opt_configs)
            if reasons:
                raise ValueError(
                    "configuration not eligible for the fused pass: "
                    + "; ".join(reasons)
                    + " (set fused_pass=False for the host backend)"
                )

        validation_datasets = suite = None
        if validation_data is not None:
            validation_datasets = self.prepare_scoring_datasets(validation_data)
            suite = self.prepare_evaluation_suite(validation_data)

        # the ShardedGameData is the same across sweep configurations: build it once
        coord_ids = list(self.coordinate_configurations)
        fe = datasets[coord_ids[0]].data
        sharded = build_sharded_game_data(
            fe.X, fe.labels, [datasets[c] for c in coord_ids[1:]],
            offsets=fe.offsets, weights=fe.weights, dtype=self.dtype, device=self.device,
        )
        logger.info("GAME fused-pass sweep: %d configurations x %d coordinates",
                    len(sweep), len(coord_ids))
        results: list[GameResult] = []
        warm_params = None
        for i, opt_configs in enumerate(sweep):
            descent, warm_params = run_fused_game_descent(
                self, datasets, opt_configs, validation_datasets, suite, sharded, warm_params,
                checkpointer=self.checkpointer(i, opt_configs, fe.n, validation_data),
            )
            results.append(_result(descent, opt_configs, suite))
        return results

    def checkpointer(self, index: int, opt_configs, n_train: int,
                     validation_data: Optional[GameInput]):
        """The CoordinateDescentCheckpointer of sweep configuration ``index``
        under ``<checkpoint_directory>/config_<index>``, or None without a
        checkpoint directory.

        Its fingerprint ties the checkpoint to (task, data sizes, evaluators,
        this configuration), as in the JAX estimator, plus the solver
        identity: the backend (host loop or fused pass) and whether the fused
        kernels run. A rerun that changes any of them starts fresh instead of
        resuming from state that neither path would have produced."""
        if self.checkpoint_directory is None:
            return None
        from photon_ml_tpu_torch.ops.fused_glm import fused_enabled

        fp_parts = [
            str(TaskType(self.task).value),
            str(n_train),
            f"val={validation_data.n if validation_data is not None else 0}",
            f"evals={[evaluator_spec_name(e) for e in self.validation_evaluators]}",
            f"re_solver={self.re_solver}",
            f"re_precision={resolve_precision(self.re_precision).name}",
            f"fused_pass={bool(self.fused_pass)}",
            f"fused_kernels={fused_enabled()}",
        ]
        for cid in sorted(self.coordinate_configurations):
            fp_parts.append(f"{cid}={opt_configs[cid]!r}")
        return CoordinateDescentCheckpointer(
            os.path.join(self.checkpoint_directory, f"config_{index}"),
            interval=self.checkpoint_interval,
            dtype=self.dtype,
            fingerprint="|".join(fp_parts),
            keep_generations=self.checkpoint_keep_generations,
            device=self.device,
        )

    def select_best_model(self, results: Sequence[GameResult]) -> GameResult:
        """Best result by primary validation metric (GameTrainingDriver
        selectBestModel:683-748); without validation, the last result."""
        with_metric = [r for r in results if r.best_metric is not None]
        if not with_metric:
            return results[-1]
        primary = resolve_evaluator(
            (list(self.validation_evaluators) or [default_evaluator_type(self.task)])[0]
        )
        best = with_metric[0]
        for r in with_metric[1:]:
            if primary.better_than(r.best_metric, best.best_metric):
                best = r
        return best


def _result(descent: CoordinateDescentResult, opt_configs, suite) -> GameResult:
    evaluations = None
    if suite is not None and (descent.metrics_history or descent.best_metrics):
        # the metrics of the best snapshot: the history row that set best_metric
        evaluations = (
            descent.best_metrics
            if descent.best_metrics is not None
            else descent.metrics_history[-1][2]
        )
    return GameResult(
        model=descent.model,
        best_model=descent.best_model,
        configuration=opt_configs,
        evaluations=evaluations,
        best_metric=descent.best_metric,
        descent=descent,
    )
