"""Block coordinate descent over GAME coordinates.

Port of photon_ml_tpu/algorithm/coordinate_descent.py (photon-lib
algorithm/CoordinateDescent.scala:38-347). Every coordinate's score is a
dense [N] tensor over the global sample axis, so the residual trick
``partialScore = fullTrainingScore - ownScore`` (CoordinateDescent.scala:
197-204) is elementwise subtraction.

Best-model selection on the primary validation evaluator follows
CoordinateDescent.scala:292-325: after every coordinate update the full
validation score is evaluated and the best GAME model snapshot kept. Locked
coordinates (partial retrain) contribute scores but are never updated.

The divergence guard runs on the device: an update whose coefficients (or
fixed-effect objective) are not finite is rejected by a ``torch.where``
select of the previous model against the new one, and the decisions of an
iteration are read to the host in one transfer at its end
(``defer_guard=True``). A validating run reads each decision right after its
update instead, so that a rejected update skips validation. Every host read
of the loop goes through ``device.to_host`` and is counted there.

``checkpointer`` (io/checkpoint.CoordinateDescentCheckpointer) saves the
models, the best-model snapshot and the incident history after every
completed iteration, and a rerun with the same checkpointer resumes from the
last completed one. Training scores are recomputed from the restored models,
and the measured ``re_solver="auto"`` records ride the manifest's ``extra``
and are seeded back on restore, so a resumed run is bit-identical to an
uninterrupted one.

Not ported yet: active-set delta updates (A13, continuous training) raise.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Mapping, Optional

import torch

from photon_ml_tpu_torch.algorithm.coordinate import (
    Coordinate,
    coefficient_arrays,
    score_model_on_dataset,
)
from photon_ml_tpu_torch.device import to_host
from photon_ml_tpu_torch.evaluation.evaluators import EvaluationSuite
from photon_ml_tpu_torch.models.game import FixedEffectModel, GameModel, RandomEffectModel
from photon_ml_tpu_torch.resilience import Incident, faultpoint, register_fault_point

Tensor = torch.Tensor

logger = logging.getLogger(__name__)

# armed as coord.update.<coordinate_id> (hierarchical match)
FP_COORD_UPDATE = register_fault_point("coord.update")


def _device_guard(model, tracker) -> tuple:
    """The divergence guard's inputs as DEVICE scalars, no host read here:
    ``(coefs_ok, value_ok, final_value)``, that is all coefficient tensors
    finite, the solver's final objective finite (None when the tracker has
    no final value, as random-effect trackers), and the raw final value for
    the incident message."""
    flags = [torch.isfinite(a).all() for a in coefficient_arrays(model)]
    coefs_ok = flags[0] if len(flags) == 1 else torch.stack(flags).all()
    final_value = getattr(tracker, "final_value", None)
    value_ok = None if final_value is None else torch.isfinite(final_value)
    return coefs_ok, value_ok, final_value


def _read_guards(guards: list) -> list:
    """Every guard's scalars on the host, in one transfer."""
    host = iter(to_host(*[t for g in guards for t in g if t is not None]))
    return [tuple(None if t is None else next(host) for t in g) for g in guards]


def _guard_cause(coefs_ok, value_ok, final_value) -> Optional[str]:
    """Host-side reject cause from read guard values: the solver's final
    objective value blew up, or the coefficients it emitted contain NaN/Inf."""
    if value_ok is not None and not bool(value_ok):
        return f"training objective is non-finite ({float(final_value)})"
    if not bool(coefs_ok):
        return "solver emitted non-finite coefficients"
    return None


def _select_variances(ok, new_var, prev_var):
    """Keep the previous variances on a rejected update. When the previous
    model had none, the device-side reject value is zeros and the host-side
    reject handling strips the field back to None (_strip_variances)."""
    if new_var is None:
        return None
    if prev_var is not None:
        return torch.where(ok, new_var, prev_var)
    return torch.where(ok, new_var, torch.zeros_like(new_var))


def _has_variances(model) -> bool:
    if isinstance(model, RandomEffectModel):
        return model.variances is not None
    if isinstance(model, FixedEffectModel):
        return model.model.coefficients.variances is not None
    return False


def _strip_variances(model):
    """Drop the variance field of a rejected update whose previous model had
    none (zero variances would read as infinite confidence)."""
    if isinstance(model, RandomEffectModel) and model.variances is not None:
        return dataclasses.replace(model, variances=None)
    if (
        isinstance(model, FixedEffectModel)
        and model.model.coefficients.variances is not None
    ):
        coef = dataclasses.replace(model.model.coefficients, variances=None)
        return dataclasses.replace(
            model, model=dataclasses.replace(model.model, coefficients=coef)
        )
    return model


def _select_update(ok, new_model, prev_model):
    """Device-side reject for coordinates without an in-program guard:
    ``where(ok, new, prev)`` on the coefficient (and variance) tensors, so the
    loop never reads ``ok`` to keep the previous model's values bit for bit."""
    if isinstance(new_model, FixedEffectModel):
        glm = new_model.model
        prev_coef = prev_model.model.coefficients
        coef = dataclasses.replace(
            glm.coefficients,
            means=torch.where(ok, glm.coefficients.means, prev_coef.means),
            variances=_select_variances(
                ok, glm.coefficients.variances, prev_coef.variances
            ),
        )
        return dataclasses.replace(
            new_model, model=dataclasses.replace(glm, coefficients=coef)
        )
    if isinstance(new_model, RandomEffectModel):
        coeffs = torch.where(ok, new_model.coeffs, prev_model.coeffs)
        variances = _select_variances(ok, new_model.variances, prev_model.variances)
        return dataclasses.replace(new_model, coeffs=coeffs, variances=variances)
    raise TypeError(f"Unknown model type: {type(new_model).__name__}")


@dataclasses.dataclass
class _PendingGuard:
    """A deferred divergence decision: the update's guard scalars stay on
    the device until the iteration-end read."""

    iteration: int
    coordinate_id: str
    guard: tuple  # (coefs_ok, value_ok, final_value), device scalars
    # the pre-update model carried no variances: on a reject the stored
    # model's device-substituted zero variances are stripped back to None
    prev_had_no_variances: bool = False


def _divergence(cid: str, iteration: int, cause: str) -> Incident:
    incident = Incident(
        kind="divergence",
        cause=cause,
        action="update rejected; previous model kept",
        coordinate_id=cid,
        iteration=iteration,
    )
    logger.warning("iter %d %s", iteration, incident.summary())
    return incident


def _flush_guards(pending: list, incidents: list, models: dict) -> None:
    """ONE transfer for every deferred guard of the iteration, then incident
    records for the rejects (the state itself was already kept previous on
    the device)."""
    if not pending:
        return
    for p, guard in zip(pending, _read_guards([p.guard for p in pending])):
        cause = _guard_cause(*guard)
        if cause is None:
            continue
        if p.prev_had_no_variances:
            models[p.coordinate_id] = _strip_variances(models[p.coordinate_id])
        incidents.append(_divergence(p.coordinate_id, p.iteration, cause))


class AutoRecordsProvider:
    """The descent loop's own ``extra_state_provider``: the coordinates'
    measured ``re_solver="auto"`` records, for the manifest's ``extra``."""

    def __init__(self, coordinates: Mapping[str, Coordinate]):
        self.coordinates = coordinates

    def __call__(self) -> Optional[dict]:
        auto = {}
        for cid, coord in self.coordinates.items():
            stats = getattr(coord, "re_solver_stats", None)
            rec = None if stats is None else stats()
            if rec is not None:
                auto[cid] = rec
        return {"re_solver_auto": auto} if auto else None


def install_extra_state(checkpointer, coordinates: Mapping[str, Coordinate]) -> None:
    """Have every save carry the coordinates' measured ``re_solver="auto"``
    records in the manifest's ``extra``, unless the caller installed a
    provider of its own (an :class:`AutoRecordsProvider` from an earlier run
    is replaced). The fingerprint pins the string "auto", not the
    measurement."""
    provider = getattr(checkpointer, "extra_state_provider", False)
    if provider is None or isinstance(provider, AutoRecordsProvider):
        checkpointer.extra_state_provider = AutoRecordsProvider(coordinates)


def seed_extra_state(restored: dict, coordinates: Mapping[str, Coordinate]) -> None:
    """Seed each coordinate's measured "auto" record from a restored
    manifest's ``extra``, so a resumed run replays the original choices
    bitwise instead of re-measuring against restored warm tables."""
    for cid, rec in ((restored.get("extra") or {}).get("re_solver_auto") or {}).items():
        coord = coordinates.get(cid)
        if coord is not None and hasattr(coord, "seed_solver_decision"):
            coord.seed_solver_decision(rec)


def restore_descent_state(checkpointer, coordinate_ids: list, n_iterations: int,
                          initial_models=None):
    """(start iteration, initial models, restored state or None, incidents)
    from the checkpointer. A checkpoint over other coordinates is ignored; a
    restore that ends in a fresh start keeps the rollback incidents it
    recorded on the way."""
    restored = checkpointer.restore()
    if restored is not None and set(restored["models"]) != set(coordinate_ids):
        logger.warning(
            "Ignoring checkpoint: coordinates %s do not match this run's %s",
            sorted(restored["models"]), sorted(coordinate_ids),
        )
        restored = None
    if restored is None:
        incidents = [Incident.from_dict(d) for d in getattr(checkpointer, "restore_incidents", [])]
        return 0, initial_models, None, incidents
    # incident history survives the crash: a resumed run still knows what its
    # predecessor absorbed (and any restore-time rollback)
    incidents = [Incident.from_dict(d) for d in restored.get("incidents") or []]
    start = restored["completed_iterations"]
    if start > n_iterations:
        logger.warning(
            "Checkpoint has %d completed iterations but only %d were requested; "
            "returning the checkpointed state unchanged (clear the checkpoint "
            "directory to retrain from scratch)", start, n_iterations,
        )
    else:
        logger.info("Resuming coordinate descent from checkpoint: %d/%d iterations done",
                    start, n_iterations)
    return start, restored["models"], restored, incidents


@dataclasses.dataclass
class CoordinateDescentResult:
    """Outcome of one descent run."""

    model: GameModel  # model after the final iteration
    best_model: GameModel  # best by primary validation metric (== model if no validation)
    best_metric: Optional[float]
    metrics_history: list  # [(iteration, coordinate_id, {metric: value})]
    trackers: dict  # coordinate_id -> [tracker per update]
    training_scores: dict  # coordinate_id -> final [N] score tensor
    # full metrics dict of the best snapshot
    best_metrics: Optional[dict] = None
    # survived failures (rejected divergent updates): graceful degradation is
    # recorded, never silent
    incidents: list = dataclasses.field(default_factory=list)

    @property
    def has_validation(self) -> bool:
        return self.best_metric is not None


def run_coordinate_descent(
    coordinates: Mapping[str, Coordinate],
    n_iterations: int,
    initial_models: Optional[Mapping[str, object]] = None,
    validation_datasets: Optional[Mapping[str, object]] = None,
    evaluation_suite: Optional[EvaluationSuite] = None,
    checkpointer: Optional[object] = None,
    defer_guard: bool = True,
    active_sets: Optional[Mapping[str, object]] = None,
) -> CoordinateDescentResult:
    """Run block coordinate descent (CoordinateDescent.run/descend:93-346).

    ``coordinates`` is ordered: iteration order is the update sequence.
    Locked coordinates are scored, never updated. ``validation_datasets``
    must cover every coordinate id when ``evaluation_suite`` is given;
    validation scores are summed across coordinates and handed to the suite
    after each update.

    Coordinates offering ``update_and_score`` apply the divergence guard
    inside their update; the others get the loop's device-side guard and a
    ``where``-based reject. Without validation the decisions are read in one
    transfer per iteration (``defer_guard=False`` reads each one after its
    update); with validation each is read after its update, so that rejected
    updates skip validation.

    ``checkpointer`` enables iteration-level recovery: after each completed
    iteration the models and the best-model snapshot are saved, and a rerun
    with the same checkpointer resumes from the last completed iteration
    (overriding ``initial_models``). A checkpoint with more completed
    iterations than ``n_iterations`` is returned unchanged.
    """
    if active_sets is not None:
        raise NotImplementedError(
            "active-set delta updates are not ported yet: ROADMAP A13 (continuous/)"
        )
    if n_iterations < 1:
        raise ValueError(f"n_iterations must be >= 1, got {n_iterations}")
    coordinate_ids = list(coordinates.keys())
    if not coordinate_ids:
        raise ValueError("No coordinates to descend over")
    validate = evaluation_suite is not None
    if validate:
        if validation_datasets is None:
            raise ValueError(
                "evaluation_suite requires validation_datasets covering every coordinate"
            )
        missing = [c for c in coordinate_ids if c not in validation_datasets]
        if missing:
            raise ValueError(f"Missing validation datasets for coordinates {missing}")

    start_iteration, restored, incidents = 0, None, []
    if checkpointer is not None:
        install_extra_state(checkpointer, coordinates)
        start_iteration, initial_models, restored, incidents = restore_descent_state(
            checkpointer, coordinate_ids, n_iterations, initial_models
        )
        if restored is not None:
            seed_extra_state(restored, coordinates)

    # --- initialize models and their training/validation scores -----------------
    models: dict[str, object] = {}
    train_scores: dict[str, Tensor] = {}
    val_scores: dict[str, Tensor] = {}
    for cid, coord in coordinates.items():
        init = None if initial_models is None else initial_models.get(cid)
        if init is not None:
            # adapt external models to the coordinate's dataset: RE models
            # re-align entity rows, FE models move to the data's device
            init = coord.prepare_initial_model(init)
        model = init if init is not None else coord.initialize_model()
        models[cid] = model
        train_scores[cid] = coord.score(model)
        if validate:
            val_scores[cid] = score_model_on_dataset(model, validation_datasets[cid])

    n = {int(s.shape[0]) for s in train_scores.values()}
    if len(n) != 1:
        raise ValueError(f"Coordinate datasets disagree on sample count: {sorted(n)}")

    trackers: dict[str, list] = {cid: [] for cid in coordinate_ids}
    metrics_history: list = []
    best_model: Optional[GameModel] = None
    best_metric: Optional[float] = None
    best_metrics: Optional[dict] = None
    if restored is not None and restored["best_models"] is not None:
        best_model = GameModel(models=restored["best_models"])
        best_metric = restored["best_metric"]
        best_metrics = restored.get("best_metrics")
    primary = evaluation_suite.primary if validate else None

    updatable = [cid for cid in coordinate_ids if not coordinates[cid].is_locked]
    if not updatable:
        raise ValueError("All coordinates are locked; nothing to train")

    # a validating run must know the reject BEFORE scoring validation data
    sync_guard = validate or not defer_guard

    for iteration in range(start_iteration, n_iterations):
        # recompute (not accumulate) the total at each iteration boundary: the
        # state is then a pure function of the models dict, which makes a
        # resumed run (restored models, recomputed scores) bit-identical
        full_train_score = sum(train_scores.values())
        pending: list[_PendingGuard] = []
        for cid in updatable:
            coord = coordinates[cid]
            faultpoint(f"{FP_COORD_UPDATE}.{cid}")
            t0 = time.perf_counter()
            # Residual trick (CoordinateDescent.scala:197-204)
            partial = full_train_score - train_scores[cid]
            prev_model = models[cid]
            prev_had_var = _has_variances(prev_model)
            fused = coord.update_and_score(prev_model, partial, train_scores[cid])
            if fused is not None:
                model, new_score, tracker = fused
                guard_ok = getattr(tracker, "guard_ok", None)
                if guard_ok is None:
                    # the update applied its reject internally and must say
                    # so, or the loop could keep a diverged model while
                    # recording "previous model kept"
                    raise TypeError(
                        f"Coordinate {cid!r}: update_and_score must return a "
                        "tracker exposing the device-side guard_ok flag"
                    )
                guard = (guard_ok, None, None)
                # on a reject the returned tensors hold the previous values
                models[cid] = model
                train_scores[cid] = new_score
            else:
                model, tracker = coord.update_model(prev_model, partial)
                guard = _device_guard(model, tracker)
            trackers[cid].append(tracker)

            if sync_guard:
                cause = _guard_cause(*_read_guards([guard])[0])
                if cause is not None:
                    # REJECT the update: the previous model for this
                    # coordinate is kept (scores unchanged), an incident is
                    # recorded, and the descent goes on over the remaining
                    # coordinates; full_train_score stays the pre-update total
                    incidents.append(_divergence(cid, iteration, cause))
                    if fused is not None and not prev_had_var:
                        models[cid] = _strip_variances(models[cid])
                    continue
                if fused is None:
                    models[cid] = model
                    new_score = coord.score(model)
                    train_scores[cid] = new_score
                full_train_score = partial + new_score
            else:
                if fused is None:
                    # device-side reject: keep the previous values without
                    # reading the flag (scoring the selected model reproduces
                    # the previous score bit for bit on a reject)
                    ok = guard[0] if guard[1] is None else torch.logical_and(*guard[:2])
                    model = _select_update(ok, model, prev_model)
                    models[cid] = model
                    new_score = coord.score(model)
                    train_scores[cid] = new_score
                full_train_score = partial + new_score
                pending.append(
                    _PendingGuard(iteration, cid, guard, prev_had_no_variances=not prev_had_var)
                )

            if logger.isEnabledFor(logging.INFO):
                # summary() reads device trackers: only pay the read when the
                # log line is actually emitted
                logger.info(
                    "iter %d coordinate %s: %s (%.2fs)",
                    iteration, cid, tracker.summary(), time.perf_counter() - t0,
                )

            if validate:
                val_scores[cid] = score_model_on_dataset(models[cid], validation_datasets[cid])
                metrics = evaluation_suite.evaluate(sum(val_scores.values()))
                metrics_history.append((iteration, cid, metrics))
                metric = metrics[primary.name]
                logger.info("iter %d coordinate %s: validation %s", iteration, cid, metrics)
                if primary.better_than(metric, best_metric):
                    best_metric = metric
                    best_metrics = metrics
                    # models are never changed in place: a dict copy snapshots them
                    best_model = GameModel(models=dict(models))

        _flush_guards(pending, incidents, models)

        if checkpointer is not None:
            checkpointer.maybe_save(
                iteration + 1,
                dict(models),
                None if best_model is None else dict(best_model.models),
                best_metric,
                best_metrics,
                force=(iteration + 1 == n_iterations),
                incidents=incidents,
            )

    # the trackers' device scalars, read now, outside the loop. Probe the
    # CLASS: LazyRandomEffectTracker reads its stats on any attribute access
    for tracker_list in trackers.values():
        for t in tracker_list:
            materialize = getattr(type(t), "materialize", None)
            if materialize is not None:
                materialize(t)

    final_model = GameModel(models=dict(models))
    if best_model is None:
        best_model = final_model
    return CoordinateDescentResult(
        model=final_model,
        best_model=best_model,
        best_metric=best_metric,
        metrics_history=metrics_history,
        trackers=trackers,
        training_scores=dict(train_scores),
        best_metrics=best_metrics,
        incidents=incidents,
    )
