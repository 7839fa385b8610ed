"""The slice as a whole: the port's GameEstimator.fit against the JAX package's.

Workload: ``interop.make_glmix_split`` at 3,000 training + 600 validation
rows, 16 fixed-effect columns, 60 users and 15 items, RE features =
intercept + 3 columns; logistic loss, L2 1.0, L-BFGS with FE 50 and RE 30
iterations, 2 coordinate-descent iterations, validation AUC. Both packages
get the same numpy arrays.

- Host loop at f64 against the JAX estimator's per-bucket path
  (``re_update_program=False``; its update program's bitwise contract fails
  on this runtime, ROADMAP §C), over a two-weight L2 sweep of the fixed
  effect with warm starts chained: FE coefficients and RE tables (atol
  1e-9), FE iterations and reasons, RE reason counts and iteration
  means and maxima (equal), every validation AUC (atol 1e-9), and the same
  configuration chosen by ``select_best_model``.
- The same fit at f32 with the fused switch on both sides: JAX runs its
  Pallas kernel in interpret mode, the port kernel B1's plain version. At
  f32 the default tolerance 1e-7 sits on the noise floor of the
  convergence test, where the two packages may end a solve one iteration
  apart (ROADMAP §C); the solves here stop at 1e-4, above that floor, so
  iterations and reasons are held equal; coefficients atol 1e-5, AUC atol
  1e-6.
- ``fused_pass=True`` against JAX's fused pass at f64: models, the final
  pass's FE iterations and every per-pass AUC.
- Both packages warm-started from the same model (a port model carried to
  JAX through ``interop.game_model_to_numpy``) fit alike.
- The knobs ported with OWL-QN, LBFGSB, the direct solves and feature
  normalization (normalization, re_solver, box constraints, L1, elastic
  net) fit as the JAX estimator does, host loop at f64 (the three fits of
  chip_smoke.py's phase 11c among them); a checkpointed fit with
  ``re_solver="auto"``, crashed and resumed, equals the whole fit bitwise.
- Every knob of a later slice raises ``NotImplementedError`` naming its
  ROADMAP item, and an ineligible fused pass raises with its reasons.
"""

import contextlib
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.data.game_data import GameInput as JInput
from photon_ml_tpu.estimators import CoordinateConfiguration as JCC
from photon_ml_tpu.estimators import FixedEffectDataConfiguration as JFE
from photon_ml_tpu.estimators import GameEstimator as JEstimator
from photon_ml_tpu.estimators import RandomEffectDataConfiguration as JRE
from photon_ml_tpu.models.game import FixedEffectModel as JFEModel
from photon_ml_tpu.models.game import GameModel as JGameModel
from photon_ml_tpu.models.game import RandomEffectModel as JREModel
from photon_ml_tpu.models.glm import Coefficients as JCoef
from photon_ml_tpu.models.glm import model_class_for_task as jmodel_class
from photon_ml_tpu.ops import pallas_glm
from photon_ml_tpu.optimization.common import OptimizerConfig as JOpt
from photon_ml_tpu.optimization.config import GLMOptimizationConfiguration as JCfg
from photon_ml_tpu.optimization.config import RegularizationContext as JReg
from photon_ml_tpu.types import RegularizationType as JRT
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch import interop
from photon_ml_tpu_torch.data.projector import ProjectorConfig, ProjectorType
from photon_ml_tpu_torch.estimators import (
    CoordinateConfiguration,
    FixedEffectDataConfiguration,
    GameEstimator,
    RandomEffectDataConfiguration,
)
from photon_ml_tpu_torch.normalization import NormalizationContext
from photon_ml_tpu_torch.ops import fused_glm
from photon_ml_tpu_torch.optimization.common import OptimizerConfig
from photon_ml_tpu_torch.optimization.config import (
    GLMOptimizationConfiguration,
    RegularizationContext,
)
from photon_ml_tpu_torch.types import RegularizationType, TaskType

SPLIT = dict(seed=42, n_train=3000, n_validation=600, n_features=16, n_users=60, n_items=15,
             re_fe_cols=3)
COORDS = ("global", "per-user", "per-item")


@contextlib.contextmanager
def pallas_interpret():
    """The JAX fused kernels on, in interpret mode, prior state restored."""
    prev = os.environ.get("PHOTON_PALLAS_INTERPRET")
    os.environ["PHOTON_PALLAS_INTERPRET"] = "1"
    try:
        with pallas_glm.pallas_override(True):
            yield
    finally:
        if prev is None:
            del os.environ["PHOTON_PALLAS_INTERPRET"]
        else:
            os.environ["PHOTON_PALLAS_INTERPRET"] = prev


def _configs(pkg, tolerance=1e-7, reg_weights=()):
    """The same coordinate configurations in the JAX package (``pkg="jax"``)
    or the port."""
    if pkg == "jax":
        cc, fe, re, cfg, opt, reg, rt = JCC, JFE, JRE, JCfg, JOpt, JReg, JRT
    else:
        cc, fe, re = CoordinateConfiguration, FixedEffectDataConfiguration, RandomEffectDataConfiguration
        cfg, opt, reg, rt = GLMOptimizationConfiguration, OptimizerConfig, RegularizationContext, RegularizationType

    def c(iters):
        return cfg(opt(max_iterations=iters, tolerance=tolerance), reg(rt.L2), 1.0)

    return {"global": cc(fe("global"), c(50), reg_weights=reg_weights),
            "per-user": cc(re("userId", "re"), c(30)),
            "per-item": cc(re("itemId", "re"), c(30))}


def _inputs():
    tr, va = interop.make_glmix_split(**SPLIT)

    def jin(wl):
        return JInput(features={"global": wl["fe_X"], "re": wl["re_features"]},
                      labels=wl["labels"], id_columns={"userId": wl["users"], "itemId": wl["items"]})

    return (jin(tr), jin(va)), (interop.glmix_game_input(tr), interop.glmix_game_input(va))


def _fit(pkg, inputs, dtype, initial_model=None, tolerance=1e-7, reg_weights=(), **kw):
    train, val = inputs
    if pkg == "jax":
        est = JEstimator(task=JTask.LOGISTIC_REGRESSION,
                         coordinate_configurations=_configs("jax", tolerance, reg_weights),
                         n_iterations=2, validation_evaluators=["AUC"], dtype=dtype, **kw)
    else:
        est = GameEstimator(task=TaskType.LOGISTIC_REGRESSION,
                            coordinate_configurations=_configs("port", tolerance, reg_weights),
                            n_iterations=2, validation_evaluators=["AUC"], dtype=dtype,
                            device="cpu", **kw)
    results = est.fit(train, validation_data=val, initial_model=initial_model)
    return results, est.select_best_model(results)


def _table(model, cid):
    m = model.get_model(cid)
    t = m.model.coefficients.means if cid == "global" else m.coeffs
    return np.asarray(t) if not isinstance(t, torch.Tensor) else t.numpy()


def _compare(jres, tres, coef_atol, auc_atol, iterations=True):
    assert len(jres) == len(tres)
    for j, t in zip(jres, tres):
        assert {c: w.regularization_weight for c, w in t.configuration.items()} == \
            {c: w.regularization_weight for c, w in j.configuration.items()}
        for cid in COORDS:
            if cid != "global":
                assert t.model.get_model(cid).entity_ids == j.model.get_model(cid).entity_ids
            np.testing.assert_allclose(_table(t.model, cid), _table(j.model, cid),
                                       rtol=0, atol=coef_atol, err_msg=cid)
            if not iterations:
                continue
            for jt, tt in zip(j.descent.trackers[cid], t.descent.trackers[cid], strict=True):
                if cid == "global":
                    assert (tt.convergence_reason, tt.iterations) == \
                        (jt.convergence_reason, jt.iterations)
                else:
                    assert tt.convergence_reason_counts == jt.convergence_reason_counts
                    assert (tt.iterations_mean, tt.iterations_max) == \
                        (jt.iterations_mean, jt.iterations_max)
        jh, th = j.descent.metrics_history, t.descent.metrics_history
        assert [(i, c) for i, c, _ in th] == [(i, c) for i, c, _ in jh]
        np.testing.assert_allclose([m["AUC"] for *_, m in th], [m["AUC"] for *_, m in jh],
                                   atol=auc_atol)
        np.testing.assert_allclose(t.best_metric, j.best_metric, atol=auc_atol)


def test_host_loop_fit_and_sweep_match_jax():
    (jin, tin) = _inputs()
    jres, jbest = _fit("jax", jin, jnp.float64, reg_weights=(1.0, 10.0), re_update_program=False)
    tres, tbest = _fit("port", tin, torch.float64, reg_weights=(1.0, 10.0))
    # sorted descending: 10.0 first, then 1.0 warm-started from its best model
    assert [r.configuration["global"].regularization_weight for r in tres] == [10.0, 1.0]
    _compare(jres, tres, coef_atol=1e-9, auc_atol=1e-9)
    assert tres.index(tbest) == jres.index(jbest)
    assert tbest.evaluations == pytest.approx(jbest.evaluations, abs=1e-9)
    assert 0.7 < tbest.best_metric < 1.0


def test_fused_switch_fit_matches_jax():
    (jin, tin) = _inputs()
    with pallas_interpret():
        assert pallas_glm.should_fuse(SPLIT["n_features"])
        jres, _ = _fit("jax", jin, jnp.float32, tolerance=1e-4, re_update_program=False)
    calls = fused_glm.fused_loss_grad_sums_plain.calls
    with fused_glm.fused_override(True):
        tres, _ = _fit("port", tin, torch.float32, tolerance=1e-4)
    assert fused_glm.fused_loss_grad_sums_plain.calls > calls  # B1's route was taken
    assert tres[0].model.get_model("global").model.coefficients.means.dtype == torch.float32
    _compare(jres, tres, coef_atol=1e-5, auc_atol=1e-6)


def test_fused_pass_matches_jax():
    (jin, tin) = _inputs()
    jres, _ = _fit("jax", jin, jnp.float64, fused_pass=True)
    tres, _ = _fit("port", tin, torch.float64, fused_pass=True)
    _compare(jres, tres, coef_atol=1e-9, auc_atol=1e-9, iterations=False)
    # one validation row per pass, and the final pass's FE iterations
    assert len(tres[0].descent.metrics_history) == 2
    (jt,), (tt,) = jres[0].descent.trackers["global"], tres[0].descent.trackers["global"]
    assert tt.iterations == jt.iterations and tt.final_value == pytest.approx(jt.final_value)
    for cid in COORDS[1:]:
        e = len(tres[0].model.get_model(cid).entity_ids)
        assert _table(tres[0].model, cid).shape[0] == e  # the junk row is dropped


def test_warm_start_from_the_same_model_matches_jax():
    """A port model, carried to JAX as numpy records, warm-starts both."""
    (jin, tin) = _inputs()
    est = GameEstimator(task=TaskType.LOGISTIC_REGRESSION,
                        coordinate_configurations=_configs("port"), n_iterations=1,
                        dtype=torch.float64, device="cpu")
    records = interop.game_model_to_numpy(est.fit(tin[0])[0].model)
    jmodels = {}
    for cid, r in records.items():
        if r["kind"] == "fixed":
            glm = jmodel_class(JTask.LOGISTIC_REGRESSION)(JCoef(jnp.asarray(r["means"])))
            jmodels[cid] = JFEModel(glm, r["feature_shard_id"])
        else:
            jmodels[cid] = JREModel(r["re_type"], r["feature_shard_id"], JTask.LOGISTIC_REGRESSION,
                                    r["entity_ids"], jnp.asarray(r["coeffs"]),
                                    jnp.asarray(r["proj_indices"]))
    jres, _ = _fit("jax", jin, jnp.float64, initial_model=JGameModel(jmodels),
                   re_update_program=False)
    tres, _ = _fit("port", tin, torch.float64,
                   initial_model=interop.game_model_from_numpy(records, device="cpu"))
    _compare(jres, tres, coef_atol=1e-9, auc_atol=1e-9)


def _port_estimator(**kw):
    configs = kw.pop("configs", None) or _configs("port")
    return GameEstimator(task=TaskType.LOGISTIC_REGRESSION, coordinate_configurations=configs,
                         device="cpu", **kw)


def _with(cid, **changes):
    import dataclasses

    configs = _configs("port")
    configs[cid] = dataclasses.replace(configs[cid], **changes)
    return configs


def _intercept_inputs():
    """The split with an intercept column in front of the fixed-effect shard
    (standardization needs one), in both packages."""
    (jin, tin) = _inputs()

    def add(gi):
        X = np.asarray(gi.features["global"])
        features = dict(gi.features, **{"global": np.hstack([np.ones((len(X), 1), X.dtype), X])})
        return dataclasses.replace(gi, features=features)

    return tuple(add(g) for g in jin), tuple(add(g) for g in tin)


def _standardization(train, pkg):
    """STANDARDIZATION contexts of the two shards (intercept at column 0)."""
    from photon_ml_tpu.normalization import FeatureDataStatistics as JStats
    from photon_ml_tpu.normalization import NormalizationContext as JNorm
    from photon_ml_tpu.types import NormalizationType as JNT
    from photon_ml_tpu_torch.normalization import FeatureDataStatistics
    from photon_ml_tpu_torch.types import NormalizationType

    out = {}
    for shard in ("global", "re"):
        X = train.features[shard]
        if pkg == "jax":
            out[shard] = JNorm.build(JNT.STANDARDIZATION, JStats.compute(X, intercept_index=0))
        else:
            out[shard] = NormalizationContext.build(
                NormalizationType.STANDARDIZATION,
                FeatureDataStatistics.compute(X, intercept_index=0))
    return out


def _fe_bounds(d):
    """Box bounds from a constraint string over the fixed effect's index map:
    the first half of the features within +-0.1."""
    from photon_ml_tpu_torch.optimization.constraints import build_bound_vectors

    text = json.dumps([{"name": f"f{j}", "term": "", "lowerBound": -0.1, "upperBound": 0.1}
                       for j in range(d // 2)])
    return build_bound_vectors(text, interop.glmix_index_maps(n_features=d)["global"])


def _reconfigure(configs, pkg, cid, opt=None, reg=None, alpha=None, weight=1.0, **changes):
    """``configs[cid]`` with another optimizer and regularization and other
    CoordinateConfiguration fields, in either package."""
    if pkg == "jax":
        cfg, optc, regc, rt = JCfg, JOpt, JReg, JRT
    else:
        cfg, optc, regc, rt = GLMOptimizationConfiguration, OptimizerConfig, RegularizationContext, \
            RegularizationType
    old = configs[cid].optimization_config
    if opt is not None or reg is not None:
        changes["optimization_config"] = cfg(
            optc(optimizer_type=opt or old.optimizer_config.optimizer_type.value,
                 max_iterations=old.optimizer_config.max_iterations,
                 tolerance=old.optimizer_config.tolerance),
            regc(rt(reg or "L2"), alpha), weight)
    return dict(configs, **{cid: dataclasses.replace(configs[cid], **changes)})


def _knob_fit(pkg, knob, inputs):
    """The fit of a knob's parity case in either package (host loop, f64;
    JAX on its per-bucket path)."""
    configs = _configs(pkg)
    kw = {}
    if knob == "normalization":  # a NEWTON FE, both shards standardized, RE "auto"
        configs = _reconfigure(configs, pkg, "global", opt="NEWTON")
        kw = {"normalization_contexts": _standardization(inputs[0], pkg), "re_solver": "auto"}
    elif knob == "re_solver":
        kw = {"re_solver": "direct"}
    elif knob == "box_constraints":  # LBFGSB FE in a box that binds
        configs = _reconfigure(configs, pkg, "global", opt="LBFGSB",
                               box_constraints=_fe_bounds(SPLIT["n_features"]))
    elif knob == "l1":
        for cid in ("global", "per-user"):
            configs = _reconfigure(configs, pkg, cid, opt="OWLQN", reg="L1", weight=10.0)
    elif knob == "elastic_net":  # an OWLQN elastic-net FE, RE "direct"
        configs = _reconfigure(configs, pkg, "global", opt="OWLQN", reg="ELASTIC_NET", alpha=0.5,
                               weight=20.0)
        kw = {"re_solver": "direct"}
    if pkg == "jax":
        kw["re_update_program"] = False
        est = JEstimator(task=JTask.LOGISTIC_REGRESSION, coordinate_configurations=configs,
                         n_iterations=2, validation_evaluators=["AUC"], dtype=jnp.float64, **kw)
    else:
        est = _port_estimator(configs=configs, n_iterations=2, validation_evaluators=["AUC"],
                              dtype=torch.float64, **kw)
    return est.fit(inputs[0], validation_data=inputs[1])


OUT_OF_SLICE = {
    "fe_storage_dtype": ({"fe_storage_dtype": torch.bfloat16}, "A8"),
    "re_storage_dtype": ({"re_storage_dtype": torch.bfloat16}, "A8"),
    "re_precision": ({"re_precision": "bf16"}, "A13"),
    "re_working_set_rows": ({"re_working_set_rows": 64}, "A13"),
    "normalization": None,
    "re_solver": None,
    "down_sampling": ({"configs": _with("global", down_sampling_rate=0.5)}, "A14"),
    "box_constraints": None,
    "l1": None,
    "elastic_net": None,
}


@pytest.mark.parametrize("knob", list(OUT_OF_SLICE))
def test_out_of_slice_knobs_raise(knob):
    """A knob of a later slice raises naming its ROADMAP item; a knob the
    port carries (None here) fits as the JAX estimator does, host loop at
    f64: coefficients (atol 1e-9), FE iterations and reasons, RE
    reason counts and iteration statistics, and every validation AUC
    (1e-9). The normalization, elastic-net and box cases are the three fits
    of chip_smoke.py's phase 11c at a small size."""
    if OUT_OF_SLICE[knob] is not None:
        kw, item = OUT_OF_SLICE[knob]
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            _port_estimator(**kw)
        return
    jin, tin = _intercept_inputs() if knob == "normalization" else _inputs()
    jres, tres = _knob_fit("jax", knob, jin), _knob_fit("port", knob, tin)
    _compare(jres, tres, coef_atol=1e-9, auc_atol=1e-9)
    fe = _table(tres[0].model, "global")
    if knob == "box_constraints":
        lo, hi = _fe_bounds(SPLIT["n_features"])
        assert np.all(fe >= lo) and np.all(fe <= hi) and np.any(np.abs(fe[:8]) == 0.1)
    if knob in ("l1", "elastic_net"):
        assert np.any(fe == 0.0)


def test_checkpointed_auto_fit_resumes_bitwise(tmp_path, monkeypatch):
    """Phase 11c(i) on the CPU: the normalized NEWTON + "auto" fit,
    checkpointed, crashed by ``coord.update:crash:4`` (the first update of
    iteration 2) and resumed, equals the whole fit bitwise, its "auto"
    record included; the record was read back, not measured again."""
    from photon_ml_tpu_torch.algorithm import coordinate as tcoord
    from photon_ml_tpu_torch.resilience import InjectedCrash, armed

    _, (train, val) = _intercept_inputs()
    probes = []
    real = tcoord.measure_auto_solvers

    def counting(*a, **k):
        probes.append(None)
        return real(*a, **k)

    def fit(ckpt):
        configs = _reconfigure(_configs("port"), "port", "global", opt="NEWTON")
        est = _port_estimator(configs=configs, n_iterations=2, validation_evaluators=["AUC"],
                              dtype=torch.float64, re_solver="auto", checkpoint_directory=ckpt,
                              normalization_contexts=_standardization(train, "port"))
        return est.fit(train, validation_data=val)[0]

    monkeypatch.setattr(tcoord, "measure_auto_solvers", counting)
    whole = fit(str(tmp_path / "a"))
    assert len(probes) == 2  # one probe per random-effect coordinate
    with pytest.raises(InjectedCrash):
        with armed("coord.update:crash:4"):
            fit(str(tmp_path / "b"))
    probes.clear()
    resumed = fit(str(tmp_path / "b"))
    assert probes == []  # the record came from the checkpoint
    for cid in COORDS:
        assert np.array_equal(_table(whole.model, cid), _table(resumed.model, cid)), cid
        assert np.array_equal(_table(whole.best_model, cid), _table(resumed.best_model, cid)), cid
    assert whole.best_metric == resumed.best_metric
    from photon_ml_tpu_torch.io.checkpoint import load_checkpoint

    extra = [load_checkpoint(str(tmp_path / d / "config_0"), device="cpu")["extra"]
             for d in ("a", "b")]
    assert extra[0] == extra[1] and set(extra[0]["re_solver_auto"]) == {"per-user", "per-item"}


def test_random_projection_and_active_data_caps_raise_at_fit():
    (_, (train, _)) = _inputs()
    for dc in (RandomEffectDataConfiguration("userId", "re", projector=ProjectorConfig(
                   ProjectorType.RANDOM_PROJECTION, projected_dim=2)),
               RandomEffectDataConfiguration("userId", "re", active_data_upper_bound=10)):
        est = _port_estimator(configs=_with("per-user", data_config=dc))
        with pytest.raises(NotImplementedError, match="ROADMAP A8"):
            est.fit(train)


def test_ineligible_fused_pass_raises_with_reasons():
    (_, (train, _)) = _inputs()
    configs = _configs("port")
    configs = {"per-user": configs["per-user"], "global": configs["global"]}
    est = _port_estimator(configs=configs, fused_pass=True)
    with pytest.raises(ValueError, match="first coordinate must be the fixed effect"):
        est.fit(train)
    est = _port_estimator(configs=_with("per-user", per_entity_reg_weights={0: 2.0}),
                          fused_pass=True)
    with pytest.raises(ValueError, match="per-entity regularization weights"):
        est.fit(train)
