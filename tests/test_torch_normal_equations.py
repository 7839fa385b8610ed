"""The port's direct random-effect solves and measured ``re_solver="auto"``
against the JAX package's.

Mirrors the host-loop cases of tests/test_normal_equations.py: the parity
matrix (four GLM families x raw/standardized x uniform/per-entity L2), the
linear closed form, variances, warm starts, the static "auto" rule, L1
fallback, determinism, the divergence guard on singular and NaN-poisoned
Gram systems, and the measured "auto" record (its probe, a seeded record
honoured bitwise, its round trip through a checkpoint's ``extra``, L1, the
per-bucket plan). Inputs are built from a numpy seed and fed to both
packages at f64: ``minimize_direct`` agrees with JAX's within 1e-9 on
every family (the closed form, and three capped Newton steps), and the
"auto" record equals JAX's per shape, iteration means and choice. Run to
its tolerance, a Newton/IRLS lane stops on the relative objective change,
and whether its last step of ~1e-8 is taken can turn on f64 rounding; the
parity matrix holds those families at 1e-7 (the noise floor of the
convergence test, ROADMAP C) and the closed form at 1e-9. The continuous and
active-set cases wait for the continuous-training port.
"""

import glob
import hashlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu.algorithm import random_effect as jre
from photon_ml_tpu.data.random_effect import build_random_effect_dataset as j_build
from photon_ml_tpu.normalization import FeatureDataStatistics as JStats
from photon_ml_tpu.normalization import NormalizationContext as JNorm
from photon_ml_tpu.optimization.common import OptimizerConfig as JOpt
from photon_ml_tpu.optimization.config import GLMOptimizationConfiguration as JCfg
from photon_ml_tpu.optimization.config import RegularizationContext as JReg
from photon_ml_tpu.types import NormalizationType as JNT
from photon_ml_tpu.types import RegularizationType as JRT
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch.algorithm import random_effect as tre
from photon_ml_tpu_torch.algorithm.coordinate import RandomEffectCoordinate
from photon_ml_tpu_torch.algorithm.coordinate_descent import run_coordinate_descent
from photon_ml_tpu_torch.data.random_effect import build_random_effect_dataset
from photon_ml_tpu_torch.io.checkpoint import CoordinateDescentCheckpointer
from photon_ml_tpu_torch.normalization import FeatureDataStatistics, NormalizationContext
from photon_ml_tpu_torch.optimization import normal_equations
from photon_ml_tpu_torch.optimization.common import OptimizerConfig
from photon_ml_tpu_torch.optimization.config import (
    GLMOptimizationConfiguration,
    RegularizationContext,
)
from photon_ml_tpu_torch.optimization.solver_cache import bucket_solves
from photon_ml_tpu_torch.types import (
    NormalizationType,
    RegularizationType,
    TaskType,
    VarianceComputationType,
)

ALL_TASKS = [TaskType.LINEAR_REGRESSION, TaskType.LOGISTIC_REGRESSION,
             TaskType.POISSON_REGRESSION, TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM]
N, E, D = 420, 12, 5
F64 = torch.float64


def l2_config(pkg="port", weight=1.0, iters=100, l1=False):
    if pkg == "jax":
        if l1:
            return JCfg(JOpt(optimizer_type="OWLQN", max_iterations=40), JReg(JRT.L1), 0.1)
        return JCfg(JOpt(max_iterations=iters, tolerance=1e-9), JReg(JRT.L2), weight)
    if l1:
        return GLMOptimizationConfiguration(OptimizerConfig(optimizer_type="OWLQN",
                                                            max_iterations=40),
                                            RegularizationContext(RegularizationType.L1), 0.1)
    return GLMOptimizationConfiguration(OptimizerConfig(max_iterations=iters, tolerance=1e-9),
                                        RegularizationContext(RegularizationType.L2), weight)


def make_problem(seed=0, n=N, n_entities=E, d=D):
    rng = np.random.default_rng(seed)
    ents = rng.integers(0, n_entities, size=n)
    X = np.concatenate([np.ones((n, 1)), rng.normal(size=(n, d - 1))], axis=1)
    z = np.einsum("nd,nd->n", X, rng.normal(size=(n_entities, d))[ents])
    labels = {
        TaskType.LINEAR_REGRESSION: z + 0.1 * rng.normal(size=n),
        TaskType.LOGISTIC_REGRESSION: (rng.random(n) < 1.0 / (1.0 + np.exp(-z))).astype(float),
        TaskType.POISSON_REGRESSION: rng.poisson(np.exp(np.clip(0.3 * z, -3, 3))).astype(float),
        TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM: (z > 0).astype(float),
    }
    return sp.csr_matrix(X), ents, labels, rng


def standardization(X, pkg="port"):
    dense = np.asarray(X.todense(), dtype=np.float64)
    if pkg == "jax":
        return JNorm.build(JNT.STANDARDIZATION, JStats.compute(dense, intercept_index=0))
    return NormalizationContext.build(NormalizationType.STANDARDIZATION,
                                      FeatureDataStatistics.compute(dense, intercept_index=0))


def _train(pkg, X, ents, y, task, solver, norm=False, per_entity=None, **kw):
    """One train_random_effect in either package on the same inputs, f64."""
    if pkg == "jax":
        n = standardization(X, "jax") if norm else None
        ds = j_build(X, ents, "e", labels=y, normalization=n, intercept_index=0 if norm else None,
                     dtype=jnp.float64)
        return jre.train_random_effect(ds, JTask(task.value), kw.pop("cfg", l2_config("jax")),
                                       jnp.zeros(len(y)), re_solver=solver, normalization=n,
                                       per_entity_reg_weights=per_entity, **kw)
    n = standardization(X) if norm else None
    ds = build_random_effect_dataset(X, ents, "e", labels=y, normalization=n,
                                     intercept_index=0 if norm else None, dtype=F64, device="cpu")
    return tre.train_random_effect(ds, task, kw.pop("cfg", l2_config()),
                                   torch.zeros(len(y), dtype=F64), re_solver=solver,
                                   normalization=n, per_entity_reg_weights=per_entity, **kw)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("task", ALL_TASKS, ids=lambda t: t.name.lower())
@pytest.mark.parametrize("normalized", [False, True], ids=["raw", "norm"])
@pytest.mark.parametrize("per_entity", [False, True], ids=["uniform-l2", "per-entity-l2"])
def test_direct_matches_lbfgs_optimum(task, normalized, per_entity):
    """The parity matrix: the direct solve agrees with JAX's direct solve
    (closed form 1e-9, Newton/IRLS 1e-7; iteration statistics and reasons
    equal) and with the port's L-BFGS optimum to solver tolerance."""
    X, ents, labels, rng = make_problem(seed=ALL_TASKS.index(task) * 10 + int(normalized))
    pe = ({int(e): float(v) for e, v in enumerate(rng.uniform(0.5, 2.0, size=E))}
          if per_entity else None)
    y = labels[task]
    m_d, t_d = _train("port", X, ents, y, task, "direct", normalized, pe)
    m_l, _ = _train("port", X, ents, y, task, "lbfgs", normalized, pe)
    j_d, jt_d = _train("jax", X, ents, y, task, "direct", normalized, pe)
    atol = 1e-9 if task == TaskType.LINEAR_REGRESSION else 1e-7
    np.testing.assert_allclose(_np(m_d.coeffs), _np(j_d.coeffs), rtol=0, atol=atol)
    assert (t_d.iterations_mean, t_d.iterations_max) == (jt_d.iterations_mean, jt_d.iterations_max)
    assert t_d.convergence_reason_counts == jt_d.convergence_reason_counts
    np.testing.assert_allclose(_np(m_d.coeffs), _np(m_l.coeffs), rtol=2e-2, atol=5e-3)
    assert np.isfinite(_np(m_d.coeffs)).all()


@pytest.mark.parametrize("task", ALL_TASKS, ids=lambda t: t.name.lower())
def test_minimize_direct_matches_jax(task):
    """``minimize_direct`` on one bucket's lanes against JAX's vmapped one:
    the closed form, or three Newton/IRLS steps (tolerance 0, so no lane
    stops on a comparison at rounding level), within 1e-9."""
    from photon_ml_tpu.data.dataset import LabeledData as JData
    from photon_ml_tpu.data.matrix import DenseDesignMatrix as JDense
    from photon_ml_tpu.function.losses import loss_for_task as j_loss
    from photon_ml_tpu.function.objective import GLMObjective as JObjective
    from photon_ml_tpu.optimization import normal_equations as jne
    from photon_ml_tpu_torch.data.dataset import LabeledData
    from photon_ml_tpu_torch.data.matrix import DenseDesignMatrix
    from photon_ml_tpu_torch.function.losses import loss_for_task
    from photon_ml_tpu_torch.function.objective import GLMObjective

    import jax

    rng = np.random.default_rng(ALL_TASKS.index(task))
    B, S, K = 5, 16, 4
    X = rng.normal(size=(B, S, K))
    z = np.einsum("bsk,bk->bs", X, rng.normal(size=(B, K)))
    y = {TaskType.LINEAR_REGRESSION: z + 0.1 * rng.normal(size=(B, S)),
         TaskType.LOGISTIC_REGRESSION: (rng.random((B, S)) < 1 / (1 + np.exp(-z))).astype(float),
         TaskType.POISSON_REGRESSION: rng.poisson(np.exp(np.clip(0.3 * z, -3, 3))).astype(float),
         TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM: (z > 0).astype(float)}[task]
    w = (rng.random((B, S)) > 0.1).astype(float)
    off, x0, l2 = 0.1 * rng.normal(size=(B, S)), 0.1 * rng.normal(size=(B, K)), rng.uniform(
        0.5, 2.0, size=B)
    quadratic = task == TaskType.LINEAR_REGRESSION

    def jsolve(Xe, ye, we, oe, w0, l2e):
        data = JData(X=JDense(Xe), labels=ye, offsets=oe, weights=we)
        return jne.minimize_direct(JObjective(j_loss(JTask(task.value)), allow_fused=False),
                                   data, w0, l2e, quadratic=quadratic, max_iterations=3,
                                   tolerance=0.0)

    jres = jax.vmap(jsolve)(*(jnp.asarray(a) for a in (X, y, w, off, x0, l2)))
    data = LabeledData(X=DenseDesignMatrix(torch.as_tensor(X)), labels=torch.as_tensor(y),
                       offsets=torch.as_tensor(off), weights=torch.as_tensor(w))
    tres = normal_equations.minimize_direct(
        GLMObjective(loss_for_task(task), allow_fused=False), data, torch.as_tensor(x0),
        torch.as_tensor(l2), quadratic=quadratic, max_iterations=3, tolerance=0.0)
    np.testing.assert_allclose(tres.coefficients.numpy(), np.asarray(jres.coefficients), rtol=0,
                               atol=1e-9)
    np.testing.assert_array_equal(tres.iterations.numpy(), np.asarray(jres.iterations))
    np.testing.assert_array_equal(tres.convergence_reason.numpy(),
                                  np.asarray(jres.convergence_reason))


def test_linear_closed_form_is_exact():
    X, ents, labels, _ = make_problem(seed=7)
    y = labels[TaskType.LINEAR_REGRESSION]
    m_d, tracker = _train("port", X, ents, y, TaskType.LINEAR_REGRESSION, "direct")
    assert tracker.iterations_mean == 1.0  # one Newton step, by construction
    # the normal equations hold: an L-BFGS run to 1e-12 lands on the same point
    m_l, _ = _train("port", X, ents, y, TaskType.LINEAR_REGRESSION, "lbfgs",
                    cfg=GLMOptimizationConfiguration(
                        OptimizerConfig(max_iterations=500, tolerance=1e-14),
                        RegularizationContext(RegularizationType.L2), 1.0))
    np.testing.assert_allclose(_np(m_d.coeffs), _np(m_l.coeffs), atol=1e-6)
    j_d, _ = _train("jax", X, ents, y, TaskType.LINEAR_REGRESSION, "direct")
    np.testing.assert_allclose(_np(m_d.coeffs), _np(j_d.coeffs), rtol=0, atol=1e-9)


def test_direct_variances_match_lbfgs():
    X, ents, labels, _ = make_problem(seed=3)
    y = labels[TaskType.LOGISTIC_REGRESSION]
    kw = dict(variance_computation=VarianceComputationType.SIMPLE)
    m_l, _ = _train("port", X, ents, y, TaskType.LOGISTIC_REGRESSION, "lbfgs", **kw)
    m_d, _ = _train("port", X, ents, y, TaskType.LOGISTIC_REGRESSION, "direct", **kw)
    np.testing.assert_allclose(_np(m_d.variances), _np(m_l.variances), rtol=1e-2, atol=1e-4)
    j_d, _ = _train("jax", X, ents, y, TaskType.LOGISTIC_REGRESSION, "direct", **kw)
    np.testing.assert_allclose(_np(m_d.variances), _np(j_d.variances), rtol=1e-9)


def test_warm_start_collapses_iterations():
    X, ents, labels, _ = make_problem(seed=11)
    y = labels[TaskType.LOGISTIC_REGRESSION]
    m_d, t_cold = _train("port", X, ents, y, TaskType.LOGISTIC_REGRESSION, "direct")
    _, t_warm = _train("port", X, ents, y, TaskType.LOGISTIC_REGRESSION, "direct",
                       initial_model=m_d)
    assert t_warm.iterations_mean <= 3.0
    assert t_warm.iterations_mean < t_cold.iterations_mean


def test_auto_picks_direct_for_small_k():
    X, ents, labels, _ = make_problem(seed=5)
    y = labels[TaskType.LOGISTIC_REGRESSION]
    m_d, _ = _train("port", X, ents, y, TaskType.LOGISTIC_REGRESSION, "direct")
    m_a, _ = _train("port", X, ents, y, TaskType.LOGISTIC_REGRESSION, "auto")
    assert torch.equal(m_a.coeffs, m_d.coeffs)


def test_auto_falls_back_to_lbfgs_beyond_k_threshold():
    rng = np.random.default_rng(17)
    n, d = 300, normal_equations.DIRECT_AUTO_K_MAX + 8
    ents = rng.integers(0, 4, size=n)
    X = sp.csr_matrix(rng.normal(size=(n, d)))
    y = (rng.random(n) > 0.5).astype(float)
    cfg = l2_config(iters=30)
    task = TaskType.LOGISTIC_REGRESSION
    m_l, _ = _train("port", X, ents, y, task, "lbfgs", cfg=cfg)
    m_a, _ = _train("port", X, ents, y, task, "auto", cfg=cfg)
    m_d, _ = _train("port", X, ents, y, task, "direct", cfg=cfg)
    assert torch.equal(m_a.coeffs, m_l.coeffs)
    assert not torch.equal(m_d.coeffs, m_l.coeffs)
    # beyond the unrolled Cholesky the direct solve factors with cholesky_ex
    j_d, _ = _train("jax", X, ents, y, task, "direct", cfg=l2_config("jax", iters=30))
    np.testing.assert_allclose(_np(m_d.coeffs), _np(j_d.coeffs), rtol=0, atol=1e-9)


def test_auto_with_l1_falls_back_and_direct_rejects():
    X, ents, labels, _ = make_problem(seed=2)
    y = labels[TaskType.LOGISTIC_REGRESSION]
    task = TaskType.LOGISTIC_REGRESSION
    m_l, _ = _train("port", X, ents, y, task, "lbfgs", cfg=l2_config(l1=True))
    m_a, _ = _train("port", X, ents, y, task, "auto", cfg=l2_config(l1=True))
    assert torch.equal(m_a.coeffs, m_l.coeffs)
    j_l, _ = _train("jax", X, ents, y, task, "lbfgs", cfg=l2_config("jax", l1=True))
    np.testing.assert_allclose(_np(m_l.coeffs), _np(j_l.coeffs), rtol=0, atol=1e-9)
    np.testing.assert_array_equal(_np(m_l.coeffs) == 0, _np(j_l.coeffs) == 0)
    with pytest.raises(ValueError, match="L1"):
        _train("port", X, ents, y, task, "direct", cfg=l2_config(l1=True))


def test_unknown_solver_rejected():
    with pytest.raises(ValueError, match="unknown re_solver"):
        normal_equations.validate_re_solver("cholesky", False)
    assert normal_equations.validate_re_solver("AUTO", True) == "auto"


def test_direct_cross_run_bitwise_determinism():
    for task in (TaskType.LINEAR_REGRESSION, TaskType.POISSON_REGRESSION):
        X, ents, labels, _ = make_problem(seed=23)
        runs = [_train("port", X, ents, labels[task], task, "direct")[0].coeffs for _ in range(2)]
        assert torch.equal(runs[0], runs[1])


# ------------------------------------------------------- divergence guard


def _single_entity_coordinate(row, y, l2_weight, re_solver="direct", n_extra=6,
                              task=TaskType.LINEAR_REGRESSION):
    """A coordinate whose first entity has exactly one sample ``row`` (a
    rank-1 Gram matrix) plus well-posed filler entities."""
    rng = np.random.default_rng(0)
    k = len(row)
    rows = [row] + [rng.normal(size=k) for _ in range(n_extra * 3)]
    ents = np.asarray([0] + [1 + (i % n_extra) for i in range(n_extra * 3)])
    ys = np.asarray([y] + list((rng.random(n_extra * 3) > 0.5).astype(float)))
    ds = build_random_effect_dataset(sp.csr_matrix(np.asarray(rows)), ents, "e", labels=ys,
                                     device="cpu")
    cfg = GLMOptimizationConfiguration(
        OptimizerConfig(max_iterations=50),
        RegularizationContext(RegularizationType.L2) if l2_weight else RegularizationContext(),
        l2_weight)
    return {"re": RandomEffectCoordinate(coordinate_id="re", dataset=ds, task=task,
                                         configuration=cfg,
                                         base_offsets=torch.zeros(len(ys), dtype=torch.float32),
                                         re_solver=re_solver)}


def test_singular_gram_rejected_by_divergence_guard():
    result = run_coordinate_descent(_single_entity_coordinate(np.array([1.0, 2.0]), 1.0, 0.0), 1)
    assert any(i.kind == "divergence" for i in result.incidents), result.incidents
    coeffs = result.model.get_model("re").coeffs
    assert torch.equal(coeffs, torch.zeros_like(coeffs))


def test_l2_damping_makes_singular_gram_solvable():
    result = run_coordinate_descent(_single_entity_coordinate(np.array([1.0, 2.0]), 1.0, 1.0), 1)
    assert not result.incidents
    assert bool(torch.isfinite(result.model.get_model("re").coeffs).all())


def test_singular_gram_rejected_for_irls_families():
    result = run_coordinate_descent(_single_entity_coordinate(
        np.array([1.0, 2.0]), 1.0, 0.0, task=TaskType.LOGISTIC_REGRESSION), 1)
    coeffs = result.model.get_model("re").coeffs
    rejected = any(i.kind == "divergence" for i in result.incidents)
    assert rejected or torch.equal(coeffs, torch.zeros_like(coeffs))
    assert bool(torch.isfinite(coeffs).all())


def test_nan_poisoned_gram_rejected():
    result = run_coordinate_descent(_single_entity_coordinate(
        np.array([np.nan, 1.0]), 1.0, 1.0, task=TaskType.LOGISTIC_REGRESSION), 1)
    assert any(i.kind == "divergence" for i in result.incidents)


# ----------------------------------------------------------- measured auto


def _auto_coordinate(re_solver="auto", seed=5, cfg=None, **kw):
    X, ents, labels, _ = make_problem(seed=seed)
    ds = build_random_effect_dataset(X, ents, "e", labels=labels[TaskType.LOGISTIC_REGRESSION],
                                     device="cpu")
    return RandomEffectCoordinate(coordinate_id="re", dataset=ds,
                                  task=TaskType.LOGISTIC_REGRESSION,
                                  configuration=cfg or l2_config(),
                                  base_offsets=torch.zeros(N, dtype=ds.sample_vals.dtype),
                                  re_solver=re_solver, **kw)


def _one_update(coord):
    model = coord.initialize_model()
    zeros = torch.zeros(coord.dataset.n_samples, dtype=coord.dataset.sample_vals.dtype)
    return coord.update_and_score(model, zeros, coord.score(model))


def test_measured_auto_records_per_bucket_iteration_counts():
    coord = _auto_coordinate()
    assert coord.re_solver_stats() is None
    _one_update(coord)
    stats = coord.re_solver_stats()
    assert stats and stats["per_shape"], stats
    for shape, rec in stats["per_shape"].items():
        assert set(rec) == {"choice", "lbfgs_iters", "direct_iters", "direct_clean"}
        expect = ("direct" if rec["direct_clean"] and rec["direct_iters"] <= rec["lbfgs_iters"]
                  else "lbfgs")
        assert rec["choice"] == expect, (shape, rec)


@pytest.mark.parametrize("norm", [False, True], ids=["raw", "norm"])
def test_measured_auto_record_matches_jax(norm):
    """The probe's record equals JAX's on the same inputs at f64: the same
    shapes, mean iterations, clean flags and choices."""
    X, ents, labels, _ = make_problem(seed=13)
    y = labels[TaskType.LOGISTIC_REGRESSION]
    tn, jn = (standardization(X), standardization(X, "jax")) if norm else (None, None)
    ds = build_random_effect_dataset(X, ents, "e", labels=y, normalization=tn,
                                     intercept_index=0 if norm else None, dtype=F64, device="cpu")
    jds = j_build(X, ents, "e", labels=y, normalization=jn, intercept_index=0 if norm else None,
                  dtype=jnp.float64)
    got = tre.measure_auto_solvers(ds, TaskType.LOGISTIC_REGRESSION, l2_config(),
                                   torch.zeros(N, dtype=F64), normalization=tn).to_dict()
    want = jre.measure_auto_solvers(jds, JTask.LOGISTIC_REGRESSION, l2_config("jax"),
                                    jnp.zeros(N), normalization=jn).to_dict()
    assert got == want and got["per_shape"]


def test_measured_auto_seeded_decision_is_honored_bitwise():
    probe = _auto_coordinate()
    _one_update(probe)
    stats = probe.re_solver_stats()
    assert any(r["choice"] == "direct" for r in stats["per_shape"].values())
    forced = {"per_shape": {k: dict(v, choice="lbfgs") for k, v in stats["per_shape"].items()}}
    seeded = _auto_coordinate()
    seeded.seed_solver_decision(forced)
    m_seeded, s_seeded, _ = _one_update(seeded)
    m_ref, s_ref, _ = _one_update(_auto_coordinate(re_solver="lbfgs"))
    assert torch.equal(m_seeded.coeffs, m_ref.coeffs) and torch.equal(s_seeded, s_ref)


def test_measured_auto_decision_roundtrips_checkpoint_extra_state(tmp_path):
    """The record rides the manifest's ``extra`` and a resumed descent seeds
    its coordinates from it, even where a fresh probe would measure
    otherwise (the stored record is rewritten to all-lbfgs between runs)."""
    ckdir = str(tmp_path / "ck")
    cp = CoordinateDescentCheckpointer(ckdir, interval=1, fingerprint="fp", device="cpu",
                                       dtype=torch.float32)
    run_coordinate_descent({"re": _auto_coordinate()}, n_iterations=1, checkpointer=cp)
    manifests = sorted(glob.glob(os.path.join(ckdir, "gen-*", "state.json")))
    assert manifests
    state = json.loads(open(manifests[-1]).read())
    rec = state["extra"]["re_solver_auto"]["re"]
    assert rec["per_shape"]
    state["extra"]["re_solver_auto"]["re"] = {
        "per_shape": {k: dict(v, choice="lbfgs") for k, v in rec["per_shape"].items()}}
    blob = json.dumps(state, indent=2, sort_keys=True)
    with open(manifests[-1], "w") as f:
        f.write(blob)
    with open(manifests[-1] + ".sha256", "w") as f:
        f.write(hashlib.sha256(blob.encode()).hexdigest())
    resumed = _auto_coordinate()
    cp2 = CoordinateDescentCheckpointer(ckdir, interval=1, fingerprint="fp", device="cpu",
                                        dtype=torch.float32)
    run_coordinate_descent({"re": resumed}, n_iterations=2, checkpointer=cp2)
    stats = resumed.re_solver_stats()
    assert all(r["choice"] == "lbfgs" for r in stats["per_shape"].values()), stats


def test_measured_auto_l1_measures_nothing_and_stays_lbfgs():
    auto = _auto_coordinate(seed=2, cfg=l2_config(l1=True))
    m_a, _, _ = _one_update(auto)
    assert auto.re_solver_stats() == {"per_shape": {}}
    m_l, _, _ = _one_update(_auto_coordinate(re_solver="lbfgs", seed=2, cfg=l2_config(l1=True)))
    assert torch.equal(m_a.coeffs, m_l.coeffs)


def test_bucket_solver_plan_validates_length():
    args = (TaskType.LOGISTIC_REGRESSION, OptimizerConfig(), False, VarianceComputationType.NONE)
    assert len(bucket_solves(*args, "lbfgs", 3)) == 3
    plan = bucket_solves(*args, ("direct", "lbfgs"), 2)
    assert len(plan) == 2 and plan[0] is not plan[1]
    with pytest.raises(ValueError, match="covers 2 buckets"):
        bucket_solves(*args, ("direct", "lbfgs"), 3)


def test_measured_auto_per_bucket_plan_reaches_update_program():
    """The measured plan drives the update program and the per-bucket path
    alike: a seeded coordinate reproduces the auto coordinate's update
    bitwise on both."""
    coord = _auto_coordinate()
    m_auto, s_auto, _ = _one_update(coord)
    plan = coord._solver_plan(None, None)
    assert isinstance(plan, tuple) and set(plan) <= {"lbfgs", "direct"}
    pinned = _auto_coordinate()
    pinned.seed_solver_decision(coord.re_solver_stats())
    m_pin, s_pin, _ = _one_update(pinned)
    assert torch.equal(m_pin.coeffs, m_auto.coeffs) and torch.equal(s_pin, s_auto)
    per_bucket = _auto_coordinate(use_update_program=False)
    per_bucket.seed_solver_decision(coord.re_solver_stats())
    m_pb, _ = per_bucket.update_model(per_bucket.initialize_model(),
                                      torch.zeros(N, dtype=per_bucket.dataset.sample_vals.dtype))
    assert torch.equal(m_pb.coeffs, m_auto.coeffs)
