"""The port's OWL-QN, LBFGSB, bounded solvers and tracking against the JAX package.

Mirrors the optimizer cases of tests/test_optimizers.py (OWLQN, LBFGSB,
bounded TRON and NEWTON, tracking, the factory's refusals) and the
reference vectors of tests/test_reference_parity.py (LBFGSBTest.scala and
OWLQNTest.scala, at their own tolerance 1e-6). Every solve is also held
against the JAX function on the same numpy inputs at f64: coefficients
within 1e-9 and, for OWL-QN, the same exact zeros; on GLM problems at the
default tolerance the iteration counts and reasons are equal too. Batched
OWL-QN lanes are held against JAX's vmapped bucket solve, and
``GLMOptimizationProblem.run`` with OWLQN elastic net and with LBFGSB
against JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize
import torch

from photon_ml_tpu.data.dataset import LabeledData as JData
from photon_ml_tpu.function.losses import logistic_loss as j_logistic
from photon_ml_tpu.function.objective import GLMObjective as JObjective
from photon_ml_tpu.function.objective import make_hessian_vector as j_hv
from photon_ml_tpu.function.objective import make_value_and_grad as j_vg
from photon_ml_tpu.optimization import minimize_lbfgsb as j_lbfgsb
from photon_ml_tpu.optimization import minimize_newton as j_newton
from photon_ml_tpu.optimization import minimize_owlqn as j_owlqn
from photon_ml_tpu.optimization import minimize_tron as j_tron
from photon_ml_tpu.optimization import solver_cache as jsc
from photon_ml_tpu.optimization.common import OptimizerConfig as JConfig
from photon_ml_tpu.optimization.config import GLMOptimizationConfiguration as JCfg
from photon_ml_tpu.optimization.config import RegularizationContext as JReg
from photon_ml_tpu.optimization.factory import build_minimizer as j_build_minimizer
from photon_ml_tpu.optimization.problem import GLMOptimizationProblem as JProblem
from photon_ml_tpu.types import OptimizerType as JOpt
from photon_ml_tpu.types import RegularizationType as JRT
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu.types import VarianceComputationType as JVar
from photon_ml_tpu_torch.data.dataset import LabeledData as TData
from photon_ml_tpu_torch.function.losses import logistic_loss as t_logistic
from photon_ml_tpu_torch.function.objective import GLMObjective as TObjective
from photon_ml_tpu_torch.function.objective import make_hessian_vector as t_hv
from photon_ml_tpu_torch.function.objective import make_value_and_grad as t_vg
from photon_ml_tpu_torch.optimization import solver_cache as tsc
from photon_ml_tpu_torch.optimization.common import OptimizerConfig, any_lane
from photon_ml_tpu_torch.optimization.config import (
    GLMOptimizationConfiguration,
    RegularizationContext,
)
from photon_ml_tpu_torch.optimization.factory import build_minimizer
from photon_ml_tpu_torch.optimization.lbfgs import minimize_lbfgs
from photon_ml_tpu_torch.optimization.lbfgsb import minimize_lbfgsb
from photon_ml_tpu_torch.optimization.newton import minimize_newton
from photon_ml_tpu_torch.optimization.owlqn import minimize_owlqn, pseudo_gradient
from photon_ml_tpu_torch.optimization.problem import GLMOptimizationProblem
from photon_ml_tpu_torch.optimization.tron import minimize_tron
from photon_ml_tpu_torch.types import (
    ConvergenceReason,
    OptimizerType,
    RegularizationType,
    TaskType,
    VarianceComputationType,
)

F64 = torch.float64


def quadratic(center, scales):
    """f(x) = 1/2 sum scales (x - center)^2 in both packages: (jax vg, jax
    hvp), (torch vg, torch hvp)."""
    cj, sj = jnp.asarray(center), jnp.asarray(scales)
    ct, st = torch.tensor(center, dtype=F64), torch.tensor(scales, dtype=F64)

    def jvg(x):
        d = x - cj
        return 0.5 * jnp.sum(sj * d * d), sj * d

    def tvg(x):
        d = x - ct
        return 0.5 * torch.sum(st * d * d, dim=-1), st * d

    return (jvg, lambda x, v: sj * v), (tvg, lambda x, v: st * v)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _same(tres, jres, atol=1e-9, iterations=True):
    tc, jc = tres.coefficients.numpy(), np.asarray(jres.coefficients)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=atol)
    np.testing.assert_array_equal(tc == 0, jc == 0)  # the same exact zeros
    np.testing.assert_allclose(float(tres.value), float(jres.value), rtol=1e-12, atol=1e-14)
    if iterations:
        assert int(tres.iterations) == int(jres.iterations)
        assert int(tres.convergence_reason) == int(jres.convergence_reason)


def _logistic(rng, n, d, w_true=None, l2=0.0, second_order=False):
    """A logistic problem's value-and-gradient in both packages, and with
    ``second_order`` their (hvp, hessian) pairs too."""
    X = rng.normal(size=(n, d))
    w_true = rng.normal(size=d) if w_true is None else w_true
    y = (X @ w_true + 0.1 * rng.normal(size=n) > 0).astype(float)
    jobj, jd = JObjective(j_logistic), JData.build(X, y, dtype=jnp.float64)
    tobj, td = TObjective(t_logistic), TData.build(X, y, dtype=F64, device="cpu")
    out = (j_vg(jobj, jd, l2_weight=l2), t_vg(tobj, td, l2_weight=l2))
    if second_order:
        out += ((j_hv(jobj, jd, l2_weight=l2), lambda w: jobj.hessian_matrix(jd, w, l2)),
                (t_hv(tobj, td, l2_weight=l2), lambda w: tobj.hessian_matrix(td, w, l2)))
    return out


# ---------------------------------------------------------------- OWLQN


def test_owlqn_lasso_soft_threshold():
    b = [3.0, -0.5, 0.2, -4.0]
    (jvg, _), (tvg, _) = quadratic(b, [1.0] * 4)
    res = minimize_owlqn(tvg, torch.zeros(4, dtype=F64), 1.0, tolerance=1e-12, max_iterations=200)
    expected = np.sign(b) * np.maximum(np.abs(b) - 1.0, 0.0)
    np.testing.assert_allclose(res.coefficients.numpy(), expected, atol=1e-6)
    jres = j_owlqn(jvg, jnp.zeros(4), 1.0, tolerance=1e-12, max_iterations=200)
    _same(res, jres, iterations=False)


def test_owlqn_produces_sparsity(rng):
    w_true = np.zeros(10)
    w_true[:3] = [2.0, -3.0, 1.5]
    jvg, tvg = _logistic(rng, 100, 10, w_true)
    res = minimize_owlqn(tvg, torch.zeros(10, dtype=F64), 5.0, max_iterations=200)
    coefs = res.coefficients.numpy()
    assert (np.abs(coefs) < 1e-8).sum() >= 4, coefs
    assert np.abs(coefs).max() > 0
    _same(res, j_owlqn(jvg, jnp.zeros(10), 5.0, max_iterations=200))


def test_owlqn_zero_l1_matches_lbfgs(rng):
    jvg, tvg = _logistic(rng, 60, 5, l2=0.5)
    r1 = minimize_owlqn(tvg, torch.zeros(5, dtype=F64), 0.0, tolerance=1e-12, max_iterations=300)
    r2 = minimize_lbfgs(tvg, torch.zeros(5, dtype=F64), tolerance=1e-12, max_iterations=300)
    np.testing.assert_allclose(r1.coefficients.numpy(), r2.coefficients.numpy(), atol=1e-4)
    _same(r1, j_owlqn(jvg, jnp.zeros(5), 0.0, tolerance=1e-12, max_iterations=300),
          iterations=False)


def test_pseudo_gradient_matches_jax(rng):
    from photon_ml_tpu.optimization.owlqn import pseudo_gradient as j_pg

    x = np.array([1.0, -2.0, 0.0, 0.0, 0.0, 0.0])
    g = np.array([0.3, -0.3, 2.0, -2.0, 0.5, -0.5])
    np.testing.assert_array_equal(pseudo_gradient(_t(x), _t(g), 1.0).numpy(),
                                  np.asarray(j_pg(jnp.asarray(x), jnp.asarray(g), 1.0)))


def test_owlqn_lanes_match_vmapped_jax(rng):
    """A bucket of entities: the port runs them as lanes of one OWL-QN loop,
    JAX as a vmapped while_loop; per-lane coefficients, zeros, iterations
    and reasons agree."""
    E, S, K = 6, 24, 5
    X = rng.normal(size=(E, S, K))
    y = (rng.uniform(size=(E, S)) > 0.5).astype(float)
    w = (rng.uniform(size=(E, S)) > 0.2).astype(float)
    off = 0.1 * rng.normal(size=(E, S))
    l2 = rng.uniform(0.5, 2.0, size=E)
    cfg = dict(optimizer_type="OWLQN", max_iterations=60)
    jw, jr, ji, _ = jsc.re_bucket_solver(JTask.LOGISTIC_REGRESSION, JConfig(**cfg), True,
                                         JVar.NONE, "lbfgs")(
        *(jnp.asarray(a) for a in (X, y, w, off, np.zeros((E, K)), l2)), jnp.asarray(0.7))
    syncs = any_lane.syncs
    tw, tr, ti, _ = tsc.re_bucket_solver(TaskType.LOGISTIC_REGRESSION, OptimizerConfig(**cfg),
                                         True, VarianceComputationType.NONE, "lbfgs")(
        *(_t(a) for a in (X, y, w, off, np.zeros((E, K)), l2)), 0.7)
    assert any_lane.syncs > syncs
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-9)
    np.testing.assert_array_equal(tw.numpy() == 0, np.asarray(jw) == 0)
    assert (tw.numpy() == 0).any()
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


# ---------------------------------------------------------------- LBFGSB


def test_lbfgsb_box_constrained_quadratic():
    (jvg, _), (tvg, _) = quadratic([2.0, -3.0], [1.0, 1.0])
    lo, hi = [-1.0, -1.0], [1.0, 1.0]
    res = minimize_lbfgsb(tvg, torch.zeros(2, dtype=F64), _t(lo), _t(hi), max_iterations=100)
    np.testing.assert_allclose(res.coefficients.numpy(), [1.0, -1.0], atol=1e-6)
    _same(res, j_lbfgsb(jvg, jnp.zeros(2), jnp.asarray(lo), jnp.asarray(hi), max_iterations=100))


def test_lbfgsb_interior_matches_unconstrained():
    (jvg, _), (tvg, _) = quadratic([0.3, -0.2], [2.0, 5.0])
    res = minimize_lbfgsb(tvg, torch.zeros(2, dtype=F64), -torch.ones(2, dtype=F64),
                          torch.ones(2, dtype=F64), tolerance=1e-12)
    np.testing.assert_allclose(res.coefficients.numpy(), [0.3, -0.2], atol=1e-7)
    _same(res, j_lbfgsb(jvg, jnp.zeros(2), -jnp.ones(2), jnp.ones(2), tolerance=1e-12),
          iterations=False)


def test_lbfgsb_matches_scipy(rng):
    jvg, tvg = _logistic(rng, 80, 4, l2=0.1)
    lo, hi = -0.2 * np.ones(4), 0.15 * np.ones(4)
    res = minimize_lbfgsb(tvg, torch.zeros(4, dtype=F64), _t(lo), _t(hi), tolerance=1e-12,
                          max_iterations=300)
    ref = scipy.optimize.minimize(
        lambda w: float(tvg(_t(w))[0]), np.zeros(4), jac=lambda w: tvg(_t(w))[1].numpy(),
        method="L-BFGS-B", bounds=list(zip(lo, hi)), tol=1e-14,
    )
    np.testing.assert_allclose(res.coefficients.numpy(), ref.x, atol=5e-4)
    _same(res, j_lbfgsb(jvg, jnp.zeros(4), jnp.asarray(lo), jnp.asarray(hi), tolerance=1e-12,
                        max_iterations=300), iterations=False)


def test_lbfgsb_skipped_pairs_keep_history_consistent():
    (jvg, _), (tvg, _) = quadratic([10.0, 10.0, -10.0], [1.0, 2.0, 3.0])
    res = minimize_lbfgsb(tvg, torch.zeros(3, dtype=F64), -torch.ones(3, dtype=F64),
                          torch.ones(3, dtype=F64), max_iterations=60, history_length=3)
    np.testing.assert_allclose(res.coefficients.numpy(), [1.0, 1.0, -1.0], atol=1e-8)
    assert int(res.convergence_reason) != ConvergenceReason.NOT_CONVERGED
    _same(res, j_lbfgsb(jvg, jnp.zeros(3), -jnp.ones(3), jnp.ones(3), max_iterations=60,
                        history_length=3))


# ------------------------------------------------------- bounded TRON, NEWTON


def test_tron_with_bounds_value_matches_coefficients():
    (jvg, jhvp), (tvg, thvp) = quadratic([2.0, -3.0], [1.0, 1.0])
    lo = -torch.ones(2, dtype=F64)
    res = minimize_tron(tvg, thvp, torch.zeros(2, dtype=F64), lower_bounds=lo, upper_bounds=-lo,
                        max_iterations=50)
    np.testing.assert_allclose(float(res.value), float(tvg(res.coefficients)[0]), rtol=1e-10)
    assert bool((res.coefficients.abs() <= 1.0 + 1e-12).all())
    _same(res, j_tron(jvg, jhvp, jnp.zeros(2), lower_bounds=-jnp.ones(2),
                      upper_bounds=jnp.ones(2), max_iterations=50))


def test_newton_with_bounds():
    (jvg, _), (tvg, _) = quadratic([2.0, -3.0], [1.0, 1.0])
    lo = -torch.ones(2, dtype=F64)
    res = minimize_newton(tvg, lambda x: torch.eye(2, dtype=F64).expand(x.shape[:-1] + (2, 2)),
                          torch.zeros(2, dtype=F64), lower_bounds=lo, upper_bounds=-lo,
                          max_iterations=50)
    np.testing.assert_allclose(res.coefficients.numpy(), [1.0, -1.0], atol=1e-6)
    np.testing.assert_allclose(float(res.value), float(tvg(res.coefficients)[0]), rtol=1e-10)
    _same(res, j_newton(jvg, lambda x: jnp.eye(2), jnp.zeros(2), lower_bounds=-jnp.ones(2),
                        upper_bounds=jnp.ones(2), max_iterations=50))


# ---------------------------------------------------------------- tracking


@pytest.mark.parametrize("opt", list(OptimizerType), ids=lambda o: o.value)
def test_tracking_matches_jax(opt, rng):
    """``track_states=True`` fills the NaN-padded value and gradient-norm
    records (monotone for the descent methods) equal to JAX's."""
    jvg, tvg, (jhvp, jh), (thvp, th) = _logistic(rng, 60, 4, l2=1.0, second_order=True)
    cfg = dict(optimizer_type=opt.value, max_iterations=20, track_states=True)
    kw_j, kw_t = {}, {}
    if opt == OptimizerType.TRON:
        kw_j["hvp"], kw_t["hvp"] = jhvp, thvp
    if opt == OptimizerType.NEWTON:
        kw_j["hess"], kw_t["hess"] = jh, th
    if opt == OptimizerType.OWLQN:
        kw_j["l1_weight"] = kw_t["l1_weight"] = 0.5
    if opt == OptimizerType.LBFGSB:
        kw_j["lower_bounds"] = jnp.full(4, -0.3)
        kw_t["lower_bounds"] = torch.full((4,), -0.3, dtype=F64)
    jres = j_build_minimizer(JConfig(**cfg))(jvg, jnp.zeros(4), **kw_j)
    tres = build_minimizer(OptimizerConfig(**cfg))(tvg, torch.zeros(4, dtype=F64), **kw_t)
    tv, jv = tres.tracked_values.numpy(), np.asarray(jres.tracked_values)
    assert tv.shape == (21,)
    np.testing.assert_array_equal(np.isnan(tv), np.isnan(jv))
    np.testing.assert_allclose(tv[~np.isnan(tv)], jv[~np.isnan(jv)], rtol=1e-12)
    np.testing.assert_allclose(tres.tracked_grad_norms.numpy(),
                               np.asarray(jres.tracked_grad_norms), rtol=1e-8, atol=1e-12)
    vals = tv[~np.isnan(tv)]
    assert len(vals) >= 2 and np.all(np.diff(vals) <= 1e-12)
    _same(tres, jres, atol=1e-8)


def test_tracking_is_per_lane():
    """Batched lanes keep their own records: a frozen lane's stays as it was."""
    centers = torch.tensor([[1.0, 1.0], [0.0, 0.0], [3.0, -2.0]], dtype=F64)
    res = minimize_lbfgs(lambda x: (0.5 * ((x - centers) ** 2).sum(-1), x - centers),
                         torch.zeros((3, 2), dtype=F64), max_iterations=10, track_states=True)
    tv = res.tracked_values
    assert tv.shape == (3, 11)
    for lane in range(3):
        n = int(res.iterations[lane])
        assert not torch.isnan(tv[lane, : n + 1]).any() and torch.isnan(tv[lane, n + 1:]).all()
    assert int(res.iterations[1]) == 0  # started at its optimum


# ------------------------------------------------------ reference vectors


def test_lbfgsb_bounds_match_reference_vectors():
    """LBFGSBTest.scala: minimize (x - 4)^2 under each box."""
    def vg(x):
        d = x - 4.0
        return torch.sum(d * d, dim=-1), 2.0 * d

    for lo, hi, x_exp, f_exp in ((-10.0, 10.0, 4.0, 0.0), (-5.0, 5.0, 4.0, 0.0),
                                 (-10.0, 3.0, 3.0, 1.0), (5.0, 10.0, 5.0, 1.0)):
        res = minimize_lbfgsb(vg, torch.tensor([(lo + hi) / 2.0], dtype=F64),
                              torch.tensor([lo], dtype=F64), torch.tensor([hi], dtype=F64),
                              tolerance=1e-10)
        assert float(res.coefficients[0]) == pytest.approx(x_exp, abs=1e-6)
        assert float(res.value) == pytest.approx(f_exp, abs=1e-6)


def test_owlqn_shrinkage_matches_reference_vectors():
    """OWLQNTest.scala: minimize sum_i (x_i - 4)^2 + w ||x||_1; the value
    is the total objective, L1 term included."""
    def vg(x):
        d = x - 4.0
        return torch.sum(d * d, dim=-1), 2.0 * d

    for w, x_exp, f_exp in ((1.0, [3.5, 3.5], 7.5), (2.0, [3.0, 3.0], 14.0),
                            (8.0, [0.0, 0.0], 32.0)):
        res = minimize_owlqn(vg, torch.zeros(2, dtype=F64), w, tolerance=1e-10,
                             max_iterations=200)
        np.testing.assert_allclose(res.coefficients.numpy(), x_exp, atol=1e-6)
        assert float(res.value) == pytest.approx(f_exp, abs=1e-6)


# ---------------------------------------------------------------- factory


@pytest.mark.parametrize("opt", [OptimizerType.OWLQN, OptimizerType.LBFGSB])
def test_warm_start_at_optimum_converges_immediately(opt):
    center = torch.tensor([1.0, -2.0], dtype=F64)
    vg = lambda x: (0.5 * torch.sum((x - center) ** 2, dim=-1), x - center)  # noqa: E731
    if opt == OptimizerType.OWLQN:
        res = minimize_owlqn(vg, center, 0.0)
    else:
        res = minimize_lbfgsb(vg, center, -5 * torch.ones(2, dtype=F64), 5 * torch.ones(2, dtype=F64))
    assert int(res.convergence_reason) == ConvergenceReason.GRADIENT_CONVERGED
    assert int(res.iterations) == 0
    np.testing.assert_array_equal(res.coefficients.numpy(), center.numpy())


def test_factory_rejects_silent_drops():
    vg = lambda x: (0.5 * torch.sum(x ** 2), x)  # noqa: E731
    with pytest.raises(ValueError, match="OWLQN"):
        build_minimizer(OptimizerConfig(optimizer_type=OptimizerType.LBFGS))(
            vg, torch.zeros(2), l1_weight=0.5)
    with pytest.raises(ValueError, match="box"):
        build_minimizer(OptimizerConfig(optimizer_type=OptimizerType.OWLQN))(
            vg, torch.zeros(2), l1_weight=0.1, lower_bounds=-torch.ones(2))
    with pytest.raises(ValueError, match="LBFGSB requires box bounds"):
        build_minimizer(OptimizerConfig(optimizer_type=OptimizerType.LBFGSB))(vg, torch.zeros(2))


# -------------------------------------------- GLMOptimizationProblem.run


def _problem_pair(task, opt, reg, weight, alpha=None):
    jp = JProblem(task=JTask(task), configuration=JCfg(
        JConfig(optimizer_type=JOpt(opt), max_iterations=100, track_states=True),
        JReg(JRT(reg), alpha), weight))
    tp = GLMOptimizationProblem(task=TaskType(task), configuration=GLMOptimizationConfiguration(
        OptimizerConfig(optimizer_type=opt, max_iterations=100, track_states=True),
        RegularizationContext(RegularizationType(reg), alpha), weight))
    return jp, tp


@pytest.mark.parametrize("task", ["LINEAR_REGRESSION", "LOGISTIC_REGRESSION",
                                  "POISSON_REGRESSION"])
@pytest.mark.parametrize("case", ["owlqn-elastic-net", "lbfgsb"])
def test_problem_run_matches_jax(task, case, rng):
    n, d = 400, 8
    X = rng.normal(size=(n, d))
    X[:, -1] = 1.0
    w_true = rng.normal(size=d) * (rng.uniform(size=d) > 0.4)
    z = X @ w_true
    y = {"LINEAR_REGRESSION": z + 0.1 * rng.normal(size=n),
         "LOGISTIC_REGRESSION": (rng.uniform(size=n) < 1 / (1 + np.exp(-z))).astype(float),
         "POISSON_REGRESSION": rng.poisson(np.exp(np.clip(0.3 * z, -3, 3))).astype(float)}[task]
    lo = hi = None
    if case == "lbfgsb":
        jp, tp = _problem_pair(task, "LBFGSB", "L2", 1.0)
        lo, hi = np.full(d, -0.3), np.full(d, 0.3)
    else:
        jp, tp = _problem_pair(task, "OWLQN", "ELASTIC_NET", 20.0, 0.5)
    jm, jres = jp.run(JData.build(X, y, dtype=jnp.float64),
                      lower_bounds=None if lo is None else jnp.asarray(lo),
                      upper_bounds=None if hi is None else jnp.asarray(hi))
    tm, tres = tp.run(TData.build(X, y, dtype=F64, device="cpu"), lower_bounds=lo,
                      upper_bounds=hi)
    _same(tres, jres)
    np.testing.assert_allclose(tm.coefficients.means.numpy(), np.asarray(jm.coefficients.means),
                               rtol=0, atol=1e-9)
    tv, jv = tres.tracked_values.numpy(), np.asarray(jres.tracked_values)  # track_states=True
    np.testing.assert_array_equal(np.isnan(tv), np.isnan(jv))
    np.testing.assert_allclose(tv[~np.isnan(tv)], jv[~np.isnan(jv)], rtol=1e-12)
    coef = tm.coefficients.means.numpy()
    if case == "lbfgsb":
        assert np.all(np.abs(coef) <= 0.3) and np.any(np.abs(coef) == 0.3)
    else:
        assert np.any(coef == 0.0)
