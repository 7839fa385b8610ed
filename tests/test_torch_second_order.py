"""The port's TRON and NEWTON solvers against the JAX package's, same numpy inputs.

Mirrors tests/test_optimizers.py (TRON, NEWTON, factory) and the solve
tests of tests/test_pallas_glm.py.

- Closed-form and GLM problems at f64: coefficients within atol 1e-8 of
  the JAX solve (1e-6 where the JAX test itself holds 1e-6 against the
  exact optimum), the same iteration count and the same convergence
  reason.
- Batched: the port runs E problems as E lanes of one host loop, JAX as a
  vmapped while_loop (``re_bucket_solver`` on a bucket of entities of
  different sizes and weights). Per-lane coefficients within atol 1e-8 and
  per-lane iteration counts and reasons equal, at the default tolerance
  1e-7. (Run to 1e-9, a lane's last line search compares values that
  differ by f64 rounding alone, and its reason can flip between
  FUNCTION_VALUES_CONVERGED and OBJECTIVE_NOT_IMPROVING between two
  implementations that sum in different orders: 8 of 80 seeded buckets
  did, against none at 1e-7.)
- Fused solves at f32: the port's plain kernel versions against the JAX
  kernels in interpret mode, atol 5e-4 on coefficients (the JAX package's
  own fused-against-stock tolerance).
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.data.dataset import LabeledData as JData
from photon_ml_tpu.data.matrix import DenseDesignMatrix as JDense
from photon_ml_tpu.function import losses as jl
from photon_ml_tpu.function.objective import GLMObjective as JObjective
from photon_ml_tpu.ops import pallas_glm
from photon_ml_tpu.optimization import minimize_newton as jnewton
from photon_ml_tpu.optimization import minimize_tron as jtron
from photon_ml_tpu.optimization import solver_cache as jsc
from photon_ml_tpu.optimization.common import OptimizerConfig as JConfig
from photon_ml_tpu.types import OptimizerType as JOpt
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu.types import VarianceComputationType as JVar
from photon_ml_tpu_torch.data.dataset import LabeledData as TData
from photon_ml_tpu_torch.data.matrix import DenseDesignMatrix as TDense
from photon_ml_tpu_torch.function import losses as tl
from photon_ml_tpu_torch.function.objective import GLMObjective as TObjective
from photon_ml_tpu_torch.function.objective import make_hessian_vector, make_value_and_grad
from photon_ml_tpu_torch.ops import fused_glm, fused_hess
from photon_ml_tpu_torch.optimization import solver_cache as tsc
from photon_ml_tpu_torch.optimization.common import OptimizerConfig, any_lane
from photon_ml_tpu_torch.optimization.factory import build_minimizer
from photon_ml_tpu_torch.optimization.lbfgs import minimize_lbfgs
from photon_ml_tpu_torch.optimization.newton import _newton_direction, minimize_newton
from photon_ml_tpu_torch.optimization.tron import minimize_tron, truncated_conjugate_gradient
from photon_ml_tpu_torch.types import (
    ConvergenceReason,
    OptimizerType,
    TaskType,
    VarianceComputationType,
)


@contextlib.contextmanager
def pallas_interpret():
    """Enable the JAX fused kernels in interpret mode, restoring prior state."""
    prev_env = os.environ.get("PHOTON_PALLAS_INTERPRET")
    pallas_glm.enable_pallas(True)
    os.environ["PHOTON_PALLAS_INTERPRET"] = "1"
    try:
        yield
    finally:
        pallas_glm.enable_pallas(None)
        if prev_env is None:
            del os.environ["PHOTON_PALLAS_INTERPRET"]
        else:
            os.environ["PHOTON_PALLAS_INTERPRET"] = prev_env


def quadratic(center, scales, lib):
    """f(x) = 1/2 sum scales (x - center)^2, in JAX (lib=jnp) or the port."""
    if lib is jnp:
        c, s = jnp.asarray(center), jnp.asarray(scales)
        return (lambda x: (0.5 * jnp.sum(s * (x - c) ** 2), s * (x - c))), (lambda x, v: s * v)
    c, s = torch.tensor(center, dtype=torch.float64), torch.tensor(scales, dtype=torch.float64)
    return (lambda x: (0.5 * torch.sum(s * (x - c) ** 2, dim=-1), s * (x - c))), (lambda x, v: s * v)


def _same(tres, jres, atol=1e-8):
    np.testing.assert_allclose(tres.coefficients.numpy(), np.asarray(jres.coefficients), atol=atol)
    np.testing.assert_allclose(float(tres.value), float(jres.value), rtol=1e-10, atol=1e-14)
    assert int(tres.iterations) == int(jres.iterations)
    assert int(tres.convergence_reason) == int(jres.convergence_reason)


def _glm(rng, n, d, loss="logistic"):
    X = rng.normal(size=(n, d))
    X[:, -1] = 1.0
    if loss == "logistic":
        y = (X @ rng.normal(size=d) + 0.3 * rng.normal(size=n) > 0).astype(float)
    else:
        X = X * 0.5
        X[:, -1] = 1.0
        y = rng.poisson(np.exp(X @ rng.normal(size=d) * 0.3)).astype(float)
    return X, y


def _objectives(X, y, jloss, tloss, l2):
    jd = JData.build(X, y, dtype=jnp.float64)
    td = TData.build(X, y, dtype=torch.float64, device="cpu")
    jo, to = JObjective(jloss), TObjective(tloss)
    return (
        (lambda w: jo.value_and_gradient(jd, w, l2), lambda w, v: jo.hessian_vector(jd, w, v, l2),
         lambda w: jo.hessian_matrix(jd, w, l2)),
        (make_value_and_grad(to, td, l2), make_hessian_vector(to, td, l2),
         lambda w: to.hessian_matrix(td, w, l2)),
    )


# ---------------------------------------------------------------- TRON


def test_tron_quadratic_one_iteration():
    jvg, jhvp = quadratic([1.0, -1.0, 2.0], [1.0, 2.0, 3.0], jnp)
    tvg, thvp = quadratic([1.0, -1.0, 2.0], [1.0, 2.0, 3.0], torch)
    jres = jtron(jvg, jhvp, jnp.zeros(3), tolerance=1e-10)
    steps = truncated_conjugate_gradient.steps
    tres = minimize_tron(tvg, thvp, torch.zeros(3, dtype=torch.float64), tolerance=1e-10)
    assert truncated_conjugate_gradient.steps > steps
    np.testing.assert_allclose(tres.coefficients.numpy(), [1.0, -1.0, 2.0], atol=1e-6)
    _same(tres, jres)


@pytest.mark.parametrize("max_iterations", [3, 50])
def test_tron_logistic_matches_jax_and_lbfgs(max_iterations, rng):
    X, y = _glm(rng, 150, 5)
    (jvg, jhvp, _), (tvg, thvp, _) = _objectives(X, y, jl.logistic_loss, tl.logistic_loss, 1.0)
    jres = jtron(jvg, jhvp, jnp.zeros(5), tolerance=1e-10, max_iterations=max_iterations)
    tres = minimize_tron(tvg, thvp, torch.zeros(5, dtype=torch.float64), tolerance=1e-10,
                         max_iterations=max_iterations)
    _same(tres, jres)
    if max_iterations == 50:
        lb = minimize_lbfgs(tvg, torch.zeros(5, dtype=torch.float64), tolerance=1e-12,
                            max_iterations=300)
        np.testing.assert_allclose(tres.coefficients.numpy(), lb.coefficients.numpy(), atol=1e-4)


def test_tron_poisson(rng):
    X, y = _glm(rng, 200, 4, loss="poisson")
    (jvg, jhvp, _), (tvg, thvp, _) = _objectives(X, y, jl.poisson_loss, tl.poisson_loss, 1e-3)
    jres = jtron(jvg, jhvp, jnp.zeros(4), tolerance=1e-10, max_iterations=100)
    tres = minimize_tron(tvg, thvp, torch.zeros(4, dtype=torch.float64), tolerance=1e-10,
                         max_iterations=100)
    _same(tres, jres)
    g = tvg(tres.coefficients)[1].numpy()
    assert np.linalg.norm(g) < 1e-4 * max(1.0, np.linalg.norm(tvg(torch.zeros(4, dtype=torch.float64))[1].numpy()))


def test_tron_with_bounds_value_matches_coefficients():
    """f and g are evaluated at the projected iterate."""
    jvg, jhvp = quadratic([2.0, -3.0], [1.0, 1.0], jnp)
    tvg, thvp = quadratic([2.0, -3.0], [1.0, 1.0], torch)
    lo, hi = -torch.ones(2, dtype=torch.float64), torch.ones(2, dtype=torch.float64)
    tres = minimize_tron(tvg, thvp, torch.zeros(2, dtype=torch.float64), lower_bounds=lo,
                         upper_bounds=hi, max_iterations=50)
    jres = jtron(jvg, jhvp, jnp.zeros(2), lower_bounds=-jnp.ones(2), upper_bounds=jnp.ones(2),
                 max_iterations=50)
    _same(tres, jres)
    np.testing.assert_allclose(float(tres.value), float(tvg(tres.coefficients)[0]), rtol=1e-10)
    assert (tres.coefficients.abs() <= 1.0 + 1e-12).all()


def test_tron_vmap_lanes_match_jax(rng):
    """Lanes with different curvature leave CG and the outer loop at
    different trips; per-lane results equal jax.vmap's."""
    centers = rng.normal(size=(5, 3))
    scales = rng.uniform(0.1, 30.0, size=(5, 3))

    def solve(center, scale):
        vg = lambda x: (0.5 * jnp.sum(scale * (x - center) ** 2), scale * (x - center))
        return jtron(vg, lambda x, v: scale * v, jnp.zeros(3), max_iterations=30, tolerance=1e-9)

    jres = jax.vmap(solve)(jnp.asarray(centers), jnp.asarray(scales))
    c, s = torch.from_numpy(centers), torch.from_numpy(scales)
    tres = minimize_tron(lambda x: (0.5 * torch.sum(s * (x - c) ** 2, dim=-1), s * (x - c)),
                         lambda x, v: s * v, torch.zeros(5, 3, dtype=torch.float64),
                         max_iterations=30, tolerance=1e-9)
    np.testing.assert_allclose(tres.coefficients.numpy(), np.asarray(jres.coefficients), atol=1e-8)
    np.testing.assert_array_equal(tres.iterations.numpy(), np.asarray(jres.iterations))
    np.testing.assert_array_equal(tres.convergence_reason.numpy(), np.asarray(jres.convergence_reason))


# ---------------------------------------------------------------- NEWTON


def test_newton_quadratic_one_step():
    jvg, _ = quadratic([1.0, -2.0, 3.0], [1.0, 10.0, 0.1], jnp)
    tvg, _ = quadratic([1.0, -2.0, 3.0], [1.0, 10.0, 0.1], torch)
    H = np.diag([1.0, 10.0, 0.1])
    jres = jnewton(jvg, lambda x: jnp.asarray(H), jnp.zeros(3), tolerance=1e-12)
    tres = minimize_newton(tvg, lambda x: torch.from_numpy(H), torch.zeros(3, dtype=torch.float64),
                           tolerance=1e-12)
    np.testing.assert_allclose(tres.coefficients.numpy(), [1.0, -2.0, 3.0], atol=1e-8)
    assert int(tres.iterations) <= 2
    _same(tres, jres)


def test_newton_logistic_matches_jax_and_lbfgs(rng):
    X, y = _glm(rng, 150, 8)
    (jvg, _, jh), (tvg, _, th) = _objectives(X, y, jl.logistic_loss, tl.logistic_loss, 1.0)
    jres = jnewton(jvg, jh, jnp.zeros(8), tolerance=1e-12, max_iterations=50)
    tres = minimize_newton(tvg, th, torch.zeros(8, dtype=torch.float64), tolerance=1e-12,
                           max_iterations=50)
    _same(tres, jres)
    lb = minimize_lbfgs(tvg, torch.zeros(8, dtype=torch.float64), tolerance=1e-12, max_iterations=200)
    np.testing.assert_allclose(tres.coefficients.numpy(), lb.coefficients.numpy(), atol=1e-5)
    assert int(tres.iterations) < int(lb.iterations) and int(tres.iterations) <= 10


def test_newton_poisson(rng):
    X, y = _glm(rng, 100, 4, loss="poisson")
    (jvg, _, jh), (tvg, _, th) = _objectives(X, y, jl.poisson_loss, tl.poisson_loss, 0.1)
    jres = jnewton(jvg, jh, jnp.zeros(4), tolerance=1e-12)
    tres = minimize_newton(tvg, th, torch.zeros(4, dtype=torch.float64), tolerance=1e-12)
    _same(tres, jres)
    np.testing.assert_allclose(tres.gradient.numpy(), 0.0, atol=1e-5)


def test_newton_singular_hessian_damps():
    """Rank-deficient Hessian (no L2): the damping ladder still makes progress."""
    def jvg(x):
        r = x[0] + x[1] - 1.0
        return 0.5 * r * r, jnp.stack([r, r])

    def tvg(x):
        r = x[..., 0] + x[..., 1] - 1.0
        return 0.5 * r * r, torch.stack([r, r], dim=-1)

    jres = jnewton(jvg, lambda x: jnp.ones((2, 2)), jnp.zeros(2), tolerance=1e-10, max_iterations=50)
    tres = minimize_newton(tvg, lambda x: torch.ones((2, 2), dtype=torch.float64),
                           torch.zeros(2, dtype=torch.float64), tolerance=1e-10, max_iterations=50)
    assert float(tres.value) < 1e-10
    _same(tres, jres)


@pytest.mark.parametrize("d", [3, 40])
def test_newton_direction_ladder(d, rng):
    """Per lane, the first level with a finite factor and direction wins,
    chosen on the device; a lane with no usable level takes -g. d = 40
    takes the cholesky_ex path."""
    A = rng.normal(size=(d, d))
    spd = A @ A.T + np.eye(d)
    singular = np.ones((d, d))
    nonfinite = np.full((d, d), np.nan)
    H = np.stack([spd, singular, nonfinite])
    g = rng.normal(size=(3, d))
    got = _newton_direction(torch.from_numpy(H), torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(got[0], np.linalg.solve(spd, -g[0]), rtol=1e-8)
    assert np.isfinite(got[1]).all()
    np.testing.assert_array_equal(got[2], -g[2])


def test_newton_with_bounds():
    jvg, _ = quadratic([2.0, -3.0], [1.0, 1.0], jnp)
    tvg, _ = quadratic([2.0, -3.0], [1.0, 1.0], torch)
    tres = minimize_newton(tvg, lambda x: torch.eye(2, dtype=torch.float64),
                           torch.zeros(2, dtype=torch.float64),
                           lower_bounds=-torch.ones(2, dtype=torch.float64),
                           upper_bounds=torch.ones(2, dtype=torch.float64), max_iterations=50)
    jres = jnewton(jvg, lambda x: jnp.eye(2), jnp.zeros(2), lower_bounds=-jnp.ones(2),
                   upper_bounds=jnp.ones(2), max_iterations=50)
    np.testing.assert_allclose(tres.coefficients.numpy(), [1.0, -1.0], atol=1e-6)
    np.testing.assert_allclose(float(tres.value), float(tvg(tres.coefficients)[0]), rtol=1e-10)
    _same(tres, jres)


@pytest.mark.parametrize("opt", ["TRON", "NEWTON"])
def test_warm_start_at_optimum_converges_immediately(opt):
    tvg, thvp = quadratic([1.0, -2.0], [1.0, 1.0], torch)
    center = torch.tensor([1.0, -2.0], dtype=torch.float64)
    if opt == "TRON":
        res = minimize_tron(tvg, thvp, center)
    else:
        res = minimize_newton(tvg, lambda x: torch.eye(2, dtype=torch.float64), center)
    assert int(res.convergence_reason) == ConvergenceReason.GRADIENT_CONVERGED
    assert int(res.iterations) == 0
    np.testing.assert_allclose(res.coefficients.numpy(), center.numpy())


# ---------------------------------------------------------------- factory


def test_factory_dispatch_and_requires(rng):
    X, y = _glm(rng, 50, 3)
    (_, _, _), (tvg, thvp, th) = _objectives(X, y, jl.logistic_loss, tl.logistic_loss, 0.5)
    x0 = torch.zeros(3, dtype=torch.float64)
    for opt, kwargs in ((OptimizerType.TRON, {"hvp": thvp}), (OptimizerType.NEWTON, {"hess": th}),
                        (OptimizerType.LBFGS, {})):
        res = build_minimizer(OptimizerConfig(optimizer_type=opt, max_iterations=100,
                                              tolerance=1e-10))(tvg, x0, **kwargs)
        assert int(res.convergence_reason) != ConvergenceReason.NOT_CONVERGED
        assert torch.isfinite(res.gradient).all()
    with pytest.raises(ValueError, match="Hessian-vector"):
        build_minimizer(OptimizerConfig(optimizer_type=OptimizerType.TRON))(tvg, x0)
    with pytest.raises(ValueError, match="full-Hessian"):
        build_minimizer(OptimizerConfig(optimizer_type=OptimizerType.NEWTON))(tvg, x0)
    with pytest.raises(ValueError, match="OWLQN"):
        build_minimizer(OptimizerConfig(optimizer_type=OptimizerType.NEWTON))(
            tvg, x0, hess=th, l1_weight=0.5)
    with pytest.raises(ValueError, match="box"):
        build_minimizer(OptimizerConfig(optimizer_type=OptimizerType.OWLQN))(
            tvg, x0, l1_weight=0.1, lower_bounds=-torch.ones(3, dtype=torch.float64))
    with pytest.raises(ValueError, match="LBFGSB requires box bounds"):
        build_minimizer(OptimizerConfig(optimizer_type=OptimizerType.LBFGSB))(tvg, x0)
    # bounded LBFGS projects: every coefficient inside the box
    lo = torch.full((3,), -0.05, dtype=torch.float64)
    res = build_minimizer(OptimizerConfig())(tvg, x0, lower_bounds=lo, upper_bounds=-lo)
    assert bool((res.coefficients.abs() <= 0.05).all())


def test_second_order_rejected_for_smoothed_hinge():
    from photon_ml_tpu_torch.optimization.config import (
        GLMOptimizationConfiguration,
        RegularizationContext,
    )
    from photon_ml_tpu_torch.optimization.problem import GLMOptimizationProblem
    from photon_ml_tpu_torch.types import RegularizationType

    for opt in (OptimizerType.NEWTON, OptimizerType.TRON):
        cfg = GLMOptimizationConfiguration(OptimizerConfig(optimizer_type=opt),
                                           RegularizationContext(RegularizationType.L2), 1.0)
        with pytest.raises(ValueError, match="twice-differentiable"):
            GLMOptimizationProblem(task=TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM, configuration=cfg)
        GLMOptimizationProblem(task=TaskType.LOGISTIC_REGRESSION, configuration=cfg)


# ------------------------------------------- batched bucket solves vs jax.vmap


@pytest.mark.parametrize("variance", ["NONE", "FULL"])
@pytest.mark.parametrize("opt", ["TRON", "NEWTON"])
def test_re_bucket_solver_matches_jax_per_lane(opt, variance, rng):
    """A bucket of 7 entities of different sizes and weights: the port's
    batched lanes against JAX's vmapped solve, per lane."""
    E, S, K = 7, 32, 4
    sizes = np.array([1, 3, 8, 13, 21, 29, 32])
    X = rng.normal(size=(E, S, K))
    X[:, :, 0] = 1.0
    y = (rng.uniform(size=(E, S)) > 0.5).astype(np.float64)
    w = rng.uniform(0.2, 3.0, size=(E, S))
    valid = np.arange(S)[None, :] < sizes[:, None]
    w = np.where(valid, w, 0.0)
    X = np.where(valid[..., None], X, 0.0)
    y = np.where(valid, y, 0.0)
    off = np.where(valid, rng.normal(size=(E, S)) * 0.2, 0.0)
    w0 = rng.normal(size=(E, K)) * 0.1
    l2 = rng.uniform(0.5, 2.0, size=E)
    cfg = dict(optimizer_type=opt, max_iterations=30)

    jsolve = jsc.re_bucket_solver(JTask.LOGISTIC_REGRESSION, JConfig(**cfg), False, JVar(variance),
                                  "lbfgs")
    jw, jr, ji, jv = jsolve(*(jnp.asarray(a) for a in (X, y, w, off, w0, l2)), jnp.asarray(0.0))
    tsolve = tsc.re_bucket_solver(TaskType.LOGISTIC_REGRESSION, OptimizerConfig(**cfg), False,
                                  VarianceComputationType(variance), "lbfgs")
    tw, tr, ti, tv = tsolve(*(torch.from_numpy(a) for a in (X, y, w, off, w0, l2)), 0.0)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-8)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert tv.shape == ((E, 0) if variance == "NONE" else (E, K))
    if variance == "FULL":
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-8)
    assert len(set(ti.tolist())) > 1  # lanes converge at different trips


@pytest.mark.parametrize("opt", ["TRON", "NEWTON"])
def test_fe_glm_solver_matches_jax(opt, rng):
    n, d = 300, 6
    X = rng.normal(size=(n, d))
    y = ((X @ rng.normal(size=d) + rng.normal(size=n)) > 0).astype(np.float64)
    off = rng.normal(size=n) * 0.1
    w = rng.uniform(0.5, 1.5, size=n)
    jd = JData.build(X, y, offsets=off, weights=w, dtype=jnp.float64)
    td = TData.build(X, y, off, w, dtype=torch.float64, device="cpu")
    from photon_ml_tpu.normalization import NormalizationContext as JNorm
    from photon_ml_tpu_torch.normalization import NO_NORMALIZATION

    empty = jnp.zeros((0,))
    jsolve = jsc.glm_solver(JTask.LOGISTIC_REGRESSION, JConfig(optimizer_type=JOpt(opt),
                            max_iterations=50), False, False, False, JVar.SIMPLE, allow_fused=False)
    jres, jvar = jsolve(jd, jnp.zeros(d), jnp.asarray(1.0), jnp.asarray(0.0), empty, empty, JNorm())
    tsolve = tsc.glm_solver(TaskType.LOGISTIC_REGRESSION,
                            OptimizerConfig(optimizer_type=opt, max_iterations=50), False, False,
                            False, VarianceComputationType.SIMPLE, allow_fused=False)
    syncs = any_lane.syncs
    tres, tvar = tsolve(td, torch.zeros(d, dtype=torch.float64), 1.0, 0.0, None, None,
                        NO_NORMALIZATION)
    assert any_lane.syncs > syncs
    _same(tres, jres)
    np.testing.assert_allclose(tvar.numpy(), np.asarray(jvar), rtol=1e-10)
    # with an upper bound that binds, the same solve against JAX's bounded one
    hi = np.full(d, 0.5)
    jres, _ = jsc.glm_solver(JTask.LOGISTIC_REGRESSION, JConfig(optimizer_type=JOpt(opt),
                             max_iterations=50), False, False, True, JVar.NONE,
                             allow_fused=False)(jd, jnp.zeros(d), jnp.asarray(1.0),
                                                jnp.asarray(0.0), empty, jnp.asarray(hi), JNorm())
    tres, _ = tsc.glm_solver(TaskType.LOGISTIC_REGRESSION,
                             OptimizerConfig(optimizer_type=opt, max_iterations=50), False, False,
                             True, VarianceComputationType.NONE, allow_fused=False)(
        td, torch.zeros(d, dtype=torch.float64), 1.0, 0.0, None, torch.as_tensor(hi),
        NO_NORMALIZATION)
    assert bool((tres.coefficients == 0.5).any())  # the bound binds
    _same(tres, jres)


# ------------------------------------------------- solves through the kernels


def _f32_problem(rng, n, d):
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.uniform(size=n) > 0.5).astype(np.float32)
    off = (rng.normal(size=n) * 0.1).astype(np.float32)
    w = np.ones(n, dtype=np.float32)
    w[::11] = 0.0
    jd = JData(X=JDense(jnp.asarray(X)), labels=jnp.asarray(y), offsets=jnp.asarray(off),
               weights=jnp.asarray(w))
    td = TData(X=TDense(torch.from_numpy(X)), labels=torch.from_numpy(y),
               offsets=torch.from_numpy(off), weights=torch.from_numpy(w))
    return jd, td


def test_tron_solve_through_fused_hvp(rng):
    """TRON with fused value+gradient (B1) and HVP (B2) matches the JAX
    fused solve and the port's stock one."""
    jd, td = _f32_problem(rng, 400, 5)
    jo, to = JObjective(jl.logistic_loss), TObjective(tl.logistic_loss)
    jvg = lambda x: jo.value_and_gradient(jd, x, 0.5)
    jhvp = lambda x, v: jo.hessian_vector(jd, x, v, 0.5)
    with pallas_interpret():
        jfused = jtron(jvg, jhvp, jnp.zeros(5, jnp.float32), tolerance=1e-10, max_iterations=60)
    tvg, thvp = make_value_and_grad(to, td, 0.5), make_hessian_vector(to, td, 0.5)
    stock = minimize_tron(tvg, thvp, torch.zeros(5), tolerance=1e-10, max_iterations=60)
    calls = fused_glm.fused_hessian_vector_sums_plain.calls
    with fused_glm.fused_override(True):
        fused = minimize_tron(tvg, thvp, torch.zeros(5), tolerance=1e-10, max_iterations=60)
    assert fused_glm.fused_hessian_vector_sums_plain.calls > calls
    np.testing.assert_allclose(fused.coefficients.numpy(), np.asarray(jfused.coefficients), atol=5e-4)
    np.testing.assert_allclose(fused.coefficients.numpy(), stock.coefficients.numpy(), atol=5e-4)


def test_newton_solve_through_fused_hessian(rng):
    """NEWTON with fused value+gradient (B1) and Hessian (B3) matches the
    JAX fused solve and the port's stock one."""
    jd, td = _f32_problem(rng, 400, 5)
    jo, to = JObjective(jl.logistic_loss), TObjective(tl.logistic_loss)
    jvg = lambda x: jo.value_and_gradient(jd, x, 0.8)
    jh = lambda x: jo.hessian_matrix(jd, x, 0.8)
    with pallas_interpret():
        jfused = jnewton(jvg, jh, jnp.zeros(5, jnp.float32), tolerance=1e-10)
    tvg, th = make_value_and_grad(to, td, 0.8), lambda x: to.hessian_matrix(td, x, 0.8)
    stock = minimize_newton(tvg, th, torch.zeros(5), tolerance=1e-10)
    calls = fused_hess.fused_hessian_matrix_plain.calls
    with fused_glm.fused_override(True):
        fused = minimize_newton(tvg, th, torch.zeros(5), tolerance=1e-10)
    assert fused_hess.fused_hessian_matrix_plain.calls > calls
    np.testing.assert_allclose(fused.coefficients.numpy(), np.asarray(jfused.coefficients), atol=5e-4)
    np.testing.assert_allclose(fused.coefficients.numpy(), stock.coefficients.numpy(), atol=5e-4)
