"""The port's L-BFGS solves against the JAX package's, same numpy inputs, f64.

- FE: ``glm_solver`` for logistic + L2 on one problem: coefficients within
  atol 1e-8, the same iteration count and the same convergence reason.
- RE: ``re_bucket_solver`` on a bucket of 7 entities of different sizes and
  weights: the port runs them as 7 lanes of one batched loop, JAX as a
  vmapped while_loop; per-lane coefficients within atol 1e-8 and per-lane
  iteration counts and reasons equal.
- The batched strong-Wolfe line search against JAX's vmapped one: per-lane
  step, value and gradient within rtol 1e-10, evaluation counts equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.data.dataset import LabeledData as JData
from photon_ml_tpu.normalization import NormalizationContext as JNorm
from photon_ml_tpu.optimization import solver_cache as jsc
from photon_ml_tpu.optimization.common import OptimizerConfig as JConfig
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu.types import VarianceComputationType as JVar
from photon_ml_tpu_torch.data.dataset import LabeledData as TData
from photon_ml_tpu_torch.normalization import NO_NORMALIZATION
from photon_ml_tpu_torch.optimization import solver_cache as tsc
from photon_ml_tpu_torch.optimization.common import OptimizerConfig as TConfig
from photon_ml_tpu_torch.optimization.common import any_lane
from photon_ml_tpu_torch.optimization.factory import build_minimizer
from photon_ml_tpu_torch.types import OptimizerType, TaskType, VarianceComputationType


@pytest.mark.parametrize("max_iterations", [5, 100])
def test_fe_glm_solver_matches_jax(max_iterations, rng):
    n, d = 300, 6
    X = rng.normal(size=(n, d))
    y = ((X @ rng.normal(size=d) + rng.normal(size=n)) > 0).astype(np.float64)
    off = rng.normal(size=n) * 0.1
    w = rng.uniform(0.5, 1.5, size=n)
    jd = JData.build(X, y, offsets=off, weights=w, dtype=jnp.float64)
    td = TData.build(X, y, off, w, dtype=torch.float64, device="cpu")
    empty = jnp.zeros((0,))
    jsolve = jsc.glm_solver(JTask.LOGISTIC_REGRESSION, JConfig(max_iterations=max_iterations),
                            False, False, False, JVar.NONE, allow_fused=False)
    jres, _ = jsolve(jd, jnp.zeros(d), jnp.asarray(1.0), jnp.asarray(0.0), empty, empty, JNorm())
    tsolve = tsc.glm_solver(TaskType.LOGISTIC_REGRESSION, TConfig(max_iterations=max_iterations),
                            False, False, False, VarianceComputationType.NONE, allow_fused=False)
    syncs = any_lane.syncs
    tres, var = tsolve(td, torch.zeros(d, dtype=torch.float64), 1.0, 0.0, None, None, NO_NORMALIZATION)
    assert any_lane.syncs > syncs
    assert tres.coefficients.shape == (d,) and var.shape == (0,)
    np.testing.assert_allclose(tres.coefficients.numpy(), np.asarray(jres.coefficients), atol=1e-8)
    np.testing.assert_allclose(float(tres.value), float(jres.value), rtol=1e-12)
    assert int(tres.iterations) == int(jres.iterations)
    assert int(tres.convergence_reason) == int(jres.convergence_reason)
    assert tres.reason_name() == jres.reason_name()


def test_re_bucket_solver_matches_jax_per_lane(rng):
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
    cfg = dict(max_iterations=30)

    jsolve = jsc.re_bucket_solver(JTask.LOGISTIC_REGRESSION, JConfig(**cfg), False, JVar.NONE, "lbfgs")
    jw, jr, ji, _ = jsolve(*(jnp.asarray(a) for a in (X, y, w, off, w0, l2)), jnp.asarray(0.0))
    tsolve = tsc.re_bucket_solver(TaskType.LOGISTIC_REGRESSION, TConfig(**cfg), False,
                                  VarianceComputationType.NONE, "lbfgs")
    tw, tr, ti, tv = tsolve(*(torch.from_numpy(a) for a in (X, y, w, off, w0, l2)), 0.0)
    assert tw.shape == (E, K) and tv.shape == (E, 0)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-8)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert len(set(ti.tolist())) > 1  # lanes converge at different trips


def test_unported_options_raise():
    """The options of the later slices now work: OWLQN and LBFGSB build,
    ``glm_solver`` takes bounds and an L1 weight, and the bucket solver takes
    ``re_solver="direct"``; L1 without OWLQN still raises."""
    quad = lambda x: (0.5 * (x * x).sum(), x)  # noqa: E731
    for opt, kw in ((OptimizerType.OWLQN, {"l1_weight": 0.5}),
                    (OptimizerType.LBFGSB, {"lower_bounds": torch.full((2,), 0.5)})):
        res = build_minimizer(TConfig(optimizer_type=opt))(quad, torch.ones(2), **kw)
        assert int(res.convergence_reason) != 0
        np.testing.assert_allclose(res.coefficients.numpy(), [0.0, 0.0] if opt == "OWLQN" else
                                   [0.5, 0.5], atol=1e-6)
    X = torch.as_tensor(np.random.default_rng(0).normal(size=(40, 3)))
    data = TData.build(X.numpy(), (X[:, 0] > 0).double().numpy(), dtype=torch.float64,
                       device="cpu")
    lo = torch.full((3,), -0.1, dtype=torch.float64)
    res, var = tsc.glm_solver(TaskType.LOGISTIC_REGRESSION, TConfig(), False, True, False,
                              VarianceComputationType.SIMPLE)(
        data, torch.zeros(3, dtype=torch.float64), 1.0, 0.0, lo, None, NO_NORMALIZATION)
    assert bool((res.coefficients >= lo).all()) and var.shape == (3,)
    res, _ = tsc.glm_solver(TaskType.LOGISTIC_REGRESSION, TConfig(optimizer_type="OWLQN"), True,
                            False, False, VarianceComputationType.NONE)(
        data, torch.zeros(3, dtype=torch.float64), 1.0, 5.0, None, None, NO_NORMALIZATION)
    assert int((res.coefficients == 0).sum()) >= 1
    E, S, K = 3, 8, 2
    Xb = torch.as_tensor(np.random.default_rng(1).normal(size=(E, S, K)))
    ones = torch.ones((E, S), dtype=torch.float64)
    w, reasons, iters, _ = tsc.re_bucket_solver(TaskType.LINEAR_REGRESSION, TConfig(), False,
                                                VarianceComputationType.NONE, "direct")(
        Xb, Xb[..., 0], ones, 0 * ones, torch.zeros((E, K), dtype=torch.float64),
        torch.ones(E, dtype=torch.float64), 0.0)
    assert iters.tolist() == [1, 1, 1] and bool(torch.isfinite(w).all())
    minimize = build_minimizer(TConfig())
    with pytest.raises(ValueError, match="OWLQN"):
        minimize(lambda x: (x.sum(), x), torch.zeros(2), l1_weight=0.5)


def test_strong_wolfe_lanes_match_vmapped_jax(rng):
    """The batched line search against JAX's strong_wolfe vmapped over lanes:
    per-lane step, value, gradient, success and evaluation count, with a
    tight budget so some lanes stop on it while others still search."""
    import jax

    from photon_ml_tpu.optimization import linesearch as jls
    from photon_ml_tpu_torch.optimization import linesearch as tls

    B, d = 9, 3
    A = rng.uniform(0.1, 50.0, size=(B, d))  # per-lane curvature, very uneven
    c = rng.normal(size=(B, d))
    x0 = rng.normal(size=(B, d))
    # Newton-like directions scaled from far too short to far too long, so
    # lanes need expansion, zoom or nothing and stop at different trips
    scale = np.geomspace(0.01, 100.0, B)[:, None]
    direction = -(x0 - c) * scale

    def f_np(lib, a, x, cc):
        r = x - cc
        return lib.sum(a * r * r, axis=-1) * 0.5 + lib.sum(lib.log(1 + lib.exp(x)), axis=-1)

    def jax_one(a, cc, x, dd):
        def vg(xx):
            return jax.value_and_grad(lambda z: f_np(jnp, a, z, cc))(xx)

        f0, g0 = vg(x)
        phi = lambda t: (lambda fg: (fg[0], fg[1], jnp.dot(fg[1], dd)))(vg(x + t * dd))
        return jls.strong_wolfe(phi, f0, g0, jnp.dot(g0, dd), jnp.asarray(1.0), max_iters=6)

    jres = jax.vmap(jax_one)(*(jnp.asarray(v) for v in (A, c, x0, direction)))

    tA, tc, tx, td = (torch.from_numpy(v) for v in (A, c, x0, direction))

    def tvg(x):
        r = x - tc
        f = 0.5 * torch.sum(tA * r * r, dim=-1) + torch.sum(torch.log(1 + torch.exp(x)), dim=-1)
        return f, tA * r + torch.sigmoid(x)

    f0, g0 = tvg(tx)

    def phi(t):
        f, g = tvg(tx + t.unsqueeze(-1) * td)
        return f, g, torch.sum(g * td, dim=-1)

    tres = tls.strong_wolfe(phi, f0, g0, torch.sum(g0 * td, dim=-1), torch.ones(B, dtype=torch.float64),
                            max_iters=6)
    np.testing.assert_array_equal(tres.evals.numpy(), np.asarray(jres.evals))
    np.testing.assert_array_equal(tres.success.numpy(), np.asarray(jres.success))
    assert len(set(tres.evals.tolist())) > 1  # lanes stop at different trips
    for t, j in ((tres.alpha, jres.alpha), (tres.value, jres.value), (tres.grad, jres.grad)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-10, atol=1e-12)
