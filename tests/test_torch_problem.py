"""The port's single-GLM entry point against the JAX package's, same numpy inputs.

Path T of the slice at a small size: BASELINE config #2
(``benchmarks/run_benchmarks.py``: linear and Poisson regression, TRON,
L2 weight 1.0, max_iterations 50; data from
``interop.make_glm_workload``, the same generative process) through
``GLMOptimizationProblem.run``.

- Stock at f64 against JAX ``problem.run``: coefficients within atol 1e-8,
  the same iteration count and convergence reason; with variances and a
  shift+factor normalization as well (variances rtol 1e-8).
- Fused at f32, the port's plain kernel versions (B1, B2) against the JAX
  kernels in interpret mode: coefficients within atol 5e-4 (the JAX
  package's own fused-against-stock tolerance) and the value within rtol
  1e-5. Iterations and reasons are held equal at f64 only: the default
  tolerance 1e-7 lies below f32's epsilon, so the last attempts of an f32
  solve compare values that differ by rounding alone (the Poisson solve
  here ends after 3 iterations in JAX and 4 in the port).
- A warm start carried across by ``interop.glm_model_from_numpy`` from a
  JAX model: both packages continue to the same model.
- The models: predict, score and classify against the JAX models.
"""

import contextlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.data.dataset import LabeledData as JData
from photon_ml_tpu.models.glm import Coefficients as JCoef
from photon_ml_tpu.models.glm import GeneralizedLinearModel as JModel
from photon_ml_tpu.normalization import NormalizationContext as JNorm
from photon_ml_tpu.ops import pallas_glm
from photon_ml_tpu.optimization.common import OptimizerConfig as JOptConfig
from photon_ml_tpu.optimization.config import GLMOptimizationConfiguration as JCfg
from photon_ml_tpu.optimization.config import RegularizationContext as JReg
from photon_ml_tpu.optimization.problem import GLMOptimizationProblem as JProblem
from photon_ml_tpu.types import OptimizerType as JOpt
from photon_ml_tpu.types import RegularizationType as JRegType
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch import interop
from photon_ml_tpu_torch.data.dataset import LabeledData as TData
from photon_ml_tpu_torch.models.glm import model_class_for_task
from photon_ml_tpu_torch.normalization import NormalizationContext as TNorm
from photon_ml_tpu_torch.ops import fused_glm
from photon_ml_tpu_torch.optimization.common import OptimizerConfig
from photon_ml_tpu_torch.optimization.config import (
    GLMOptimizationConfiguration,
    RegularizationContext,
)
from photon_ml_tpu_torch.optimization.problem import GLMOptimizationProblem, cholesky_inverse
from photon_ml_tpu_torch.optimization.tron import truncated_conjugate_gradient
from photon_ml_tpu_torch.types import OptimizerType, RegularizationType, TaskType

TASKS = [("LINEAR_REGRESSION", "y_linear"), ("POISSON_REGRESSION", "y_poisson")]


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


def _problems(task, opt="TRON", iters=50, variance="NONE", norm=None):
    jp = JProblem(
        task=JTask(task),
        configuration=JCfg(JOptConfig(optimizer_type=JOpt(opt), max_iterations=iters),
                           JReg(JRegType.L2), 1.0),
        normalization=norm[0] if norm else JNorm(),
        variance_computation=variance,
    )
    tp = GLMOptimizationProblem(
        task=TaskType(task),
        configuration=GLMOptimizationConfiguration(
            OptimizerConfig(optimizer_type=OptimizerType(opt), max_iterations=iters),
            RegularizationContext(RegularizationType.L2), 1.0),
        normalization=norm[1] if norm else TNorm(),
        variance_computation=variance,
    )
    return jp, tp


def _same_result(tres, jres, atol):
    np.testing.assert_allclose(tres.coefficients.numpy(), np.asarray(jres.coefficients), atol=atol)
    assert int(tres.iterations) == int(jres.iterations)
    assert int(tres.convergence_reason) == int(jres.convergence_reason)


@pytest.mark.parametrize("task,label", TASKS)
def test_path_t_stock_f64_matches_jax(task, label):
    wl = interop.make_glm_workload(n_samples=1500, n_features=8)
    jp, tp = _problems(task)
    jm, jres = jp.run(JData.build(wl["X"], wl[label], dtype=jnp.float64))
    tdata = TData.build(wl["X"], wl[label], dtype=torch.float64, device="cpu")
    steps = truncated_conjugate_gradient.steps
    tm, tres = tp.run(tdata)
    assert truncated_conjugate_gradient.steps > steps
    _same_result(tres, jres, 1e-8)
    np.testing.assert_allclose(tm.to_numpy(), np.asarray(jm.coefficients.means), atol=1e-8)
    assert tm.coefficients.variances is None and tm.task == TaskType(task)
    assert tm.coefficients.means.device == tdata.labels.device


@pytest.mark.parametrize("task,label", TASKS)
def test_path_t_fused_f32_matches_jax(task, label):
    wl = interop.make_glm_workload(n_samples=1500, n_features=8)
    jp, tp = _problems(task)
    with pallas_interpret():
        _, jres = jp.run(JData.build(wl["X"], wl[label], dtype=jnp.float32))
    calls = fused_glm.fused_hessian_vector_sums_plain.calls
    with fused_glm.fused_override(True):
        tm, tres = tp.run(TData.build(wl["X"], wl[label], dtype=torch.float32, device="cpu"))
    assert fused_glm.fused_hessian_vector_sums_plain.calls > calls  # B2 ran every CG step
    assert tm.coefficients.means.dtype == torch.float32
    np.testing.assert_allclose(tres.coefficients.numpy(), np.asarray(jres.coefficients), atol=5e-4)
    np.testing.assert_allclose(float(tres.value), float(jres.value), rtol=1e-5)
    assert tres.reason_name() != "NOT_CONVERGED"


@pytest.mark.parametrize("opt", ["TRON", "NEWTON"])
@pytest.mark.parametrize("variance", ["SIMPLE", "FULL"])
def test_run_with_normalization_and_variances(opt, variance, rng):
    """Logistic with a shift+factor normalization: the optimum returns to
    the original space and the variances scale by factor^2, as in JAX."""
    n, d = 400, 5
    X = rng.normal(size=(n, d))
    X[:, 0] = 1.0
    y = (X @ rng.normal(size=d) + rng.normal(size=n) > 0).astype(float)
    factors = rng.uniform(0.5, 2.0, size=d)
    shifts = rng.normal(size=d) * 0.2
    factors[0], shifts[0] = 1.0, 0.0
    norms = (JNorm(factors=factors, shifts=shifts, intercept_index=0),
             TNorm(factors=factors, shifts=shifts, intercept_index=0))
    jp, tp = _problems("LOGISTIC_REGRESSION", opt=opt, variance=variance, norm=norms)
    jm, jres = jp.run(JData.build(X, y, dtype=jnp.float64))
    tm, tres = tp.run(TData.build(X, y, dtype=torch.float64, device="cpu"))
    _same_result(tres, jres, 1e-8)
    np.testing.assert_allclose(tm.to_numpy(), np.asarray(jm.coefficients.means), atol=1e-8)
    np.testing.assert_allclose(tm.coefficients.variances.numpy(),
                               np.asarray(jm.coefficients.variances), rtol=1e-8)
    tdata = TData.build(X, y, dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(
        tp.compute_variances(tdata, tres.coefficients).numpy(),
        np.asarray(jp.compute_variances(JData.build(X, y, dtype=jnp.float64), jres.coefficients)),
        rtol=1e-8)


@pytest.mark.parametrize("task,label", TASKS)
def test_warm_start_carried_across(task, label):
    """A JAX model after 2 TRON iterations crosses by interop; both packages
    continue from it to the same model."""
    wl = interop.make_glm_workload(n_samples=1500, n_features=8)
    jdata = JData.build(wl["X"], wl[label], dtype=jnp.float64)
    jp2, _ = _problems(task, iters=2)
    jm0, _ = jp2.run(jdata)
    jp, tp = _problems(task)
    jm, jres = jp.run(jdata, initial_model=jm0)
    start = interop.glm_model_from_numpy(task, np.asarray(jm0.coefficients.means), device="cpu",
                                         dtype=torch.float64)
    tm, tres = tp.run(TData.build(wl["X"], wl[label], dtype=torch.float64, device="cpu"),
                      initial_model=start)
    _same_result(tres, jres, 1e-8)
    back = interop.glm_model_to_numpy(tm)
    assert back["variances"] is None and back["task"] == TaskType(task)
    np.testing.assert_allclose(back["means"], np.asarray(jm.coefficients.means), atol=1e-8)


def test_bounds_and_normalization_rejected():
    jp, tp = _problems("LINEAR_REGRESSION",
                       norm=(None, TNorm(factors=np.ones(3), shifts=np.zeros(3), intercept_index=0)))
    data = TData.build(np.ones((4, 3)), np.zeros(4), dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="Box constraints"):
        tp.run(data, lower_bounds=np.zeros(3))
    # without normalization the bound reaches the solve, as in JAX
    jplain, plain = _problems("LINEAR_REGRESSION")
    rng = np.random.default_rng(3)
    X, y = rng.normal(size=(40, 3)), rng.normal(size=40) + 2.0
    upper = np.full(3, 0.1)
    tm, tres = plain.run(TData.build(X, y, dtype=torch.float64, device="cpu"), upper_bounds=upper)
    jm, jres = jplain.run(JData.build(X, y, dtype=jnp.float64), upper_bounds=jnp.asarray(upper))
    assert bool((tm.coefficients.means <= 0.1).all())
    _same_result(tres, jres, 1e-9)


@pytest.mark.parametrize("task", list(JTask))
def test_models_match_jax(task, rng):
    X = rng.normal(size=(20, 3))
    means = rng.normal(size=3)
    off = rng.normal(size=20)
    jm = JModel(JCoef(jnp.asarray(means)), task)
    tm = interop.glm_model_from_numpy(task.value, means, device="cpu", dtype=torch.float64)
    from photon_ml_tpu.models.glm import model_class_for_task as jclass

    cls = model_class_for_task(task.value)
    assert cls.__name__ == jclass(task).__name__
    assert cls(tm.coefficients).task == TaskType(task.value)
    from photon_ml_tpu.data.matrix import DenseDesignMatrix as JDense
    from photon_ml_tpu_torch.data.matrix import DenseDesignMatrix as TDense

    np.testing.assert_allclose(tm.predict(TDense(torch.from_numpy(X)), torch.from_numpy(off)).numpy(),
                               np.asarray(jm.predict(JDense(jnp.asarray(X)), jnp.asarray(off))),
                               rtol=1e-12)
    tdata = TData.build(X, np.zeros(20), off, dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(tm.score(tdata).numpy(),
                               np.asarray(jm.score(JData.build(X, np.zeros(20), off,
                                                               dtype=jnp.float64))), rtol=1e-12)
    if task.is_classification:
        np.testing.assert_array_equal(tm.classify(TDense(torch.from_numpy(X))).numpy(),
                                      np.asarray(jm.classify(JDense(jnp.asarray(X)))))
    else:
        with pytest.raises(ValueError, match="classification"):
            tm.classify(TDense(torch.from_numpy(X)))
    zero = GLMOptimizationProblem(TaskType(task.value), GLMOptimizationConfiguration())
    assert zero.initialize_zero_model(3, device="cpu").dim == 3


def test_cholesky_inverse_matches_jax(rng):
    from photon_ml_tpu.optimization.problem import cholesky_inverse as jinv

    A = rng.normal(size=(6, 6))
    H = A @ A.T + np.eye(6)
    np.testing.assert_allclose(cholesky_inverse(torch.from_numpy(H)).numpy(),
                               np.asarray(jinv(jnp.asarray(H))), rtol=1e-10, atol=1e-12)
    assert not torch.isfinite(cholesky_inverse(-torch.from_numpy(H))).all()
