"""The port's constraint maps against the JAX package's.

Mirrors tests/test_constraints.py: JSON parsing, the wildcard and overlap
rules, projection, constrained training with bounds that bind at the
optimum (LBFGS projection, LBFGSB, TRON), the estimator with box
constraints on its fixed effect, and the refusal of bounds together with
normalization. The bound vectors are held equal to JAX's
``build_bound_vectors`` on the same text and index map, and each
constrained solve against JAX's within 1e-9 at f64 with the same iteration
count and reason.
"""

import json
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.data.dataset import LabeledData as JData
from photon_ml_tpu.data.index_map import IndexMap as JIndexMap
from photon_ml_tpu.optimization import constraints as jcons
from photon_ml_tpu.optimization.common import OptimizerConfig as JOpt
from photon_ml_tpu.optimization.config import GLMOptimizationConfiguration as JCfg
from photon_ml_tpu.optimization.config import RegularizationContext as JReg
from photon_ml_tpu.optimization.problem import GLMOptimizationProblem as JProblem
from photon_ml_tpu.types import OptimizerType as JOptType
from photon_ml_tpu.types import RegularizationType as JRT
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch.data.dataset import FixedEffectDataset, LabeledData
from photon_ml_tpu_torch.data.index_map import IndexMap, feature_key
from photon_ml_tpu_torch.normalization import NormalizationContext
from photon_ml_tpu_torch.optimization.common import OptimizerConfig
from photon_ml_tpu_torch.optimization.config import (
    GLMOptimizationConfiguration,
    RegularizationContext,
)
from photon_ml_tpu_torch.optimization.constraints import (
    build_bound_vectors,
    parse_constraint_entries,
    project_coefficients,
)
from photon_ml_tpu_torch.optimization.problem import GLMOptimizationProblem
from photon_ml_tpu_torch.types import RegularizationType, TaskType

KEYS = [feature_key("age", ""), feature_key("income", "usd"), feature_key("income", "eur"),
        feature_key("height", "cm")]


def _imap():
    return IndexMap.build(KEYS, add_intercept=True)


def _same_as_jax(text):
    """The port's bound vectors, checked equal to JAX's on the same input."""
    got = build_bound_vectors(text, _imap())
    want = jcons.build_bound_vectors(text, JIndexMap.build(KEYS, add_intercept=True))
    if want is None:
        assert got is None
    else:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    return got


class TestParsing:
    def test_explicit_bounds(self):
        imap = _imap()
        lower, upper = _same_as_jax(json.dumps([
            {"name": "age", "term": "", "lowerBound": -1.0, "upperBound": 1.0},
            {"name": "income", "term": "usd", "upperBound": 0.5},
        ]))
        i_age = imap.get_index(feature_key("age", ""))
        i_usd = imap.get_index(feature_key("income", "usd"))
        assert (lower[i_age], upper[i_age]) == (-1.0, 1.0)
        assert lower[i_usd] == -np.inf and upper[i_usd] == 0.5
        i_cm = imap.get_index(feature_key("height", "cm"))
        assert lower[i_cm] == -np.inf and upper[i_cm] == np.inf

    def test_term_wildcard(self):
        imap = _imap()
        lower, _ = _same_as_jax(json.dumps([{"name": "income", "term": "*", "lowerBound": 0.0}]))
        for term in ("usd", "eur"):
            assert lower[imap.get_index(feature_key("income", term))] == 0.0
        assert lower[imap.get_index(feature_key("age", ""))] == -np.inf

    def test_all_wildcard_excludes_intercept(self):
        imap = _imap()
        lower, upper = _same_as_jax(json.dumps([{"name": "*", "term": "*", "lowerBound": -2.0,
                                                 "upperBound": 2.0}]))
        assert lower[imap.intercept_index] == -np.inf and upper[imap.intercept_index] == np.inf
        mask = np.ones(imap.size, bool)
        mask[imap.intercept_index] = False
        assert np.all(lower[mask] == -2.0) and np.all(upper[mask] == 2.0)

    def test_absent_features_and_empty_text(self):
        assert _same_as_jax(json.dumps([{"name": "weight", "term": "kg", "lowerBound": 0}])) is None
        assert _same_as_jax("") is None and _same_as_jax("[]") is None

    def test_validation_errors(self):
        imap = _imap()
        with pytest.raises(ValueError, match="name.*term|term.*name"):
            parse_constraint_entries(json.dumps([{"name": "a"}]))
        with pytest.raises(ValueError, match="below upper"):
            parse_constraint_entries(
                json.dumps([{"name": "a", "term": "", "lowerBound": 2, "upperBound": 1}]))
        with pytest.raises(ValueError, match="wildcard"):
            parse_constraint_entries(json.dumps([{"name": "*", "term": "t", "lowerBound": 0}]))
        with pytest.raises(ValueError, match="not a constraint"):
            parse_constraint_entries(json.dumps([{"name": "a", "term": ""}]))
        with pytest.raises(ValueError, match="parse"):
            parse_constraint_entries("{not json")
        with pytest.raises(ValueError, match="[Cc]onflict"):
            build_bound_vectors(json.dumps([
                {"name": "income", "term": "usd", "upperBound": 1.0},
                {"name": "income", "term": "*", "lowerBound": 0.0},
            ]), imap)
        with pytest.raises(ValueError, match="only entry"):
            build_bound_vectors(json.dumps([
                {"name": "*", "term": "*", "upperBound": 1.0},
                {"name": "age", "term": "", "lowerBound": 0.0},
            ]), imap)

    def test_project_coefficients(self):
        bounds = (np.array([-1.0, -np.inf]), np.array([1.0, 0.0]))
        np.testing.assert_array_equal(project_coefficients(np.array([2.0, 0.5]), bounds),
                                      [1.0, 0.0])
        np.testing.assert_array_equal(project_coefficients(np.array([2.0, 0.5]), None),
                                      [2.0, 0.5])


def _cfg(pkg, opt, iters=200, weight=1e-6):
    if pkg == "jax":
        return JCfg(JOpt(optimizer_type=JOptType(opt), max_iterations=iters), JReg(JRT.L2), weight)
    return GLMOptimizationConfiguration(OptimizerConfig(optimizer_type=opt, max_iterations=iters),
                                        RegularizationContext(RegularizationType.L2), weight)


class TestConstrainedTraining:
    @pytest.mark.parametrize("opt", ["LBFGS", "LBFGSB", "TRON", "NEWTON"])
    def test_active_bounds_hold_at_optimum(self, opt):
        """The reference test's own inputs: its generator, seeded from its node
        id as tests/conftest.py seeds it. How close the interior coordinate
        comes to the generating one depends on the draw (the projected
        solvers stop on the relative objective tolerance)."""
        node = ("tests/test_constraints.py::TestConstrainedTraining::"
                f"test_active_bounds_hold_at_optimum[{opt}]")
        rng = np.random.default_rng(zlib.crc32(node.encode()) ^ 271828)
        n, d = 300, 3
        X = rng.normal(size=(n, d))
        w_true = np.array([2.0, -1.5, 0.3])
        y = X @ w_true + 0.01 * rng.normal(size=n)
        lower, upper = np.full(d, -0.5), np.full(d, 0.5)
        glm, res = GLMOptimizationProblem(task=TaskType.LINEAR_REGRESSION,
                                          configuration=_cfg("port", opt)).run(
            LabeledData.build(X, y, dtype=torch.float64, device="cpu"), lower_bounds=lower,
            upper_bounds=upper)
        w = glm.coefficients.means.numpy()
        assert np.all(w >= lower) and np.all(w <= upper)
        assert w[0] == pytest.approx(0.5, abs=1e-6)
        assert w[1] == pytest.approx(-0.5, abs=1e-6)
        assert abs(w[2] - w_true[2]) < 0.1
        jglm, jres = JProblem(task=JTask.LINEAR_REGRESSION, configuration=_cfg("jax", opt)).run(
            JData.build(X, y, dtype=jnp.float64), lower_bounds=jnp.asarray(lower),
            upper_bounds=jnp.asarray(upper))
        np.testing.assert_allclose(w, np.asarray(jglm.coefficients.means), rtol=0, atol=1e-9)
        assert int(res.iterations) == int(jres.iterations)
        assert int(res.convergence_reason) == int(jres.convergence_reason)

    def test_estimator_applies_constraints(self, rng):
        from photon_ml_tpu_torch.data.game_data import GameInput
        from photon_ml_tpu_torch.estimators import (
            CoordinateConfiguration,
            FixedEffectDataConfiguration,
            GameEstimator,
        )

        n, d = 200, 3
        X = rng.normal(size=(n, d))
        y = X @ np.array([3.0, -3.0, 0.1]) + 0.01 * rng.normal(size=n)
        est = GameEstimator(
            task=TaskType.LINEAR_REGRESSION,
            coordinate_configurations={"global": CoordinateConfiguration(
                FixedEffectDataConfiguration("global"), _cfg("port", "LBFGS", 100),
                box_constraints=(np.full(d, -1.0), np.full(d, 1.0)))},
            dtype=torch.float64, device="cpu",
        )
        w = est.fit(GameInput(features={"global": X}, labels=y))[0].model.get_model(
            "global").model.coefficients.means.numpy()
        assert np.all(np.abs(w) <= 1.0)
        assert w[0] == pytest.approx(1.0, abs=1e-6)
        assert w[1] == pytest.approx(-1.0, abs=1e-6)

    def test_constraints_reject_normalization(self, rng):
        from photon_ml_tpu_torch.algorithm.coordinate import FixedEffectCoordinate

        X, y = rng.normal(size=(20, 2)), rng.normal(size=20)
        ds = FixedEffectDataset(LabeledData.build(X, y, dtype=torch.float64, device="cpu"))
        with pytest.raises(ValueError, match="cannot be combined"):
            FixedEffectCoordinate(
                coordinate_id="global", dataset=ds, task=TaskType.LINEAR_REGRESSION,
                configuration=_cfg("port", "LBFGS", weight=1.0),
                normalization=NormalizationContext(factors=np.ones(2) * 2.0),
                box_constraints=(np.full(2, -1.0), np.full(2, 1.0)),
            )
