"""The port's GAME models and evaluators against the JAX package's.

- Evaluators: the same numpy scores, labels and weights through both
  packages' evaluators (AUC with ties, the NaN of a one-class sample, AUPR,
  RMSE, the pointwise losses, precision@k, a per-user AUC and the
  evaluation suite fed a tensor). The metrics are the same numpy code in
  both, so they agree exactly; the losses run in each package's f64 ops,
  rtol 1e-12.
- ``RandomEffectModel.aligned_to`` on a scoring-only validation view that
  holds unseen entities and unseen columns: the same re-laid-out table as
  JAX's, exactly; entities and slots without a coefficient score 0, and the
  validation scores agree with JAX's to atol 1e-12 (f64).
- The fused pass's model keeps [E, K] tables (the pass's junk row E is
  dropped) and scores a validation set exactly as a host-loop model with the
  same coefficients does.
- ``interop.game_model_to_numpy`` / ``game_model_from_numpy`` round trip
  exactly, and a JAX GameModel built from the records scores a validation
  set as the port's does (atol 1e-12, f64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu.data.random_effect import build_random_effect_dataset as jbuild_re
from photon_ml_tpu.evaluation import evaluators as jev
from photon_ml_tpu.evaluation import metric_map as jmm
from photon_ml_tpu.models.game import RandomEffectModel as JREModel
from photon_ml_tpu.models.glm import Coefficients as JCoef
from photon_ml_tpu.models.glm import model_class_for_task as jmodel_class
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch import interop
from photon_ml_tpu_torch.algorithm.coordinate import RandomEffectCoordinate, score_model_on_dataset
from photon_ml_tpu_torch.data.random_effect import build_random_effect_dataset
from photon_ml_tpu_torch.device import to_host
from photon_ml_tpu_torch.estimators import (
    CoordinateConfiguration,
    FixedEffectDataConfiguration,
    GameEstimator,
    RandomEffectDataConfiguration,
)
from photon_ml_tpu_torch.evaluation import evaluators as tev
from photon_ml_tpu_torch.evaluation import metric_map as tmm
from photon_ml_tpu_torch.models.game import GameModel, RandomEffectModel
from photon_ml_tpu_torch.models.glm import Coefficients, model_class_for_task
from photon_ml_tpu_torch.optimization.common import OptimizerConfig
from photon_ml_tpu_torch.optimization.config import (
    GLMOptimizationConfiguration,
    RegularizationContext,
)
from photon_ml_tpu_torch.types import RegularizationType, TaskType

# ------------------------------------------------------------------ evaluators


def _scores(rng, n=500, ties=False, one_class=False):
    s = rng.normal(size=n)
    if ties:
        s = np.round(s, 1)  # about 60 distinct values: long tie groups
    y = (rng.uniform(size=n) < 0.4).astype(np.float64)
    if one_class:
        y[:] = 1.0
    w = rng.uniform(0.2, 2.0, size=n)
    return s, y, w


EVALUATORS = ["AUC", "AUPR", "RMSE", "LOGISTIC_LOSS", "POISSON_LOSS", "SQUARED_LOSS",
              "SMOOTHED_HINGE_LOSS", "PRECISION_AT_K"]


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("etype", EVALUATORS)
def test_evaluator_matches_jax(etype, weighted, ties, rng):
    s, y, w = _scores(rng, ties=ties)
    w = w if weighted else None
    j = jev.evaluator_for_type(etype).evaluate(s, y, w)
    t = tev.evaluator_for_type(etype).evaluate(s, y, w)
    assert tev.evaluator_for_type(etype).name == jev.evaluator_for_type(etype).name
    if etype.endswith("LOSS"):
        np.testing.assert_allclose(t, j, rtol=1e-12)
    else:
        assert t == j


@pytest.mark.parametrize("etype", ["AUC", "AUPR"])
def test_one_class_sample_is_nan_in_both(etype, rng):
    s, y, w = _scores(rng, one_class=True)
    if etype == "AUPR":
        y[:] = 0.0  # AUPR is undefined without positives
    assert np.isnan(jev.evaluator_for_type(etype).evaluate(s, y, w))
    assert np.isnan(tev.evaluator_for_type(etype).evaluate(s, y, w))
    better = tev.evaluator_for_type(etype).better_than
    assert better(0.5, float("nan")) and not better(float("nan"), 0.5)


def test_evaluation_suite_reads_a_tensor_once(rng):
    """Per-user AUC and global metrics on scores handed over as a tensor; the
    offsets are added before the metrics, as in the JAX suite."""
    s, y, w = _scores(rng, n=800, ties=True)
    offsets = rng.normal(size=len(s)) * 0.1
    users = rng.integers(0, 12, size=len(s))
    specs = ["AUC", ("AUC", "userId"), "LOGISTIC_LOSS"]
    j = jev.EvaluationSuite([jev.resolve_evaluator(x) for x in specs], y, offsets, w,
                            {"userId": users}).evaluate(jnp.asarray(s))
    suite = tev.EvaluationSuite([tev.resolve_evaluator(x) for x in specs], y, offsets, w,
                                {"userId": users})
    reads = to_host.transfers
    t = suite.evaluate(torch.as_tensor(s))
    assert to_host.transfers == reads + 1
    assert list(t) == list(j) == ["AUC", "AUC@userId", "LOGISTIC_LOSS"]
    assert t["AUC"] == j["AUC"] and t["AUC@userId"] == j["AUC@userId"]
    np.testing.assert_allclose(t["LOGISTIC_LOSS"], j["LOGISTIC_LOSS"], rtol=1e-12)


@pytest.mark.parametrize("task", ["LOGISTIC_REGRESSION", "LINEAR_REGRESSION",
                                  "POISSON_REGRESSION"])
def test_metric_map_matches_jax(task, rng):
    X = rng.normal(size=(300, 5))
    w = rng.normal(size=5) * 0.3
    z = X @ w
    y = {"LOGISTIC_REGRESSION": (rng.uniform(size=300) < 1 / (1 + np.exp(-z))).astype(float),
         "LINEAR_REGRESSION": z + rng.normal(size=300),
         "POISSON_REGRESSION": rng.poisson(np.exp(z)).astype(float)}[task]
    jm = jmodel_class(JTask(task))(JCoef(jnp.asarray(w)))
    tm = model_class_for_task(TaskType(task))(Coefficients(torch.as_tensor(w)))
    j = jmm.evaluate_model(jm, X, y)
    t = tmm.evaluate_model(tm, X, y)
    assert sorted(t) == sorted(j)
    for k in j:
        np.testing.assert_allclose(t[k], j[k], rtol=1e-10, err_msg=k)


# -------------------------------------------------------- random-effect models


def _re_split(rng, n_train=600, n_val=300, d=10, n_ent=25, unseen=5):
    """CSR features with an intercept, entity ids where the validation rows
    bring ``unseen`` entities the training rows never had, and columns a
    training entity never observed."""
    def draw(n, ents, density):
        dense = rng.normal(size=(n, d)) * (rng.uniform(size=(n, d)) < density)
        dense[:, 0] = 1.0
        return sp.csr_matrix(dense), rng.choice(ents, size=n)
    Xt, et = draw(n_train, np.arange(n_ent), 0.04)
    Xv, ev = draw(n_val, np.arange(n_ent + unseen), 0.5)
    return Xt, et, Xv, ev


def _models(rng, Xt, et, Xv, ev):
    jt = jbuild_re(Xt, et, "userId", labels=np.zeros(Xt.shape[0]), dtype=jnp.float64)
    jv = jbuild_re(Xv, ev, "userId", dtype=jnp.float64, scoring_only=True)
    tt = build_random_effect_dataset(Xt, et, "userId", labels=np.zeros(Xt.shape[0]),
                                     dtype=torch.float64, device="cpu")
    tv = build_random_effect_dataset(Xv, ev, "userId", dtype=torch.float64, scoring_only=True,
                                     device="cpu")
    proj = tt.proj_indices.numpy()
    coeffs = np.where(proj >= 0, rng.normal(size=proj.shape), 0.0)
    jm = JREModel("userId", "re", JTask.LOGISTIC_REGRESSION, jt.entity_ids,
                  jnp.asarray(coeffs), jt.proj_indices)
    tm = RandomEffectModel("userId", "re", TaskType.LOGISTIC_REGRESSION, tt.entity_ids,
                           torch.as_tensor(coeffs), tt.proj_indices)
    return jm, jv, tm, tv


def test_aligned_to_matches_jax_on_a_validation_view(rng):
    jm, jv, tm, tv = _models(rng, *_re_split(rng))
    ja, ta = jm.aligned_to(jv), tm.aligned_to(tv)
    assert ta.entity_ids == ja.entity_ids == tv.entity_ids
    assert ta.proj_indices is tv.proj_indices
    np.testing.assert_array_equal(ta.coeffs.numpy(), np.asarray(ja.coeffs))
    # unseen entities: whole rows of zeros
    unseen = [i for i, e in enumerate(tv.entity_ids) if tm.row_for_entity(e) < 0]
    assert unseen and not ta.coeffs[unseen].any()
    # a slot whose column the entity's model never saw holds 0
    seen_cols = {e: set(tm.proj_indices[tm.row_for_entity(e)].tolist()) for e in tm.entity_ids}
    fresh = [(i, k) for i, e in enumerate(tv.entity_ids) if e in seen_cols
             for k, c in enumerate(tv.proj_indices[i].tolist()) if c >= 0 and c not in seen_cols[e]]
    assert fresh and all(float(ta.coeffs[i, k]) == 0.0 for i, k in fresh)
    assert ta.aligned_to(tv) is ta  # a model aligned to a dataset is returned as it is


def test_aligned_to_keeps_rows_by_entity_id(rng):
    """A model whose entity rows and slots are permuted aligns to the same
    table as the original."""
    jm, jv, tm, tv = _models(rng, *_re_split(rng))
    perm = rng.permutation(tm.n_entities)
    slot_perm = rng.permutation(tm.proj_indices.shape[1])
    shuffled = RandomEffectModel(
        "userId", "re", TaskType.LOGISTIC_REGRESSION, tuple(tm.entity_ids[i] for i in perm),
        tm.coeffs[perm][:, slot_perm], tm.proj_indices[perm][:, slot_perm])
    assert torch.equal(shuffled.aligned_to(tv).coeffs, tm.aligned_to(tv).coeffs)


def test_validation_scores_match_jax_and_unseen_entities_score_zero(rng):
    Xt, et, Xv, ev = _re_split(rng)
    jm, jv, tm, tv = _models(rng, Xt, et, Xv, ev)
    t = tm.score_dataset(tv).numpy()
    np.testing.assert_allclose(t, np.asarray(jm.score_dataset(jv)), atol=1e-12)
    unseen_rows = ~np.isin(ev, et)
    assert unseen_rows.any() and not t[unseen_rows].any()
    assert t[~unseen_rows].any()


# ------------------------------------------------------------- whole models

SPLIT = dict(seed=11, n_train=1200, n_validation=300, n_features=6, n_users=20, n_items=6,
             re_fe_cols=2)


OPT = GLMOptimizationConfiguration(OptimizerConfig(max_iterations=30),
                                   RegularizationContext(RegularizationType.L2), 1.0)


def _estimator(**kw):
    opt = OPT
    return GameEstimator(
        task=TaskType.LOGISTIC_REGRESSION,
        coordinate_configurations={
            "global": CoordinateConfiguration(FixedEffectDataConfiguration("global"), opt),
            "per-user": CoordinateConfiguration(RandomEffectDataConfiguration("userId", "re"), opt),
            "per-item": CoordinateConfiguration(RandomEffectDataConfiguration("itemId", "re"), opt),
        },
        n_iterations=2, dtype=torch.float64, device="cpu", **kw)


def test_fused_pass_model_scores_as_the_host_loop_scores_its_coefficients():
    tr, va = interop.make_glmix_split(**SPLIT)
    est = _estimator(fused_pass=True)
    model = est.fit(interop.glmix_game_input(tr))[0].model
    datasets = est.prepare_training_datasets(interop.glmix_game_input(tr))
    val = est.prepare_scoring_datasets(interop.glmix_game_input(va))
    for cid in ("per-user", "per-item"):
        fused = model.get_model(cid)
        ds = datasets[cid]
        assert tuple(fused.coeffs.shape) == (ds.n_entities, ds.max_k)  # no junk row
        # the host loop's model of the same coefficients: its coordinate's
        # zero model with the table put in
        coord = RandomEffectCoordinate(cid, ds, TaskType.LOGISTIC_REGRESSION, OPT,
                                       torch.zeros(ds.n_samples, dtype=torch.float64))
        host = coord.initialize_model().update_entities(fused.coeffs.clone())
        assert torch.equal(score_model_on_dataset(fused, val[cid]),
                           score_model_on_dataset(host, val[cid]))
        assert score_model_on_dataset(host, val[cid]).any()


def test_interop_round_trip_and_jax_scoring(rng):
    from photon_ml_tpu.data.game_data import GameInput as JInput
    from photon_ml_tpu.estimators import GameEstimator as JEstimator
    from photon_ml_tpu.estimators import (
        CoordinateConfiguration as JCC,
        FixedEffectDataConfiguration as JFE,
        RandomEffectDataConfiguration as JRE,
    )
    from photon_ml_tpu.models.game import FixedEffectModel as JFEModel
    from photon_ml_tpu.models.game import GameModel as JGameModel
    from photon_ml_tpu.optimization.config import GLMOptimizationConfiguration as JCfg

    tr, va = interop.make_glmix_split(**SPLIT)
    model = _estimator().fit(interop.glmix_game_input(tr))[0].model
    records = interop.game_model_to_numpy(model)
    back = interop.game_model_from_numpy(records, device="cpu")
    assert back.coordinate_ids == model.coordinate_ids
    assert torch.equal(back.get_model("global").model.coefficients.means,
                       model.get_model("global").model.coefficients.means)
    for cid in ("per-user", "per-item"):
        a, b = back.get_model(cid), model.get_model(cid)
        assert a.entity_ids == b.entity_ids and torch.equal(a.coeffs, b.coeffs)
        assert torch.equal(a.proj_indices, b.proj_indices.to(torch.int32))

    # the same records as a JAX GameModel score the validation set alike
    jmodels = {}
    for cid, r in records.items():
        if r["kind"] == "fixed":
            jglm = jmodel_class(JTask(r["task"].value))(JCoef(jnp.asarray(r["means"])))
            jmodels[cid] = JFEModel(jglm, r["feature_shard_id"])
        else:
            jmodels[cid] = JREModel(r["re_type"], r["feature_shard_id"], JTask(r["task"].value),
                                    r["entity_ids"], jnp.asarray(r["coeffs"]),
                                    jnp.asarray(r["proj_indices"]))
    jin = JInput(features={"global": va["fe_X"], "re": va["re_features"]},
                 labels=va["labels"], id_columns={"userId": va["users"], "itemId": va["items"]})
    jest = JEstimator(task=JTask.LOGISTIC_REGRESSION, coordinate_configurations={
        "global": JCC(JFE("global"), JCfg()), "per-user": JCC(JRE("userId", "re"), JCfg()),
        "per-item": JCC(JRE("itemId", "re"), JCfg())}, dtype=jnp.float64)
    jval = jest.prepare_scoring_datasets(jin)
    tval = _estimator().prepare_scoring_datasets(interop.glmix_game_input(va))
    for cid in records:
        np.testing.assert_allclose(
            score_model_on_dataset(back.get_model(cid), tval[cid]).numpy(),
            np.asarray(jmodels[cid].score_dataset(jval[cid])), atol=1e-12)
    assert isinstance(JGameModel(jmodels), JGameModel) and isinstance(back, GameModel)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_fixed_effect_scores_in_byte_bounded_chunks(dtype, rng, monkeypatch):
    """Validation and transform scores of a dense fixed effect form their
    [rows, D] products in row chunks no larger than the byte bound, with the
    same bits as one unchunked product (``row_sum`` is row-independent)."""
    from photon_ml_tpu_torch.models import game

    n, d = 1000, 37
    values = torch.as_tensor(rng.normal(size=(n, d)), dtype=dtype)
    means = torch.as_tensor(rng.normal(size=d), dtype=dtype)
    whole = game.row_sum(values * means)
    seen, real = [], game.row_sum

    def recording(terms):
        seen.append(terms.shape[0] * 64 * terms.element_size())  # 64: D padded to 2^k
        return real(terms)

    monkeypatch.setattr(game, "row_sum", recording)
    assert torch.equal(game.fixed_effect_view_score(values, means), whole)
    assert seen == [n * 64 * values.element_size()]  # under the default bound: one product
    seen.clear()
    bound = 10_000
    monkeypatch.setattr(game, "FE_SCORE_CHUNK_BYTES", bound)
    rows = game.score_chunk_rows(d, values.element_size())
    assert rows * 64 * values.element_size() <= bound < (rows + 1) * 64 * values.element_size()
    chunked = game.fixed_effect_view_score(values, means)
    assert torch.equal(chunked, whole)
    assert len(seen) == -(-n // rows) and max(seen) <= bound
    monkeypatch.setattr(game, "FE_SCORE_CHUNK_BYTES", 16)
    assert game.score_chunk_rows(5000, 8) == 1  # a row wider than the bound: one row
