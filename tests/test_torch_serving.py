"""The port's serving engine and GameTransformer on the CPU.

On the CPU (``device="cpu"``) the engine runs the same body it captures as
a CUDA graph on the card, eagerly (the graphs themselves are held by
tests/test_torch_cuda_serving.py on the card). Held here:

- the engine against the port's eager scorer (``GameTransformer(engine=
  "eager")``) BITWISE, same dtype, with and without offsets and per
  coordinate: the BASELINE shapes, the GLM family matrix, mixed-precision
  coordinates, integer offsets, a random-projection coordinate, a
  coordinate named "offsets" and the zero-coordinate model;
- the engine against the JAX package's engine on the same f32 tables and
  requests: within rtol 1e-5 and atol 1e-6 of the largest score (f32 sums
  in two orders), and within 1e-12 at f64;
- ``predict``'s link (on the device, or on the host when the offsets would
  widen the result), unseen entities and columns scoring 0, entity ids of an
  incomparable dtype degrading to 0 like the eager lookup, sparse and wide
  dense fixed-effect requests, batch and width buckets, the content-keyed
  cache with ``evict_engine``, concurrent first hits, and the bf16 policy
  within 0.05 of the largest f32 score (the JAX package's
  tests/test_precision.py bound);
- every entry point defaults to CUDA and raises without it.
"""

import dataclasses
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu.data.game_data import GameInput as JInput
from photon_ml_tpu.models.game import FixedEffectModel as JFE
from photon_ml_tpu.models.game import GameModel as JGame
from photon_ml_tpu.models.game import RandomEffectModel as JRE
from photon_ml_tpu.models.glm import Coefficients as JCoef
from photon_ml_tpu.models.glm import model_class_for_task as jclass
from photon_ml_tpu.serving import clear_engine_cache as jclear
from photon_ml_tpu.serving import get_engine as jget_engine
from photon_ml_tpu.transformers import GameTransformer as JTransformer
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch.data.game_data import GameInput
from photon_ml_tpu_torch.models.game import FixedEffectModel, GameModel, RandomEffectModel
from photon_ml_tpu_torch.models.glm import Coefficients, model_class_for_task
from photon_ml_tpu_torch.serving import (
    FE_SPARSE_MIN_COLS,
    GameServingEngine,
    clear_engine_cache,
    evict_engine,
    get_engine,
    model_fingerprint,
    width_bucket,
)
from photon_ml_tpu_torch.transformers import GameTransformer
from photon_ml_tpu_torch.types import TaskType

CPU = {"device": "cpu"}
ALL_TASKS = [TaskType.LOGISTIC_REGRESSION, TaskType.LINEAR_REGRESSION,
             TaskType.POISSON_REGRESSION, TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM]


@pytest.fixture(autouse=True)
def _fresh_engine_cache():
    clear_engine_cache()
    jclear()
    yield
    clear_engine_cache()
    jclear()


def _fixed(rng, d=6, task=TaskType.LOGISTIC_REGRESSION, dtype=torch.float64, shard="global"):
    means = torch.as_tensor(rng.normal(size=d), dtype=dtype)
    return FixedEffectModel(model_class_for_task(task)(Coefficients(means)), shard)


def _random(rng, re_type, E, d=5, k_max=3, dtype=torch.float64, task=TaskType.LOGISTIC_REGRESSION):
    """Per-entity models over random column subsets of a [*, d] shard (the
    loaded-from-disk layout)."""
    proj = np.full((E, k_max), -1, dtype=np.int32)
    coeffs = np.zeros((E, k_max))
    for i in range(E):
        k = int(rng.integers(1, k_max + 1))
        proj[i, :k] = np.sort(rng.choice(d, size=k, replace=False))
        coeffs[i, :k] = rng.normal(size=k)
    return RandomEffectModel(re_type=re_type, feature_shard_id="re_shard", task=task,
                             entity_ids=tuple(f"e{i}" for i in range(E)),
                             coeffs=torch.as_tensor(coeffs, dtype=dtype),
                             proj_indices=torch.as_tensor(proj))


def _input(rng, n=137, d=6, d_re=5, users=10, items=4, with_items=True, dtype=np.float64):
    """BASELINE config #3's shape: ids include entities the models never saw,
    the RE shard is genuinely sparse."""
    ids = {"userId": np.asarray([f"e{i}" for i in rng.integers(0, users + 3, size=n)],
                                dtype=object)}
    if with_items:
        ids["itemId"] = np.asarray([f"e{i}" for i in rng.integers(0, items + 2, size=n)],
                                   dtype=object)
    re = rng.normal(size=(n, d_re))
    re[rng.random(size=re.shape) < 0.4] = 0.0
    return GameInput(features={"global": rng.normal(size=(n, d)).astype(dtype),
                               "re_shard": sp.csr_matrix(re)},
                     labels=(rng.random(n) > 0.5).astype(np.float64),
                     offsets=rng.normal(size=n).astype(dtype), id_columns=ids)


def assert_parity(model, data):
    """Engine and eager scorer: same dtype, same bits."""
    eager = GameTransformer(model=model, engine="eager", **CPU)
    fused = GameTransformer(model=model, **CPU)
    for inc in (True, False):
        se, sf = eager.score(data, include_offsets=inc), fused.score(data, include_offsets=inc)
        assert sf.dtype == se.dtype and sf.shape == se.shape == (data.n,)
        np.testing.assert_array_equal(sf, se)
    pe, pf = eager.score_per_coordinate(data), fused.score_per_coordinate(data)
    assert list(pf) == list(pe)
    for cid in pe:
        assert pf[cid].dtype == pe[cid].dtype, cid
        np.testing.assert_array_equal(pf[cid], pe[cid])


def _glmix(rng, task=TaskType.LOGISTIC_REGRESSION, dtype=torch.float64, items=True):
    models = {"fixed": _fixed(rng, task=task, dtype=dtype),
              "per-user": _random(rng, "userId", 10, dtype=dtype, task=task)}
    if items:
        models["per-item"] = _random(rng, "itemId", 4, dtype=dtype, task=task)
    return GameModel(models=models)


# ------------------------------------------------------------ engine vs eager


def test_parity_fixed_effect_only(rng):
    assert_parity(GameModel(models={"fixed": _fixed(rng)}), _input(rng, with_items=False))


@pytest.mark.parametrize("task", ALL_TASKS)
def test_family_matrix_engine_score_parity(rng, task):
    assert_parity(_glmix(rng, task), _input(rng))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_parity_glmix_three_coordinates(rng, dtype):
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    assert_parity(_glmix(rng, dtype=dtype), _input(rng, dtype=np_dtype))


def test_parity_mixed_precision_coordinates(rng):
    """f64 fixed effect + f32 random-effect table: per-coordinate dtypes
    survive the engine (no stack promotion)."""
    model = GameModel(models={"fixed": _fixed(rng),
                              "per-user": _random(rng, "userId", 10, dtype=torch.float32)})
    data = _input(rng, with_items=False)
    assert_parity(model, data)
    per = GameTransformer(model=model, **CPU).score_per_coordinate(data)
    assert per["per-user"].dtype == np.float32 and per["fixed"].dtype == np.float64


def test_parity_integer_offsets(rng):
    """Integer offsets promote to f64 in numpy: the engine adds them on the
    host, as eager does."""
    model = GameModel(models={"fixed": _fixed(rng, dtype=torch.float32)})
    data = GameInput(features={"global": rng.normal(size=(21, 6)).astype(np.float32)},
                     offsets=rng.integers(-3, 3, size=21))
    assert_parity(model, data)
    assert GameTransformer(model=model, **CPU).score(data).dtype == np.float64


def test_parity_projected_random_effect(rng):
    from photon_ml_tpu_torch.data.projector import ProjectorConfig, ProjectorType, make_projector

    projector = make_projector(ProjectorConfig(ProjectorType.RANDOM_PROJECTION, projected_dim=3,
                                               seed=7), original_dim=7, intercept_index=0)
    E, K = 6, projector.projected_dim
    re = RandomEffectModel(re_type="userId", feature_shard_id="re_shard",
                           task=TaskType.LOGISTIC_REGRESSION,
                           entity_ids=tuple(f"e{i}" for i in range(E)),
                           coeffs=torch.as_tensor(rng.normal(size=(E, K))),
                           proj_indices=torch.as_tensor(np.tile(np.arange(K, dtype=np.int32),
                                                                (E, 1))),
                           projector=projector)
    model = GameModel(models={"fixed": _fixed(rng), "per-user": re})
    assert_parity(model, _input(rng, d_re=7, users=E, with_items=False))


def test_coordinate_named_offsets_does_not_collide(rng):
    assert_parity(GameModel(models={"offsets": _fixed(rng)}), _input(rng, with_items=False))


@pytest.mark.parametrize("engine", ["eager", "fused"])
def test_zero_coordinate_model_scores_offsets_shape(rng, engine):
    offsets = rng.normal(size=17)
    data = GameInput(features={"global": rng.normal(size=(17, 3))}, offsets=offsets)
    t = GameTransformer(model=GameModel(models={}), engine=engine, **CPU)
    scored = t.score(data)
    assert scored.shape == (17,) and scored.dtype == np.float64
    np.testing.assert_array_equal(scored, offsets)
    np.testing.assert_array_equal(t.score(data, include_offsets=False), np.zeros(17))
    assert t.score_per_coordinate(data) == {}


def test_transform_metrics_parity(rng):
    model = _glmix(rng, items=False)
    data = _input(rng, with_items=False)
    s_e, m_e = GameTransformer(model, evaluators=["AUC"], engine="eager", **CPU).transform(data)
    s_f, m_f = GameTransformer(model, evaluators=["AUC"], **CPU).transform(data)
    np.testing.assert_array_equal(s_f, s_e)
    assert m_f["AUC"] == m_e["AUC"]
    assert GameTransformer(model, **CPU).transform(data)[1] is None  # no evaluators


def test_unseen_entities_and_columns_score_zero(rng):
    model = GameModel(models={"per-user": _random(rng, "userId", 3)})
    data = GameInput(features={"re_shard": sp.csr_matrix(rng.normal(size=(9, 5)))},
                     id_columns={"userId": np.asarray(["nobody"] * 9, dtype=object)})
    np.testing.assert_array_equal(
        GameTransformer(model, **CPU).score(data, include_offsets=False), np.zeros(9))
    # an entity whose model saw only some columns: the others add exactly 0
    re = model.get_model("per-user")
    cols = re.proj_indices[0][re.proj_indices[0] >= 0].numpy()
    x = np.zeros((1, 5))
    x[0, :] = 1.0
    one = GameInput(features={"re_shard": sp.csr_matrix(x)},
                    id_columns={"userId": np.asarray(["e0"], dtype=object)})
    want = float(re.coeffs[0][: len(cols)].sum())
    assert GameTransformer(model, **CPU).score(one, include_offsets=False)[0] == pytest.approx(
        want, abs=1e-12)


def test_entity_id_dtype_mismatch_degrades_like_eager(rng):
    """An integer-entity model served string ids scores those rows 0 (the
    eager dict-lookup miss), and matching int ids still resolve."""
    E, d = 5, 4
    model = GameModel(models={"per-user": RandomEffectModel(
        re_type="userId", feature_shard_id="re_shard", task=TaskType.LOGISTIC_REGRESSION,
        entity_ids=tuple(range(E)), coeffs=torch.as_tensor(rng.normal(size=(E, d))),
        proj_indices=torch.as_tensor(np.tile(np.arange(d, dtype=np.int32), (E, 1))))})
    n = 11
    data = GameInput(features={"re_shard": sp.csr_matrix(rng.normal(size=(n, d)))},
                     id_columns={"userId": np.asarray([f"u{i}" for i in range(n)],
                                                      dtype=object)})
    out = GameTransformer(model, **CPU).score(data, include_offsets=False)
    np.testing.assert_array_equal(out, np.zeros(n))
    np.testing.assert_array_equal(
        out, GameTransformer(model, engine="eager", **CPU).score(data, include_offsets=False))
    data_int = dataclasses.replace(data, id_columns={"userId": np.arange(n) % E})
    assert np.abs(GameTransformer(model, **CPU).score(data_int, include_offsets=False)).max() > 0
    assert_parity(model, data_int)


# ------------------------------------------------------------------ predict


@pytest.mark.parametrize("task", ALL_TASKS)
def test_family_matrix_predict_applies_the_link(rng, task):
    """f64 model, f64 offsets: the link runs on the device at f64 and agrees
    with numpy's link of the engine's margins to 1e-15."""
    eng = get_engine(_glmix(rng, task), **CPU)
    data = _input(rng)
    margins = eng.score(data, include_offsets=True)
    if task == TaskType.LOGISTIC_REGRESSION:
        want = 1.0 / (1.0 + np.exp(-margins))
    elif task == TaskType.POISSON_REGRESSION:
        want = np.exp(margins)
    else:
        np.testing.assert_array_equal(eng.predict(data), margins)
        return
    np.testing.assert_allclose(eng.predict(data), want, rtol=1e-15, atol=0)


@pytest.mark.parametrize("task", ALL_TASKS)
def test_family_matrix_host_link_when_offsets_widen(rng, task):
    """f32 model, f64 offsets: numpy would widen the result to f64, so the
    offsets are added and the link applied on the host
    (precision.host_link): the same numpy code on the same margins."""
    from photon_ml_tpu_torch.optimization.precision import host_link, offsets_fuse_on_device

    eng = get_engine(_glmix(rng, task, dtype=torch.float32), **CPU)
    data = _input(rng, dtype=np.float32)
    data = dataclasses.replace(data, offsets=data.offsets.astype(np.float64))
    assert not offsets_fuse_on_device(data.offsets, torch.float32)
    margins = eng.score(data)
    assert margins.dtype == np.float64
    np.testing.assert_array_equal(eng.predict(data), host_link(task, margins))


def test_device_link_with_f32_offsets(rng):
    eng = get_engine(_glmix(rng, dtype=torch.float32), **CPU)
    data = _input(rng, dtype=np.float32)
    margins = eng.score(data)
    assert margins.dtype == np.float32
    np.testing.assert_allclose(eng.predict(data), 1.0 / (1.0 + np.exp(-margins.astype(np.float64))),
                               rtol=1e-6, atol=1e-7)


# -------------------------------------------------------------- vs JAX engine


def _to_jax(model: GameModel) -> JGame:
    out = {}
    for cid, m in model:
        task = JTask(TaskType(m.task).value)
        if isinstance(m, FixedEffectModel):
            out[cid] = JFE(jclass(task)(JCoef(jnp.asarray(m.model.coefficients.means.numpy()))),
                           m.feature_shard_id)
        else:
            out[cid] = JRE(re_type=m.re_type, feature_shard_id=m.feature_shard_id, task=task,
                           entity_ids=m.entity_ids, coeffs=jnp.asarray(m.coeffs.numpy()),
                           proj_indices=jnp.asarray(m.proj_indices.numpy()))
    return JGame(models=out)


def _jax_input(data: GameInput) -> JInput:
    return JInput(features=dict(data.features), labels=data.labels, offsets=data.offsets,
                  weights=data.weights, id_columns=dict(data.id_columns))


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("task", ALL_TASKS)
def test_engine_matches_the_jax_engine(rng, task, dtype, rtol):
    model = _glmix(rng, task, dtype=dtype)
    data = _input(rng, dtype=np.float32 if dtype == torch.float32 else np.float64)
    mine, theirs = get_engine(model, **CPU), jget_engine(_to_jax(model))
    jdata = _jax_input(data)
    a, b = mine.score(data), np.asarray(theirs.score(jdata))
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * 0.1 * np.abs(b).max())
    pa, pb = mine.score_per_coordinate(data), theirs.score_per_coordinate(jdata)
    for cid in pa:
        np.testing.assert_allclose(pa[cid], np.asarray(pb[cid]), rtol=rtol,
                                   atol=rtol * 0.1 * np.abs(np.asarray(pb[cid])).max())
    np.testing.assert_allclose(mine.predict(data), np.asarray(theirs.predict(jdata)), rtol=rtol,
                               atol=rtol * 0.1)


def test_transform_auc_matches_jax(rng):
    model = _glmix(rng)
    data = _input(rng, n=400)
    _, m_port = GameTransformer(model, evaluators=["AUC"], **CPU).transform(data)
    _, m_jax = JTransformer(_to_jax(model), evaluators=["AUC"]).transform(_jax_input(data))
    assert m_port["AUC"] == pytest.approx(m_jax["AUC"], abs=1e-12)


# ------------------------------------------------ fixed-effect request layouts


def test_sparse_fixed_effect_request(rng):
    """A CSR fixed-effect request scores through the per-sample gather; it
    agrees with the dense request to f64 rounding."""
    model = GameModel(models={"fixed": _fixed(rng, d=32)})
    dense = np.zeros((40, 32))
    for i in range(40):
        dense[i, rng.choice(32, size=5, replace=False)] = rng.normal(size=5)
    eng = get_engine(model, **CPU)
    s_dense = eng.score(GameInput(features={"global": dense}), include_offsets=False)
    s_csr = eng.score(GameInput(features={"global": sp.csr_matrix(dense)}),
                      include_offsets=False)
    np.testing.assert_allclose(s_csr, s_dense, rtol=1e-6, atol=1e-7)  # f32 value storage


def test_wide_dense_request_routes_through_the_sparse_view(rng):
    """A dense request of FE_SPARSE_MIN_COLS columns takes the per-sample
    view with its values at the model's dtype; at f32 it equals the CSR
    container request bitwise (the same values in the same CSR order)."""
    d = FE_SPARSE_MIN_COLS
    dense = np.zeros((16, d))
    for i in range(16):
        dense[i, rng.choice(d, size=6, replace=False)] = rng.normal(size=6)
    for dtype in (torch.float32, torch.float64):
        eng = get_engine(GameModel(models={"fixed": _fixed(rng, d=d, dtype=dtype)}), **CPU)
        fe = eng._prepare(GameInput(features={"global": dense}))[0]["coord:fixed"]
        assert "values" not in fe and fe["cols"].shape[1] == width_bucket(6) == 8
        assert fe["vals"].dtype == (np.float32 if dtype == torch.float32 else np.float64)
        if dtype == torch.float32:
            np.testing.assert_array_equal(
                eng.score(GameInput(features={"global": dense}), include_offsets=False),
                eng.score(GameInput(features={"global": sp.csr_matrix(dense)}),
                          include_offsets=False))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_wide_dense_engine_matches_eager(dtype, rng):
    """At 1,024 columns and more the engine's dense route drops zeros, so
    its row sums pair the terms otherwise than eager's: the scores agree
    within 2 * ceil(log2 D) units of rounding of each row's sum of
    absolute terms (the pairwise-summation bound of both orders), in the
    eager scorer's dtype. Under 1,024 columns they agree bitwise
    (``assert_parity``)."""
    n, d = 64, 1100
    X = rng.normal(size=(n, d))
    X[rng.random(size=X.shape) < 0.3] = 0.0
    model = GameModel(models={"fixed": _fixed(rng, d=d, dtype=dtype)})
    data = GameInput(features={"global": X}, offsets=np.zeros(n))
    eager = GameTransformer(model=model, engine="eager", **CPU).score(data, include_offsets=False)
    fused = GameTransformer(model=model, **CPU).score(data, include_offsets=False)
    assert fused.dtype == eager.dtype
    means = model.get_model("fixed").model.coefficients.means.numpy()
    scale = np.abs(X.astype(means.dtype) * means).sum(axis=1)
    bound = 2 * int(np.ceil(np.log2(d))) * np.finfo(means.dtype).eps * scale
    assert np.all(np.abs(fused - eager) <= bound), np.max(np.abs(fused - eager) / scale)
    assert not np.array_equal(fused, eager) or dtype == torch.float64  # the pairing differs


def test_int_and_string_id_models_do_not_share_an_engine(rng, tmp_path):
    """A model with int entity ids (an in-process fit) and its Avro round
    trip (string ids) get different fingerprints and engines, in either
    order of caching; the round trip's engine equals the eager scorer
    bitwise on string-id requests, and models loaded from the same files
    share one engine."""
    from photon_ml_tpu_torch.data.index_map import IndexMap, feature_key
    from photon_ml_tpu_torch.io.model_io import load_game_model, save_game_model
    from photon_ml_tpu_torch.types import intercept_key

    E, K = 4, 2
    coeffs = torch.as_tensor(rng.normal(size=(E, K)), dtype=torch.float32)
    proj = torch.as_tensor(np.tile(np.arange(K, dtype=np.int32), (E, 1)))
    int_model = GameModel(models={
        "fixed": _fixed(rng, d=3, dtype=torch.float32),
        "per-user": RandomEffectModel(re_type="userId", feature_shard_id="re_shard",
                                      task=TaskType.LOGISTIC_REGRESSION,
                                      entity_ids=tuple(range(E)), coeffs=coeffs,
                                      proj_indices=proj)})
    maps = {"fixed": IndexMap([feature_key(f"g{j}") for j in range(3)]),
            "per-user": IndexMap([intercept_key(), feature_key("r1", "t")])}
    save_game_model(str(tmp_path / "m"), int_model, maps)
    str_model = load_game_model(str(tmp_path / "m"), maps, dtype=torch.float32, device="cpu")
    assert str_model.get_model("per-user").entity_ids == tuple(str(i) for i in range(E))
    assert model_fingerprint(int_model) != model_fingerprint(str_model)
    again = load_game_model(str(tmp_path / "m"), maps, dtype=torch.float32, device="cpu")
    assert model_fingerprint(again) == model_fingerprint(str_model)
    req = GameInput(features={"global": rng.normal(size=(6, 3)),
                              "re_shard": sp.csr_matrix(rng.normal(size=(6, K)))},
                    id_columns={"userId": np.asarray([str(i % E) for i in range(6)], dtype=object)})
    for first in (int_model, str_model):  # either model cached first
        clear_engine_cache()
        get_engine(first, **CPU)
        fused = GameTransformer(model=str_model, **CPU).score(req)
        eager = GameTransformer(model=str_model, engine="eager", **CPU).score(req)
        np.testing.assert_array_equal(fused, eager)
        assert get_engine(again, **CPU) is get_engine(str_model, **CPU)
    assert np.abs(eager).max() > 0


# -------------------------------------------------------- buckets and cache


def _bucket_model_and_req(rng):
    model = GameModel(models={"fixed": _fixed(rng), "per-user": _random(rng, "userId", 10)})

    def req(n):
        return GameInput(features={"global": rng.normal(size=(n, 6)),
                                   "re_shard": sp.csr_matrix(rng.normal(size=(n, 5)) + 10.0)},
                         id_columns={"userId": np.asarray([f"e{i % 10}" for i in range(n)],
                                                          dtype=object)})

    return get_engine(model, **CPU), req


def test_batch_bucketing_one_program_per_bucket(rng):
    eng, req = _bucket_model_and_req(rng)
    assert eng.bucket(50) == 64 and eng.bucket(60) == 64 and eng.bucket(100) == 128
    eng.score(req(50))
    assert eng.bucket_count == 1 and eng.capture_count == 0  # no graphs on the CPU
    eng.score(req(60))
    assert eng.bucket_count == 1
    eng.score(req(100))
    eng.score(req(128))
    assert eng.bucket_count == 2


def test_nnz_width_bucketing(rng):
    model = GameModel(models={"per-user": _random(rng, "userId", 6, d=20)})
    eng = get_engine(model, **CPU)

    def req(nnz):
        dense = np.zeros((32, 20))
        for i in range(32):
            dense[i, rng.choice(20, size=nnz, replace=False)] = rng.normal(size=nnz) + 5.0
        return GameInput(features={"re_shard": sp.csr_matrix(dense)},
                         id_columns={"userId": np.asarray([f"e{i % 6}" for i in range(32)],
                                                          dtype=object)})

    reqs = []
    for nnz, buckets in ((5, 1), (7, 1), (3, 2), (8, 2), (12, 3)):
        reqs.append(req(nnz))
        eng.score(reqs[-1])
        assert eng.bucket_count == buckets, nnz
    for r in reqs:
        assert_parity(model, r)  # padded widths keep the eager bits


def test_concurrent_first_hits_run_one_bucket_once(rng):
    eng, req = _bucket_model_and_req(rng)
    request = req(50)
    results, errors = [None] * 8, []
    barrier = threading.Barrier(8)

    def worker(i):
        try:
            barrier.wait(timeout=30)
            results[i] = eng.score(request)
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors and eng.bucket_count == 1
    for out in results:
        np.testing.assert_array_equal(out, results[0])


def test_get_engine_content_keyed_cache(rng):
    m1 = GameModel(models={"fixed": _fixed(rng)})
    m2 = GameModel(models={"fixed": m1.models["fixed"]})
    assert get_engine(m1, **CPU) is get_engine(m2, **CPU)
    assert model_fingerprint(m1) == model_fingerprint(m2)
    m3 = GameModel(models={"fixed": _fixed(rng)})
    assert model_fingerprint(m3) != model_fingerprint(m1)
    assert get_engine(m3, **CPU) is not get_engine(m1, **CPU)
    bf16 = get_engine(m1, precision="bf16", **CPU)
    assert bf16 is not get_engine(m1, **CPU)  # the policy keys the cache
    assert get_engine(m1, precision="f32", **CPU) is get_engine(m1, **CPU)


def test_evict_engine_is_fingerprint_scoped_and_spares_held_engines(rng):
    m1 = GameModel(models={"fixed": _fixed(rng), "per-user": _random(rng, "userId", 10)})
    m2 = GameModel(models={"fixed": _fixed(rng)})
    e1, e2 = get_engine(m1, **CPU), get_engine(m2, **CPU)
    data = _input(rng, with_items=False)
    reference = e1.score(data)
    assert evict_engine(e1.fingerprint) == 1
    assert get_engine(m2, **CPU) is e2 and get_engine(m1, **CPU) is not e1
    np.testing.assert_array_equal(e1.score(data), reference)  # a held engine keeps working
    assert evict_engine("not-a-fingerprint") == 0


def test_bf16_policy_within_tolerance(rng):
    model = _glmix(rng, dtype=torch.float32)
    data = _input(rng, dtype=np.float32)
    s32 = get_engine(model, **CPU).score(data)
    eng16 = get_engine(model, precision="bf16", **CPU)
    assert eng16._coords[1].coeffs.dtype == torch.bfloat16
    s16 = eng16.score(data)
    assert s16.dtype == s32.dtype
    assert np.abs(s16 - s32).max() <= 0.05 * (np.abs(s32).max() + 1e-6)


# --------------------------------------------------------------- device rule


def test_entry_points_default_to_cuda(rng):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    model = GameModel(models={"fixed": _fixed(rng)})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_engine(model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GameServingEngine(model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GameTransformer(model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GameTransformer(model, engine="eager")
    with pytest.raises(ValueError, match="engine"):
        GameTransformer(model, engine="jit", **CPU)
    assert GameServingEngine(model, **CPU).device.type == "cpu"
