"""The graphed random-effect L-BFGS bucket solve on the card
(photon_ml_tpu_torch/optimization/bucket_graphs.py). Every test needs a
CUDA device and skips without one: CUDA graphs exist only there
(tests/test_torch_bucket_graphs.py drives the same driver on the CPU, each
replay an eager call). The file imports neither JAX nor the JAX package, so
on a machine with a card it runs alone:

    python -m pytest tests/test_torch_cuda_bucket_graphs.py --noconftest -q

- Two GLMix passes over a small skewed dataset, and three updates of a
  random-effect coordinate's update program, give BITWISE the same
  coefficients and scores graphed as eager (``bucket_graphs.engages``
  patched to refuse every solve), in the same host syncs;
  ``re.graph_captures`` is the bucket count after the first pass and does
  not grow in the second, and every trip is a graph trip.
- A streamed working-set chunk, a population update and NEWTON's bucket
  solves record no graph trip.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.profiler import ProfilerActivity, profile

from photon_ml_tpu_torch import interop
from photon_ml_tpu_torch.algorithm.coordinate import RandomEffectCoordinate
from photon_ml_tpu_torch.data.random_effect import build_random_effect_dataset
from photon_ml_tpu_torch.optimization import bucket_graphs
from photon_ml_tpu_torch.optimization.common import OptimizerConfig, any_lane
from photon_ml_tpu_torch.optimization.config import (
    GLMOptimizationConfiguration,
    RegularizationContext,
)
from photon_ml_tpu_torch.optimization.solver_cache import re_population_update_program
from photon_ml_tpu_torch.parallel.game import init_game_params, make_game_step
from photon_ml_tpu_torch.types import (
    OptimizerType,
    RegularizationType,
    TaskType,
    VarianceComputationType,
)
from photon_ml_tpu_torch.util import timed

WORKLOAD = dict(seed=11, n_samples=6000, n_features=6, n_users=120, n_items=30, re_fe_cols=2)


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs exist only there")


@pytest.fixture(autouse=True)
def fresh_recorder():
    timed.reset()
    yield
    timed.reset()


def _cfg(opt="LBFGS", iters=30):
    return GLMOptimizationConfiguration(
        OptimizerConfig(optimizer_type=OptimizerType(opt), max_iterations=iters),
        RegularizationContext(RegularizationType.L2), 1.0,
    )


def _glmix(opt="LBFGS"):
    wl = interop.make_glmix_workload(**WORKLOAD)
    # a heavy tail of ratings per user: user u rates about (u + 1)^2 times
    rng = np.random.default_rng(3)
    p = np.arange(1, WORKLOAD["n_users"] + 1, dtype=np.float64) ** 2
    wl["users"] = rng.choice(WORKLOAD["n_users"], size=WORKLOAD["n_samples"], p=p / p.sum())
    data = interop.build_game_data(wl, dtype=torch.float32, device="cuda")
    step = make_game_step(data, TaskType.LOGISTIC_REGRESSION, _cfg(opt, 50), [_cfg(opt)] * 2,
                          fuse_fe=False, device="cuda")
    return data, step


def _profiled(fn):
    timed.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    torch.cuda.synchronize()
    return out, timed.snapshot()["counters"]


def _equal(a, b):
    return a.dtype == b.dtype and torch.equal(a.view(torch.int32), b.view(torch.int32))


def _passes(n=2):
    data, step = _glmix()
    params = init_game_params(data, device="cuda")
    syncs, counters = [], []
    for _ in range(n):
        before = any_lane.syncs
        (params, _), c = _profiled(lambda: step(params))
        syncs.append(any_lane.syncs - before)
        counters.append(c)
    return data, params, syncs, counters


@pytest.mark.cuda
def test_graphed_glmix_passes_are_bitwise_the_eager_ones(monkeypatch):
    _needs_cuda()
    data, graphed, syncs, counters = _passes()
    n_buckets = sum(len(rc.buckets) for rc in data.re)
    assert [rc.graphs.captures for rc in data.re] == [len(rc.buckets) for rc in data.re]
    assert counters[0]["re.graph_captures"] == n_buckets
    assert "re.graph_captures" not in counters[1]
    for c in counters:
        assert c["re.graph_trips"] == c["re.trips"] > 0
    assert all(rc.graphs.pool_bytes > 0 for rc in data.re)

    monkeypatch.setattr(bucket_graphs, "engages", lambda *args: False)
    data_e, eager, syncs_e, counters_e = _passes()
    assert all(rc.graphs.captures == 0 for rc in data_e.re)
    assert all("re.graph_trips" not in c for c in counters_e)
    assert syncs == syncs_e
    assert [c["re.trips"] for c in counters] == [c["re.trips"] for c in counters_e]
    assert _equal(graphed["fixed"], eager["fixed"])
    for a, b in zip(graphed["re"], eager["re"]):
        assert _equal(a, b)


def _workload(n=6400, n_users=640, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 3))
    users = np.minimum(rng.zipf(1.6, size=n) - 1, n_users - 1)
    y = (X @ rng.normal(size=3) + 0.7 * rng.normal(size=n_users)[users] > 0).astype(np.float64)
    re = np.concatenate([np.ones((n, 1)), 2.0 * X[:, :2] + 0.5], axis=1)
    return sp.csr_matrix(re), users, y


def _dataset():
    X, users, y = _workload()
    return build_random_effect_dataset(X, users, "userId", feature_shard_id="re", labels=y,
                                       device="cuda"), len(y)


def _coord(budget=None, opt="LBFGS"):
    ds, n = _dataset()
    return RandomEffectCoordinate(
        coordinate_id="re", dataset=ds, task=TaskType.LOGISTIC_REGRESSION,
        configuration=_cfg(opt, 40), base_offsets=torch.zeros(n, device="cuda"),
        variance_computation=VarianceComputationType.NONE, working_set_rows=budget,
    )


def _updates(coord, n=3):
    partial = torch.zeros(coord.dataset.n_samples, device="cuda")
    model = coord.initialize_model()
    score = coord.score(model)
    for _ in range(n):
        model, score, tracker = coord.update_and_score(model, partial, score)
        assert bool(tracker.guard_ok)
    return model, score


@pytest.mark.cuda
def test_the_update_program_graphed_is_bitwise_eager(monkeypatch):
    _needs_cuda()
    coord = _coord()
    (model, score), counters = _profiled(lambda: _updates(coord))
    assert coord._update_static()["graphs"].captures == len(coord.dataset.buckets)
    assert counters["re.graph_trips"] == counters["re.trips"] > 0
    monkeypatch.setattr(bucket_graphs, "engages", lambda *args: False)
    model_e, score_e = _updates(_coord())
    assert _equal(model.coeffs, model_e.coeffs)
    assert _equal(score, score_e)


def _chunk():
    return _updates(_coord(budget=64), 1)


def _population():
    ds, n = _dataset()
    P, E, K = 2, ds.n_entities, ds.max_k
    update = re_population_update_program(TaskType.LOGISTIC_REGRESSION,
                                          _cfg().optimizer_config, False,
                                          VarianceComputationType.NONE, E)
    zeros = torch.zeros((P, n), device="cuda")
    l2 = torch.tensor([[0.5], [2.0]], device="cuda").expand(P, E).contiguous()
    return update(torch.zeros((P, E, K), device="cuda"), zeros, None, zeros, l2,
                  torch.zeros(P, device="cuda"), ds.buckets, [None] * len(ds.buckets),
                  ds.scoring_view())


def _newton():
    data, step = _glmix("NEWTON")
    return step(init_game_params(data, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["chunk", "population", "newton"])
def test_chunk_population_and_newton_paths_take_no_graph(path):
    _needs_cuda()
    before = any_lane.syncs
    _, counters = _profiled({"chunk": _chunk, "population": _population, "newton": _newton}[path])
    assert any_lane.syncs > before
    assert counters.get("re.graph_trips", 0) == 0
    assert counters.get("re.graph_captures", 0) == 0
