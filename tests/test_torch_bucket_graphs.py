"""The graphed random-effect L-BFGS bucket solve (photon_ml_tpu_torch/
optimization/bucket_graphs.py) on the CPU.

CUDA graphs exist only on the card; here the driver runs with each "replay"
an eager call of its step over the same static buffers, which is what the
graphs hold. Over skewed buckets:

- the driver's coefficients, values, gradients, iterations and reasons are
  BITWISE ``minimize_lbfgs``'s, over several lane counts and two solves in
  a row, with a lane stationary at its warm start, a lane whose line search
  fails and lanes that reach ``max_iterations``;
- through ``solve_buckets`` the counters ``re.trips`` (every bucket solve's
  host syncs), ``re.graph_trips`` (those of graphed solves) and
  ``re.graph_captures`` (one per bucket, in its first solve) count as
  specified, and the graphed buckets' tables equal the eager ones bitwise;
- the strong-Wolfe search, split into steps, is bitwise the search written
  as one loop, in NEWTON's and L-BFGS's solves;
- the benchmark's reader ``re_graphed_trip_share.glmix`` reads those
  counters.

tests/test_torch_cuda_bucket_graphs.py holds the captured graphs on the card.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from photon_ml_tpu_torch.data.dataset import LabeledData
from photon_ml_tpu_torch.data.matrix import DenseDesignMatrix
from photon_ml_tpu_torch.data.random_effect import EntityBucket
from photon_ml_tpu_torch.function.losses import loss_for_task
from photon_ml_tpu_torch.function.objective import GLMObjective
from photon_ml_tpu_torch.optimization import bucket_graphs, linesearch
from photon_ml_tpu_torch.optimization.bucket_graphs import BucketGraphs, GraphedLbfgs
from photon_ml_tpu_torch.optimization.common import OptimizerConfig, any_lane
from photon_ml_tpu_torch.optimization.lbfgs import minimize_lbfgs
from photon_ml_tpu_torch.optimization.newton import minimize_newton
from photon_ml_tpu_torch.optimization.solver_cache import re_bucket_solver, solve_buckets
from photon_ml_tpu_torch.types import ConvergenceReason, TaskType, VarianceComputationType
from photon_ml_tpu_torch.util import timed

K = 4
OBJ = GLMObjective(loss_for_task(TaskType.LOGISTIC_REGRESSION), allow_fused=False)


@pytest.fixture(autouse=True)
def fresh_recorder():
    timed.reset()
    yield
    timed.reset()


def _bucket(counts, rng, row0=0, sid0=0, dtype=torch.float32):
    """An entity bucket of ``len(counts)`` lanes, lane e holding counts[e]
    samples and padding to the largest count."""
    E, S = len(counts), max(max(counts), 1)
    X = rng.normal(size=(E, S, K))
    w = np.zeros((E, S))
    ids = np.full((E, S), -1)
    sid = sid0
    for e, n in enumerate(counts):
        w[e, :n] = 1.0
        ids[e, :n] = np.arange(sid, sid + n)
        sid += n
    X[w == 0] = 0.0
    y = (rng.random((E, S)) < 1.0 / (1.0 + np.exp(-X @ rng.normal(size=K)))) & (w > 0)
    return EntityBucket(
        entity_rows=torch.arange(row0, row0 + E, dtype=torch.int32),
        X=torch.as_tensor(X, dtype=dtype), labels=torch.as_tensor(y, dtype=dtype),
        weights=torch.as_tensor(w, dtype=dtype),
        sample_ids=torch.as_tensor(ids, dtype=torch.int32),
    ), sid


def _skewed(n_lanes, rng):
    """Sample counts of a heavy tail: lane e about 2 + e^2 / 3, lane 0 none
    (it stays at a zero warm start), at most 60."""
    return [0] + [min(2 + (e * e) // 3, 60) for e in range(1, n_lanes)]


def _eager(step):
    """The CPU's stand-in for a capture: its ``replay`` runs the step."""
    return SimpleNamespace(replay=step)


def _bits(t):
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def _assert_bitwise(got, want):
    for name in ("coefficients", "value", "gradient", "iterations", "convergence_reason"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(_bits(a), _bits(b)), name


@pytest.mark.parametrize("n_lanes, max_iterations", [(1, 30), (2, 30), (7, 30), (33, 30),
                                                     (33, 4)])
def test_the_graphed_driver_is_bitwise_the_eager_solve(n_lanes, max_iterations):
    rng = np.random.default_rng(n_lanes)
    bucket, _ = _bucket(_skewed(n_lanes, rng), rng)
    E, S = bucket.X.shape[:2]
    cfg = OptimizerConfig(max_iterations=max_iterations, tolerance=1e-7)
    offsets = torch.as_tensor(0.1 * rng.normal(size=(E, S)), dtype=torch.float32)
    if n_lanes > 2:
        # a lane whose objective is NaN: its line search fails
        offsets[n_lanes - 1, 0] = float("nan")
    x0 = torch.as_tensor(0.2 * rng.normal(size=(E, K)), dtype=torch.float32)
    x0[0] = 0.0  # no sample, no warm start: stationary at once
    l2 = torch.as_tensor(0.5 + rng.random(E), dtype=torch.float32)

    captured = []

    def capture(step):
        captured.append(step)
        return _eager(step)

    driver = GraphedLbfgs(OBJ, bucket.X, bucket.labels, bucket.weights, cfg, offsets, x0, l2,
                          capture)
    second = (x0 * 0.5, offsets * 0.5, l2 * 2.0)
    for x0_i, off_i, l2_i in ((x0, offsets, l2), second):
        data = LabeledData(X=DenseDesignMatrix(bucket.X), labels=bucket.labels, offsets=off_i,
                           weights=bucket.weights)
        syncs = any_lane.syncs
        want = minimize_lbfgs(lambda w: OBJ.value_and_gradient(data, w, l2_i), x0_i,
                              max_iterations=cfg.max_iterations, tolerance=cfg.tolerance,
                              history_length=cfg.history_length,
                              max_line_search_iterations=cfg.max_line_search_iterations)
        eager_syncs = any_lane.syncs - syncs
        syncs = any_lane.syncs
        got = driver.solve(x0_i, off_i, l2_i)
        # the same trips: one host read for each of the eager loop's
        assert any_lane.syncs - syncs == eager_syncs
        _assert_bitwise(got, want)
    assert len(captured) == 3  # the three steps, captured in the first solve alone

    reasons = got.convergence_reason.tolist()
    assert reasons[0] == ConvergenceReason.GRADIENT_CONVERGED and int(got.iterations[0]) == 0
    if n_lanes > 2:
        assert reasons[n_lanes - 1] == ConvergenceReason.OBJECTIVE_NOT_IMPROVING
    if max_iterations == 4:
        assert ConvergenceReason.MAX_ITERATIONS in reasons
    # the result is the solve's own, not the driver's buffers
    assert got.coefficients.data_ptr() != driver.state["x"].data_ptr()


def _table_problem(rng, lane_counts=((3, 9, 1, 40, 0), (12, 2, 25), (60,))):
    buckets, row, sid = [], 0, 0
    for counts in lane_counts:
        b, sid = _bucket(list(counts), rng, row0=row, sid0=sid)
        buckets.append(b)
        row += len(counts)
    offsets = torch.as_tensor(0.1 * rng.normal(size=sid), dtype=torch.float32)
    l2_rows = torch.as_tensor(0.5 + rng.random(row), dtype=torch.float32)
    return buckets, row, offsets, l2_rows


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        return fn()


def test_solve_buckets_counts_trips_graph_trips_and_captures(monkeypatch):
    """The graphed driver engaged on the CPU (``engages`` patched to admit
    it, each replay an eager call): over two solves of three buckets,
    ``re.trips`` is every bucket solve's host syncs on both paths,
    ``re.graph_trips`` the graphed solves' and ``re.graph_captures`` one per
    bucket, in the first solve; the tables equal the eager ones bitwise."""
    rng = np.random.default_rng(4)
    buckets, E, offsets, l2_rows = _table_problem(rng)
    solve = re_bucket_solver(TaskType.LOGISTIC_REGRESSION, OptimizerConfig(max_iterations=30),
                             False, VarianceComputationType.NONE)
    warm = torch.as_tensor(0.1 * rng.normal(size=(E, K)), dtype=torch.float32)
    warm[4] = 0.0  # the lane with no sample

    def run(graphs):
        coeffs = warm.clone()
        trips, counters = [], []
        for _ in range(2):
            timed.reset()
            syncs = any_lane.syncs
            _profiled(lambda: solve_buckets(solve, buckets, coeffs, None, offsets, l2_rows, 0.0,
                                            graphs=graphs))
            trips.append(any_lane.syncs - syncs)
            counters.append(timed.snapshot()["counters"])
        return coeffs, trips, counters

    eager, eager_trips, eager_counters = run(None)
    monkeypatch.setattr(bucket_graphs, "engages", lambda *args: True)
    graphs = BucketGraphs(capture=_eager)
    graphed, trips, counters = run(graphs)

    assert torch.equal(_bits(graphed), _bits(eager))
    assert trips == eager_trips
    for c, t in zip(eager_counters, eager_trips):
        assert c["re.trips"] == t and "re.graph_trips" not in c
    assert [c["re.trips"] for c in counters] == trips
    assert [c["re.graph_trips"] for c in counters] == trips
    assert counters[0]["re.graph_captures"] == len(buckets)
    assert "re.graph_captures" not in counters[1]
    assert graphs.captures == len(buckets)


def test_a_bucket_solve_without_resident_graphs_keeps_the_eager_loop(monkeypatch):
    """A solve that is handed no graphs (a probe's transient bucket, a
    streamed chunk) never builds a driver, even where ``engages`` holds."""
    monkeypatch.setattr(bucket_graphs, "engages", lambda *args: True)
    monkeypatch.setattr(bucket_graphs, "GraphedLbfgs", None)
    rng = np.random.default_rng(6)
    buckets, E, offsets, l2_rows = _table_problem(rng)
    solve = re_bucket_solver(TaskType.LOGISTIC_REGRESSION, OptimizerConfig(max_iterations=30),
                             False, VarianceComputationType.NONE)
    coeffs = torch.zeros((E, K))
    timed.reset()
    _profiled(lambda: solve_buckets(solve, buckets, coeffs, None, offsets, l2_rows, 0.0))
    counters = timed.snapshot()["counters"]
    assert counters["re.trips"] > 0 and "re.graph_trips" not in counters


@pytest.mark.parametrize("graphed", [False, True])
def test_the_graphed_trip_share_reader(graphed, monkeypatch):
    """portbench's ``re_graphed_trip_share.glmix``: None while nothing is
    recorded, 0% over eager bucket solves (a NEWTON cell's), 100% over
    graphed ones."""
    from portbench.harness import Bench

    read = Bench().reader("re_graphed_trip_share.glmix")
    ctx = {"config": "glmix", "trace": {"busy_s": 0.0}}
    rng = np.random.default_rng(9)
    buckets, E, offsets, l2_rows = _table_problem(rng)
    solve = re_bucket_solver(TaskType.LOGISTIC_REGRESSION, OptimizerConfig(max_iterations=30),
                             False, VarianceComputationType.NONE)
    graphs = None
    if graphed:
        monkeypatch.setattr(bucket_graphs, "engages", lambda *args: True)
        graphs = BucketGraphs(capture=_eager)

    def run():
        solve_buckets(solve, buckets, torch.zeros((E, K)), None, offsets, l2_rows, 0.0,
                      graphs=graphs)

    run()  # outside the profiler: nothing recorded
    assert read(ctx) is None
    _profiled(run)
    assert read({**ctx, "trace": None}) is None
    assert read(ctx) == (100.0 if graphed else 0.0)


def _strong_wolfe_one_loop(phi, f0, g0, dphi0, init_alpha, max_iters=10, active=None):
    """The strong-Wolfe search written as one loop over ``linesearch._body``,
    the form its steps (``wolfe_start``, ``wolfe_running``, ``wolfe_trip``,
    ``wolfe_result``) must reproduce bit for bit."""
    _where, _body = linesearch._where, linesearch._body
    dtype, dev = f0.dtype, f0.device
    fin = torch.finfo(dtype)
    big = torch.full_like(f0, float("inf"))
    zero = torch.zeros_like(f0)
    thresh = fin.eps * torch.clamp_min(torch.abs(f0), fin.tiny) / 2.0 ** min(max_iters, 60)
    searchable = ~(dphi0 >= -thresh) | ~torch.isfinite(f0)
    if active is not None:
        searchable = searchable & active
    a1 = torch.where(searchable, torch.as_tensor(init_alpha, dtype=dtype, device=dev), zero)
    f_a1, g_a1, dphi_a1 = phi(a1)
    st = dict(
        stage=torch.where(searchable, 0, 2).to(torch.int32),
        i=torch.ones_like(f0, dtype=torch.int32), a=a1,
        f_a=torch.where(searchable, f_a1, f0), g_a=_where(searchable, g_a1, g0),
        dphi_a=torch.where(searchable, dphi_a1, dphi0),
        a_lo=zero, f_lo=f0, dphi_lo=dphi0, a_hi=big, f_hi=big, dphi_hi=big,
        a_best=zero, f_best=f0, g_best=g0,
    )
    while True:
        running = (st["stage"] < 2) & (st["i"] < max_iters)
        if not any_lane(running):
            break
        new = _body(st, phi, f0, dphi0, big)
        st = {k: _where(running, new[k], st[k]) for k in linesearch._FIELDS}
    success = st["stage"] == 2
    has_fallback = st["a_best"] > 0
    alpha = torch.where(success, st["a"], torch.where(has_fallback, st["a_best"], zero))
    value = torch.where(success, st["f_a"], torch.where(has_fallback, st["f_best"], f0))
    grad = _where(success, st["g_a"], st["g_best"])
    return linesearch.LineSearchResult(alpha=alpha, value=value, grad=grad,
                                       success=success | has_fallback, evals=st["i"])


@pytest.mark.parametrize("opt", ["NEWTON", "LBFGS"])
def test_the_split_strong_wolfe_search_is_bitwise_the_one_loop(opt, monkeypatch):
    rng = np.random.default_rng(8)
    bucket, _ = _bucket(_skewed(17, rng), rng, dtype=torch.float64)
    E, S = bucket.X.shape[:2]
    data = LabeledData(X=DenseDesignMatrix(bucket.X), labels=bucket.labels,
                       offsets=torch.as_tensor(0.1 * rng.normal(size=(E, S))),
                       weights=bucket.weights)
    l2 = torch.as_tensor(0.5 + rng.random(E))
    x0 = torch.as_tensor(0.3 * rng.normal(size=(E, K)))

    def vg(w):
        return OBJ.value_and_gradient(data, w, l2)

    def solve():
        if opt == "NEWTON":
            return minimize_newton(vg, lambda w: OBJ.hessian_matrix(data, w, l2), x0,
                                   max_iterations=20)
        return minimize_lbfgs(vg, x0, max_iterations=30)

    split = solve()
    monkeypatch.setattr(linesearch, "strong_wolfe", _strong_wolfe_one_loop)
    one_loop = solve()
    _assert_bitwise(split, one_loop)
    assert int(split.iterations.max()) > 1
