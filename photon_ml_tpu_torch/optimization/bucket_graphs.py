"""The random-effect L-BFGS bucket solve replayed from CUDA graphs.

A bucket's batched L-BFGS solve (optimization/lbfgs.py) is a host loop of
trips, each a few hundred small kernels over the bucket's lanes and one
``common.any_lane`` read. Eagerly the host spends milliseconds a trip
dispatching them and the card idles. Here the solve of one RESIDENT bucket
runs from three CUDA graphs, captured in its first solve and replayed in
every later one:

- ``init_head``: ``lbfgs_init``, then the head: ``lbfgs_active``,
  ``lbfgs_direction``, ``wolfe_start`` and ``wolfe_running``;
- ``trip``: one ``wolfe_trip`` and ``wolfe_running``;
- ``tail_head``: ``wolfe_result``, ``lbfgs_tail``, then the head again.

A solve copies its inputs (warm start, offsets-plus-scores, L2 weights) into
static buffers, replays ``init_head``, and then reads the same masks the
eager loop reads, in the same order: ``any_lane(active)``, then
``any_lane(running)`` after each ``trip`` replay, and ``tail_head`` after
each search. The graphs hold the same kernels in the same order as
``minimize_lbfgs``, over the same lanes, for the same number of trips; the
step functions are the eager loop's own, so the two compute the same bits.

Every value that passes from one step to the next lives in a buffer
allocated outside capture (:class:`GraphedLbfgs`); a graph's own
allocations are scratch that no other graph reads. So one memory pool
serves every graph of a random-effect coordinate (:class:`BucketGraphs`):
its graphs replay one at a time on one stream, and a later capture may take
blocks an earlier graph's scratch used. The serving engine
(serving/engine.py) gives each graph a pool of its own because concurrent
callers there replay graphs and copy their outputs out of the pool between
replays; neither happens here.

Which solves take the graphs is decided from what the code can observe
(:func:`engages`); every other solve keeps the eager loop.
"""

from __future__ import annotations

import gc
from typing import Callable, Optional

import torch

from photon_ml_tpu_torch.analysis.runtime_guard import named_boundary, note_trace
from photon_ml_tpu_torch.data.dataset import LabeledData
from photon_ml_tpu_torch.data.matrix import DenseDesignMatrix
from photon_ml_tpu_torch.optimization.common import OptimizerConfig, OptResult, any_lane
from photon_ml_tpu_torch.optimization.lbfgs import (
    lbfgs_active,
    lbfgs_direction,
    lbfgs_init,
    lbfgs_tail,
    line_function,
)
from photon_ml_tpu_torch.optimization.linesearch import (
    _FIELDS,
    wolfe_result,
    wolfe_running,
    wolfe_start,
    wolfe_trip,
)
from photon_ml_tpu_torch.types import OptimizerType
from photon_ml_tpu_torch.util.timed import count

Tensor = torch.Tensor


def engages(opt_config: OptimizerConfig, has_l1: bool, w0: Tensor, active) -> bool:
    """Whether a resident bucket's solve runs from graphs: on CUDA, L-BFGS
    with no L1 weight and no state tracking, from a plain [E, K] warm start
    (no population axis) and no ``active`` mask. OWL-QN, TRON, NEWTON, a
    population and every CPU solve keep the eager loop."""
    return (
        w0.device.type == "cuda"
        and OptimizerType(opt_config.optimizer_type) == OptimizerType.LBFGS
        and not has_l1
        and not opt_config.track_states
        and w0.dim() == 2
        and active is None
    )


class GraphedLbfgs:
    """One bucket's L-BFGS solve over static buffers.

    ``objective`` is the bucket's lane objective and ``X``, ``labels`` and
    ``weights`` its resident block; ``offsets``, ``x0`` and ``l2`` give the
    shapes and dtypes of the per-solve inputs. ``capture(step)`` returns
    what replays ``step`` through its ``replay()``: a CUDA graph
    (:class:`_CudaCapture`), or a stand-in whose ``replay`` is ``step``
    itself, which runs the same steps eagerly over the same buffers (the
    CPU tests drive the driver so).

    The first :meth:`solve` runs each step once eagerly (the warm-up the
    capture needs), captures the three steps, and then solves by replays,
    as every later solve does.
    """

    def __init__(self, objective, X: Tensor, labels: Tensor, weights: Tensor,
                 opt_config: OptimizerConfig, offsets: Tensor, x0: Tensor, l2: Tensor,
                 capture: Callable):
        self._config = opt_config
        self._capture = capture
        self._steps = None
        E, K = x0.shape
        m = opt_config.history_length
        dtype, dev = x0.dtype, x0.device

        def vec(dt=dtype):
            return torch.zeros((E,), dtype=dt, device=dev)

        def rows():
            return torch.zeros((E, K), dtype=dtype, device=dev)

        # the per-solve inputs
        self.x0 = torch.zeros_like(x0)
        self.offsets = torch.zeros_like(offsets)
        self.l2 = torch.zeros_like(l2)
        # the solver state (the fields of lbfgs.lbfgs_init's dict)
        self.state = dict(
            x=rows(), f=vec(), g=rows(),
            S=torch.zeros((E, m, K), dtype=dtype, device=dev),
            Y=torch.zeros((E, m, K), dtype=dtype, device=dev),
            rho=torch.zeros((E, m), dtype=dtype, device=dev),
            k=vec(torch.int32), n_written=vec(torch.int32), reason=vec(torch.int32),
            loss_abs_tol=vec(), grad_abs_tol=vec(),
        )
        self.active = vec(torch.bool)
        self.direction = rows()
        self.dphi0 = vec()
        # the line search's state (linesearch._FIELDS) and its open bracket end
        self.search = {f: rows() if f in ("g_a", "g_best") else vec() for f in _FIELDS}
        for f in ("stage", "i"):
            self.search[f] = vec(torch.int32)
        self.running = vec(torch.bool)
        self.big = torch.full((E,), float("inf"), dtype=dtype, device=dev)

        data = LabeledData(X=DenseDesignMatrix(X), labels=labels, offsets=self.offsets,
                           weights=weights)
        l2_rows = self.l2  # not ``self``: no cycle, so the graphs die with their owner

        def value_and_grad(w):
            return objective.value_and_gradient(data, w, l2_rows)

        self._vg = value_and_grad

    # -- the steps: each writes its results into the buffers --------------

    def _head(self) -> None:
        st, cfg = self.state, self._config
        active = lbfgs_active(st)
        direction, dphi0, init_alpha = lbfgs_direction(st)
        search = wolfe_start(line_function(self._vg, st["x"], direction), st["f"], st["g"],
                             dphi0, init_alpha, self.big, cfg.max_line_search_iterations, active)
        self.active.copy_(active)
        self.direction.copy_(direction)
        self.dphi0.copy_(dphi0)
        _put(self.search, search)
        self.running.copy_(wolfe_running(self.search, cfg.max_line_search_iterations))

    def _init_head(self) -> None:
        cfg = self._config
        _put(self.state, lbfgs_init(self._vg, self.x0, cfg.history_length, cfg.tolerance))
        self._head()

    def _trip(self) -> None:
        st, cfg = self.state, self._config
        phi = line_function(self._vg, st["x"], self.direction)
        _put(self.search, wolfe_trip(self.search, self.running, phi, st["f"], self.dphi0,
                                     self.big))
        self.running.copy_(wolfe_running(self.search, cfg.max_line_search_iterations))

    def _tail_head(self) -> None:
        st = self.state
        ls = wolfe_result(self.search, st["f"], st["g"])
        _put(st, lbfgs_tail(self._vg, st, self.direction, ls, self.active,
                            self._config.max_iterations))
        self._head()

    # -- the solve -------------------------------------------------------

    def _capture_steps(self) -> None:
        """Run each step once eagerly, then capture the three. The eager runs
        leave values in the buffers that the solve's first replay
        overwrites: ``init_head`` reads nothing but the inputs."""
        steps = (self._init_head, self._trip, self._tail_head)
        for step in steps:
            step()
        self._steps = tuple(self._capture(step) for step in steps)
        count("re.graph_captures", 1)

    @property
    def captured(self) -> bool:
        return self._steps is not None

    def solve(self, x0: Tensor, offsets: Tensor, l2: Tensor) -> OptResult:
        """The bucket's solve from warm start ``x0`` [E, K] over
        ``offsets`` [E, S] and L2 weights ``l2`` [E]. The result's tensors
        are the solve's own, not the buffers."""
        self.x0.copy_(x0)
        self.offsets.copy_(offsets)
        self.l2.copy_(l2)
        if self._steps is None:
            self._capture_steps()
        init_head, trip, tail_head = self._steps
        syncs = any_lane.syncs
        init_head.replay()
        while any_lane(self.active):
            while any_lane(self.running):
                trip.replay()
            tail_head.replay()
        count("re.graph_trips", any_lane.syncs - syncs)
        st = self.state
        return OptResult(coefficients=st["x"].clone(), value=st["f"].clone(),
                         gradient=st["g"].clone(), iterations=st["k"].clone(),
                         convergence_reason=st["reason"].clone())


def _put(buffers: dict, values: dict) -> None:
    """Write a step's results into the buffers of the same names."""
    for name, value in values.items():
        buf = buffers[name]
        if value is not buf:
            buf.copy_(value)


class _CudaCapture:
    """Captures a step into a CUDA graph on a random-effect coordinate's one
    pool and side stream (module docstring), and adds the device bytes the
    pool took to ``pool_bytes``. A failed capture raises.

    Python's cycle collector is off while a capture records: a collection
    there could destroy another, unreachable graph, a CUDA call that
    invalidates the capture."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self.pool_bytes = 0

    def __call__(self, step: Callable) -> "torch.cuda.CUDAGraph":
        with named_boundary():
            # the warm-up's work is done before the capture starts
            torch.cuda.synchronize(self.device)
        before = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(self.stream):
                graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
                try:
                    step()
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass  # the step's own error is the one to raise
                    raise
                graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        self.pool_bytes += torch.cuda.memory_reserved(self.device) - before
        note_trace("re bucket capture")
        return graph


class BucketGraphs:
    """The graphed solves of one random-effect coordinate's resident
    buckets: one :class:`GraphedLbfgs` per bucket and solver key (the
    configuration and dtypes), all captured on one pool. The owner of the
    buckets holds it (``parallel.game.ShardedRECoordinate``,
    ``data.random_effect.RandomEffectDataset``, the update program's static
    inputs) and hands it to ``solver_cache.solve_buckets``, so a transient
    bucket (a probe's, a streamed chunk's, an active-set delta's) never
    takes a graph.

    ``capture`` stands in for the CUDA capture (:class:`GraphedLbfgs`);
    ``captures`` counts the buckets captured, ``pool_bytes`` the device
    bytes the pool took."""

    def __init__(self, capture: Optional[Callable] = None):
        self._capture = capture
        self._solves: dict = {}  # (id(bucket), key) -> (bucket, GraphedLbfgs)

    @property
    def captures(self) -> int:
        return sum(d.captured for _, d in self._solves.values())

    @property
    def pool_bytes(self) -> int:
        return getattr(self._capture, "pool_bytes", 0)

    def driver(self, bucket, key, make: Callable[[Callable], GraphedLbfgs]) -> GraphedLbfgs:
        """The bucket's graphed solve under ``key``: ``make(capture)`` builds
        it the first time. The entry holds the bucket, so its id stays its
        own."""
        entry = self._solves.get((id(bucket), key))
        if entry is None:
            if self._capture is None:
                self._capture = _CudaCapture(bucket.X.device)
            entry = self._solves[(id(bucket), key)] = (bucket, make(self._capture))
        return entry[1]
