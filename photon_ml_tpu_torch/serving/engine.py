"""Fused GAME serving engine: one CUDA graph per request bucket.

Port of photon_ml_tpu/serving/engine.py. The eager scoring path
(transformers/game_transformer.py) rebuilds a scoring dataset per coordinate
per call and pays one host round trip per coordinate. This engine keeps the
model's tables resident on the device and runs the whole per-request
pipeline (the fixed-effect product, every random-effect gather/dot, the
offset add, optionally the link) as one replay of a captured CUDA graph,
with one device-to-host copy of the scores.

Design:

- **Device-resident model state, placed once.** At build every coordinate's
  table (FE means [D], RE coefficients [E, K]) moves to the engine's device,
  stored per the precision policy. Engines are cached by content fingerprint
  (``get_engine``), so repeated ``GameTransformer`` construction over the
  same loaded model reuses one engine and its graphs.
- **No per-request alignment.** The engine precomputes (host, once) a sorted
  (entity-row, global-column) -> model-slot key table; each request's CSR
  entries map into the model's own layout with one vectorized searchsorted.
  Unseen entities and columns the model never saw score exactly 0, as
  ``aligned_to``'s zero fill does. Request preparation stays on the host in
  numpy.
- **One CUDA graph per bucket.** Batch sizes pad to the next power of two
  and each random effect's row width to its width bucket; the JAX engine
  keys one ``jax.jit`` program on that signature, and this engine captures
  one ``torch.cuda.CUDAGraph`` per signature (``_batch_signature`` plus the
  statics), once, and replays it. ``capture_count`` counts captures:
  steady-state serving captures nothing. A graph that fails to capture or
  replay raises; the engine never scores eagerly in its place. On the CPU
  (``device="cpu"``, the caller's choice) the same ``_fused`` body runs
  eagerly, since CUDA graphs do not exist there.
- **Bitwise parity with the eager path.** The random-effect score is the
  function the eager path runs (``models.game.random_effect_view_score``)
  over a per-sample view with the same dtype rules (values stored float32,
  CSR entry order), and the dense fixed effect goes through
  ``models.game.fixed_effect_view_score``. Both sum each row in a fixed
  order whose bits depend neither on the number of rows nor on trailing
  zero padding, so the padded engine and the unpadded eager scorer agree
  bit for bit on dense fixed effects under ``FE_SPARSE_MIN_COLS`` (1,024)
  columns. A sparse fixed-effect request scores through a per-sample
  gather/dot, and so does a dense one of 1,024 columns or more, with its
  values kept at the model's dtype: dropping its zeros changes the pairing
  of the row sum, so that route agrees with eager within rounding (a few
  ulps of the row's terms), not bitwise.

Padding discipline: padded rows carry entity row -1, column slot -1 and value
0 everywhere, so every per-row computation is inert and the trailing rows are
sliced off after the single host transfer.

Concurrency: a graph's static buffers are shared, so each graph has its own
lock, held from the copy into its buffers to the copy of its output; the
first hit on a bucket captures exactly once while concurrent callers wait.
All of an engine's copies and replays go through one CUDA stream, so the
graphs, which share one memory pool, never run at the same time on the
device while callers on different buckets never wait on one engine-wide
lock.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import threading
from collections import OrderedDict
from typing import Optional, Union

import numpy as np
import scipy.sparse as sp
import torch

from photon_ml_tpu_torch.data.game_data import GameInput, as_csr
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.function.losses import mean_function_for_task
from photon_ml_tpu_torch.models.game import (
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
    fixed_effect_view_score,
    random_effect_view_score,
    row_sum,
)
from photon_ml_tpu_torch.optimization.precision import (
    host_link,
    offsets_fuse_on_device,
    resolve_precision,
    torch_to_numpy_dtype,
)

Tensor = torch.Tensor

# Smallest padded batch: tiny buckets would capture a graph per handful of
# samples; production deployments pass a larger floor via get_engine.
MIN_BATCH_PAD = 8

# Smallest padded per-row nnz width (see _per_sample_view).
MIN_WIDTH_PAD = 4

# Dense fixed-effect requests with at least this many columns route through
# the per-sample sparse view instead of padding a [B, K] device buffer.
FE_SPARSE_MIN_COLS = 1024

# one capture at a time in the process: a capture must not interleave with
# another thread's capture
_CAPTURE_LOCK = threading.Lock()


def width_bucket(max_row_nnz: int) -> int:
    """The engine's nnz-width bucket for a request whose widest row has
    ``max_row_nnz`` entries: next power of two >= MIN_WIDTH_PAD."""
    w = max(int(max_row_nnz), 1)
    p = MIN_WIDTH_PAD
    while p < w:
        p *= 2
    return p


# --------------------------------------------------------------------------
# model fingerprint
# --------------------------------------------------------------------------


def _host_array(a) -> np.ndarray:
    """Host numpy copy of a tensor or array (bf16 as its int16 bits)."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu()
        return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(a)


def _hash_array(h, a) -> None:
    dtype = str(a.dtype) if isinstance(a, torch.Tensor) else str(np.asarray(a).dtype)
    a = _host_array(a)
    h.update(dtype.encode())
    h.update(repr(a.shape).encode())
    h.update(np.ascontiguousarray(a).tobytes())


def _hash_projector(h, p) -> None:
    """Structural + sampled-content digest of a RandomProjector."""
    mat = np.asarray(p.matrix)
    h.update(b"|proj|")
    h.update(repr(mat.shape).encode())
    h.update(str(p.intercept_index).encode())
    d, k = mat.shape
    rows = np.unique(np.linspace(0, d - 1, num=min(d, 16), dtype=np.int64))
    cols = np.unique(np.linspace(0, k - 1, num=min(k, 4), dtype=np.int64))
    _hash_array(h, mat[np.ix_(rows, cols)])
    norm = p.normalization
    if norm is not None:
        for vec in (norm.factors, norm.shifts):
            if vec is not None:
                _hash_array(h, vec)


def model_fingerprint(model: GameModel) -> str:
    """Content digest of a GameModel over host copies of its tables:
    coordinate ids/types/metadata plus the coefficient bytes. Identical
    models (the same directory loaded twice) share one engine."""
    h = hashlib.blake2b(digest_size=16)
    for cid, m in model:
        h.update(cid.encode())
        if isinstance(m, FixedEffectModel):
            h.update(b"|fe|")
            h.update(m.feature_shard_id.encode())
            h.update(str(m.task).encode())
            _hash_array(h, m.model.coefficients.means)
        elif isinstance(m, RandomEffectModel):
            h.update(b"|re|")
            h.update(m.re_type.encode())
            h.update(m.feature_shard_id.encode())
            h.update(str(m.task).encode())
            # the type with the text: int ids and their string forms (a model
            # read back from its files) look up different requests
            h.update("\x1f".join(f"{type(e).__name__}:{e}" for e in m.entity_ids).encode())
            _hash_array(h, m.coeffs)
            _hash_array(h, m.proj_indices)
            if m.projector is not None:
                _hash_projector(h, m.projector)
        else:
            raise TypeError(f"Cannot fingerprint model of type {type(m).__name__}")
    return h.hexdigest()


# --------------------------------------------------------------------------
# per-coordinate device/lookup state
# --------------------------------------------------------------------------


@dataclasses.dataclass
class _FixedCoord:
    cid: str
    feature_shard_id: str
    means: Tensor  # [D], device-resident, storage dtype
    values_dtype: torch.dtype  # dense request values are cast to the model's dtype


@dataclasses.dataclass
class _RandomCoord:
    cid: str
    re_type: str
    feature_shard_id: str
    coeffs: Tensor  # [max(E,1), K], device-resident, storage dtype
    # entity lookup (host): parallel sorted-ids/rows arrays, or a dict when the
    # ids are not homogeneously sortable
    ids_sorted: Optional[np.ndarray]
    rows_sorted: Optional[np.ndarray]
    row_by_entity: Optional[dict]
    # (row * col_span + global col) -> model slot, sorted for searchsorted
    slot_keys: np.ndarray  # [M] int64, sorted
    slot_vals: np.ndarray  # [M] int32
    col_span: int

    def entity_rows(self, ents) -> np.ndarray:
        """[n] model row per request entity id, -1 = no model (vectorized)."""
        ents = np.asarray(ents)
        if self.ids_sorted is not None:
            if len(self.ids_sorted) == 0:
                return np.full(len(ents), -1, dtype=np.int32)
            try:
                pos = np.clip(np.searchsorted(self.ids_sorted, ents), 0, len(self.ids_sorted) - 1)
                hit = self.ids_sorted[pos] == ents
                if hit is False or hit is NotImplemented:  # incomparable dtypes
                    raise TypeError("entity id comparison degenerated")
                return np.where(hit, self.rows_sorted[pos], -1).astype(np.int32)
            except TypeError:
                # request ids not comparable with the model's (e.g. str vs
                # int): the dict path misses like the eager
                # RandomEffectModel.row_for_entity and scores 0
                if self.row_by_entity is None:
                    self.row_by_entity = {
                        e: int(r) for e, r in zip(self.ids_sorted.tolist(), self.rows_sorted)
                    }
        get = self.row_by_entity.get
        return np.fromiter((get(e, -1) for e in ents.tolist()), dtype=np.int32, count=len(ents))

    def local_slots(self, entity_row_per_nnz, cols) -> np.ndarray:
        """Model-layout slot per nnz entry, -1 when the entity has no model or
        the model never saw the column (aligned_to's zero fill, as a mask)."""
        cols = cols.astype(np.int64)
        valid = (entity_row_per_nnz >= 0) & (cols >= 0) & (cols < self.col_span)
        if len(self.slot_keys) == 0:
            return np.full(len(cols), -1, dtype=np.int32)
        key = np.where(valid, entity_row_per_nnz.astype(np.int64) * self.col_span + cols, 0)
        pos = np.clip(np.searchsorted(self.slot_keys, key), 0, len(self.slot_keys) - 1)
        hit = valid & (self.slot_keys[pos] == key)
        return np.where(hit, self.slot_vals[pos], -1).astype(np.int32)


def _build_fixed_state(cid: str, m: FixedEffectModel, put) -> _FixedCoord:
    means = m.model.coefficients.means
    return _FixedCoord(cid=cid, feature_shard_id=m.feature_shard_id, means=put(means),
                       values_dtype=means.dtype)


def _build_random_state(cid: str, m: RandomEffectModel, put) -> _RandomCoord:
    # a projected model serves in the original space, as the eager scorer
    # does (RandomEffectModel.score_dataset back-projects)
    m = m.to_original_space()
    proj = m.proj_indices.detach().cpu().numpy()
    if proj.ndim != 2:
        proj = proj.reshape((0, 1))
    E, K = proj.shape
    col_span = int(proj.max()) + 1 if proj.size and int(proj.max()) >= 0 else 1
    rows_idx, slots = np.nonzero(proj >= 0)
    keys = rows_idx.astype(np.int64) * col_span + proj[rows_idx, slots]
    order = np.argsort(keys, kind="stable")
    ids_sorted = rows_sorted = row_by_entity = None
    try:
        ids = np.asarray(m.entity_ids)
        if ids.dtype == object:
            raise TypeError("heterogeneous entity ids")
        id_order = np.argsort(ids, kind="stable")
        ids_sorted = ids[id_order]
        rows_sorted = id_order.astype(np.int32)
    except TypeError:
        row_by_entity = {e: i for i, e in enumerate(m.entity_ids)}
    coeffs = m.coeffs
    if E == 0:
        # keep the gather well-formed; every request row maps to -1 anyway
        coeffs = torch.zeros((1, max(K, 1)), dtype=coeffs.dtype, device=coeffs.device)
    return _RandomCoord(
        cid=cid,
        re_type=m.re_type,
        feature_shard_id=m.feature_shard_id,
        coeffs=put(coeffs),
        ids_sorted=ids_sorted,
        rows_sorted=rows_sorted,
        row_by_entity=row_by_entity,
        slot_keys=keys[order],
        slot_vals=slots[order].astype(np.int32),
        col_span=col_span,
    )


@dataclasses.dataclass
class _Graph:
    """One captured bucket: static input buffers, the outputs the graph
    writes, and the lock that owns them between copy-in and copy-out."""

    lock: threading.Lock
    graph: Optional[object] = None  # torch.cuda.CUDAGraph once captured
    inputs: Optional[dict] = None
    outputs: Optional[tuple] = None
    held_bytes: int = 0  # device bytes the bucket holds (buffers + pool growth)


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------


class GameServingEngine:
    """Serves a loaded GameModel: one CUDA graph per request bucket on a
    CUDA device, the same body eagerly on the CPU. Build via ``get_engine``
    (content-keyed cache) rather than directly."""

    def __init__(
        self,
        model: GameModel,
        device="cuda",
        min_batch_pad: int = MIN_BATCH_PAD,
        fingerprint: Optional[str] = None,
        precision: Optional[object] = None,
    ):
        self.model = model
        self.device = resolve_device(device)
        self.min_batch_pad = int(min_batch_pad)
        # storage precision of the device tables: the f32 policy keeps every
        # cast an identity (the bitwise-held path); reduced policies store the
        # tables narrower and upcast to f32 inside the graph
        self._precision = resolve_precision(precision)
        self._fingerprint = fingerprint
        self._use_graphs = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._use_graphs else None
        self._pool = torch.cuda.graph_pool_handle() if self._use_graphs else None
        self._lock = threading.Lock()  # guards the bucket dict and counters
        self._buckets: dict = {}
        self.capture_count = 0
        self.bucket_count = 0
        self._coords: list[Union[_FixedCoord, _RandomCoord]] = []
        for cid, m in model:
            if isinstance(m, FixedEffectModel):
                self._coords.append(_build_fixed_state(cid, m, self._place_table))
            elif isinstance(m, RandomEffectModel):
                self._coords.append(_build_random_state(cid, m, self._place_table))
            else:
                raise TypeError(f"Cannot serve model of type {type(m).__name__}")
        # dtype of the summed scores, the rule of the eager path's numpy sum
        dtypes = [self._coord_dtype(st) for st in self._coords]
        self._score_dtype = functools.reduce(torch.promote_types, dtypes) if dtypes else None

    # -- device state ------------------------------------------------------

    def _place_table(self, t: Tensor) -> Tensor:
        return self._precision.to_storage(t.detach().to(self.device))

    def _coord_dtype(self, st) -> torch.dtype:
        if isinstance(st, _FixedCoord):
            return torch.promote_types(self._precision.to_accum(st.means).dtype, st.values_dtype)
        return torch.promote_types(self._precision.to_accum(st.coeffs).dtype, torch.float32)

    @property
    def fingerprint(self) -> str:
        """Content fingerprint of the served model (``model_fingerprint``)."""
        if self._fingerprint is None:
            self._fingerprint = model_fingerprint(self.model)
        return self._fingerprint

    def graph_bytes(self) -> dict:
        """Device bytes each captured bucket holds: its static buffers, its
        outputs and the growth of the shared pool at its capture."""
        with self._lock:
            return {k: b.held_bytes for k, b in self._buckets.items() if b.graph is not None}

    def bucket(self, n: int) -> int:
        """Padded batch size for a request of ``n`` samples: next power of
        two >= min_batch_pad."""
        p = self.min_batch_pad
        while p < n:
            p *= 2
        return p

    # -- request prep (host) ----------------------------------------------

    def _prepare(self, data: GameInput):
        n = data.n
        n_pad = self.bucket(n)
        offsets = np.asarray(data.offsets)
        off = np.zeros(n_pad, dtype=offsets.dtype)
        off[:n] = offsets
        # coordinate ids are user config strings: namespace them so a
        # coordinate named "offsets" cannot collide with the offsets entry
        batch = {"offsets": off}
        for st in self._coords:
            if isinstance(st, _FixedCoord):
                batch["coord:" + st.cid] = self._prepare_fixed(st, data, n, n_pad)
            else:
                batch["coord:" + st.cid] = self._prepare_random(st, data, n, n_pad)
        return batch, n

    @staticmethod
    def _per_sample_view(X: sp.csr_matrix, n: int, n_pad: int, vals_dtype=np.float32):
        """[n_pad, W] (global cols, vals) from a CSR matrix, entries in CSR
        order with W = the request's max row nnz padded to its width bucket.
        Padding entries carry col -1 / val 0 and add exact zeros. Values are
        stored as ``vals_dtype``: float32 as the eager path stores sparse
        values, or a dense fixed effect's own dtype on its wide route."""
        counts = np.diff(X.indptr)
        W = width_bucket(int(counts.max()) if n else 1)
        cols = np.full((n_pad, W), -1, dtype=np.int32)
        vals = np.zeros((n_pad, W), dtype=vals_dtype)
        rows_per_nnz = slot_per_nnz = None
        if n and X.nnz:
            rows_per_nnz = np.repeat(np.arange(n), counts)
            slot_per_nnz = np.arange(X.nnz) - np.repeat(X.indptr[:-1], counts)
            cols[rows_per_nnz, slot_per_nnz] = X.indices
            vals[rows_per_nnz, slot_per_nnz] = X.data
        return cols, vals, rows_per_nnz, slot_per_nnz

    def _prepare_fixed(self, st: _FixedCoord, data: GameInput, n: int, n_pad: int):
        X = data.shard(st.feature_shard_id)
        if not sp.issparse(X):
            values_dtype = torch_to_numpy_dtype(st.values_dtype)
            arr = np.asarray(X)
            if arr.shape[1] < FE_SPARSE_MIN_COLS:
                padded = np.zeros((n_pad, arr.shape[1]), dtype=values_dtype)
                padded[:n] = arr
                return {"values": padded}
            # wide-K routing: never a [B, K] buffer for a wide fixed effect;
            # the per-sample branch of a sparse-container request, with the
            # values kept at the model's dtype (dropping the zeros changes
            # the sum's pairing: equal to eager within rounding, not bitwise)
            cols, vals, _, _ = self._per_sample_view(sp.csr_matrix(arr.astype(values_dtype)),
                                                     n, n_pad, values_dtype)
            return {"cols": cols, "vals": vals}
        cols, vals, _, _ = self._per_sample_view(X.tocsr(), n, n_pad)
        return {"cols": cols, "vals": vals}

    def _prepare_random(self, st: _RandomCoord, data: GameInput, n: int, n_pad: int):
        X = as_csr(data.shard(st.feature_shard_id))
        ent_rows = st.entity_rows(data.ids(st.re_type))
        rows = np.full(n_pad, -1, dtype=np.int32)
        rows[:n] = ent_rows
        cols, vals, rows_per_nnz, slot_per_nnz = self._per_sample_view(X, n, n_pad)
        if rows_per_nnz is not None:
            cols[rows_per_nnz, slot_per_nnz] = st.local_slots(ent_rows[rows_per_nnz], X.indices)
        return {"rows": rows, "cols": cols, "vals": vals}

    # -- the fused body ----------------------------------------------------

    def _fused(self, batch: dict, per_coordinate: bool, include_offsets: bool,
               apply_link: bool):
        # reduced-precision tables upcast to the accumulation dtype here;
        # under the reference policy `to_accum` is an identity
        acc = self._precision.to_accum
        scores = []
        for st in self._coords:
            b = batch["coord:" + st.cid]
            if isinstance(st, _FixedCoord):
                if "values" in b:
                    s = fixed_effect_view_score(b["values"], acc(st.means))
                else:
                    cols = b["cols"]
                    g = acc(st.means)[torch.clamp_min(cols, 0).long()]
                    g = torch.where(cols >= 0, g, torch.zeros((), dtype=g.dtype, device=g.device))
                    s = row_sum(g * b["vals"])
            else:
                s = random_effect_view_score(acc(st.coeffs), b["rows"], b["cols"], b["vals"])
            scores.append(s)
        if per_coordinate:
            # a tuple, not a stack: each coordinate keeps its own dtype
            return tuple(scores)
        # left-to-right in coordinate order: the association of the eager
        # path's sum over coordinates
        total = functools.reduce(lambda a, c: a + c, scores)
        if include_offsets:
            total = total + batch["offsets"]
        if apply_link:
            total = mean_function_for_task(self.model.task)(total)
        return (total,)

    # -- dispatch: one graph per bucket -----------------------------------

    @staticmethod
    def _batch_signature(batch) -> tuple:
        """Entry names, shapes and dtypes of a prepared batch (the statics
        join in ``_run``'s key)."""
        parts = []
        for name in sorted(batch):
            v = batch[name]
            if isinstance(v, dict):
                parts.append((name,) + tuple((k, v[k].shape, str(v[k].dtype)) for k in sorted(v)))
            else:
                parts.append((name, v.shape, str(v.dtype)))
        return tuple(parts)

    def _to_device(self, batch: dict) -> dict:
        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        return {k: ({kk: put(vv) for kk, vv in v.items()} if isinstance(v, dict) else put(v))
                for k, v in batch.items()}

    def _run(self, batch: dict, **statics) -> list:
        """The outputs of the fused body for a prepared batch, on the host."""
        key = (tuple(sorted(statics.items())), self._batch_signature(batch))
        with self._lock:
            entry = self._buckets.get(key)
            if entry is None:
                entry = self._buckets[key] = _Graph(lock=threading.Lock())
                self.bucket_count += 1
        if not self._use_graphs:
            with entry.lock:  # first hits on one bucket serialize, as on CUDA
                out = self._fused(self._to_device(batch), **statics)
            return [o.numpy() for o in out]
        with entry.lock, torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            if entry.graph is None:
                self._capture(entry, batch, statics)
            for name, v in batch.items():
                if isinstance(v, dict):
                    for k, a in v.items():
                        entry.inputs[name][k].copy_(torch.from_numpy(np.ascontiguousarray(a)))
                else:
                    entry.inputs[name].copy_(torch.from_numpy(np.ascontiguousarray(v)))
            entry.graph.replay()
            # one device-to-host copy per output; .cpu() waits for the stream
            return [o.cpu().numpy() for o in entry.outputs]

    def _capture(self, entry: _Graph, batch: dict, statics: dict) -> None:
        """Capture the fused body for this bucket into one CUDA graph on the
        engine's pool: static buffers, warm-up on a side stream (as PyTorch
        requires before a capture), then the capture. Raises on failure."""
        with _CAPTURE_LOCK:
            torch.cuda.synchronize(self.device)
            before = torch.cuda.memory_reserved(self.device)
            allocated = torch.cuda.memory_allocated(self.device)
            inputs = self._to_device(batch)
            warm = torch.cuda.Stream(self.device)
            warm.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(warm):
                for _ in range(2):
                    self._fused(inputs, **statics)
            torch.cuda.current_stream(self.device).wait_stream(warm)
            graph = torch.cuda.CUDAGraph()
            # capture on the graph's own side stream: other threads keep
            # replaying other buckets on the engine's stream meanwhile
            with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
                outputs = self._fused(inputs, **statics)
            torch.cuda.synchronize(self.device)
            grown = torch.cuda.memory_reserved(self.device) - before
            live = torch.cuda.memory_allocated(self.device) - allocated
            entry.inputs, entry.outputs, entry.graph = inputs, outputs, graph
            entry.held_bytes = max(grown, live)
            with self._lock:
                self.capture_count += 1

    # -- public scoring API ------------------------------------------------

    def score(self, data: GameInput, include_offsets: bool = True) -> np.ndarray:
        """Total [N] score in one graph replay + one host transfer.

        The offset add fuses on the device unless the offsets' dtype would
        change the result's (``precision.offsets_fuse_on_device``): the eager
        path adds offsets on the host in numpy, and the engine then does the
        same, so values and dtype match."""
        if not self._coords:
            # zero-coordinate model: the eager path's exact numpy ops
            total = np.zeros(data.n)
            if include_offsets:
                total = total + np.asarray(data.offsets)
            return total
        offsets = np.asarray(data.offsets)
        fuse_offsets = include_offsets and offsets_fuse_on_device(offsets, self._score_dtype)
        batch, n = self._prepare(data)
        res = self._run(batch, per_coordinate=False, include_offsets=fuse_offsets,
                        apply_link=False)[0][:n]
        if include_offsets and not fuse_offsets:
            res = res + offsets
        return res

    def predict(self, data: GameInput) -> np.ndarray:
        """Mean response: link-inverse of (score + offsets), on the device
        (sigmoid / exp / identity per the model task). When the offsets stay
        on the host (``score``'s rule), the add AND the link run on the host
        at full precision (``precision.host_link``, within
        ``HOST_LINK_EXP_ULPS`` of any other exp)."""
        if self._coords and offsets_fuse_on_device(data.offsets, self._score_dtype):
            batch, n = self._prepare(data)
            return self._run(batch, per_coordinate=False, include_offsets=True,
                             apply_link=True)[0][:n]
        margins = self.score(data, include_offsets=True)
        return host_link(self.model.task, margins)

    def score_per_coordinate(self, data: GameInput) -> dict[str, np.ndarray]:
        """Per-coordinate [N] scores from one replay, each coordinate in its
        own dtype."""
        if not self._coords:
            return {}
        batch, n = self._prepare(data)
        parts = self._run(batch, per_coordinate=True, include_offsets=False, apply_link=False)
        return {st.cid: parts[i][:n] for i, st in enumerate(self._coords)}


# --------------------------------------------------------------------------
# engine cache
# --------------------------------------------------------------------------

_engines: "OrderedDict[tuple, GameServingEngine]" = OrderedDict()
_engines_lock = threading.Lock()
MAX_CACHED_ENGINES = 8


def get_engine(model: GameModel, device="cuda", min_batch_pad: int = MIN_BATCH_PAD,
               precision: Optional[object] = None) -> GameServingEngine:
    """Content-keyed engine lookup: the same model content (same coefficient
    bytes) on the same device and policy maps to the same engine and its
    graphs across GameTransformer instances. LRU-bounded, so a long-running
    process cycling many models does not pin every table on the device."""
    dev = resolve_device(device)
    policy = resolve_precision(precision)
    key = (model_fingerprint(model), str(dev), int(min_batch_pad), policy.name)
    with _engines_lock:
        eng = _engines.get(key)
        if eng is not None:
            _engines.move_to_end(key)
            return eng
    eng = GameServingEngine(model, device=dev, min_batch_pad=min_batch_pad,
                            fingerprint=key[0], precision=policy)
    with _engines_lock:
        existing = _engines.get(key)
        if existing is not None:  # lost a race: keep the first one
            _engines.move_to_end(key)
            return existing
        _engines[key] = eng
        while len(_engines) > MAX_CACHED_ENGINES:
            _engines.popitem(last=False)
    return eng


def evict_engine(fingerprint: str) -> int:
    """Drop every cached engine serving the given model fingerprint (all
    devices and configurations). Only the cache's dict ENTRY goes: an engine
    a request already holds keeps working and is freed afterwards. Returns
    the number of entries dropped."""
    with _engines_lock:
        victims = [k for k in _engines if k[0] == fingerprint]
        for k in victims:
            del _engines[k]
    return len(victims)


def clear_engine_cache() -> None:
    """Drop cached engines (same swap-the-entry discipline as ``evict_engine``)."""
    with _engines_lock:
        _engines.clear()
