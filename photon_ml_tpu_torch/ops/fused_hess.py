"""The full Gauss-Newton Hessian in one pass over the design matrix (kernel B3).

Port of photon_ml_tpu/ops/pallas_glm.py::fused_hessian_matrix, the NEWTON
solver's per-iteration op. The stock objective materializes the normalized
design ``A = (X - shift) * factor`` in device memory and runs one GEMM;
the kernel builds the normalized rows on chip and returns

    H = sum_live A_i^T (A_i * d_i),   d_i = w_i * dzz(z_i, y_i)

with ``z = X @ eff_coef + offsets + margin_shift``, in f32 for f32 and bf16
storage alike. The caller adds the L2 diagonal. The CUDA source is
ops/csrc/fused_hess.cu.

Routing follows the tensor, as for B1 and B2 (ops/fused_glm.py): a CUDA
tensor launches the kernel or raises, a CPU tensor runs
:func:`fused_hessian_matrix_plain`. The gate is B1's switch plus
``MAX_HESS_DIM``, the JAX package's cap, kept so that the same problems
take the same route in both packages.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from photon_ml_tpu_torch.function.losses import PointwiseLoss
from photon_ml_tpu_torch.ops import fused_glm
from photon_ml_tpu_torch.ops.fused_glm import _live_margins, check_design, check_operand

Tensor = torch.Tensor

MAX_HESS_DIM = 512
ROW_MAX_DIM = 128  # up to this D, one launch stages whole rows (ROW_MAX in the source)
ROW_TILE_BYTES = 8 * 1024  # bytes of one staged row tile there
MAX_ROW_TILE = 64
TILE = 128  # output tile edge above ROW_MAX_DIM (TB in the source)
TILE_STEP_ROWS = 32  # rows a tile CTA stages per step (KT in the source)
PARTIAL_BYTES = 16 * 1024 * 1024  # cap on the tile path's [chunks, tiles, 128, 128] partials


class HessPlan(NamedTuple):
    """How one call cuts the work. Whole rows (D <= ROW_MAX_DIM): ``ctas``
    CTAs of ``rows_per_cta`` consecutive rows each, partials summed in groups
    of ``group`` CTAs. Tiles: ``tiles`` upper output tiles times ``ctas`` row
    chunks of ``rows_per_cta`` rows, after a row-weight launch of
    ``weight_ctas`` CTAs."""

    whole_rows: bool
    tile_rows: int  # rows staged per step
    ctas: int
    rows_per_cta: int
    group: int
    tiles: int
    weight_ctas: int
    partial_floats: int


def row_tile(d: int) -> int:
    """Rows of one staged tile of the whole-row kernel: a multiple of 8
    (the tensor cores' depth), at most 64, about 8 KB of f32 (its split
    arrays hold f32 whatever the storage)."""
    return max(8, min(MAX_ROW_TILE, ROW_TILE_BYTES // (d * 4)) // 8 * 8)


def row_threads(d: int, elem: int, vec: int, kr: int) -> int:
    """Lanes a row of the whole-row kernel, a power of two, at most 32:
    enough for 8 values a lane (PER in the source), and more while the
    tile's kr rows would leave some of the 256 threads idle."""
    units, per_lane = (d // (16 // elem), 8 // (16 // elem) or 1) if vec else (d, 8)
    tpr = 1
    while tpr * per_lane < units or 2 * tpr * kr <= 256:
        tpr *= 2
    return min(32, tpr)


def plan(n: int, d: int, elem: int, sms: int, ctas_per_sm: int = 1) -> HessPlan:
    """The cut of an [n, d] problem of ``elem``-byte entries on a card with
    ``sms`` SMs, where ``ctas_per_sm`` whole-row CTAs fit on one SM. An
    empty problem gets one empty range, whose partials are zeros."""
    if d <= ROW_MAX_DIM:
        part = fused_glm.partition_rows(n, ctas_per_sm * sms)
        width = d * (d + 1) // 2
        return HessPlan(True, row_tile(d), part.ctas, part.rows_per_cta, part.group, 1, 0,
                        (part.ctas + part.groups) * width)
    side = -(-d // TILE)
    tiles = side * (side + 1) // 2
    chunks = max(1, min(sms // tiles, -(-n // TILE_STEP_ROWS),
                        PARTIAL_BYTES // (4 * tiles * TILE * TILE)))
    rows = max(1, -(-n // chunks))
    chunks = max(1, -(-n // rows))
    return HessPlan(False, TILE_STEP_ROWS, chunks, rows, 1, tiles, max(1, min(-(-n // 8), 8 * sms)),
                    chunks * tiles * TILE * TILE)


def _hess_rows(X, labels, offsets, weights, eff_coef, margin_shift, shifts, factors, loss):
    """(d, A): the row weights d = w*dzz(z) (0 on dead rows) and the
    normalized f32 rows, widened first, then shifted and scaled, then
    zeroed on dead rows (a shifted zero row is not zero; inf * 0 is NaN)."""
    f32 = torch.float32
    live, w, _, z = _live_margins(X, offsets, weights, eff_coef, margin_shift)
    zero = torch.zeros((), dtype=f32, device=X.device)
    d = torch.where(live, w * loss.dzz(z, labels.to(f32)), zero)
    A = (X.to(f32) - shifts.to(f32)) * factors.to(f32)
    return d, torch.where(live[:, None], A, zero)


def fused_hessian_matrix_plain(
    X: Tensor,
    labels: Tensor,
    offsets: Tensor,
    weights: Tensor,
    eff_coef: Tensor,
    margin_shift: Tensor,
    shifts: Tensor,
    factors: Tensor,
    *,
    loss: PointwiseLoss,
) -> Tensor:
    """Plain PyTorch version of B3: same inputs, same masking and widening,
    f32 result [D, D]. Runs on any device."""
    fused_hessian_matrix_plain.calls += 1
    d, A = _hess_rows(X, labels, offsets, weights, eff_coef, margin_shift, shifts, factors, loss)
    return A.T @ (A * d[:, None])


fused_hessian_matrix_plain.calls = 0


def fused_hessian_matrix_scales(
    X: Tensor,
    labels: Tensor,
    offsets: Tensor,
    weights: Tensor,
    eff_coef: Tensor,
    margin_shift: Tensor,
    shifts: Tensor,
    factors: Tensor,
    *,
    loss: PointwiseLoss,
) -> Tensor:
    """``|A|^T (|A| * |d|)``: the sum of absolute terms behind each entry of
    B3's output, the scale two versions of the kernel are held to."""
    d, A = _hess_rows(X, labels, offsets, weights, eff_coef, margin_shift, shifts, factors, loss)
    return A.abs().T @ (A.abs() * d.abs()[:, None])


def _lib():
    from photon_ml_tpu_torch.ops import build

    lib = build.load("fused_hess")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fused_hess_plan.argtypes = [i, i, i, i, i, ctypes.POINTER(i)]
        lib.fused_hess_plan.restype = i
        lib.fused_hess_launch.argtypes = [i, i, i, i, p, p, p, p, p, p, p, p, ll, i, i, i, ll, i,
                                          i, i, i, p, p, p, p, p]
        lib.fused_hess_launch.restype = i
        lib._typed = True
    return lib


_occupancy: dict[tuple, int] = {}


def _ctas_per_sm(dtype_id: int, vec: int, loss_id: int, d: int, kr: int, device) -> int:
    """Resident whole-row CTAs per SM for one instantiation (cached)."""
    key = (dtype_id, vec, loss_id, d, kr, device.index)
    if key not in _occupancy:
        per_sm = ctypes.c_int(0)
        err = _lib().fused_hess_plan(dtype_id, vec, loss_id, d, kr, ctypes.byref(per_sm))
        if err != 0 or per_sm.value < 1:
            raise RuntimeError(f"fused_hess_plan failed (cuda error {err}, {per_sm.value} CTAs/SM)")
        _occupancy[key] = per_sm.value
    return _occupancy[key]


def fused_hessian_matrix(
    X: Tensor,
    labels: Tensor,
    offsets: Tensor,
    weights: Tensor,
    eff_coef: Tensor,
    margin_shift: Tensor,
    shifts: Tensor,
    factors: Tensor,
    *,
    loss: PointwiseLoss,
) -> Tensor:
    """H [D, D] f32 without the L2 term, one pass over X, symmetric bitwise.

    X [N, D] f32 or bf16 with D <= MAX_HESS_DIM; labels, offsets, weights
    [N]; eff_coef, shifts, factors [D]; margin_shift a scalar tensor. CUDA
    tensors launch kernel B3, CPU tensors run the plain version; there is no
    fallback between the two.
    """
    if X.device.type == "cpu":
        return fused_hessian_matrix_plain(
            X, labels, offsets, weights, eff_coef, margin_shift, shifts, factors, loss=loss
        )
    n, d = check_design(X, MAX_HESS_DIM, "fused_hessian_matrix")
    f32 = torch.float32
    dev = X.device
    y, off, w = labels.to(f32), offsets.to(f32), weights.to(f32)
    coef, sh, fc, ms = eff_coef.to(f32), shifts.to(f32), factors.to(f32), margin_shift.to(f32)
    for name, t in (("labels", y), ("offsets", off), ("weights", w)):
        check_operand(name, t, (n,), (f32,), dev)
    for name, t in (("eff_coef", coef), ("shifts", sh), ("factors", fc)):
        check_operand(name, t, (d,), (f32,), dev)
    check_operand("margin_shift", ms, (), (f32,), dev)
    dtype_id, elem = (0, 4) if X.dtype == f32 else (1, 2)
    vec = int(d * elem % 16 == 0 and X.data_ptr() % 16 == 0)
    with torch.cuda.device(dev):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        kr = row_tile(d)
        per_sm = _ctas_per_sm(dtype_id, vec, loss.kernel_id, d, kr, dev) if d <= ROW_MAX_DIM else 1
        p = plan(n, d, elem, sms, per_sm)
        dvec_n = 0 if p.whole_rows else n
        scratch = torch.empty(p.partial_floats + dvec_n, dtype=f32, device=dev)
        H = torch.empty((d, d), dtype=f32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().fused_hess_launch(
            0 if p.whole_rows else 1, dtype_id, vec, loss.kernel_id, X.data_ptr(), y.data_ptr(),
            off.data_ptr(), w.data_ptr(), coef.data_ptr(), ms.data_ptr(), sh.data_ptr(),
            fc.data_ptr(), n, d, p.tile_rows, row_threads(d, elem, vec, kr), p.rows_per_cta,
            p.ctas, p.group, p.tiles, p.weight_ctas, scratch[p.partial_floats:].data_ptr(),
            scratch.data_ptr(), fused_glm.ticket_counters(dev, stream).data_ptr(), H.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_hessian_matrix kernel launch failed with cuda error {err}")
    fused_hessian_matrix.launches += 1
    return H


fused_hessian_matrix.launches = 0
