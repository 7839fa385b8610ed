"""The GLM objective's row-streaming kernels, one pass over the design matrix.

Kernel B1, port of photon_ml_tpu/ops/pallas_glm.py::fused_loss_grad_sums.
The stock objective reads X twice per evaluation (``z = X @ w`` then
``g = X^T d``); B1 reads it once and returns the raw sums

    (sum_live w*l(z, y),  X^T (w*dz) over live rows,  sum_live w*dz)

with ``z = X @ eff_coef + offsets + margin_shift``.

Kernel B2, port of ``fused_hessian_vector_sums``: the Gauss-Newton
Hessian-vector product, which the stock path computes in three passes over
X (``z``, ``dv = X @ eff_v``, ``X^T u``), in one:

    (X^T u,  sum_live u),  u = w * dzz(z, y) * (X @ eff_v + shift_v)

The caller applies the normalization algebra and the L2 term, exactly as
for the stock path. Both kernels live in ops/csrc/fused_glm.cu.

Routing follows the tensor: on a CUDA tensor a wrapper launches its
hand-written kernel or raises; on a CPU tensor it runs its ``*_plain``
version, the same function in plain PyTorch with the same masking and bf16
rounding (the counterpart of the TPU kernels' interpret mode).

The switch is the JAX package's: off by default, on with
``enable_fused(True)`` or ``PHOTON_PALLAS=1``, and :func:`should_fuse`
closes the route above ``MAX_FUSED_DIM`` columns.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import os
from typing import NamedTuple

import torch

from photon_ml_tpu_torch.function.losses import PointwiseLoss

Tensor = torch.Tensor

# A row of X spreads over at most 256 threads, 16 values each.
MAX_FUSED_DIM = 4096
# Bytes of one staged [BN, D] tile of X (the kernel keeps a ring of four).
TILE_BYTES = 16 * 1024
MAX_TILE_ROWS = 64
MAX_CTAS_PER_SM = 4  # the persistent grid: at most this many CTAs on each SM
TICKETS = 64  # integer counters of the in-launch cross-CTA sum, per stream

_enabled: bool | None = None


def enable_fused(on: bool | None) -> None:
    """Process-wide switch for the fused kernels (overrides PHOTON_PALLAS;
    ``None`` reverts to the environment variable). Counterpart of
    ``pallas_glm.enable_pallas``; the decision is taken at every call, so
    there is no solver cache to drop."""
    global _enabled
    _enabled = None if on is None else bool(on)


def fused_enabled() -> bool:
    if _enabled is not None:
        return _enabled
    return os.environ.get("PHOTON_PALLAS", "") not in ("", "0")


def enabled_override() -> bool | None:
    """The current override (None = deferring to PHOTON_PALLAS)."""
    return _enabled


@contextlib.contextmanager
def fused_override(on: bool | None):
    """Scoped :func:`enable_fused`: restores the previous override on exit."""
    prev = _enabled
    enable_fused(on)
    try:
        yield
    finally:
        enable_fused(prev)


def should_fuse(n_cols: int) -> bool:
    """True when the fused kernels replace the stock paths: the switch is on
    and the coefficient vector fits B1 and B2 (B3 also needs
    ``fused_hess.MAX_HESS_DIM``). The port runs
    on one device, so the JAX gate's single-device condition always holds;
    a CPU tensor takes the plain version, as interpret mode does on JAX."""
    return fused_enabled() and n_cols <= MAX_FUSED_DIM


def _mxu_round(x: Tensor, v: Tensor) -> Tensor:
    """bf16 storage feeds bf16 operands with f32 accumulation (_mxu_dtype)."""
    if x.dtype == torch.bfloat16:
        return v.to(torch.bfloat16).to(torch.float32)
    return v


def _live_margins(X, offsets, weights, eff_coef, margin_shift):
    """(live, w, x, z): the live-row mask, the f32 weights, X in f32 with
    dead rows zeroed (excluded, never multiplied, so an inf there stays
    inert) and the f32 margins, rounded as the kernels round them."""
    f32 = torch.float32
    w = weights.to(f32)
    live = w != 0.0
    x = torch.where(live[:, None], X, torch.zeros((), dtype=X.dtype, device=X.device)).to(f32)
    z = x @ _mxu_round(X, eff_coef.to(f32)) + (offsets + margin_shift).to(f32)
    return live, w, x, z


def _grad_weights(X, labels, offsets, weights, eff_coef, margin_shift, loss):
    """(w*l, w*dz, x): B1's per-row terms (0 on dead rows) and the masked rows."""
    live, w, x, z = _live_margins(X, offsets, weights, eff_coef, margin_shift)
    l, dz = loss.loss_and_dz(z, labels.to(torch.float32))
    zero = torch.zeros((), dtype=torch.float32, device=X.device)
    return torch.where(live, w * l, zero), torch.where(live, w * dz, zero), x


def fused_loss_grad_sums_plain(
    X: Tensor,
    labels: Tensor,
    offsets: Tensor,
    weights: Tensor,
    eff_coef: Tensor,
    margin_shift: Tensor,
    *,
    loss: PointwiseLoss,
) -> tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version of B1: same inputs, same masking, same bf16
    rounding, f32 results. Runs on any device."""
    fused_loss_grad_sums_plain.calls += 1
    wl, wdz, x = _grad_weights(X, labels, offsets, weights, eff_coef, margin_shift, loss)
    return wl.sum(), _mxu_round(X, wdz) @ x, wdz.sum()


fused_loss_grad_sums_plain.calls = 0


def fused_loss_grad_sums_scales(
    X: Tensor,
    labels: Tensor,
    offsets: Tensor,
    weights: Tensor,
    eff_coef: Tensor,
    margin_shift: Tensor,
    *,
    loss: PointwiseLoss,
) -> tuple[Tensor, Tensor, Tensor]:
    """The sums of absolute terms behind each output of B1,
    ``(sum |w*l|, |X|^T |w*dz|, sum |w*dz|)`` over live rows: the scale of
    the rounding error of each sum, whatever order it is added in. Two
    versions of the kernel are held to each other relative to these."""
    wl, wdz, x = _grad_weights(X, labels, offsets, weights, eff_coef, margin_shift, loss)
    return wl.abs().sum(), _mxu_round(X, wdz).abs() @ x.abs(), wdz.abs().sum()


def _hvp_weights(X, labels, offsets, weights, eff_coef, margin_shift, eff_v, shift_v, loss):
    """(u, x): B2's per-row weight u = w*dzz(z)*dv (0 on dead rows) and the
    masked rows. margin_shift shifts z; shift_v shifts dv only."""
    live, w, x, z = _live_margins(X, offsets, weights, eff_coef, margin_shift)
    dv = x @ _mxu_round(X, eff_v.to(torch.float32)) + shift_v.to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=X.device)
    return torch.where(live, w * loss.dzz(z, labels.to(torch.float32)) * dv, zero), x


def fused_hessian_vector_sums_plain(
    X: Tensor,
    labels: Tensor,
    offsets: Tensor,
    weights: Tensor,
    eff_coef: Tensor,
    margin_shift: Tensor,
    eff_v: Tensor,
    shift_v: Tensor,
    *,
    loss: PointwiseLoss,
) -> tuple[Tensor, Tensor]:
    """Plain PyTorch version of B2: same inputs, same masking, same bf16
    rounding (v before its product, u before X^T u), f32 results."""
    fused_hessian_vector_sums_plain.calls += 1
    u, x = _hvp_weights(X, labels, offsets, weights, eff_coef, margin_shift, eff_v, shift_v, loss)
    return _mxu_round(X, u) @ x, u.sum()


fused_hessian_vector_sums_plain.calls = 0


def fused_hessian_vector_sums_scales(
    X: Tensor,
    labels: Tensor,
    offsets: Tensor,
    weights: Tensor,
    eff_coef: Tensor,
    margin_shift: Tensor,
    eff_v: Tensor,
    shift_v: Tensor,
    *,
    loss: PointwiseLoss,
) -> tuple[Tensor, Tensor]:
    """The sums of absolute terms behind each output of B2,
    ``(|X|^T |u|, sum |u|)`` over live rows (see
    :func:`fused_loss_grad_sums_scales`)."""
    u, x = _hvp_weights(X, labels, offsets, weights, eff_coef, margin_shift, eff_v, shift_v, loss)
    return _mxu_round(X, u).abs() @ x.abs(), u.abs().sum()


def _lib():
    from photon_ml_tpu_torch.ops import build

    lib = build.load("fused_glm")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fused_glm_plan.argtypes = [i, i, i, i, i, i, ctypes.POINTER(i)]
        lib.fused_glm_plan.restype = i
        lib.fused_glm_launch.argtypes = [i, i, i, i, p, p, p, p, p, p, p, p, ll, i, i, i, ll, i,
                                         i, p, p, p, p]
        lib.fused_glm_launch.restype = i
        lib._typed = True
    return lib


_B1, _B2 = 0, 1  # the kernel's mode argument
_plans: dict[tuple, tuple[int, int, int]] = {}
_tickets: dict[tuple[int, int], Tensor] = {}


class RowPartition(NamedTuple):
    """The persistent grid's cut of N rows: CTA b owns rows
    [b * rows_per_cta, min(N, (b + 1) * rows_per_cta)), and the in-launch
    sum adds the CTAs' partials in groups of ``group`` consecutive CTAs."""

    rows_per_cta: int
    ctas: int
    group: int

    @property
    def groups(self) -> int:
        return -(-self.ctas // self.group)


def partition_rows(n: int, max_ctas: int) -> RowPartition:
    """Cut N rows into at most ``max_ctas`` contiguous, non-empty ranges of
    nearly equal length (one empty range when N = 0), grouped by about the
    square root of their count so both levels of the sum stay short."""
    rows = max(1, -(-n // max_ctas))
    ctas = max(1, -(-n // rows))
    return RowPartition(rows, ctas, max(1, math.isqrt(ctas - 1) + 1))


def tile_rows(d: int, elem: int) -> int:
    """BN, the rows of one staged tile of a D-column X of ``elem``-byte entries."""
    return max(1, min(MAX_TILE_ROWS, TILE_BYTES // (d * elem)))


def threads_per_row(d: int, elem: int, vec: int) -> int:
    """Threads that share one row of X in a kernel: a power of two, at most
    256, each holding 16 of the row's values (``vec``: 16-byte words of the
    staged tile; else single elements)."""
    units = d // (16 // elem) if vec else d
    per_thread = elem if vec else 16  # words of 16 / elem values, or elements
    tpr = 1
    while tpr * per_thread < units:
        tpr *= 2
    return tpr


def _plan(mode: int, dtype_id: int, vec: int, loss_id: int, d: int, elem: int,
          device) -> tuple[int, int, int]:
    """(tile rows BN, threads per row, max persistent CTAs) for one instantiation."""
    key = (mode, dtype_id, vec, loss_id, d, device.index)
    plan = _plans.get(key)
    if plan is None:
        bn = tile_rows(d, elem)
        tpr = threads_per_row(d, elem, vec)
        per_sm = ctypes.c_int(0)
        err = _lib().fused_glm_plan(mode, dtype_id, vec, loss_id, d, bn, ctypes.byref(per_sm))
        if err != 0 or per_sm.value < 1:
            raise RuntimeError(f"fused_glm_plan failed (cuda error {err}, {per_sm.value} CTAs/SM)")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        plan = (bn, tpr, min(per_sm.value, MAX_CTAS_PER_SM) * sms)
        _plans[key] = plan
    return plan


def ticket_counters(device, stream: int) -> Tensor:
    """The int32 counters of the kernels' in-launch cross-CTA sums on
    ``stream``. Every launch leaves the counters it used at 0 again, so the
    launches of one stream, which run in order, share them; another stream
    gets its own. Zeroed once, at the stream's first launch."""
    key = (device.index, stream)
    t = _tickets.get(key)
    if t is None:
        t = torch.zeros(TICKETS, dtype=torch.int32, device=device)
        _tickets[key] = t
    return t


def check_operand(name: str, t: Tensor, shape: tuple, dtypes: tuple, device) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``shape`` and one of
    ``dtypes`` on ``device``: what a kernel takes, checked before a launch."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, X on {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes {dtypes}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_design(X: Tensor, max_dim: int, fn: str) -> tuple[int, int]:
    """(N, D) of a CUDA design matrix a kernel takes, or raise."""
    if X.device.type != "cuda":
        raise ValueError(f"{fn} runs on CUDA or CPU tensors, not {X.device}")
    if X.dim() != 2:
        raise ValueError(f"X must be [N, D], got shape {tuple(X.shape)}")
    n, d = X.shape
    if not 1 <= d <= max_dim:
        raise ValueError(f"the kernel takes 1 <= D <= {max_dim}, got D={d}")
    check_operand("X", X, (n, d), (torch.float32, torch.bfloat16), X.device)
    return n, d


def _launch(mode, X, y, off, w, coef, v, margin_shift, shift_v, loss, fn):
    """Check the operands, plan and launch mode ``mode`` of the row-streaming
    kernel; returns (val, grad [D], wsum) as views of one f32 buffer."""
    n, d = check_design(X, MAX_FUSED_DIM, fn)
    f32 = torch.float32
    dev = X.device
    for name, t in (("labels", y), ("offsets", off), ("weights", w)):
        check_operand(name, t, (n,), (f32,), dev)
    check_operand("eff_coef", coef, (d,), (f32,), dev)
    check_operand("margin_shift", margin_shift, (), (f32,), dev)
    if mode == _B2:
        check_operand("eff_v", v, (d,), (f32,), dev)
        check_operand("shift_v", shift_v, (), (f32,), dev)
    dtype_id, elem = (0, 4) if X.dtype == f32 else (1, 2)
    vec = int(d * elem % 16 == 0 and X.data_ptr() % 16 == 0)
    # the plan's attribute and occupancy query and the launch act on the
    # current device: make it X's
    with torch.cuda.device(dev):
        bn, tpr, max_ctas = _plan(mode, dtype_id, vec, loss.kernel_id, d, elem, dev)
        part = partition_rows(n, max_ctas)
        scratch = torch.empty((part.ctas + part.groups) * (d + 2), dtype=f32, device=dev)
        out = torch.empty(d + 2, dtype=f32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().fused_glm_launch(
            mode, dtype_id, vec, loss.kernel_id, X.data_ptr(), y.data_ptr(), off.data_ptr(),
            w.data_ptr(), coef.data_ptr(), v.data_ptr() if v is not None else None,
            margin_shift.data_ptr(), shift_v.data_ptr() if shift_v is not None else None,
            n, d, bn, tpr, part.rows_per_cta, part.ctas, part.group, scratch.data_ptr(),
            ticket_counters(dev, stream).data_ptr(), out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed with cuda error {err}")
    return out[d], out[:d], out[d + 1]


def fused_loss_grad_sums(
    X: Tensor,
    labels: Tensor,
    offsets: Tensor,
    weights: Tensor,
    eff_coef: Tensor,
    margin_shift: Tensor,
    *,
    loss: PointwiseLoss,
) -> tuple[Tensor, Tensor, Tensor]:
    """(loss_sum, gradient_vector_sum [D], weighted_dz_sum), f32, one X pass.

    X [N, D] f32 or bf16; labels, offsets, weights [N]; eff_coef [D];
    margin_shift a scalar tensor. CUDA tensors launch kernel B1, CPU
    tensors run the plain version; there is no fallback between the two.
    """
    if X.device.type == "cpu":
        return fused_loss_grad_sums_plain(
            X, labels, offsets, weights, eff_coef, margin_shift, loss=loss
        )
    f32 = torch.float32
    out = _launch(_B1, X, labels.to(f32), offsets.to(f32), weights.to(f32), eff_coef.to(f32),
                  None, margin_shift.to(f32), None, loss, "fused_loss_grad_sums")
    fused_loss_grad_sums.launches += 1
    return out


fused_loss_grad_sums.launches = 0


def fused_hessian_vector_sums(
    X: Tensor,
    labels: Tensor,
    offsets: Tensor,
    weights: Tensor,
    eff_coef: Tensor,
    margin_shift: Tensor,
    eff_v: Tensor,
    shift_v: Tensor,
    *,
    loss: PointwiseLoss,
) -> tuple[Tensor, Tensor]:
    """(X^T u [D], sum u), f32, one X pass: the Gauss-Newton HVP sums with
    u = w * dzz(z, y) * (X @ eff_v + shift_v) and
    z = X @ eff_coef + offsets + margin_shift.

    X [N, D] f32 or bf16; labels, offsets, weights [N]; eff_coef, eff_v [D];
    margin_shift and shift_v scalar tensors. CUDA tensors launch kernel B2,
    CPU tensors run the plain version; there is no fallback between the two.
    """
    if X.device.type == "cpu":
        return fused_hessian_vector_sums_plain(
            X, labels, offsets, weights, eff_coef, margin_shift, eff_v, shift_v, loss=loss
        )
    f32 = torch.float32
    _, vec, usum = _launch(_B2, X, labels.to(f32), offsets.to(f32), weights.to(f32),
                           eff_coef.to(f32), eff_v.to(f32), margin_shift.to(f32), shift_v.to(f32),
                           loss, "fused_hessian_vector_sums")
    fused_hessian_vector_sums.launches += 1
    return vec, usum


fused_hessian_vector_sums.launches = 0
