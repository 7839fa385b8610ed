"""Kernel B1: the port's fused loss+gradient sums against the JAX Pallas kernel.

On the CPU the port's wrapper runs the kernel's plain PyTorch version; the
JAX kernel runs in interpret mode. Same numpy inputs into both.

Tolerances: f32 rtol 1e-5, for the different summation order; bf16 rtol
2e-3 on the same bf16-rounded inputs (a margin that differs in its last f32
bit can round w*dz to the neighbouring bf16 value). Vectors are compared
entry by entry with an absolute floor of rtol times their largest entry.
The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda_kernels.py.
"""

import contextlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.function import losses as jl
from photon_ml_tpu.ops import pallas_glm
from photon_ml_tpu_torch.data.dataset import LabeledData
from photon_ml_tpu_torch.data.matrix import DenseDesignMatrix
from photon_ml_tpu_torch.function import losses as tl
from photon_ml_tpu_torch.function.objective import GLMObjective
from photon_ml_tpu_torch.ops import fused_glm

LOSSES = [
    (jl.logistic_loss, tl.logistic_loss),
    (jl.squared_loss, tl.squared_loss),
    (jl.poisson_loss, tl.poisson_loss),
    (jl.smoothed_hinge_loss, tl.smoothed_hinge_loss),
]


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


def _problem(rng, n, d):
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.uniform(size=n) > 0.5).astype(np.float32)
    off = (rng.normal(size=n) * 0.1).astype(np.float32)
    w = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    dead = rng.choice(n, size=max(1, n // 20), replace=False)
    w[dead] = 0.0
    X[dead[::2]] = np.inf  # inert: weight-0 rows are never multiplied
    coef = (rng.normal(size=d) * 0.5 / np.sqrt(d)).astype(np.float32)
    return X, y, off, w, coef


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.max(np.abs(want)))


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("d", [5, 33])
@pytest.mark.parametrize("pair", LOSSES, ids=lambda p: p[0].name)
def test_plain_matches_jax_kernel(pair, d, storage, rng):
    jloss, tloss = pair
    X, y, off, w, coef = _problem(rng, 700, d)  # 700 rows: ragged against the 512 block
    shift = np.float32(0.3)
    jX = jnp.asarray(X)
    tX = torch.from_numpy(X)
    if storage == "bf16":
        jX, tX = jX.astype(jnp.bfloat16), tX.to(torch.bfloat16)
        np.testing.assert_array_equal(np.asarray(jX.astype(jnp.float32)), tX.float().numpy())
    want = pallas_glm.fused_loss_grad_sums(
        jX, jnp.asarray(y), jnp.asarray(off), jnp.asarray(w), jnp.asarray(coef),
        jnp.asarray(shift), loss_and_dz=jloss.loss_and_dz, interpret=True,
    )
    got = fused_glm.fused_loss_grad_sums(
        tX, torch.from_numpy(y), torch.from_numpy(off), torch.from_numpy(w),
        torch.from_numpy(coef), torch.tensor(shift), loss=tloss,
    )
    rtol = 1e-5 if storage == "f32" else 2e-3
    for g, j in zip(got, want):
        assert g.dtype == torch.float32
        assert torch.isfinite(g).all()
        _close(g.numpy(), j, rtol)


def test_cpu_tensor_takes_plain_version(rng):
    X, y, off, w, coef = _problem(rng, 64, 8)
    calls = fused_glm.fused_loss_grad_sums_plain.calls
    launches = fused_glm.fused_loss_grad_sums.launches
    fused_glm.fused_loss_grad_sums(*(torch.from_numpy(a) for a in (X, y, off, w, coef)),
                                   torch.tensor(0.0), loss=tl.logistic_loss)
    assert fused_glm.fused_loss_grad_sums_plain.calls == calls + 1
    assert fused_glm.fused_loss_grad_sums.launches == launches


def test_switch_and_gate(monkeypatch):
    """should_fuse and the objective's gate close as the JAX gate does."""
    monkeypatch.delenv("PHOTON_PALLAS", raising=False)
    X = torch.zeros((4, 3), dtype=torch.float32)
    data = LabeledData(X=DenseDesignMatrix(X), labels=torch.zeros(4), offsets=torch.zeros(4),
                       weights=torch.ones(4))
    obj = GLMObjective(tl.logistic_loss)
    assert fused_glm.enabled_override() is None
    assert not fused_glm.should_fuse(3)  # off by default
    monkeypatch.setenv("PHOTON_PALLAS", "1")
    assert fused_glm.should_fuse(3)
    monkeypatch.setenv("PHOTON_PALLAS", "0")
    assert not fused_glm.should_fuse(3)
    with fused_glm.fused_override(True):
        assert fused_glm.should_fuse(fused_glm.MAX_FUSED_DIM)
        assert not fused_glm.should_fuse(fused_glm.MAX_FUSED_DIM + 1)
        assert fused_glm.MAX_FUSED_DIM == pallas_glm.MAX_FUSED_DIM
        assert obj._fused_eligible(data.X, torch.zeros(3, dtype=torch.float32))
        assert not obj._fused_eligible(data.X, torch.zeros(3, dtype=torch.float64))
        assert not GLMObjective(tl.logistic_loss, allow_fused=False)._fused_eligible(
            data.X, torch.zeros(3, dtype=torch.float32))
        f64 = DenseDesignMatrix(X.double())
        assert not obj._fused_eligible(f64, torch.zeros(3, dtype=torch.float32))
        with fused_glm.fused_override(False):
            assert not obj._fused_eligible(data.X, torch.zeros(3, dtype=torch.float32))
        assert fused_glm.enabled_override() is True
    assert fused_glm.enabled_override() is None



@pytest.mark.parametrize("d", [1, 63, 64, 65, 257, 512, 4096])
@pytest.mark.parametrize("rows", ["0", "1", "tile-1", "tile+1", "100000"])
def test_row_partition_covers_every_row(rows, d):
    """B1/B2's persistent grid on a 132-SM card, f32 and bf16: at most
    MAX_CTAS_PER_SM CTAs per SM, each owning a non-empty range of rows (one
    empty range when N = 0), the ranges in order and every row in exactly
    one; groups of the in-launch sum that cover the CTAs, with their
    counters within TICKETS; tiles of at most MAX_TILE_ROWS rows and
    TILE_BYTES bytes."""
    for elem in (4, 2):
        bn = fused_glm.tile_rows(d, elem)
        assert 1 <= bn <= fused_glm.MAX_TILE_ROWS
        assert bn == 1 or bn * d * elem <= fused_glm.TILE_BYTES
        n = {"0": 0, "1": 1, "tile-1": bn - 1, "tile+1": bn + 1, "100000": 100_000}[rows]
        part = fused_glm.partition_rows(n, fused_glm.MAX_CTAS_PER_SM * 132)
        assert 1 <= part.ctas <= fused_glm.MAX_CTAS_PER_SM * 132
        begins = [b * part.rows_per_cta for b in range(part.ctas)]
        ends = [min(n, b + part.rows_per_cta) for b in begins]
        assert begins[0] == 0 and ends[-1] == n
        assert all(e == b for e, b in zip(ends, begins[1:]))
        assert all(e > b for b, e in zip(begins, ends)) or (n == 0 and part.ctas == 1)
        assert part.groups * part.group >= part.ctas > (part.groups - 1) * part.group
        assert part.groups + 1 <= fused_glm.TICKETS
