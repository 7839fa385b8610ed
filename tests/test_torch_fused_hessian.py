"""Kernels B2 and B3: the port's fused Hessian-vector sums and Hessian matrix
against the JAX Pallas kernels, and through GLMObjective.

On the CPU the port's wrappers run the kernels' plain PyTorch versions; the
JAX kernels run in interpret mode. Same numpy inputs into both, with dead
rows (weight 0) that hold inf, a ragged last block, and nonzero
``margin_shift`` and ``shift_v`` (B2) or shifts and factors (B3): the places
where a kernel can agree with its plain version and still differ from JAX.

Tolerances: f32 rtol 1e-5, for the summation order. B2 at bf16 storage
rtol 2e-3: u is rounded to bf16 before X^T u, and a u that differs in its
last f32 bit can round to the neighbouring bf16 value. B3 rounds nothing
after z (its math is f32 for both storages), so bf16 keeps rtol 1e-5.
Vectors and matrices are compared entry by entry with an absolute floor of
rtol times their largest entry. Through the objective at f64 (stock paths)
rtol 1e-12. The CUDA kernels themselves are held against the plain versions
on the card by tests/test_torch_cuda_kernels.py.
"""

import contextlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.data.dataset import LabeledData as JData
from photon_ml_tpu.data.matrix import DenseDesignMatrix as JDense
from photon_ml_tpu.function import losses as jl
from photon_ml_tpu.function.objective import GLMObjective as JObjective
from photon_ml_tpu.normalization import NormalizationContext as JNorm
from photon_ml_tpu.ops import pallas_glm
from photon_ml_tpu_torch.data.dataset import LabeledData as TData
from photon_ml_tpu_torch.data.matrix import DenseDesignMatrix as TDense
from photon_ml_tpu_torch.function import losses as tl
from photon_ml_tpu_torch.function.objective import GLMObjective as TObjective
from photon_ml_tpu_torch.normalization import NormalizationContext as TNorm
from photon_ml_tpu_torch.ops import fused_glm, fused_hess

LOSSES = [
    (jl.logistic_loss, tl.logistic_loss),
    (jl.squared_loss, tl.squared_loss),
    (jl.poisson_loss, tl.poisson_loss),
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


def _problem(rng, n, d, dead_every):
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.uniform(size=n) > 0.5).astype(np.float32)
    off = (rng.normal(size=n) * 0.1).astype(np.float32)
    w = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    w[::dead_every] = 0.0
    X[::dead_every] = np.inf  # inert: weight-0 rows are excluded, never multiplied
    coef = (rng.normal(size=d) * 0.5 / np.sqrt(d)).astype(np.float32)
    return X, y, off, w, coef


def _storage(X, storage):
    jX, tX = jnp.asarray(X), torch.from_numpy(X)
    if storage == "bf16":
        jX, tX = jX.astype(jnp.bfloat16), tX.to(torch.bfloat16)
        np.testing.assert_array_equal(np.asarray(jX.astype(jnp.float32)), tX.float().numpy())
    return jX, tX


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.max(np.abs(want)))


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("pair", LOSSES, ids=lambda p: p[0].name)
def test_fused_hvp_plain_matches_jax_kernel(pair, storage, rng):
    jloss, tloss = pair
    n, d = pallas_glm.BLOCK_ROWS + 51, 6
    X, y, off, w, coef = _problem(rng, n, d, dead_every=7)
    v = rng.normal(size=d).astype(np.float32)
    shift, shift_v = np.float32(0.3), np.float32(-0.7)
    jX, tX = _storage(X, storage)
    want = pallas_glm.fused_hessian_vector_sums(
        jX, jnp.asarray(y), jnp.asarray(off), jnp.asarray(w), jnp.asarray(coef),
        jnp.asarray(shift), jnp.asarray(v), jnp.asarray(shift_v), dzz=jloss.dzz, interpret=True,
    )
    calls = fused_glm.fused_hessian_vector_sums_plain.calls
    got = fused_glm.fused_hessian_vector_sums(
        tX, *(torch.from_numpy(a) for a in (y, off, w, coef)), torch.tensor(shift),
        torch.from_numpy(v), torch.tensor(shift_v), loss=tloss,
    )
    assert fused_glm.fused_hessian_vector_sums_plain.calls == calls + 1
    rtol = 1e-5 if storage == "f32" else 2e-3
    for g, j in zip(got, want):
        assert g.dtype == torch.float32
        _close(g.numpy(), j, rtol)
    # shift_v shifts dv alone: moved onto the offsets it would change z
    moved = fused_glm.fused_hessian_vector_sums(
        tX, *(torch.from_numpy(a) for a in (y, off, w, coef)), torch.tensor(shift + shift_v),
        torch.from_numpy(v), torch.tensor(np.float32(0.0)), loss=tloss,
    )
    assert not torch.allclose(moved[0], got[0], rtol=1e-3)


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("pair", LOSSES, ids=lambda p: p[0].name)
def test_fused_hessian_matrix_plain_matches_jax_kernel(pair, storage, rng):
    jloss, tloss = pair
    n, d = pallas_glm.HESS_BLOCK_ROWS + 33, 5
    X, y, off, w, coef = _problem(rng, n, d, dead_every=6)
    shifts = (rng.normal(size=d) * 0.2).astype(np.float32)
    factors = rng.uniform(0.5, 2.0, size=d).astype(np.float32)
    shift = np.float32(-0.2)
    jX, tX = _storage(X, storage)
    want = pallas_glm.fused_hessian_matrix(
        jX, jnp.asarray(y), jnp.asarray(off), jnp.asarray(w), jnp.asarray(coef),
        jnp.asarray(shift), jnp.asarray(shifts), jnp.asarray(factors),
        dzz=jloss.dzz, interpret=True,
    )
    calls = fused_hess.fused_hessian_matrix_plain.calls
    got = fused_hess.fused_hessian_matrix(
        tX, *(torch.from_numpy(a) for a in (y, off, w, coef)), torch.tensor(shift),
        torch.from_numpy(shifts), torch.from_numpy(factors), loss=tloss,
    )
    assert fused_hess.fused_hessian_matrix_plain.calls == calls + 1
    assert got.shape == (d, d) and got.dtype == torch.float32
    _close(got.numpy(), want, 1e-5)
    np.testing.assert_allclose(got.numpy(), got.numpy().T, rtol=1e-6, atol=1e-6 * got.abs().max().item())


def _objective_inputs(rng, n, d):
    X, y, off, w, coef = _problem(rng, n, d, dead_every=9)
    X[:, -1] = 1.0  # the intercept column of the shift normalization
    X[::9] = np.inf
    shifts = (rng.normal(size=d) * 0.1).astype(np.float32)
    shifts[-1] = 0.0
    factors = (np.abs(rng.normal(size=d)) + 0.5).astype(np.float32)
    factors[-1] = 1.0
    v = rng.normal(size=d).astype(np.float32)
    return X, y, off, w, coef, v, shifts, factors


def _data(X, y, off, w):
    jd = JData(X=JDense(jnp.asarray(X)), labels=jnp.asarray(y), offsets=jnp.asarray(off),
               weights=jnp.asarray(w))
    td = TData(X=TDense(torch.from_numpy(X)), labels=torch.from_numpy(y),
               offsets=torch.from_numpy(off), weights=torch.from_numpy(w))
    return jd, td


def test_fused_hvp_with_normalization(rng):
    """GLMObjective.hessian_vector under shift+factor normalization: fused
    (B2) against JAX fused, stock f64 against JAX stock."""
    X, y, off, w, coef, v, shifts, factors = _objective_inputs(rng, 250, 4)
    jn = JNorm(factors=factors, shifts=shifts, intercept_index=3)
    tn = TNorm(factors=factors, shifts=shifts, intercept_index=3)
    jd, td = _data(X, y, off, w)
    jo, to = JObjective(jl.logistic_loss, jn), TObjective(tl.logistic_loss, tn)
    with pallas_interpret():
        assert jo._fused_hessian_vector(jd, jnp.asarray(coef), jnp.asarray(v), 0.3) is not None
        jfused = jo.hessian_vector(jd, jnp.asarray(coef), jnp.asarray(v), 0.3)
    calls = fused_glm.fused_hessian_vector_sums_plain.calls
    with fused_glm.fused_override(True):
        tfused = to.hessian_vector(td, torch.from_numpy(coef), torch.from_numpy(v), 0.3)
    assert fused_glm.fused_hessian_vector_sums_plain.calls == calls + 1
    _close(tfused.numpy(), jfused, 1e-5)

    # stock at f64: the dead inf rows must stay out of the weighted sums
    Xs = np.where(np.isinf(X), 0.0, X)
    jd64 = JData.build(Xs, y, offsets=off, weights=w, dtype=jnp.float64)
    td64 = TData.build(Xs, y, off, w, dtype=torch.float64, device="cpu")
    jstock = jo.hessian_vector(jd64, jnp.asarray(coef, jnp.float64), jnp.asarray(v, jnp.float64), 0.3)
    tstock = to.hessian_vector(td64, torch.from_numpy(coef).double(), torch.from_numpy(v).double(), 0.3)
    _close(tstock.numpy(), jstock, 1e-12)
    _close(tfused.numpy(), tstock.numpy(), 1e-4)


def test_fused_hessian_matrix_through_objective_with_normalization(rng):
    X, y, off, w, coef, _, shifts, factors = _objective_inputs(rng, 200, 4)
    jn = JNorm(factors=factors, shifts=shifts, intercept_index=3)
    tn = TNorm(factors=factors, shifts=shifts, intercept_index=3)
    jd, td = _data(X, y, off, w)
    jo, to = JObjective(jl.logistic_loss, jn), TObjective(tl.logistic_loss, tn)
    with pallas_interpret():
        assert jo._fused_hessian_matrix(jd, jnp.asarray(coef), 0.4) is not None
        jfused = jo.hessian_matrix(jd, jnp.asarray(coef), 0.4)
    calls = fused_hess.fused_hessian_matrix_plain.calls
    with fused_glm.fused_override(True):
        tfused = to.hessian_matrix(td, torch.from_numpy(coef), 0.4)
    assert fused_hess.fused_hessian_matrix_plain.calls == calls + 1
    _close(tfused.numpy(), jfused, 1e-5)
    Xs = np.where(np.isinf(X), 0.0, X)
    jd64 = JData.build(Xs, y, offsets=off, weights=w, dtype=jnp.float64)
    td64 = TData.build(Xs, y, off, w, dtype=torch.float64, device="cpu")
    jstock = jo.hessian_matrix(jd64, jnp.asarray(coef, jnp.float64), 0.4)
    tstock = to.hessian_matrix(td64, torch.from_numpy(coef).double(), 0.4)
    _close(tstock.numpy(), jstock, 1e-12)
    _close(tfused.numpy(), tstock.numpy(), 1e-4)


def test_hessian_gate(monkeypatch):
    """B3 closes above MAX_HESS_DIM, where B1 and B2 stay open, as in JAX;
    batched and f64 problems never fuse."""
    monkeypatch.delenv("PHOTON_PALLAS", raising=False)
    assert fused_hess.MAX_HESS_DIM == pallas_glm.MAX_HESS_DIM
    d = fused_hess.MAX_HESS_DIM + 1
    n = 3
    data = TData(X=TDense(torch.zeros((n, d))), labels=torch.zeros(n), offsets=torch.zeros(n),
                 weights=torch.ones(n))
    obj = TObjective(tl.logistic_loss)
    coef = torch.zeros(d)
    with fused_glm.fused_override(True):
        assert obj._fused_hessian_matrix(data, coef, 0.0) is None
        assert obj._fused_hessian_vector(data, coef, coef, 0.0) is not None
        narrow = TData(X=TDense(torch.zeros((n, 4))), labels=torch.zeros(n),
                       offsets=torch.zeros(n), weights=torch.ones(n))
        assert obj._fused_hessian_matrix(narrow, torch.zeros(4), 0.0) is not None
        assert obj._fused_hessian_matrix(narrow, torch.zeros(4, dtype=torch.float64), 0.0) is None
        batched = TData(X=TDense(torch.zeros((2, n, 4))), labels=torch.zeros(2, n),
                        offsets=torch.zeros(2, n), weights=torch.ones(2, n))
        assert obj._fused_hessian_matrix(batched, torch.zeros(2, 4), 0.0) is None
    assert obj._fused_hessian_matrix(narrow, torch.zeros(4), 0.0) is None  # off by default


@pytest.mark.parametrize("n,d", [(0, 5), (1, 5), (289, 8), (100_000, 64), (1_000_000, 64),
                                 (100_000, 128), (0, 129), (20_011, 257), (100_000, 512)])
def test_hessian_plan_covers_every_row(n, d):
    """B3's launch plan on a 132-SM card, f32 and bf16: at least one CTA of
    at least one row (an empty problem too); CTA ranges (whole rows) or row
    chunks (tiles) in order, every row in exactly one, none empty past the
    first; partials within PARTIAL_BYTES, and whole-row partials at D <= 64
    a quarter of that or less (three CTAs an SM); the whole-row path up to
    ROW_MAX_DIM, staging a multiple of 8 rows a step, a power of two lanes
    a row that hold its values, with no fewer lanes than keep all threads
    busy."""
    per_sm = 3 if d <= 64 else 1  # whole-row CTAs an SM holds
    for elem in (4, 2):
        p = fused_hess.plan(n, d, elem, 132, per_sm)
        assert p.whole_rows == (d <= fused_hess.ROW_MAX_DIM)
        assert p.ctas >= 1 and p.rows_per_cta >= 1 and p.tile_rows % 8 == 0
        begins = [b * p.rows_per_cta for b in range(p.ctas)]
        ends = [min(n, b + p.rows_per_cta) for b in begins]
        assert begins[0] == 0 and ends[-1] == n
        assert all(e == b for e, b in zip(ends, begins[1:]))
        assert all(e > b for b, e in zip(begins, ends)) or (n == 0 and p.ctas == 1)
        assert 4 * p.partial_floats <= fused_hess.PARTIAL_BYTES
        if p.whole_rows:
            for vec in (0, 1) if d * elem % 16 == 0 else (0,):
                tpr = fused_hess.row_threads(d, elem, vec, p.tile_rows)
                words, per_lane = (d * elem // 16, max(1, elem // 2)) if vec else (d, 8)
                assert tpr & (tpr - 1) == 0 and tpr <= 32 and tpr * per_lane >= words
                assert tpr == 32 or 256 // tpr <= p.tile_rows or tpr * per_lane < 2 * words
            width = d * (d + 1) // 2
            groups = -(-p.ctas // p.group)
            assert p.partial_floats == (p.ctas + groups) * width
            assert groups + 1 <= fused_glm.TICKETS and p.ctas <= 132 * per_sm
            if d <= 64:
                assert 16 * p.partial_floats <= fused_hess.PARTIAL_BYTES
        else:
            side = -(-d // fused_hess.TILE)
            assert p.tiles == side * (side + 1) // 2 <= fused_glm.TICKETS
            assert p.ctas * p.tiles <= 132 and p.weight_ctas >= 1
            assert p.partial_floats == p.ctas * p.tiles * fused_hess.TILE ** 2
