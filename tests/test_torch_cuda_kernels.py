"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one (the kernels have
no CPU mode). The file imports neither JAX nor the JAX package, so on a
machine with a card and without JAX it runs on its own:

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -q

Tolerance: each output entry of a kernel (B1, B2, B3) is within 1e-5 of
its plain version on the same inputs, relative to the sum of the absolute
terms that entry adds up (the ``*_scales`` functions), for f32 and bf16
storage alike: only the summation order differs, and the plain version
rounds to bf16 where the kernel does. B2 and B3 must also repeat bitwise,
and B3's output must be symmetric bitwise.
"""

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch.data.matrix import DenseDesignMatrix
from photon_ml_tpu_torch.function import losses
from photon_ml_tpu_torch.ops import fused_glm, fused_hess

TOL = 1e-5

LOSSES = [losses.logistic_loss, losses.squared_loss, losses.poisson_loss, losses.smoothed_hinge_loss]


def _inputs(n, d, storage, seed, heavy_last=False, misaligned=False):
    """(X, y, off, w, coef, margin_shift) on the card, ~5% dead rows, half of
    them holding inf. ``misaligned``: X is a view whose base is one element
    past a 16-byte boundary, so no row is 16-byte aligned."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.uniform(size=n) > 0.5).astype(np.float32)
    off = (rng.normal(size=n) * 0.1).astype(np.float32)
    w = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    dead = rng.choice(n, size=min(n, max(1, n // 20)), replace=False)
    w[dead] = 0.0
    X[dead[::2]] = np.inf
    if heavy_last:
        # the last row, in the ragged last tile, outweighs all the others
        X[-1] = rng.normal(size=d)
        w[-1] = float(n)
    coef = (rng.normal(size=d) * 0.5 / np.sqrt(d)).astype(np.float32)
    args = [torch.from_numpy(a).cuda() for a in (X, y, off, w, coef)]
    args[0] = args[0].to(storage)
    if misaligned:
        buf = torch.empty(n * d + 16, dtype=storage, device="cuda")
        skip = (-buf.data_ptr() % 16) // buf.element_size() + 1
        args[0] = buf[skip: skip + n * d].view(n, d).copy_(args[0])
    return args + [torch.tensor(0.3, device="cuda")]


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,heavy_last", [((100_000, 64), False), ((20_011, 4096), False),
                                              ((20_011, 4096), True), ((700, 33), False),
                                              ((1, 5), False)])
def test_fused_loss_grad_sums_matches_plain(shape, heavy_last, storage):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args = _inputs(*shape, storage, seed=shape[0] + shape[1], heavy_last=heavy_last)
    finite, within = {}, {}
    for loss in LOSSES:
        launches = fused_glm.fused_loss_grad_sums.launches
        got = fused_glm.fused_loss_grad_sums(*args, loss=loss)
        want = fused_glm.fused_loss_grad_sums_plain(*args, loss=loss)
        scales = fused_glm.fused_loss_grad_sums_scales(*args, loss=loss)
        assert fused_glm.fused_loss_grad_sums.launches == launches + 1
        for out, g, p, scale in zip(("val", "grad", "wsum"), got, want, scales):
            finite[loss.name, out] = torch.isfinite(g).all()
            within[loss.name, out] = ((g.double() - p.double()).abs() <= TOL * scale.double()).all()
    finite, within = ({k: bool(v) for k, v in d.items()} for d in (finite, within))
    assert all(finite.values()), finite
    assert all(within.values()), within


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(100_000, 64), (7, 300, 8)])
def test_bf16_matvec_matches_widened_product(shape):
    """The bf16 GEMM with f32 output sums the same exact products as the
    widened f32 product that the CPU runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(3)
    X = torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16)
    w = torch.randn(shape[-1], generator=g, device="cuda").expand(*shape[:-2], shape[-1])
    v = torch.randn(shape[-2], generator=g, device="cuda").expand(*shape[:-2], shape[-2])
    Xf = X.float()
    m = DenseDesignMatrix(X)
    for got, want, scale in (
        (m.matvec(w), Xf @ w.bfloat16().float()[..., None], Xf.abs() @ w.bfloat16().float().abs()[..., None]),
        (m.rmatvec(v), Xf.transpose(-1, -2) @ v.bfloat16().float()[..., None],
         Xf.abs().transpose(-1, -2) @ v.bfloat16().float().abs()[..., None]),
    ):
        assert got.dtype == torch.float32
        err = (got.double() - want.squeeze(-1).double()).abs()
        assert bool((err <= TOL * scale.squeeze(-1).double()).all()), float(err.max())


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = _inputs(64, 8, torch.float32, seed=1)
    with pytest.raises(TypeError):
        fused_glm.fused_loss_grad_sums(args[0].double(), *args[1:], loss=losses.logistic_loss)
    with pytest.raises(ValueError):
        fused_glm.fused_loss_grad_sums(args[0][:, ::2], *args[1:4], args[4][:4], args[5],
                                       loss=losses.logistic_loss)
    wide = torch.zeros((4, fused_glm.MAX_FUSED_DIM + 1), device="cuda")
    with pytest.raises(ValueError):
        fused_glm.fused_loss_grad_sums(wide, *(a[:4] for a in args[1:4]),
                                       torch.zeros(wide.shape[1], device="cuda"), args[5],
                                       loss=losses.logistic_loss)


def _within(got, want, scale):
    return bool(((got.double() - want.double()).abs() <= TOL * scale.double()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,heavy_last", [((100_000, 64), False), ((50_000, 64), False),
                                              ((20_011, 4096), True), ((700, 33), False),
                                              ((1, 5), False)])
def test_fused_hessian_vector_sums_matches_plain(shape, heavy_last, storage):
    """B2 against its plain version; at 20,011 x 4096 the tile holds two
    rows, so the heavy last row sits alone in the ragged last tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args = _inputs(*shape, storage, seed=shape[0] + 7 * shape[1], heavy_last=heavy_last)
    g = torch.Generator(device="cuda").manual_seed(5)
    v = torch.randn(shape[1], generator=g, device="cuda") / shape[1] ** 0.5
    hvp_args = args + [v, torch.tensor(-0.7, device="cuda")]
    results = {}
    for loss in LOSSES:
        launches = fused_glm.fused_hessian_vector_sums.launches
        got = fused_glm.fused_hessian_vector_sums(*hvp_args, loss=loss)
        again = fused_glm.fused_hessian_vector_sums(*hvp_args, loss=loss)
        want = fused_glm.fused_hessian_vector_sums_plain(*hvp_args, loss=loss)
        scales = fused_glm.fused_hessian_vector_sums_scales(*hvp_args, loss=loss)
        assert fused_glm.fused_hessian_vector_sums.launches == launches + 2
        results[loss.name] = (
            all(bool(torch.isfinite(t).all()) for t in got),
            all(_within(a, b, c) for a, b, c in zip(got, want, scales)),
            all(torch.equal(a, b) for a, b in zip(got, again)),
        )
    assert all(all(r) for r in results.values()), results


def _hess_inputs(n, d, storage, seed, heavy_last=False):
    X, y, off, w, coef, shift = _inputs(n, d, storage, seed, heavy_last)
    g = torch.Generator(device="cuda").manual_seed(seed)
    shifts = torch.randn(d, generator=g, device="cuda") * 0.2
    factors = torch.rand(d, generator=g, device="cuda") * 1.5 + 0.5
    return [X, y, off, w, coef, shift, shifts, factors]


def _ragged_rows(d):
    """A row count near 20,000 whose last chunk ends in a staged step of
    one row on this card (fused_hess.plan), for the heavy-last-row case."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n in range(20_000, 21_000):
        p = fused_hess.plan(n, d, 4, sms)
        if (n - (p.ctas - 1) * p.rows_per_cta) % p.tile_rows == 1:
            return n
    raise AssertionError("no such row count")


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,heavy_last", [((100_000, 64), False), ((20_011, 257), False),
                                              (("ragged", 257), True), ((700, 33), False),
                                              ((100_000, 512), False), ((1, 5), False),
                                              ((0, 5), False)])
def test_fused_hessian_matrix_matches_plain(shape, heavy_last, storage):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    n, d = shape
    if n == "ragged":
        n = _ragged_rows(d)
    args = _hess_inputs(n, d, storage, seed=n + d, heavy_last=heavy_last)
    results = {}
    for loss in LOSSES:
        launches = fused_hess.fused_hessian_matrix.launches
        got = fused_hess.fused_hessian_matrix(*args, loss=loss)
        again = fused_hess.fused_hessian_matrix(*args, loss=loss)
        want = fused_hess.fused_hessian_matrix_plain(*args, loss=loss)
        scale = fused_hess.fused_hessian_matrix_scales(*args, loss=loss)
        assert fused_hess.fused_hessian_matrix.launches == launches + 2
        results[loss.name] = (bool(torch.isfinite(got).all()), _within(got, want, scale),
                              torch.equal(got, again), torch.equal(got, got.T))
    assert all(all(r) for r in results.values()), results


@pytest.mark.cuda
def test_hessian_kernels_reject_what_they_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    loss = losses.logistic_loss
    X, y, off, w, coef, shift = _inputs(64, 8, torch.float32, seed=2)
    v, sv = coef.clone(), torch.tensor(0.1, device="cuda")
    with pytest.raises(TypeError):
        fused_glm.fused_hessian_vector_sums(X.double(), y, off, w, coef, shift, v, sv, loss=loss)
    with pytest.raises(ValueError):
        fused_glm.fused_hessian_vector_sums(X[:, ::2], y, off, w, coef[:4], shift, v[:4], sv, loss=loss)
    with pytest.raises(ValueError):
        fused_glm.fused_hessian_vector_sums(X, y, off, w, coef, shift, v, sv.reshape(1), loss=loss)
    with pytest.raises(ValueError):
        fused_glm.fused_hessian_vector_sums(X, y, off, w, coef, shift, v[:7], sv, loss=loss)
    sh, fc = torch.zeros(8, device="cuda"), torch.ones(8, device="cuda")
    with pytest.raises(TypeError):
        fused_hess.fused_hessian_matrix(X.double(), y, off, w, coef, shift, sh, fc, loss=loss)
    with pytest.raises(ValueError):
        fused_hess.fused_hessian_matrix(X[:, ::2], y, off, w, coef[:4], shift, sh[:4], fc[:4], loss=loss)
    with pytest.raises(ValueError):
        fused_hess.fused_hessian_matrix(X, y, off, w, coef, shift, sh[:7], fc, loss=loss)
    wide = torch.zeros((4, fused_hess.MAX_HESS_DIM + 1), device="cuda")
    zd = torch.zeros(wide.shape[1], device="cuda")
    with pytest.raises(ValueError):
        fused_hess.fused_hessian_matrix(wide, *(a[:4] for a in (y, off, w)), zd, shift, zd, zd + 1,
                                        loss=loss)


def _b2_args(args, d, seed=5):
    g = torch.Generator(device="cuda").manual_seed(seed)
    v = torch.randn(d, generator=g, device="cuda") / d**0.5
    return args + [v, torch.tensor(-0.7, device="cuda")]


def _hess_args(args, d, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    shifts = torch.randn(d, generator=g, device="cuda") * 0.2
    factors = torch.rand(d, generator=g, device="cuda") * 1.5 + 0.5
    return args + [shifts, factors]


def _kernel_cases(args, d):
    """(kernel, plain, scales, args) of B1, B2 and B3 on one problem."""
    return [
        (fused_glm.fused_loss_grad_sums, fused_glm.fused_loss_grad_sums_plain,
         fused_glm.fused_loss_grad_sums_scales, args),
        (fused_glm.fused_hessian_vector_sums, fused_glm.fused_hessian_vector_sums_plain,
         fused_glm.fused_hessian_vector_sums_scales, _b2_args(args, d)),
        (fused_hess.fused_hessian_matrix, fused_hess.fused_hessian_matrix_plain,
         fused_hess.fused_hessian_matrix_scales, _hess_args(args, d, seed=7)),
    ]


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


# N below one staged tile; D = 1, 63 and 65 around the whole-row widths, 129
# and 257 past B3's whole-row cut (ROW_MAX_DIM), 136 a tile path with
# aligned rows and a ragged column block; "misaligned" an X view whose base
# is off a 16-byte boundary at an otherwise aligned width
EDGE_SHAPES = [(5, 64), (3, 8), (3000, 1), (3000, 63), (3000, 65), (3000, 129), (3000, 136),
               (3000, 257), "misaligned"]


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", EDGE_SHAPES, ids=str)
def test_kernels_at_edge_shapes(shape, storage):
    """B1, B2 and B3 against their plain versions at the edges of their
    tilings, all four losses; every output repeats bitwise, B3's is
    symmetric bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    misaligned = shape == "misaligned"
    n, d = (3000, 64) if misaligned else shape
    args = _inputs(n, d, storage, seed=3 * n + d, misaligned=misaligned)
    if misaligned:
        assert args[0].data_ptr() % 16 != 0
    results = {}
    for kernel, plain, scales, kargs in _kernel_cases(args, d):
        for loss in LOSSES:
            got = _tuple(kernel(*kargs, loss=loss))
            again = _tuple(kernel(*kargs, loss=loss))
            want = _tuple(plain(*kargs, loss=loss))
            scale = _tuple(scales(*kargs, loss=loss))
            results[kernel.__name__, loss.name] = (
                all(bool(torch.isfinite(t).all()) for t in got),
                all(_within(a, b, c) for a, b, c in zip(got, want, scale)),
                all(torch.equal(a, b) for a, b in zip(got, again)),
                kernel is not fused_hess.fused_hessian_matrix or torch.equal(got[0], got[0].T),
            )
    assert all(all(r) for r in results.values()), results


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(100_000, 64), (20_011, 512)])
def test_back_to_back_and_second_stream_repeat_bitwise(shape):
    """Two calls queued back to back, and a call on a second stream running
    beside one on the first, return the same bits: the in-launch sum's
    integer tickets are reset by each launch and never shared across
    streams."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n, d = shape
    args = _inputs(n, d, torch.float32, seed=11)
    loss = losses.logistic_loss
    side = torch.cuda.Stream()
    for kernel, _, _, kargs in _kernel_cases(args, d):
        first = _tuple(kernel(*kargs, loss=loss))
        torch.cuda.synchronize()
        side.wait_stream(torch.cuda.current_stream())
        queued = [_tuple(kernel(*kargs, loss=loss)) for _ in range(2)]
        with torch.cuda.stream(side):
            beside = [_tuple(kernel(*kargs, loss=loss)) for _ in range(3)]
        queued += [_tuple(kernel(*kargs, loss=loss)) for _ in range(2)]
        torch.cuda.synchronize()
        for i, out in enumerate(queued + beside):
            diff = [float((a.double() - b.double()).abs().max()) for a, b in zip(first, out)]
            assert all(torch.equal(a, b) for a, b in zip(first, out)), (kernel.__name__, i, diff)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
def test_hvp_margin_shift_shifts_z_not_dv(storage):
    """B2 reads margin_shift in the kernel: it shifts z exactly as the same
    shift on the offsets does (bitwise), and not dv (moving it onto shift_v
    changes the result)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    X, y, off, w, coef, ms = _inputs(50_000, 64, storage, seed=13)
    v, sv = _b2_args([], 64)
    zero = torch.tensor(0.0, device="cuda")
    for loss in LOSSES:
        got = fused_glm.fused_hessian_vector_sums(X, y, off, w, coef, ms, v, sv, loss=loss)
        on_offsets = fused_glm.fused_hessian_vector_sums(X, y, off + ms, w, coef, zero, v, sv,
                                                         loss=loss)
        on_dv = fused_glm.fused_hessian_vector_sums(X, y, off, w, coef, zero, v, sv + ms, loss=loss)
        want = fused_glm.fused_hessian_vector_sums_plain(X, y, off, w, coef, ms, v, sv, loss=loss)
        scale = fused_glm.fused_hessian_vector_sums_scales(X, y, off, w, coef, ms, v, sv, loss=loss)
        assert all(_within(a, b, c) for a, b, c in zip(got, want, scale)), loss.name
        assert all(torch.equal(a, b) for a, b in zip(got, on_offsets)), loss.name
        assert not _within(on_dv[0], got[0], scale[0]), loss.name


def _solve_pair(problem, data, **bounds):
    """(fused, stock) results of one GLMOptimizationProblem.run on the card,
    with B1's launches in the fused one."""
    out = []
    for fuse in (True, False):
        with fused_glm.fused_override(fuse):
            before = fused_glm.fused_loss_grad_sums.launches
            model, res = problem.run(data, **bounds)
            out.append((model, res, fused_glm.fused_loss_grad_sums.launches - before))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("opt", ["OWLQN", "LBFGSB"])
def test_b1_under_owlqn_and_lbfgsb_matches_stock(opt):
    """Config #2's shape (50,000 x 64, ``make_glm_workload(seed=2)``): an
    OWLQN elastic-net and an LBFGSB linear solve run their every evaluation
    through B1, and the objective equals the stock solve's within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from photon_ml_tpu_torch import interop
    from photon_ml_tpu_torch.data.dataset import LabeledData
    from photon_ml_tpu_torch.optimization.common import OptimizerConfig
    from photon_ml_tpu_torch.optimization.config import (
        GLMOptimizationConfiguration,
        RegularizationContext,
    )
    from photon_ml_tpu_torch.optimization.problem import GLMOptimizationProblem

    wl = interop.make_glm_workload(seed=2, n_samples=50_000, n_features=64)
    reg = (RegularizationContext("ELASTIC_NET", 0.5) if opt == "OWLQN"
           else RegularizationContext("L2"))
    problem = GLMOptimizationProblem(task="LINEAR_REGRESSION", configuration=(
        GLMOptimizationConfiguration(OptimizerConfig(optimizer_type=opt, max_iterations=100),
                                     reg, 1.0 if opt == "LBFGSB" else 5000.0)))
    data = LabeledData.build(wl["X"], wl["y_linear"], dtype=torch.float32, device="cuda")
    bounds = {} if opt == "OWLQN" else {"lower_bounds": np.full(64, -0.1),
                                        "upper_bounds": np.full(64, 0.1)}
    (mf, rf, launches), (ms, rs, stock) = _solve_pair(problem, data, **bounds)
    assert launches > 0 and stock == 0
    assert abs(float(rf.value) - float(rs.value)) <= 1e-4 * abs(float(rs.value))
    coef = mf.coefficients.means
    if opt == "LBFGSB":
        assert bool((coef.abs() <= 0.1).all()) and bool((coef.abs() == 0.1).any())
    else:
        assert bool((coef == 0).any())


@pytest.mark.cuda
def test_b3_with_normalization_inside_a_newton_fit():
    """A NEWTON solve under STANDARDIZATION on the card: B3 builds each
    Hessian with real shifts and factors, B1 evaluates with a non-zero
    margin shift, and the fused fit's objective and coefficients equal the
    stock fit's within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from photon_ml_tpu_torch import interop
    from photon_ml_tpu_torch.data.dataset import LabeledData
    from photon_ml_tpu_torch.normalization import FeatureDataStatistics, NormalizationContext
    from photon_ml_tpu_torch.optimization.common import OptimizerConfig
    from photon_ml_tpu_torch.optimization.config import (
        GLMOptimizationConfiguration,
        RegularizationContext,
    )
    from photon_ml_tpu_torch.optimization.problem import GLMOptimizationProblem

    wl = interop.make_glm_workload(seed=2, n_samples=50_000, n_features=64)
    X = np.hstack([np.ones((50_000, 1), np.float32), wl["X"] * 3.0 + 1.5])
    norm = NormalizationContext.build("STANDARDIZATION",
                                      FeatureDataStatistics.compute(X, intercept_index=0))
    assert np.abs(norm.shifts).max() > 1.0
    problem = GLMOptimizationProblem(
        task="POISSON_REGRESSION", normalization=norm,
        configuration=GLMOptimizationConfiguration(
            OptimizerConfig(optimizer_type="NEWTON", max_iterations=30),
            RegularizationContext("L2"), 1.0))
    data = LabeledData.build(X, wl["y_poisson"], dtype=torch.float32, device="cuda")
    b3 = fused_hess.fused_hessian_matrix.launches
    (mf, rf, b1), (ms, rs, stock) = _solve_pair(problem, data)
    assert fused_hess.fused_hessian_matrix.launches > b3 and b1 > 0 and stock == 0
    assert abs(float(rf.value) - float(rs.value)) <= 1e-4 * abs(float(rs.value))
    torch.testing.assert_close(mf.coefficients.means, ms.coefficients.means, rtol=0, atol=1e-4)
