#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on a CUDA card.

Run from the root of a checkout, on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. probe: a CUDA device must exist; prints the card's name and power limit;
   turns TF32 off so every f32 product runs in full f32.
2. build: compiles the port's kernel sources with nvcc, one process per
   source, all started together; prints the build time and ptxas report.
3. kernel B1 (fused loss+gradient sums) against its plain PyTorch version on
   the card, f32 and bf16 storage, at the shapes listed in KERNEL_SHAPES and
   Path T's 50,000 x 64, for all four losses at the flagship shape and Path
   T's squared and Poisson losses at its shape, and with a last row (in the
   ragged last tile) that outweighs all others; prints errors, times and the
   bound. Each output must also repeat bitwise.
4. kernel B2 (fused Hessian-vector sums) the same way, with nonzero
   margin_shift and shift_v.
5. kernel B3 (fused Hessian matrix) the same way at HESS_SHAPES, with
   nonzero shifts and factors; the output must also be symmetric bitwise and
   repeat bitwise. B3 runs on the tensor cores in split-precision TF32, so
   its operations bound is 3 * N * D * (D + 1) at the TF32 rate (the f32
   rate's bound is printed beside it), and its library yardstick is
   cuBLAS's f32 GEMM A^T (A * d) alone, on operands prepared outside the
   timed window (the port never calls it). No single PyTorch call computes
   B1's or B2's function, so theirs is null.
6. the flagship GLMix pass with L-BFGS (bench shape: 100,000 x 64 fixed
   effect, 2,000 users, 500 items, seed 42): runs of 3 passes with the fused
   fixed effect and on the stock path, in the order fused, stock, stock,
   fused; B1 must launch on every fused run and never on a stock run, and
   the fused FE objective must stay within 1% of the stock one.
7. Path N, the same pass with NEWTON for the fixed and both random effects
   (bench.py's newton_f32 variant), in the same four runs: B3 and B1 must
   launch on every fused run and never on a stock run, and the fused FE
   objective must stay within 1% of the L-BFGS stock objective of phase 6.
8. Path T, BASELINE config #2 through GLMOptimizationProblem.run: linear and
   then Poisson regression with TRON on 50,000 x 64, fused, stock, stock,
   fused; B2 must launch on every fused run and never on a stock run, the
   fused and stock objectives must agree, and the coefficients must recover
   the generating ones.

Each path's kernel counts are set to 0 just before its runs and read just
after. The line before the last is a JSON summary of every kernel; the last
line is ``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12  # H100 SXM dense TF32 on the tensor cores (B3's unit)
# (N, D) of the B1 and B2 checks: two widths at 100k rows, 1M rows, and a
# ragged row count at the kernels' widest D
KERNEL_SHAPES = [(100_000, 64), (100_000, 512), (1_000_000, 64), (20_011, 4096)]
MAIN_SHAPE = (100_000, 64)  # the flagship fixed effect (B1, B3 on Path N)
PATH_T_SHAPE = (50_000, 64)  # BASELINE config #2 (B2 on Path T)
# the B3 checks: the flagship, MAX_HESS_DIM, 1M rows, ragged in N and D
HESS_SHAPES = [(100_000, 64), (100_000, 512), (1_000_000, 64), (20_011, 257)]
# kernel vs plain, each output entry relative to the sum of the absolute
# terms it adds up: only the summation order differs (the plain version rounds
# to bf16 where the kernel does), so a few f32 ulps of that scale
TOL = 1e-5
FLAGSHIP_QUALITY = 0.01  # FE objective within 1% of the L-BFGS stock path
# Path T: fused vs stock objective at the optimum; f32 sums over 50,000 rows
# in two orders differ by ~1e-6 of the value
PATH_T_AGREE = 1e-4
# Path T: largest coefficient error against the generating coefficients
# (standard errors are ~0.002-0.004 at 50,000 rows)
PATH_T_RECOVERY = 0.05
PASSES = 3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def probe():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"probe: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")


def build():
    from photon_ml_tpu_torch.ops import build as kbuild

    names = ("fused_glm", "fused_hess")
    t0 = time.perf_counter()

    def one(name):
        t = time.perf_counter()
        kbuild.load(name)
        return time.perf_counter() - t

    with ThreadPoolExecutor(len(names)) as pool:
        seconds = dict(zip(names, pool.map(one, names)))
    print(f"build: {', '.join(f'{n} {s:.1f} s' for n, s in seconds.items())}, "
          f"all in {time.perf_counter() - t0:.1f} s")
    for name, log in kbuild.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {name}: {line.strip()}")


def gpu_ms(fn, reps: int, cold: bool) -> float:
    """Device time of one call, by CUDA events. The stream is stalled first so
    the host enqueues every call before the device reaches them; ``cold``
    evicts L2 (50 MB) with a 256 MB write before each call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if not cold:
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def row_inputs(n, d, storage, seed, heavy_last=False):
    """(X, y, off, w, coef, margin_shift) on the card: ~5% dead rows (weight
    0), half of them holding inf; optionally a last row that outweighs all
    the others."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn(n, d, generator=g, device="cuda")
    y = (torch.rand(n, generator=g, device="cuda") > 0.5).float()
    off = torch.randn(n, generator=g, device="cuda") * 0.1
    w = torch.rand(n, generator=g, device="cuda") + 0.5
    dead = torch.rand(n, generator=g, device="cuda") < 0.05
    w[dead] = 0.0
    X[dead & (torch.rand(n, generator=g, device="cuda") < 0.5)] = float("inf")
    if heavy_last:  # dropping the last row would move every output by about half
        X[-1] = torch.randn(d, generator=g, device="cuda")
        w[-1] = float(n)
    coef = torch.randn(d, generator=g, device="cuda") * (0.5 / d**0.5)
    shift = torch.tensor(0.3, device="cuda")
    return [X.to(storage), y, off, w, coef, shift]


def errors(got, want, scales):
    """Largest error of each kernel output against the plain version, entry
    by entry relative to the sum of absolute terms of that entry; and the
    largest absolute error."""
    rel = [float(((g.double() - p.double()).abs() / s.double().clamp_min(1e-30)).max())
           for g, p, s in zip(got, want, scales)]
    max_abs = max(float((g.double() - p.double()).abs().max()) for g, p in zip(got, want))
    return rel, max_abs


def bound(bytes_moved: float, flops: float, rate: float = F32_FLOPS_PER_S) -> tuple[float, str]:
    """(least ms the card could take, what bounds it), with operations at
    ``rate`` per second."""
    b, f = bytes_moved / HBM_BYTES_PER_S, flops / rate
    return max(b, f) * 1e3, "bytes" if b >= f else "operations"


def check_kernel(tag, kernel, plain, scales, cases, cost, stock, timed_shapes, main_shape,
                 extra_checks=lambda got: {}, library=None, rate=F32_FLOPS_PER_S,
                 f32_cost=None):
    """Hold ``kernel`` against ``plain`` on every case (n, d, storage, loss,
    heavy_last, args); time kernel, plain, the stock route and, where given,
    the one library call that computes the same function (``library(args,
    loss)`` prepares its operands and returns the call) at the logistic,
    not heavy cases of ``timed_shapes``. ``cost(n, d, bytes per entry)`` is
    (bytes, operations), the operations at ``rate``; ``f32_cost`` the same
    work counted for the f32 rate outside the tensor cores, printed beside
    it. Returns the timings of the f32 case at ``main_shape``, the shape of
    the kernel's main path."""
    import torch

    from photon_ml_tpu_torch.function import losses

    def outputs(fn, args, loss):
        out = fn(*args, loss=loss)
        return out if isinstance(out, tuple) else (out,)

    main = None
    for n, d, storage, loss, heavy, args in cases:
        got = outputs(kernel, args, loss)
        want = outputs(plain, args, loss)
        sc = outputs(scales, args, loss)
        torch.cuda.synchronize()
        again = outputs(kernel, args, loss)
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        finite = all(bool(torch.isfinite(t).all()) for t in got)
        rel, max_abs = errors(got, want, sc)
        name = f"{n}x{d} {str(storage).split('.')[-1]} {loss.name}" + (" heavy last row" if heavy else "")
        extra = extra_checks(got)
        print(f"{tag}: {name}: rel err {' '.join(f'{r:.2e}' for r in rel)} (tol {TOL:g}), "
              f"max abs err {max_abs:.3e}, repeat bitwise {bitwise}"
              + "".join(f", {k} {v}" for k, v in extra.items()))
        if not finite or not bitwise or max(rel) > TOL or not all(extra.values()):
            fail(f"{tag} disagrees with its plain version at {name}")
        if loss is not losses.logistic_loss or heavy or (n, d) not in timed_shapes:
            continue
        eb = args[0].element_size()
        bound_ms, bound_by = bound(*cost(n, d, eb), rate)
        t = {
            "ms": gpu_ms(lambda: kernel(*args, loss=loss), 20, cold=True),
            "warm_ms": gpu_ms(lambda: kernel(*args, loss=loss), 50, cold=False),
            "plain_ms": gpu_ms(lambda: plain(*args, loss=loss), 20, cold=True),
            "stock_ms": gpu_ms(stock(args, loss), 20, cold=True),
            "library_ms": gpu_ms(library(args, loss), 20, cold=True) if library else None,
        }
        lib = f", library {t['library_ms']:.4f} ms" if library else ""
        f32 = f", f32-rate bound {bound(*f32_cost(n, d, eb))[0]:.4f} ms" if f32_cost else ""
        print(f"{tag}: {name}: kernel {t['ms']:.4f} ms (warm L2 {t['warm_ms']:.4f}), plain "
              f"{t['plain_ms']:.4f} ms, stock {t['stock_ms']:.4f} ms{lib}, bound {bound_ms:.4f} ms "
              f"({bound_by}){f32}, {cost(n, d, eb)[0] / t['ms'] / 1e6:.0f} GB/s, "
              f"{cost(n, d, eb)[1] / t['ms'] / 1e9:.2f} TFLOP/s")
        if storage == torch.float32 and (n, d) == main_shape:
            main = dict(t, bound_ms=bound_ms, bound_by=bound_by, max_abs_err=max_abs)
        torch.cuda.empty_cache()
    return main


def _cases(shapes, seed, inputs, more_losses, heavy_shape):
    """Every shape with the logistic loss, each (shape, losses) pair of
    ``more_losses`` with those losses, and a heavy last row at
    ``heavy_shape``; f32 and bf16 storage each."""
    import torch

    from photon_ml_tpu_torch.function import losses

    both = (torch.float32, torch.bfloat16)
    spec = [(n, d, s, losses.logistic_loss, False) for n, d in shapes for s in both]
    spec += [(*shape, s, l, False) for shape, ls in more_losses for s in both for l in ls]
    spec += [(*heavy_shape, s, losses.logistic_loss, True) for s in both]
    for i, (n, d, s, l, h) in enumerate(spec):
        yield n, d, s, l, h, inputs(n, d, s, seed + i, h)


def more_losses():
    """The losses B1 and B2 are checked with besides the logistic one: all
    of them at the flagship shape, and Path T's squared and Poisson losses
    at its shape."""
    from photon_ml_tpu_torch.function import losses

    return [(MAIN_SHAPE, (losses.squared_loss, losses.poisson_loss, losses.smoothed_hinge_loss)),
            (PATH_T_SHAPE, (losses.squared_loss, losses.poisson_loss))]


def check_b1():
    from photon_ml_tpu_torch.data.dataset import LabeledData
    from photon_ml_tpu_torch.data.matrix import DenseDesignMatrix
    from photon_ml_tpu_torch.function.objective import GLMObjective
    from photon_ml_tpu_torch.ops import fused_glm

    def stock(args, loss):
        X, y, off, w, coef, shift = args
        data = LabeledData(DenseDesignMatrix(X), y, off + shift, w)
        obj = GLMObjective(loss, allow_fused=False)
        return lambda: obj.value_and_gradient(data, coef)

    shapes = KERNEL_SHAPES + [PATH_T_SHAPE]
    return check_kernel(
        "b1", fused_glm.fused_loss_grad_sums, fused_glm.fused_loss_grad_sums_plain,
        fused_glm.fused_loss_grad_sums_scales,
        _cases(shapes, 1000, row_inputs, more_losses(), KERNEL_SHAPES[-1]),
        lambda n, d, eb: (n * d * eb + 12 * n + 4 * d + 4 * (d + 2), 4 * n * d),
        stock, shapes, MAIN_SHAPE,
    )


def check_b2():
    import torch

    from photon_ml_tpu_torch.data.dataset import LabeledData
    from photon_ml_tpu_torch.data.matrix import DenseDesignMatrix
    from photon_ml_tpu_torch.function.objective import GLMObjective
    from photon_ml_tpu_torch.ops import fused_glm

    def inputs(n, d, storage, seed, heavy):
        args = row_inputs(n, d, storage, seed, heavy)
        g = torch.Generator(device="cuda").manual_seed(seed + 1)
        v = torch.randn(d, generator=g, device="cuda") / d**0.5
        return args + [v, torch.tensor(-0.7, device="cuda")]

    def stock(args, loss):  # three passes over X: z, dv and X^T u
        X, y, off, w, coef, shift, v, _ = args
        data = LabeledData(DenseDesignMatrix(X), y, off + shift, w)
        obj = GLMObjective(loss, allow_fused=False)
        return lambda: obj.hessian_vector(data, coef, v)

    shapes = KERNEL_SHAPES + [PATH_T_SHAPE]
    return check_kernel(
        "b2", fused_glm.fused_hessian_vector_sums, fused_glm.fused_hessian_vector_sums_plain,
        fused_glm.fused_hessian_vector_sums_scales,
        _cases(shapes, 2000, inputs, more_losses(), KERNEL_SHAPES[-1]),
        lambda n, d, eb: (n * d * eb + 12 * n + 8 * d + 4 + 4 * (d + 1), 6 * n * d),
        stock, shapes, PATH_T_SHAPE,
    )


def check_b3():
    import torch

    from photon_ml_tpu_torch.data.dataset import LabeledData
    from photon_ml_tpu_torch.data.matrix import DenseDesignMatrix
    from photon_ml_tpu_torch.function import losses
    from photon_ml_tpu_torch.function.objective import GLMObjective
    from photon_ml_tpu_torch.normalization import NormalizationContext
    from photon_ml_tpu_torch.ops import fused_hess

    def inputs(n, d, storage, seed, heavy):
        args = row_inputs(n, d, storage, seed, heavy)
        g = torch.Generator(device="cuda").manual_seed(seed + 1)
        shifts = torch.randn(d, generator=g, device="cuda") * 0.2
        factors = torch.rand(d, generator=g, device="cuda") * 1.5 + 0.5
        return args + [shifts, factors]

    def stock(args, loss):  # a materialized normalized design and one GEMM
        X, y, off, w, coef, shift, shifts, factors = args
        data = LabeledData(DenseDesignMatrix(X), y, off + shift, w)
        norm = NormalizationContext(factors=factors, shifts=shifts, intercept_index=0)
        obj = GLMObjective(loss, norm, allow_fused=False)
        return lambda: obj.hessian_matrix(data, coef)

    def library(args, loss):
        """cuBLAS's f32 GEMM alone, A^T (A * d), on operands prepared here,
        outside the timed window; the port never calls it."""
        d_rows, A = fused_hess._hess_rows(*args, loss)
        Ad = A * d_rows[:, None]
        return lambda: torch.mm(A.T, Ad)

    def bytes_moved(n, d, eb):
        return n * d * eb + 12 * n + 12 * d + 4 * d * d

    others = (losses.squared_loss, losses.poisson_loss, losses.smoothed_hinge_loss)
    return check_kernel(
        "b3", fused_hess.fused_hessian_matrix, fused_hess.fused_hessian_matrix_plain,
        fused_hess.fused_hessian_matrix_scales,
        _cases(HESS_SHAPES, 3000, inputs, [(MAIN_SHAPE, others)], HESS_SHAPES[-1]),
        # split-precision TF32: three tensor-core products per multiply-add
        lambda n, d, eb: (bytes_moved(n, d, eb), 3 * n * d * (d + 1)),
        stock, HESS_SHAPES, MAIN_SHAPE,
        extra_checks=lambda got: {"symmetric bitwise": torch.equal(got[0], got[0].T)},
        library=library, rate=TF32_FLOPS_PER_S,
        f32_cost=lambda n, d, eb: (bytes_moved(n, d, eb), n * d * (d + 1) + 2 * n * d),
    )


def kernel_counts():
    """The launch counters of every kernel wrapper."""
    from photon_ml_tpu_torch.ops import fused_glm, fused_hess

    return [fused_glm.fused_loss_grad_sums, fused_glm.fused_hessian_vector_sums,
            fused_hess.fused_hessian_matrix]


def zero_counts():
    for k in kernel_counts():
        k.launches = 0


def read_counts() -> dict:
    return {k.__name__: k.launches for k in kernel_counts()}


def run_glmix(opt: str, label: str, wl=None):
    """Runs of PASSES flagship passes with optimizer ``opt`` for every
    coordinate, fused, stock, stock, fused (each side runs first once).
    Returns ([(fuse, fe_value, counts, fixed coefficients)], workload)."""
    import torch

    from photon_ml_tpu_torch import interop
    from photon_ml_tpu_torch.ops import fused_glm
    from photon_ml_tpu_torch.optimization.common import OptimizerConfig, any_lane
    from photon_ml_tpu_torch.optimization.config import (
        GLMOptimizationConfiguration,
        RegularizationContext,
    )
    from photon_ml_tpu_torch.parallel.game import init_game_params, make_game_step
    from photon_ml_tpu_torch.types import RegularizationType, TaskType

    t0 = time.perf_counter()
    wl = wl or interop.make_glmix_workload(seed=42)
    data = interop.build_game_data(wl, device="cuda")
    torch.cuda.synchronize()
    n = data.n
    print(f"{label}: built {n} x {data.fe_X.n_cols} with {[rc.n_entities for rc in data.re]} entities, "
          f"buckets {[[tuple(b.X.shape) for b in rc.buckets] for rc in data.re]} "
          f"in {time.perf_counter() - t0:.2f} s")

    def cfg(iters):
        return GLMOptimizationConfiguration(
            OptimizerConfig(optimizer_type=opt, max_iterations=iters),
            RegularizationContext(RegularizationType.L2), 1.0,
        )

    runs = []
    for fuse in (True, False, False, True):
        kind = "fused" if fuse else "stock"
        with fused_glm.fused_override(True):
            step = make_game_step(data, TaskType.LOGISTIC_REGRESSION, cfg(50), [cfg(30), cfg(30)],
                                  fuse_fe=fuse, device="cuda")
            params = init_game_params(data, device="cuda")
            torch.cuda.synchronize()
            zero_counts()
            seconds = []
            for p in range(PASSES):
                syncs0 = any_lane.syncs
                t0 = time.perf_counter()
                params, diag = step(params)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                re_it = [[int(x) for x in r] for r in diag["re_iterations_max"]]
                print(f"{label} {kind} run {len(runs)} pass {p}: fe_value {float(diag['fe_value']):.6f} "
                      f"fe_iterations {int(diag['fe_iterations'])} re_iterations_max {re_it} "
                      f"{seconds[-1]:.4f} s {n / seconds[-1]:.0f} samples/s "
                      f"host_syncs {any_lane.syncs - syncs0}")
            counts = read_counts()
        print(f"{label} {kind} run {len(runs)}: launches over {PASSES} passes {counts}, "
              f"samples/s over the run {n * PASSES / sum(seconds):.0f}")
        for t in (params["fixed"], *params["re"], diag["total_scores"]):
            if not bool(torch.isfinite(t).all()):
                fail(f"non-finite {label} {kind} parameters or scores")
        want = [(rc.n_entities + 1, rc.max_k) for rc in data.re]
        if params["fixed"].shape != (data.fe_X.n_cols,) or [tuple(t.shape) for t in params["re"]] != want:
            fail(f"unexpected {label} {kind} parameter shapes")
        runs.append((fuse, float(diag["fe_value"]), counts, params["fixed"]))
    print(f"{label}: repeat runs bitwise equal: fused {torch.equal(runs[0][3], runs[3][3])}, "
          f"stock {torch.equal(runs[1][3], runs[2][3])}")
    return runs, wl


def check_launches(label, runs, kernels):
    for fuse, _, counts, _ in runs:
        for k in kernels:
            if (counts[k] > 0) != fuse:
                fail(f"{label}: {k} launched {counts[k]} times on a {'fused' if fuse else 'stock'} run")


def gap_check(label, value, anchor, limit):
    gap = abs(value - anchor) / abs(anchor)
    print(f"{label}: FE objective {value:.6f} vs anchor {anchor:.6f}: rel gap {gap:.2e} (limit {limit})")
    if not gap <= limit:
        fail(f"{label}: FE objective is not within {limit} of its anchor")


def run_flagship():
    """Phase 6: the L-BFGS pass. Returns (B1 launches of the first fused
    run, the stock FE objective that anchors Path N, the workload)."""
    runs, wl = run_glmix("LBFGS", "flagship")
    check_launches("flagship", runs, ["fused_loss_grad_sums"])
    gap_check("flagship", runs[0][1], runs[1][1], FLAGSHIP_QUALITY)
    return runs[0][2]["fused_loss_grad_sums"], runs[1][1], wl


def run_path_n(anchor, wl):
    """Phase 7: NEWTON for every coordinate. Returns the counts of its
    first fused run."""
    runs, _ = run_glmix("NEWTON", "path N", wl)
    check_launches("path N", runs, ["fused_loss_grad_sums", "fused_hessian_matrix"])
    gap_check("path N fused NEWTON vs L-BFGS stock", runs[0][1], anchor, FLAGSHIP_QUALITY)
    gap_check("path N stock NEWTON vs L-BFGS stock", runs[1][1], anchor, FLAGSHIP_QUALITY)
    return runs[0][2]


def run_path_t():
    """Phase 8: config #2 through GLMOptimizationProblem.run. Returns the
    counts of the first fused run of each task, summed."""
    import torch

    from photon_ml_tpu_torch import interop
    from photon_ml_tpu_torch.data.dataset import LabeledData
    from photon_ml_tpu_torch.ops import fused_glm
    from photon_ml_tpu_torch.optimization.common import OptimizerConfig, any_lane
    from photon_ml_tpu_torch.optimization.config import (
        GLMOptimizationConfiguration,
        RegularizationContext,
    )
    from photon_ml_tpu_torch.optimization.problem import GLMOptimizationProblem
    from photon_ml_tpu_torch.optimization.tron import truncated_conjugate_gradient
    from photon_ml_tpu_torch.types import RegularizationType, TaskType

    n, d = PATH_T_SHAPE
    wl = interop.make_glm_workload(seed=2, n_samples=n, n_features=d)
    first_fused = None
    for task, key, truth in ((TaskType.LINEAR_REGRESSION, "y_linear", wl["w"]),
                             (TaskType.POISSON_REGRESSION, "y_poisson", wl["w"] * 0.25)):
        problem = GLMOptimizationProblem(
            task=task,
            configuration=GLMOptimizationConfiguration(
                OptimizerConfig(optimizer_type="TRON", max_iterations=50),
                RegularizationContext(RegularizationType.L2), 1.0,
            ),
        )
        data = LabeledData.build(wl["X"], wl[key], dtype=torch.float32, device="cuda")
        truth = torch.as_tensor(truth, dtype=torch.float32, device="cuda")
        runs = []
        for fuse in (True, False, False, True):
            kind = "fused" if fuse else "stock"
            with fused_glm.fused_override(fuse):
                torch.cuda.synchronize()
                zero_counts()
                syncs0, cg0 = any_lane.syncs, truncated_conjugate_gradient.steps
                t0 = time.perf_counter()
                model, res = problem.run(data)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                counts = read_counts()
            coef = model.coefficients.means
            err = float((coef - truth).abs().max())
            print(f"path T {task.value} {kind} run {len(runs)}: value {float(res.value):.6f} "
                  f"iterations {int(res.iterations)} {res.reason_name()} cg_steps "
                  f"{truncated_conjugate_gradient.steps - cg0} host_syncs {any_lane.syncs - syncs0} "
                  f"{seconds:.4f} s, launches {counts}, max |coef - generating| {err:.4f}")
            if coef.shape != (d,) or not bool(torch.isfinite(coef).all()):
                fail(f"path T {task.value} {kind}: bad coefficients")
            if not err <= PATH_T_RECOVERY:
                fail(f"path T {task.value} {kind}: coefficients miss the generating ones by {err}")
            runs.append((fuse, float(res.value), counts, coef))
        check_launches(f"path T {task.value}", runs, ["fused_loss_grad_sums", "fused_hessian_vector_sums"])
        # the path's run: the first fused solve of each task
        first_fused = {k: v + (first_fused or {}).get(k, 0) for k, v in runs[0][2].items()}
        gap_check(f"path T {task.value} fused vs stock", runs[0][1], runs[1][1], PATH_T_AGREE)
    return first_fused


def main() -> int:
    probe()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    import photon_ml_tpu_torch  # noqa: F401 - fails outside a checkout of the repo

    build()
    timing = {"b1": check_b1(), "b2": check_b2(), "b3": check_b3()}
    b1_launches, anchor, wl = run_flagship()
    path_n = run_path_n(anchor, wl)
    path_t = run_path_t()
    source = "photon_ml_tpu_torch/ops/csrc/"
    kernels = []
    for key, name, src, replaces, launches in (
        ("b1", "fused_loss_grad_sums", "fused_glm.cu", "photon_ml_tpu/ops/pallas_glm.py:218", b1_launches),
        ("b2", "fused_hessian_vector_sums", "fused_glm.cu", "photon_ml_tpu/ops/pallas_glm.py:301",
         path_t["fused_hessian_vector_sums"]),
        ("b3", "fused_hessian_matrix", "fused_hess.cu", "photon_ml_tpu/ops/pallas_glm.py:393",
         path_n["fused_hessian_matrix"]),
    ):
        t = timing[key]
        kernels.append({
            "name": name, "route": "cuda", "source": source + src, "replaces": replaces,
            "launches": launches, "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
