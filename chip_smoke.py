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
9. the estimator, ``GameEstimator.fit`` + ``select_best_model``, the entry
   point of the README quick start, on the flagship model with a validation
   set (``interop.make_glmix_split``: one draw of 120,000 rows, seed 42,
   split into 100,000 training and 20,000 validation rows; 2 iterations,
   AUC): the host loop fused then stock, ``fused_pass=True`` fused, and the
   host loop with NEWTON on the fixed effect, fused. Each fit prints its
   seconds, samples/s per pass, host syncs, kernel launches and validation
   AUC. B1 must launch on the fused fits and never on the stock fit, B3 on
   the NEWTON fit; the fused FE objectives must stay within 1% of the stock
   one, and the final validation AUCs of the three L-BFGS fits within 0.002
   of each other.
10. the model after the fit, on phase 9's split: a host-loop fit with the
   fused fixed effect and ``checkpoint_directory`` (run A whole; run B
   crashed by an armed ``coord.update:crash:4`` fault, the first update of
   iteration 2, then rerun on the same directory): B's final and best
   models, best AUC and evaluations must equal A's bitwise, and B1 must
   launch in both; prints seconds per save and restore, bytes per
   generation and generations kept. The best and the final model go through
   ``save_game_model`` / ``load_game_model(device="cuda")`` (the reference's
   Avro layout) with every table bitwise equal; ``GameTransformer.transform``
   of the loaded best model on the validation rows must give the fit's AUC
   within 1e-6 and the eager scorer's scores bitwise. Then the serving
   engine (one CUDA graph per bucket) answers benchmarks/scoring_bench.py's
   stream: 32 requests of 2,049-4,096 rows, warmed up with one; prints
   samples/s, p50 and p99 ms, the eager rate on 4 requests, and the bytes
   the 4,096-row graph holds. Checks: 0 captures after warm-up, the probe
   equal to the eager scorer bitwise (best and final model), ``predict``
   within LINK_ULPS of numpy's link of ``score``, a 100-row request
   captured once and then replayed, and a bf16-policy engine within 0.05 of
   the largest f32 score.

11. slice 6 (L1 and elastic net, box constraints, the direct and
   measured-"auto" random-effect solves, feature normalization): (a)
   config #2's elastic-net half, linear and Poisson OWLQN with
   ELASTIC_NET (alpha 0.5) through GLMOptimizationProblem.run on Path T's
   data, fused then stock: B1 must launch on the fused solves only, the
   objectives agree within PATH_T_AGREE, every coefficient within
   PATH_T_RECOVERY of the generating one, and both runs' exact zeros are
   printed; (b) the flagship pass with ``re_solver="direct"``, fused then
   stock (3 passes): the FE objective within 1% of phase 6's L-BFGS stock
   anchor, the mean RE iterations per bucket printed beside phase 6's; (c)
   three ``GameEstimator.fit``s on phase 9's split, each fused then stock:
   (i) a NEWTON fixed effect on the shard with an intercept column and its
   other columns moved by SHARD_SHIFT, both shards standardized, RE
   ``re_solver="auto"``, checkpointed, then crashed by
   ``coord.update:crash:4`` and resumed: equal to the whole fit bitwise,
   its "auto" record included, with B1 and B3 launching under shifts above
   1 and the fused FE coefficients within SHIFTED_FE_AGREE of the stock
   ones;
   (ii) an OWLQN elastic-net fixed effect with direct RE solves; (iii) an
   LBFGSB fixed effect in a box built by ``constraints.build_bound_vectors``
   from a constraint string: every coefficient inside its box and some
   bound binding. No fit may reject an update; each prints its seconds,
   host syncs, launches and validation AUC.

Each path's kernel counts are set to 0 just before its runs and read just
after. The line before the last is a JSON summary of every kernel; the last
line is ``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
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
ESTIMATOR_ITERATIONS = 2
AUC_AGREE = 0.002  # final validation AUC across the three L-BFGS fits
TRANSFORM_AUC_AGREE = 1e-6  # GameTransformer's AUC of the loaded model vs the fit's
# the serving stream of benchmarks/scoring_bench.py
SERVE_REQUESTS, SERVE_BATCH, SERVE_EAGER_REQUESTS = 32, 4096, 4
BF16_AGREE = 0.05  # bf16-policy engine vs f32, of the largest score (tests/test_precision.py)
# on-device link vs numpy's link of the same margins, f32 ulps: two f32
# evaluations of 1 / (1 + exp(-m)), each up to 3-4 ulps from the correctly
# rounded value (CUDA's expf is within 2 ulps, numpy's f32 exp measured 3;
# one rounding each for the add and the division), so up to 8 apart
LINK_ULPS = 8
# phase 11: elastic-net weight (alpha 0.5: L1 500, shrinkage ~0.01 at 50,000
# standard-normal rows, inside PATH_T_RECOVERY) and the box of 11c(iii)
ELASTIC_NET_WEIGHT = 1000.0
BOX = 0.1
# 11c(i): the FE shard's columns are moved by SHARD_SHIFT, so standardization
# shifts them by as much (the standardized problem is the same one), and a B3
# that dropped the shifts would build another Hessian; the fused FE
# coefficients must agree with the stock ones within SHIFTED_FE_AGREE
SHARD_SHIFT = 1.5
SHIFTED_FE_AGREE = 1e-3


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


def run_glmix(opt: str, label: str, wl=None, re_solver="lbfgs", order=(True, False, False, True)):
    """Runs of PASSES flagship passes with optimizer ``opt`` for every
    coordinate and ``re_solver`` for the random effects, in ``order`` (by
    default fused, stock, stock, fused: each side runs first once).
    Returns ([(fuse, fe_value, counts, fixed coefficients, mean RE
    iterations per bucket)], workload)."""
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
    for fuse in order:
        kind = "fused" if fuse else "stock"
        re_iters = []
        with fused_glm.fused_override(True):
            step = make_game_step(data, TaskType.LOGISTIC_REGRESSION, cfg(50), [cfg(30), cfg(30)],
                                  re_solver=re_solver, fuse_fe=fuse, device="cuda")
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
                re_iters += [x for r in re_it for x in r]
                print(f"{label} {kind} run {len(runs)} pass {p}: fe_value {float(diag['fe_value']):.6f} "
                      f"fe_iterations {int(diag['fe_iterations'])} re_iterations_max {re_it} "
                      f"{seconds[-1]:.4f} s {n / seconds[-1]:.0f} samples/s "
                      f"host_syncs {any_lane.syncs - syncs0}")
            counts = read_counts()
        re_mean = sum(re_iters) / len(re_iters)
        print(f"{label} {kind} run {len(runs)}: launches over {PASSES} passes {counts}, "
              f"samples/s over the run {n * PASSES / sum(seconds):.0f}, mean RE iterations per "
              f"bucket {re_mean:.2f}")
        for t in (params["fixed"], *params["re"], diag["total_scores"]):
            if not bool(torch.isfinite(t).all()):
                fail(f"non-finite {label} {kind} parameters or scores")
        want = [(rc.n_entities + 1, rc.max_k) for rc in data.re]
        if params["fixed"].shape != (data.fe_X.n_cols,) or [tuple(t.shape) for t in params["re"]] != want:
            fail(f"unexpected {label} {kind} parameter shapes")
        runs.append((fuse, float(diag["fe_value"]), counts, params["fixed"], re_mean))
    if len(runs) == 4:
        print(f"{label}: repeat runs bitwise equal: fused {torch.equal(runs[0][3], runs[3][3])}, "
              f"stock {torch.equal(runs[1][3], runs[2][3])}")
    return runs, wl


def check_launches(label, runs, kernels):
    for fuse, _, counts, *_ in runs:
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
    run, the stock FE objective that anchors Path N, the stock run's mean
    RE iterations per bucket, the workload)."""
    runs, wl = run_glmix("LBFGS", "flagship")
    check_launches("flagship", runs, ["fused_loss_grad_sums"])
    gap_check("flagship", runs[0][1], runs[1][1], FLAGSHIP_QUALITY)
    return runs[0][2]["fused_loss_grad_sums"], runs[1][1], runs[1][4], wl


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


def flagship_estimator(fe_opt="LBFGS", cls=None, fe=None, **kw):
    """The estimator of phases 9 to 11: the flagship model (FE L-BFGS or
    NEWTON 50 iterations, or the coordinate configuration ``fe``; per-user
    and per-item RE L-BFGS 30), L2 1.0, ESTIMATOR_ITERATIONS iterations,
    validation AUC, on the card."""
    from photon_ml_tpu_torch.estimators import (
        CoordinateConfiguration,
        FixedEffectDataConfiguration,
        GameEstimator,
        RandomEffectDataConfiguration,
    )
    from photon_ml_tpu_torch.evaluation import EvaluatorType
    from photon_ml_tpu_torch.optimization.common import OptimizerConfig
    from photon_ml_tpu_torch.optimization.config import (
        GLMOptimizationConfiguration,
        RegularizationContext,
    )
    from photon_ml_tpu_torch.types import RegularizationType, TaskType

    def cfg(opt, iters):
        return GLMOptimizationConfiguration(
            OptimizerConfig(optimizer_type=opt, max_iterations=iters),
            RegularizationContext(RegularizationType.L2), 1.0,
        )

    return (cls or GameEstimator)(
        task=TaskType.LOGISTIC_REGRESSION,
        coordinate_configurations={
            "global": fe or CoordinateConfiguration(FixedEffectDataConfiguration("global"),
                                                    cfg(fe_opt, 50)),
            "per-user": CoordinateConfiguration(RandomEffectDataConfiguration("userId", "re"),
                                                cfg("LBFGS", 30)),
            "per-item": CoordinateConfiguration(RandomEffectDataConfiguration("itemId", "re"),
                                                cfg("LBFGS", 30)),
        },
        n_iterations=ESTIMATOR_ITERATIONS,
        validation_evaluators=[EvaluatorType.AUC],
        device="cuda",
        **kw,
    )


def run_estimator():
    """Phase 9: GameEstimator.fit on the flagship split. Returns the
    training workload and the training and validation GameInputs."""
    import torch

    from photon_ml_tpu_torch import interop
    from photon_ml_tpu_torch.device import to_host
    from photon_ml_tpu_torch.ops import fused_glm
    from photon_ml_tpu_torch.optimization.common import any_lane

    t0 = time.perf_counter()
    train_wl, val_wl = interop.make_glmix_split(seed=42)
    train, val = interop.glmix_game_input(train_wl), interop.glmix_game_input(val_wl)
    n = train.n
    print(f"estimator: drew {n} training and {val.n} validation rows in "
          f"{time.perf_counter() - t0:.2f} s")

    # the fits build their datasets themselves; this build alone says how
    # much of a fit's wall time it is
    est = flagship_estimator("LBFGS")
    t = time.perf_counter()
    est.prepare_training_datasets(train)
    est.prepare_scoring_datasets(val)
    torch.cuda.synchronize()
    print(f"estimator: training and validation datasets built in {time.perf_counter() - t:.3f} s")

    fits = {}
    for label, fuse, fe_opt, kw in (("host loop fused", True, "LBFGS", {}),
                                    ("host loop stock", False, "LBFGS", {}),
                                    ("fused pass", True, "LBFGS", {"fused_pass": True}),
                                    ("host loop NEWTON fused", True, "NEWTON", {})):
        est = flagship_estimator(fe_opt, **kw)
        with fused_glm.fused_override(fuse):
            torch.cuda.synchronize()
            zero_counts()
            syncs0, reads0 = any_lane.syncs, to_host.transfers
            t = time.perf_counter()
            results = est.fit(train, validation_data=val)
            best = est.select_best_model(results)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t
            counts = read_counts()
        descent = best.descent
        fe_value = descent.trackers["global"][-1].final_value
        final_auc = descent.metrics_history[-1][2]["AUC"]
        syncs = (any_lane.syncs - syncs0, to_host.transfers - reads0)
        fe_iters = [t.iterations for t in descent.trackers["global"]]
        print(f"estimator {label}: fit {seconds:.3f} s (dataset build included), "
              f"{n * ESTIMATOR_ITERATIONS / seconds:.0f} samples/s per pass, host syncs "
              f"{sum(syncs)} (loop checks {syncs[0]}, reads {syncs[1]}), launches {counts}, "
              f"FE iterations {fe_iters}, FE objective {fe_value:.6f}, validation AUC best "
              f"{best.best_metric:.6f} final {final_auc:.6f}, incidents {len(descent.incidents)}")
        model = best.model
        fe = model.get_model("global").model.coefficients.means
        if fe.shape != (train_wl["fe_X"].shape[1],) or not bool(torch.isfinite(fe).all()):
            fail(f"estimator {label}: bad fixed-effect coefficients")
        for cid, ids in (("per-user", train_wl["users"]), ("per-item", train_wl["items"])):
            re = model.get_model(cid)
            if re.coeffs.shape[0] != len(set(ids.tolist())) or not bool(torch.isfinite(re.coeffs).all()):
                fail(f"estimator {label}: bad {cid} table {tuple(re.coeffs.shape)}")
        if not (math.isfinite(best.best_metric) and math.isfinite(final_auc)) or descent.incidents:
            fail(f"estimator {label}: validation AUC not finite or an update was rejected")
        fits[label] = {"counts": counts, "fe_value": fe_value, "auc": final_auc}
    for label, fit in fits.items():
        b1, b3 = fit["counts"]["fused_loss_grad_sums"], fit["counts"]["fused_hessian_matrix"]
        if (b1 > 0) != ("fused" in label) or ("NEWTON" in label and not b3 > 0):
            fail(f"estimator {label}: launches {fit['counts']}")
    anchor = fits["host loop stock"]["fe_value"]
    for label in ("host loop fused", "fused pass"):
        gap_check(f"estimator {label} vs host loop stock", fits[label]["fe_value"], anchor,
                  FLAGSHIP_QUALITY)
    aucs = [fits[k]["auc"] for k in ("host loop fused", "host loop stock", "fused pass")]
    print(f"estimator: final validation AUC spread {max(aucs) - min(aucs):.2e} (limit {AUC_AGREE})")
    if not max(aucs) - min(aucs) <= AUC_AGREE:
        fail("estimator: the L-BFGS fits disagree on validation AUC")
    return train_wl, train, val


def _tree_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path) for f in files)


def _with_str_ids(data):
    """The same rows with entity ids as strings: a model read from Avro
    files names its entities by the strings its records hold."""
    import dataclasses

    import numpy as np

    return dataclasses.replace(
        data, id_columns={t: np.asarray(c).astype(str) for t, c in data.id_columns.items()})


def _serving_requests(entity_ids: dict, seed=7):
    """benchmarks/scoring_bench.py's request stream at the flagship width:
    SERVE_REQUESTS requests of SERVE_BATCH // 2 + 1 .. SERVE_BATCH rows (one
    bucket), FE 64 dense columns, RE CSR intercept + 7, f32 offsets, ids drawn
    over the model's entities."""
    import numpy as np
    import scipy.sparse as sp

    from photon_ml_tpu_torch.data.game_data import GameInput

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(SERVE_REQUESTS):
        n = int(rng.integers(SERVE_BATCH // 2 + 1, SERVE_BATCH + 1))
        fe = rng.normal(size=(n, 64)).astype(np.float32)
        re = sp.csr_matrix(np.concatenate([np.ones((n, 1), np.float32), fe[:, :7]], axis=1))
        out.append(GameInput(
            features={"global": fe, "re": re},
            offsets=rng.normal(size=n).astype(np.float32),
            id_columns={tag: rng.choice(ids, size=n) for tag, ids in entity_ids.items()},
        ))
    return out


def _dense_tables(model) -> dict:
    """Every table of a GameModel on the host: the fixed effects' means, and
    each random effect as {entity id as a string: its dense coefficient row
    over the shard's columns}. The Avro layout stores an entity's non-zero
    coefficients only, so two models with equal dense tables score alike."""
    import numpy as np

    out = {}
    for cid, m in model:
        if not hasattr(m, "coeffs"):
            out[cid] = m.model.coefficients.means.cpu().numpy()
            continue
        coeffs, proj = m.coeffs.cpu().numpy(), m.proj_indices.cpu().numpy()
        width = int(proj.max()) + 1 if proj.size else 0
        rows = {}
        for i, e in enumerate(m.entity_ids):
            row = np.zeros(width, coeffs.dtype)
            row[proj[i][proj[i] >= 0]] = coeffs[i][proj[i] >= 0]
            rows[str(e)] = row
        out[cid] = rows
    return out


def _same_tables(a, b) -> bool:
    """Two GameModels' tables bitwise equal, in the same coordinate order."""
    import numpy as np

    ta, tb = _dense_tables(a), _dense_tables(b)
    if list(ta) != list(tb):
        return False
    for cid, x in ta.items():
        y = tb[cid]
        if isinstance(x, dict):
            width = max([len(r) for r in list(x.values()) + list(y.values())] + [0])

            def pad(r):
                return np.pad(r, (0, width - len(r)))

            if set(x) != set(y) or any(
                    pad(x[e]).tobytes() != pad(y[e]).tobytes() or x[e].dtype != y[e].dtype
                    for e in x):
                return False
        elif x.dtype != y.dtype or x.tobytes() != y.tobytes():
            return False
    return True


def run_model_after_fit(train_wl, train, val):
    """Phase 10: the fitted model leaves the fit. A checkpointed fit (run A
    whole, run B crashed inside iteration 2 and rerun), the Avro round trip
    of the best model, GameTransformer on the validation rows and the
    serving engine's CUDA graphs over a request stream. Returns B1's
    launches in the checkpointed fits."""
    import shutil

    import numpy as np
    import torch

    from photon_ml_tpu_torch import interop
    from photon_ml_tpu_torch.estimators import GameEstimator
    from photon_ml_tpu_torch.evaluation import EvaluatorType
    from photon_ml_tpu_torch.io.checkpoint import list_generations, load_checkpoint
    from photon_ml_tpu_torch.io.model_io import load_game_model, save_game_model
    from photon_ml_tpu_torch.ops import fused_glm
    from photon_ml_tpu_torch.optimization.precision import host_link
    from photon_ml_tpu_torch.resilience import InjectedCrash, armed
    from photon_ml_tpu_torch.serving import get_engine
    from photon_ml_tpu_torch.transformers import GameTransformer

    class Recording(GameEstimator):
        """Keeps the checkpointers it makes, for their save/restore times."""

        made = []

        def checkpointer(self, *args):
            ck = super().checkpointer(*args)
            Recording.made.append(ck)
            return ck

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_phase10")
    shutil.rmtree(work, ignore_errors=True)

    def fit(ckpt):
        est = flagship_estimator(cls=Recording, checkpoint_directory=ckpt)
        best = est.select_best_model(est.fit(train, validation_data=val))
        torch.cuda.synchronize()
        return best, Recording.made[-1]

    # 1. checkpointed fit: A whole; B crashed inside iteration 2, then rerun
    launches = {}
    with fused_glm.fused_override(True):
        zero_counts()
        t = time.perf_counter()
        a, ck_a = fit(os.path.join(work, "a"))
        seconds_a = time.perf_counter() - t
        launches["A"] = read_counts()["fused_loss_grad_sums"]
        zero_counts()
        try:
            with armed("coord.update:crash:4"):  # the first update of iteration 2
                fit(os.path.join(work, "b"))
            fail("model after fit: the armed crash did not fire")
        except InjectedCrash:
            pass
        b, ck_b = fit(os.path.join(work, "b"))
        launches["B"] = read_counts()["fused_loss_grad_sums"]
    gen_dir = list_generations(os.path.join(work, "b", "config_0"))[-1][1]
    state = load_checkpoint(os.path.join(work, "b", "config_0"), device="cuda")
    resumed_ok = (_same_tables(a.model, b.model) and _same_tables(a.best_model, b.best_model)
                  and a.best_metric == b.best_metric
                  and state["completed_iterations"] == ESTIMATOR_ITERATIONS)
    tail = [m for _, _, m in a.descent.metrics_history][-len(b.descent.metrics_history):]
    resumed_ok = resumed_ok and tail == [m for _, _, m in b.descent.metrics_history]
    kept = len(list_generations(os.path.join(work, "a", "config_0")))
    print(f"model after fit: checkpointed fit A {seconds_a:.3f} s, B1 launches A {launches['A']} "
          f"B {launches['B']}; saves {ck_a.save_seconds} s, restore "
          f"{ck_b.restore_seconds} s (B rerun), {_tree_bytes(gen_dir)} bytes per generation, "
          f"{kept} generations kept; resume bitwise {resumed_ok}, best AUC {b.best_metric:.6f}")
    if not resumed_ok:
        fail("model after fit: the resumed fit differs from the uninterrupted one")
    if not (launches["A"] > 0 and launches["B"] > 0):
        fail(f"model after fit: B1 launches {launches}")

    # 2. the best and the final model through the reference's Avro layout and back
    maps = interop.glmix_index_maps()
    loaded = {}
    for which, model in (("best", a.best_model), ("final", a.model)):
        model_dir = os.path.join(work, which)
        t = time.perf_counter()
        save_game_model(model_dir, model, maps)
        save_s = time.perf_counter() - t
        t = time.perf_counter()
        loaded[which] = load_game_model(model_dir, maps, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        avro_ok = _same_tables(model, loaded[which])
        print(f"model after fit: the {which} model's Avro save {save_s:.3f} s, load "
              f"{load_s:.3f} s, {_tree_bytes(model_dir)} bytes; tables bitwise {avro_ok}")
        if not avro_ok:
            fail(f"model after fit: the Avro round trip changed a table of the {which} model")

    # 3. GameTransformer on the validation rows
    val_s = _with_str_ids(val)
    final = loaded["final"]
    loaded = loaded["best"]
    t = time.perf_counter()
    scores, metrics = GameTransformer(model=loaded, evaluators=[EvaluatorType.AUC]).transform(val_s)
    transform_s = time.perf_counter() - t
    eager_scores, _ = GameTransformer(model=loaded, engine="eager").transform(val_s)
    auc_gap = abs(metrics["AUC"] - a.best_metric)
    same = scores.dtype == eager_scores.dtype and np.array_equal(scores, eager_scores)
    print(f"model after fit: transform {val.n} rows {transform_s:.3f} s, AUC {metrics['AUC']:.6f} "
          f"(fit {a.best_metric:.6f}, gap {auc_gap:.2e}, limit {TRANSFORM_AUC_AGREE}); "
          f"engine vs eager bitwise {same}")
    if not (auc_gap <= TRANSFORM_AUC_AGREE and same):
        fail("model after fit: transform disagrees with the fit or with the eager scorer")

    # 4. the serving engine over a request stream
    entity_ids = {m.re_type: np.asarray(m.entity_ids) for _, m in loaded if hasattr(m, "coeffs")}
    requests = _serving_requests(entity_ids)
    eng = get_engine(loaded)
    eng.score(requests[0])  # warm-up: captures the 4,096 bucket's graph
    warm = eng.capture_count
    latencies = []
    t0 = time.perf_counter()
    for req in requests:
        t = time.perf_counter()
        eng.score(req)
        latencies.append(time.perf_counter() - t)
    elapsed = time.perf_counter() - t0
    captures = eng.capture_count - warm
    samples = sum(r.n for r in requests)
    prep = []  # the host's share of a request: its numpy preparation alone
    for req in requests:
        t = time.perf_counter()
        eng._prepare(req)
        prep.append(time.perf_counter() - t)
    eager = GameTransformer(model=loaded, engine="eager")
    eager.score(requests[0])
    t = time.perf_counter()
    eager_samples = sum(len(eager.score(r)) for r in requests[:SERVE_EAGER_REQUESTS])
    eager_rate = eager_samples / (time.perf_counter() - t)
    probe = requests[0]
    s_engine, s_eager = eng.score(probe), eager.score(probe)
    probe_ok = s_engine.dtype == s_eager.dtype and np.array_equal(s_engine, s_eager)
    s_final = get_engine(final).score(probe)  # the final model's tables are not zero
    probe_ok = probe_ok and np.array_equal(
        s_final, GameTransformer(model=final, engine="eager").score(probe))
    host = host_link(loaded.task, s_engine)  # numpy's f32 link of the engine's margins
    predicted = eng.predict(probe)
    link_ulps = int(np.max(np.abs(predicted.view(np.int32).astype(np.int64)
                                  - host.view(np.int32).astype(np.int64))))
    small = _serving_requests(entity_ids, seed=8)[0].select(np.arange(100))
    before = eng.capture_count
    first_small = eng.score(small)
    again_small = eng.score(small)
    small_ok = (eng.capture_count == before + 1 and np.array_equal(first_small, again_small)
                and np.array_equal(first_small, eager.score(small)))
    eng16 = get_engine(loaded, precision="bf16")
    s16 = eng16.score(probe)
    bf16_dev = float(np.abs(s16 - s_engine).max())
    bf16_limit = BF16_AGREE * (float(np.abs(s_engine).max()) + 1e-6)
    held = max(eng.graph_bytes().values())  # the 4,096-row bucket's graph is the largest
    lat = np.asarray(latencies) * 1e3
    print(f"serving: {len(requests)} requests, {samples} samples in {elapsed:.4f} s: "
          f"{samples / elapsed:.0f} samples/s, p50 {np.percentile(lat, 50):.3f} ms, "
          f"p99 {np.percentile(lat, 99):.3f} ms (request preparation p50 "
          f"{np.percentile(np.asarray(prep) * 1e3, 50):.3f} ms); captures after warm-up {captures}; eager "
          f"{eager_rate:.0f} samples/s on {SERVE_EAGER_REQUESTS} requests "
          f"({samples / elapsed / eager_rate:.1f}x); probe bitwise {probe_ok}; predict vs host "
          f"link {link_ulps} f32 ulps; 100-row request captured once and replayed {small_ok}; "
          f"bf16 engine largest deviation {bf16_dev:.3e} (limit {bf16_limit:.3e}); the "
          f"{eng.bucket(SERVE_BATCH)}-row bucket's graph holds {held} bytes")
    if captures != 0 or not probe_ok or not small_ok:
        fail("serving: a capture after warm-up, or the engine disagrees with the eager scorer")
    if link_ulps > LINK_ULPS or not bf16_dev <= bf16_limit:
        fail("serving: predict or the bf16 engine out of tolerance")
    shutil.rmtree(work, ignore_errors=True)
    return launches["A"] + launches["B"]


def _syncs():
    from photon_ml_tpu_torch.device import to_host
    from photon_ml_tpu_torch.optimization.common import any_lane

    return any_lane.syncs + to_host.transfers


def run_elastic_net():
    """Phase 11a: config #2's elastic-net half, linear and Poisson OWLQN
    through GLMOptimizationProblem.run on Path T's data, fused then stock.
    Returns the fused solves' counts, summed."""
    import torch

    from photon_ml_tpu_torch import interop
    from photon_ml_tpu_torch.data.dataset import LabeledData
    from photon_ml_tpu_torch.ops import fused_glm
    from photon_ml_tpu_torch.optimization.common import OptimizerConfig
    from photon_ml_tpu_torch.optimization.config import (
        GLMOptimizationConfiguration,
        RegularizationContext,
    )
    from photon_ml_tpu_torch.optimization.problem import GLMOptimizationProblem
    from photon_ml_tpu_torch.types import RegularizationType, TaskType

    n, d = PATH_T_SHAPE
    wl = interop.make_glm_workload(seed=2, n_samples=n, n_features=d)
    total = {}
    for task, key, truth in ((TaskType.LINEAR_REGRESSION, "y_linear", wl["w"]),
                             (TaskType.POISSON_REGRESSION, "y_poisson", wl["w"] * 0.25)):
        problem = GLMOptimizationProblem(task=task, configuration=GLMOptimizationConfiguration(
            OptimizerConfig(optimizer_type="OWLQN", max_iterations=100),
            RegularizationContext(RegularizationType.ELASTIC_NET, 0.5), ELASTIC_NET_WEIGHT))
        data = LabeledData.build(wl["X"], wl[key], dtype=torch.float32, device="cuda")
        truth = torch.as_tensor(truth, dtype=torch.float32, device="cuda")
        runs = []
        for fuse in (True, False):
            kind = "fused" if fuse else "stock"
            with fused_glm.fused_override(fuse):
                torch.cuda.synchronize()
                zero_counts()
                syncs0 = _syncs()
                t0 = time.perf_counter()
                model, res = problem.run(data)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                counts = read_counts()
            coef = model.coefficients.means
            err = float((coef - truth).abs().max())
            zeros = int((coef == 0).sum())
            print(f"11a elastic net {task.value} {kind}: {seconds:.4f} s, host syncs "
                  f"{_syncs() - syncs0}, launches {counts}")
            print(f"11a elastic net {task.value} {kind}: value {float(res.value):.6f} iterations "
                  f"{int(res.iterations)} {res.reason_name()}, exact zeros {zeros} of {d}, "
                  f"max |coef - generating| {err:.4f}")
            if not bool(torch.isfinite(coef).all()) or not err <= PATH_T_RECOVERY:
                fail(f"11a {task.value} {kind}: coefficients miss the generating ones by {err}")
            runs.append((fuse, float(res.value), counts))
        check_launches(f"11a {task.value}", runs, ["fused_loss_grad_sums"])
        gap_check(f"11a {task.value} fused vs stock", runs[0][1], runs[1][1], PATH_T_AGREE)
        total = {k: v + total.get(k, 0) for k, v in runs[0][2].items()}
    return total


def run_direct_pass(wl, anchor, re_iters):
    """Phase 11b: the flagship pass with re_solver="direct", fused then
    stock. Returns the fused run's counts."""
    runs, _ = run_glmix("LBFGS", "11b direct", wl, re_solver="direct", order=(True, False))
    check_launches("11b direct", runs, ["fused_loss_grad_sums"])
    for fuse, value, _, _, re_mean in runs:
        print(f"11b direct {'fused' if fuse else 'stock'}: mean RE iterations per bucket "
              f"{re_mean:.2f} (phase 6 L-BFGS stock {re_iters:.2f})")
        gap_check(f"11b direct {'fused' if fuse else 'stock'} vs L-BFGS stock", value, anchor,
                  FLAGSHIP_QUALITY)
    return runs[0][2]


def run_slice6_fits(train, val):
    """Phase 11c: three GameEstimator.fits on phase 9's split, each fused
    then stock (the fused FE objective within 1% of the stock one).
    (i) NEWTON FE on the shard with an intercept and shifted columns, both
    shards standardized, RE "auto", checkpointed: run A whole, run B crashed by
    coord.update:crash:4 and resumed, equal to A bitwise with its "auto"
    record; (ii) OWLQN elastic-net FE, RE "direct"; (iii) LBFGSB FE in a
    box from a constraint string. Returns the counts of the fused fits
    ((i)'s run A, (ii) and (iii)), summed."""
    import dataclasses
    import shutil

    import numpy as np
    import torch

    from photon_ml_tpu_torch import interop
    from photon_ml_tpu_torch.estimators import CoordinateConfiguration, FixedEffectDataConfiguration
    from photon_ml_tpu_torch.io.checkpoint import load_checkpoint
    from photon_ml_tpu_torch.normalization import FeatureDataStatistics, NormalizationContext
    from photon_ml_tpu_torch.ops import fused_glm
    from photon_ml_tpu_torch.optimization.common import OptimizerConfig
    from photon_ml_tpu_torch.optimization.config import (
        GLMOptimizationConfiguration,
        RegularizationContext,
    )
    from photon_ml_tpu_torch.optimization.constraints import build_bound_vectors
    from photon_ml_tpu_torch.resilience import InjectedCrash, armed
    from photon_ml_tpu_torch.types import NormalizationType, RegularizationType

    def with_icpt(gi):
        X = gi.features["global"]
        icpt = np.hstack([np.ones((len(X), 1), X.dtype), X + np.asarray(SHARD_SHIFT, X.dtype)])
        return dataclasses.replace(gi, features=dict(gi.features, global_icpt=icpt))

    train_i, val_i = with_icpt(train), with_icpt(val)
    norms = {shard: NormalizationContext.build(
        NormalizationType.STANDARDIZATION,
        FeatureDataStatistics.compute(train_i.features[shard], intercept_index=0))
        for shard in ("global_icpt", "re")}
    d = train.features["global"].shape[1]
    text = json.dumps([{"name": f"f{j}", "term": "", "lowerBound": -BOX, "upperBound": BOX}
                       for j in range(d // 2)])
    lo, hi = build_bound_vectors(text, interop.glmix_index_maps(n_features=d)["global"])

    def fe_config(opt, reg=RegularizationType.L2, alpha=None, weight=1.0):
        return GLMOptimizationConfiguration(OptimizerConfig(optimizer_type=opt, max_iterations=50),
                                            RegularizationContext(reg, alpha), weight)

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_phase11")
    shutil.rmtree(work, ignore_errors=True)
    newton = CoordinateConfiguration(FixedEffectDataConfiguration("global_icpt"),
                                     fe_config("NEWTON"))
    fits = {
        "(i) NEWTON normalized, RE auto": (
            lambda ck: flagship_estimator(fe=newton, normalization_contexts=norms,
                                          re_solver="auto", checkpoint_directory=ck),
            train_i, val_i),
        "(ii) OWLQN elastic net, RE direct": (
            lambda ck: flagship_estimator(fe=CoordinateConfiguration(
                FixedEffectDataConfiguration("global"),
                fe_config("OWLQN", RegularizationType.ELASTIC_NET, 0.5, ELASTIC_NET_WEIGHT)),
                re_solver="direct"), train, val),
        "(iii) LBFGSB in a box, RE L-BFGS": (
            lambda ck: flagship_estimator(fe=CoordinateConfiguration(
                FixedEffectDataConfiguration("global"), fe_config("LBFGSB"),
                box_constraints=(lo, hi))), train, val),
    }
    total, results, fit_counts, fe_coefs = {}, {}, {}, {}
    for label, (make, tr, va) in fits.items():
        values = {}
        for fuse in (True, False):
            kind = "fused" if fuse else "stock"
            with fused_glm.fused_override(fuse):
                torch.cuda.synchronize()
                zero_counts()
                syncs0 = _syncs()
                t0 = time.perf_counter()
                est = make(os.path.join(work, "a" if fuse else "stock"))
                best = est.select_best_model(est.fit(tr, validation_data=va))
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                counts = read_counts()
            descent = best.descent
            values[kind] = descent.trackers["global"][-1].final_value
            fe = best.model.get_model("global").model.coefficients.means
            fe_coefs[label, kind] = fe
            print(f"11c {label} {kind}: fit {seconds:.3f} s (dataset build included), host "
                  f"syncs {_syncs() - syncs0}, launches {counts}")
            print(f"11c {label} {kind}: FE iterations "
                  f"{[t.iterations for t in descent.trackers['global']]}, FE objective "
                  f"{values[kind]:.6f}, exact zeros {int((fe == 0).sum())} of {fe.numel()}, "
                  f"validation AUC best {best.best_metric:.6f} final "
                  f"{descent.metrics_history[-1][2]['AUC']:.6f}, incidents {len(descent.incidents)}")
            if descent.incidents or not math.isfinite(best.best_metric) \
                    or not bool(torch.isfinite(fe).all()):
                fail(f"11c {label} {kind}: a rejected update, or a non-finite model or AUC")
            if (counts["fused_loss_grad_sums"] > 0) != fuse:
                fail(f"11c {label} {kind}: B1 launched {counts['fused_loss_grad_sums']} times")
            if fuse:
                total = {k: v + total.get(k, 0) for k, v in counts.items()}
                fit_counts[label], results[label] = counts, best
        gap_check(f"11c {label} fused vs stock", values["fused"], values["stock"],
                  FLAGSHIP_QUALITY)
    first = "(i) NEWTON normalized, RE auto"
    shifts = float(np.abs(norms["global_icpt"].shifts).max())
    b3 = fit_counts[first]["fused_hessian_matrix"]
    agree = float((fe_coefs[first, "fused"] - fe_coefs[first, "stock"]).abs().max())
    print(f"11c (i): largest |shift| of the FE shard {shifts:.4f}, B3 launches {b3}, fused vs "
          f"stock FE coefficients max abs diff {agree:.3e} (limit {SHIFTED_FE_AGREE})")
    if not (b3 > 0 and shifts > 1.0):
        fail("11c (i): B3 did not launch under shifts above 1")
    if not agree <= SHIFTED_FE_AGREE:
        fail("11c (i): fused and stock FE coefficients disagree under real shifts")
    box = results["(iii) LBFGSB in a box, RE L-BFGS"].model.get_model("global")
    fe = box.model.coefficients.means.cpu().numpy()
    lo, hi = lo.astype(fe.dtype), hi.astype(fe.dtype)  # the box the solve clamps to
    bound = int(((fe == lo) | (fe == hi)).sum())
    print(f"11c (iii): {bound} of {d // 2} box bounds bind")
    if not (np.all(fe >= lo) and np.all(fe <= hi)) or bound == 0:
        fail("11c (iii): a coefficient outside its box, or no bound binds")

    # (i) crashed in its first update of iteration 2, then resumed
    make, tr, va = fits[first]
    with fused_glm.fused_override(True):
        try:
            with armed("coord.update:crash:4"):
                make(os.path.join(work, "b")).fit(tr, validation_data=va)
            fail("11c (i): the armed crash did not fire")
        except InjectedCrash:
            pass
        syncs0 = _syncs()
        t0 = time.perf_counter()
        est = make(os.path.join(work, "b"))
        resumed = est.select_best_model(est.fit(tr, validation_data=va))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    whole = results[first]
    extra = [load_checkpoint(os.path.join(work, r, "config_0"), device="cuda")["extra"]
             for r in ("a", "b")]
    same = (_same_tables(whole.model, resumed.model)
            and _same_tables(whole.best_model, resumed.best_model)
            and whole.best_metric == resumed.best_metric and extra[0] == extra[1])
    print(f"11c (i) resumed after the crash: {seconds:.3f} s, host syncs {_syncs() - syncs0}; "
          f"bitwise equal to the whole fit, its auto record included: {same}; auto record "
          f"{json.dumps(extra[0])}")
    if not same:
        fail("11c (i): the resumed fit differs from the whole one")
    shutil.rmtree(work, ignore_errors=True)
    return total


def run_slice6(wl, anchor, re_iters, train, val):
    """Phase 11: L1 and elastic net, the direct RE solves, box constraints,
    normalization and the measured "auto" on the card. Returns the kernel
    launches of the path (11a's and 11c's fused solves, 11b's fused run)."""
    parts = [run_elastic_net(), run_direct_pass(wl, anchor, re_iters), run_slice6_fits(train, val)]
    return {k: sum(p.get(k, 0) for p in parts) for k in parts[0]}


def main() -> int:
    probe()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    import photon_ml_tpu_torch  # noqa: F401 - fails outside a checkout of the repo

    build()
    timing = {"b1": check_b1(), "b2": check_b2(), "b3": check_b3()}
    b1_launches, anchor, re_iters, wl = run_flagship()
    path_n = run_path_n(anchor, wl)
    path_t = run_path_t()
    train_wl, train, val = run_estimator()
    b1_after_fit = run_model_after_fit(train_wl, train, val)
    slice6 = run_slice6(wl, anchor, re_iters, train, val)
    source = "photon_ml_tpu_torch/ops/csrc/"
    kernels = []
    for key, name, src, replaces, launches in (
        ("b1", "fused_loss_grad_sums", "fused_glm.cu", "photon_ml_tpu/ops/pallas_glm.py:218",
         b1_launches + b1_after_fit + slice6["fused_loss_grad_sums"]),
        ("b2", "fused_hessian_vector_sums", "fused_glm.cu", "photon_ml_tpu/ops/pallas_glm.py:301",
         path_t["fused_hessian_vector_sums"] + slice6["fused_hessian_vector_sums"]),
        ("b3", "fused_hessian_matrix", "fused_hess.cu", "photon_ml_tpu/ops/pallas_glm.py:393",
         path_n["fused_hessian_matrix"] + slice6["fused_hessian_matrix"]),
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
