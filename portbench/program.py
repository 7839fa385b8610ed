"""What the benchmark takes from the program (``photon_ml_tpu_torch``): its
counters, its kernel loader and the optimizer configuration of a coordinate.
Imported only once a run has its card, so that the files under ``portbench``
alone refuse to run."""

from __future__ import annotations

import time


def counters() -> dict:
    """A snapshot of the program's own counters."""
    from photon_ml_tpu_torch.ops import fused_glm, fused_hess
    from photon_ml_tpu_torch.optimization.common import any_lane
    from photon_ml_tpu_torch.optimization.tron import truncated_conjugate_gradient

    return {
        "host_syncs": any_lane.syncs,
        "b1_launches": fused_glm.fused_loss_grad_sums.launches,
        "b2_launches": fused_glm.fused_hessian_vector_sums.launches,
        "b3_launches": fused_hess.fused_hessian_matrix.launches,
        "cg_steps": truncated_conjugate_gradient.steps,
    }


def delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in before}


def load_kernels(names) -> float:
    """Seconds to build (first run of a checkout) or load the program's
    kernel libraries ``names``."""
    from photon_ml_tpu_torch.ops import build

    t = time.perf_counter()
    for name in names:
        build.load(name)
    return time.perf_counter() - t


def coordinate_config(optimizer: str, max_iterations: int, tolerance: float, l2_weight: float):
    """The program's configuration of one L2-regularized coordinate solve."""
    from photon_ml_tpu_torch.optimization.common import OptimizerConfig
    from photon_ml_tpu_torch.optimization.config import (
        GLMOptimizationConfiguration,
        RegularizationContext,
    )
    from photon_ml_tpu_torch.types import RegularizationType

    return GLMOptimizationConfiguration(
        OptimizerConfig(optimizer_type=optimizer, max_iterations=int(max_iterations),
                        tolerance=float(tolerance)),
        RegularizationContext(RegularizationType.L2), float(l2_weight),
    )
