"""Shared optimizer infrastructure.

Port of photon_ml_tpu/optimization/common.py: the optimizer configuration,
the result record and the convergence reasons of the reference Optimizer
(relative tolerances made absolute from the INITIAL state; checks in the
order of Optimizer.getConvergenceReason).

Everything is batched-first: OptResult fields carry a leading lane axis when
the solve is batched, and convergence is per lane.

The JAX optimizers run as device-side while loops. Here each loop is a host
loop that asks the device whether any lane is still active, one
device-to-host sync per trip; :func:`any_lane` is that question, and
``any_lane.syncs`` counts how often it was asked.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from photon_ml_tpu_torch.types import ConvergenceReason, OptimizerType

Tensor = torch.Tensor

DEFAULT_TOLERANCE = 1e-7
DEFAULT_MAX_ITER = 100


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Static optimizer configuration (reference OptimizerConfig.scala:47)."""

    optimizer_type: OptimizerType = OptimizerType.LBFGS
    max_iterations: int = DEFAULT_MAX_ITER
    tolerance: float = DEFAULT_TOLERANCE
    history_length: int = 10
    # one budget shared by bracketing and zoom (see optimization/linesearch.py)
    max_line_search_iterations: int = 10
    max_cg_iterations: int = 20
    max_improvement_failures: int = 5
    track_states: bool = False

    def __post_init__(self):
        object.__setattr__(self, "optimizer_type", OptimizerType(self.optimizer_type))


class OptResult(NamedTuple):
    """Terminal optimizer state (+ optional per-iteration tracking tensors)."""

    coefficients: Tensor
    value: Tensor
    gradient: Tensor
    iterations: Tensor  # int - iterations actually performed
    convergence_reason: Tensor  # int - ConvergenceReason code
    # [..., max_iter + 1] objective values and gradient norms, NaN-padded
    tracked_values: Optional[Tensor] = None
    tracked_grad_norms: Optional[Tensor] = None

    def first_lane(self) -> "OptResult":
        """The result of a one-lane solve without its lane axis."""
        return OptResult(*(None if t is None else t[0] for t in self))

    def reason_name(self) -> str:
        """Human-readable convergence reason (scalar results only)."""
        return ConvergenceReason(int(self.convergence_reason)).name


def norm(x: Tensor) -> Tensor:
    """Euclidean norm over the last axis, sqrt(sum x^2) as jnp.linalg.norm."""
    return torch.sqrt(torch.sum(x * x, dim=-1))


def convergence_check(
    *,
    value: Tensor,
    prev_value: Tensor,
    grad: Tensor,
    iteration: Tensor,
    max_iterations: int,
    loss_abs_tol: Tensor,
    grad_abs_tol: Tensor,
    objective_failed: Tensor | bool = False,
) -> Tensor:
    """Per-lane ConvergenceReason code for the current state (0 = keep going).

    Order of checks matches Optimizer.getConvergenceReason
    (Optimizer.scala:135-149)."""

    def code(reason):
        return torch.full_like(iteration, int(reason), dtype=torch.int32)

    reason = torch.where(
        torch.abs(value - prev_value) <= loss_abs_tol,
        code(ConvergenceReason.FUNCTION_VALUES_CONVERGED),
        torch.where(
            norm(grad) <= grad_abs_tol,
            code(ConvergenceReason.GRADIENT_CONVERGED),
            code(ConvergenceReason.NOT_CONVERGED),
        ),
    )
    failed = torch.as_tensor(objective_failed, device=reason.device)
    reason = torch.where(failed, code(ConvergenceReason.OBJECTIVE_NOT_IMPROVING), reason)
    return torch.where(iteration >= max_iterations, code(ConvergenceReason.MAX_ITERATIONS), reason)


def init_tracking(max_iterations: int, f0: Tensor, g0_norm: Tensor, enabled: bool):
    """Fixed-size NaN-padded tracking tensors [B, max_iterations + 1] with
    slot 0 holding the initial state (the reference's states tracker);
    (None, None) when tracking is off."""
    if not enabled:
        return None, None
    shape = f0.shape + (max_iterations + 1,)
    values = torch.full(shape, float("nan"), dtype=f0.dtype, device=f0.device)
    gnorms = torch.full(shape, float("nan"), dtype=f0.dtype, device=f0.device)
    values[..., 0] = f0
    gnorms[..., 0] = g0_norm
    return values, gnorms


def record_tracking(values, gnorms, idx: Tensor, f: Tensor, gnorm: Tensor, active: Tensor):
    """Write (f, gnorm) at slot ``idx`` of every ``active`` lane; frozen lanes
    keep their record, as a vmapped while_loop keeps theirs."""
    if values is None:
        return None, None
    slot = torch.arange(values.shape[-1], device=values.device) == idx.unsqueeze(-1).long()
    slot = slot & active.unsqueeze(-1)
    return (torch.where(slot, f.unsqueeze(-1), values),
            torch.where(slot, gnorm.unsqueeze(-1), gnorms))


def any_lane(mask: Tensor) -> bool:
    """Whether any lane of ``mask`` is set: the host loops' one sync per trip."""
    any_lane.syncs += 1
    return bool(mask.any())


any_lane.syncs = 0
