"""Optimizer dispatch. Port of photon_ml_tpu/optimization/factory.py
(reference optimization/OptimizerFactory.scala:37-80).

``build_minimizer`` maps an OptimizerConfig to a uniform callable
``minimize(value_and_grad, x0, *, l1_weight, hvp, hess, lower_bounds,
upper_bounds) -> OptResult``. The L1/L2 split follows RegularizationContext
(RegularizationContext.scala:38-134): L2 is folded into the smooth objective
by the caller and L1 routes to OWLQN. The JAX package's refusals are kept:
L1 without OWLQN, bounds with OWLQN and LBFGSB without bounds raise
``ValueError``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from photon_ml_tpu_torch.optimization.common import OptimizerConfig, OptResult
from photon_ml_tpu_torch.optimization.lbfgs import minimize_lbfgs
from photon_ml_tpu_torch.optimization.lbfgsb import minimize_lbfgsb
from photon_ml_tpu_torch.optimization.newton import minimize_newton
from photon_ml_tpu_torch.optimization.owlqn import minimize_owlqn
from photon_ml_tpu_torch.optimization.tron import minimize_tron
from photon_ml_tpu_torch.types import OptimizerType

Tensor = torch.Tensor


def build_minimizer(config: OptimizerConfig):
    """Returns minimize(value_and_grad, x0, *, l1_weight, hvp, hess, lower/upper_bounds)."""
    opt = OptimizerType(config.optimizer_type)

    def minimize(
        value_and_grad: Callable[[Tensor], tuple[Tensor, Tensor]],
        x0: Tensor,
        *,
        l1_weight=0.0,
        hvp: Optional[Callable[[Tensor, Tensor], Tensor]] = None,
        hess: Optional[Callable[[Tensor], Tensor]] = None,
        lower_bounds: Optional[Tensor] = None,
        upper_bounds: Optional[Tensor] = None,
    ) -> OptResult:
        # OWLQN never reads the weight on the host: no sync on its path
        if opt != OptimizerType.OWLQN and float(l1_weight) != 0.0:
            raise ValueError(
                f"L1 regularization requires OWLQN; {opt.value} would silently ignore it"
            )
        has_bounds = lower_bounds is not None or upper_bounds is not None
        if has_bounds and opt == OptimizerType.OWLQN:
            raise ValueError("OWLQN does not support box constraints")
        if opt == OptimizerType.OWLQN:
            return minimize_owlqn(
                value_and_grad, x0, l1_weight,
                max_iterations=config.max_iterations,
                tolerance=config.tolerance,
                history_length=config.history_length,
                max_line_search_iterations=config.max_line_search_iterations,
                track_states=config.track_states,
            )
        if opt == OptimizerType.NEWTON:
            if hess is None:
                raise ValueError("NEWTON requires a full-Hessian callable")
            return minimize_newton(
                value_and_grad, hess, x0,
                max_iterations=config.max_iterations,
                tolerance=config.tolerance,
                max_line_search_iterations=config.max_line_search_iterations,
                lower_bounds=lower_bounds,
                upper_bounds=upper_bounds,
                track_states=config.track_states,
            )
        if opt == OptimizerType.TRON:
            if hvp is None:
                raise ValueError("TRON requires a Hessian-vector-product callable")
            return minimize_tron(
                value_and_grad, hvp, x0,
                max_iterations=config.max_iterations,
                tolerance=config.tolerance,
                max_cg_iterations=config.max_cg_iterations,
                max_improvement_failures=config.max_improvement_failures,
                lower_bounds=lower_bounds,
                upper_bounds=upper_bounds,
                track_states=config.track_states,
            )
        if opt == OptimizerType.LBFGSB:
            if not has_bounds:
                raise ValueError("LBFGSB requires box bounds")
            inf = float("inf")
            return minimize_lbfgsb(
                value_and_grad, x0,
                lower_bounds if lower_bounds is not None else -inf,
                upper_bounds if upper_bounds is not None else inf,
                max_iterations=config.max_iterations,
                tolerance=config.tolerance,
                history_length=config.history_length,
                max_line_search_iterations=config.max_line_search_iterations,
                track_states=config.track_states,
            )
        # LBFGS, with post-step projection when bounds are given
        return minimize_lbfgs(
            value_and_grad, x0,
            max_iterations=config.max_iterations,
            tolerance=config.tolerance,
            history_length=config.history_length,
            max_line_search_iterations=config.max_line_search_iterations,
            lower_bounds=lower_bounds,
            upper_bounds=upper_bounds,
            track_states=config.track_states,
        )

    return minimize
