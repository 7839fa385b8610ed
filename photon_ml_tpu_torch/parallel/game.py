"""One GLMix coordinate-descent pass on one device. Port of photon_ml_tpu/parallel/game.py.

The flagship model is a fixed effect plus per-entity random effects
(BASELINE.json config #3). One pass (CoordinateDescent.scala:119-346) is:

- FE score: ``fe_X @ coef``;
- FE solve: the configured optimizer (L-BFGS, OWL-QN, TRON or NEWTON) over the
  GLM objective with the other coordinates' scores as offsets; when fused,
  kernel B1 computes each value+gradient, B2 each TRON Hessian-vector
  product and B3 each NEWTON Hessian (up to 512 columns);
- RE solves: each random-effect coordinate's buckets as batched lanes of
  the configured optimizer, or of the direct Gram/Cholesky Newton solves
  under ``re_solver="direct"`` ("auto": for K <= 32), one lane per
  entity, never fused (NEWTON and the direct solves build the stock
  [E, K, K] Hessians and factor them with the unrolled small_linalg
  Cholesky);
- RE score: a per-sample gather of each entity's coefficients.

The JAX package jits the pass over a device mesh. Here the pass runs
eagerly on one device: ``device=`` replaces ``mesh``, and the dataclasses
keep the JAX names. Padding discipline is the same: padded samples carry
weight 0, and padded bucket entities would scatter into the junk
coefficient row E, which the pass keeps at zero.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.data.dataset import LabeledData
from photon_ml_tpu_torch.data.matrix import DenseDesignMatrix
from photon_ml_tpu_torch.data.random_effect import RandomEffectDataset
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.models.game import random_effect_view_score
from photon_ml_tpu_torch.normalization import NO_NORMALIZATION
from photon_ml_tpu_torch.optimization.config import GLMOptimizationConfiguration
from photon_ml_tpu_torch.optimization.solver_cache import (
    glm_solver,
    re_bucket_solver,
    solve_buckets,
)
from photon_ml_tpu_torch.types import TaskType, VarianceComputationType

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ShardedREBucket:
    """One padded entity block (unsharded here: the port runs on one device)."""

    entity_rows: Tensor  # [E_b] int32 into the coordinate's [E+1] table (E = junk)
    X: Tensor  # [E_b, S, K]
    labels: Tensor  # [E_b, S]
    weights: Tensor  # [E_b, S] (0 = padding)
    sample_ids: Tensor  # [E_b, S] int32 global sample ids, -1 pad


@dataclasses.dataclass(frozen=True)
class ShardedRECoordinate:
    """One random-effect coordinate: training buckets + per-sample scoring view."""

    buckets: tuple
    sample_entity_rows: Tensor  # [N] int32, -1 = no model
    sample_local_cols: Tensor  # [N, nnz] int32, -1 pad
    sample_vals: Tensor  # [N, nnz]
    n_entities: int
    max_k: int


@dataclasses.dataclass(frozen=True)
class ShardedGameData:
    """Flagship GLMix training data on one device: the dense fixed-effect
    design matrix + one ShardedRECoordinate per random effect."""

    fe_X: DenseDesignMatrix
    labels: Tensor  # [N]
    offsets: Tensor  # [N]
    weights: Tensor  # [N]
    re: tuple

    @property
    def n(self) -> int:
        return self.labels.shape[0]

    @property
    def device(self) -> torch.device:
        return self.labels.device


def _on(data: ShardedGameData, device) -> torch.device:
    dev = resolve_device(device)
    if data.device != dev:
        raise ValueError(f"the data lives on {data.device}, not on {dev}")
    return dev


def build_sharded_game_data(
    fe_X,
    labels: np.ndarray,
    re_datasets: Sequence[RandomEffectDataset],
    *,
    offsets: Optional[np.ndarray] = None,
    weights: Optional[np.ndarray] = None,
    dtype=torch.float32,
    device="cuda",
) -> ShardedGameData:
    """Place the flagship data on ``device``, all in ``dtype``.

    ``fe_X`` is a dense [N, D] array. The JAX form's bf16 storage options
    (``fe_storage_dtype``, ``re_storage_dtype``) are not ported yet.
    """
    dev = resolve_device(device)
    fe = LabeledData.build(fe_X, labels, offsets, weights, dtype=dtype, device=dev)
    coords = []
    for ds in re_datasets:
        buckets = tuple(
            ShardedREBucket(
                entity_rows=b.entity_rows.to(dev),
                X=b.X.to(device=dev, dtype=dtype),
                labels=b.labels.to(device=dev, dtype=dtype),
                weights=b.weights.to(device=dev, dtype=dtype),
                sample_ids=b.sample_ids.to(dev),
            )
            for b in ds.buckets
        )
        coords.append(
            ShardedRECoordinate(
                buckets=buckets,
                sample_entity_rows=ds.sample_entity_rows.to(dev),
                sample_local_cols=ds.sample_local_cols.to(dev),
                sample_vals=ds.sample_vals.to(device=dev, dtype=dtype),
                n_entities=ds.n_entities,
                max_k=ds.max_k,
            )
        )
    return ShardedGameData(fe_X=fe.X, labels=fe.labels, offsets=fe.offsets,
                           weights=fe.weights, re=tuple(coords))


def init_game_params(data: ShardedGameData, device="cuda") -> dict:
    """Zero-initialized parameters: fixed-effect coefficients [D] and one
    [E+1, K] table per random effect (row E is the junk row for bucket
    padding, kept zero by game_train_step)."""
    dev = _on(data, device)
    dtype = data.labels.dtype
    fe = torch.zeros((data.fe_X.n_cols,), dtype=dtype, device=dev)
    re = tuple(torch.zeros((rc.n_entities + 1, rc.max_k), dtype=dtype, device=dev) for rc in data.re)
    return {"fixed": fe, "re": re}


def _re_score(rc: ShardedRECoordinate, coeffs: Tensor) -> Tensor:
    """[N] scores via the per-sample gathered view (entities without a model
    score 0)."""
    return random_effect_view_score(coeffs, rc.sample_entity_rows, rc.sample_local_cols,
                                    rc.sample_vals)


def game_train_step(
    data: ShardedGameData,
    params: dict,
    task: TaskType,
    fe_config: GLMOptimizationConfiguration,
    re_configs: Sequence[GLMOptimizationConfiguration],
    fuse_fe: bool = False,
    re_solver: str = "lbfgs",
    device="cuda",
) -> tuple[dict, dict]:
    """One coordinate-descent pass over [fixed, re_0, re_1, ...].

    Each coordinate runs the optimizer of its config (LBFGS, OWLQN, TRON
    or NEWTON); ``re_solver`` picks the random effects' bucket solver.
    ``fuse_fe`` lets the fixed-effect objective take kernels B1, B2 and B3
    when the switch is on (ops/fused_glm.should_fuse). The input params
    are not modified.

    Returns (new params, diagnostics {fe_value, fe_iterations, total_scores,
    re_iterations_max}); diagnostics stay on the device.
    """
    _on(data, device)
    task = TaskType(task)
    no_var = VarianceComputationType.NONE

    fe_coef = params["fixed"]
    re_coeffs = list(params["re"])
    dtype, dev = fe_coef.dtype, fe_coef.device
    fe_l2 = torch.as_tensor(fe_config.l2_weight, dtype=dtype, device=dev)
    re_l2 = [torch.as_tensor(cfg.l2_weight, dtype=dtype, device=dev) for cfg in re_configs]

    fe_score = data.fe_X.matvec(fe_coef)
    re_scores = [_re_score(rc, w) for rc, w in zip(data.re, re_coeffs)]
    total = fe_score + sum(re_scores) if re_scores else fe_score

    # ---- fixed-effect coordinate (partial = total - own) --------------------
    d = LabeledData(
        X=data.fe_X,
        labels=data.labels,
        offsets=data.offsets + (total - fe_score),
        weights=data.weights,
    )
    empty = torch.zeros((0,), dtype=dtype, device=dev)
    fe_solve = glm_solver(
        task, fe_config.optimizer_config, bool(fe_config.l1_weight), False, False,
        no_var, allow_fused=fuse_fe,
    )
    fe_res, _ = fe_solve(d, fe_coef, fe_l2, fe_config.l1_weight or 0.0, empty, empty,
                         NO_NORMALIZATION)
    fe_coef = fe_res.coefficients
    fe_score = data.fe_X.matvec(fe_coef)
    total = fe_score + sum(re_scores) if re_scores else fe_score

    # ---- random-effect coordinates ------------------------------------------
    re_iter_maxes = []
    for i, (rc, cfg) in enumerate(zip(data.re, re_configs)):
        solve = re_bucket_solver(task, cfg.optimizer_config, bool(cfg.l1_weight), no_var, re_solver)
        offsets_plus = data.offsets + (total - re_scores[i])
        coeffs = re_coeffs[i].clone()
        l2_rows = torch.full((coeffs.shape[0],), 1.0, dtype=dtype, device=dev) * re_l2[i]
        _, iters = solve_buckets(solve, rc.buckets, coeffs, None, offsets_plus, l2_rows,
                                 cfg.l1_weight or 0.0)
        # the junk row must stay zero
        coeffs[rc.n_entities :] = 0.0
        re_coeffs[i] = coeffs
        re_scores[i] = _re_score(rc, coeffs)
        total = fe_score + sum(re_scores)
        # the batched loops run until every lane converges, so a bucket's
        # executed iteration count is the max over its entities
        re_iter_maxes.append(tuple(torch.max(it) for it in iters))

    new_params = {"fixed": fe_coef, "re": tuple(re_coeffs)}
    diagnostics = {
        "fe_value": fe_res.value,
        "fe_iterations": fe_res.iterations,
        "total_scores": total,
        "re_iterations_max": tuple(re_iter_maxes),
    }
    return new_params, diagnostics


def make_game_step(
    data: ShardedGameData,
    task: TaskType,
    fe_config: GLMOptimizationConfiguration,
    re_configs: Sequence[GLMOptimizationConfiguration],
    re_solver: str = "lbfgs",
    *,
    fuse_fe: bool = True,
    device="cuda",
):
    """``step(params) -> (params, diagnostics)`` over ``data``: the port's
    ``make_jitted_game_step``. As in the one-device JAX form the fixed effect
    may fuse (``fuse_fe=True``); ``fuse_fe=False`` keeps it on the stock
    two-matmul path whatever the switch says."""
    dev = _on(data, device)
    re_configs = tuple(re_configs)

    def step(params):
        return game_train_step(data, params, task, fe_config, re_configs,
                               fuse_fe=fuse_fe, re_solver=re_solver, device=dev)

    return step
