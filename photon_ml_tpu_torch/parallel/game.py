"""One GLMix coordinate-descent pass, on one device or over a mesh of ranks.

Port of photon_ml_tpu/parallel/game.py. The flagship model is a fixed
effect plus per-entity random effects (BASELINE.json config #3). One pass
(CoordinateDescent.scala:119-346) is:

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
  Cholesky); on CUDA an L-BFGS bucket solve replays its trips from the
  CUDA graphs its coordinate holds (optimization/bucket_graphs.py);
- RE score: a per-sample gather of each entity's coefficients.

The JAX package jits the pass over a device mesh. Here it runs eagerly:
on one ``device``, or, with data built over a ``parallel.mesh.Mesh`` of
several ranks, on every rank over its blocks (parallel/placement.py):

- the fixed effect's samples are sharded; each objective evaluation sums
  its data terms in one all_reduce, and with the kernels switched on B1
  (B2, B3) run on each rank's dense block (the JAX package's
  ``shard_mapped_glm_solver``); the [N] score is the ranks' blocks
  gathered;
- the random effects' entity blocks are sharded; the bucket solves need no
  communication, and one all_reduce per coordinate update returns the
  whole [N] score and the whole table (each sample and each row has one
  owning rank, so the sums are exact).

Score vectors and coefficients are the same on every rank. Padding
discipline: padded samples carry weight 0, and padded bucket entities
scatter into the junk coefficient row E, which the pass keeps at zero.
"""

from __future__ import annotations

import dataclasses
import functools
import operator
from typing import Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.data.dataset import LabeledData
from photon_ml_tpu_torch.data.matrix import (
    DesignMatrix,
    as_design_matrix_with_storage,
)
from photon_ml_tpu_torch.data.random_effect import RandomEffectDataset
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.function.losses import loss_for_task
from photon_ml_tpu_torch.function.objective import lane_sums
from photon_ml_tpu_torch.models.game import random_effect_view_score
from photon_ml_tpu_torch.normalization import NO_NORMALIZATION
from photon_ml_tpu_torch.optimization.bucket_graphs import BucketGraphs
from photon_ml_tpu_torch.optimization.config import GLMOptimizationConfiguration
from photon_ml_tpu_torch.optimization.precision import FLOAT32
from photon_ml_tpu_torch.optimization.solver_cache import (
    _fe_population_update_fn,
    _re_coordinate_update_fn,
    glm_solver,
    population_matvec,
    re_bucket_solver,
    solve_buckets,
)
from photon_ml_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_lanes,
    all_reduce_many,
    collective_region,
    gather_rows,
    local_rows,
    padded_rows,
)
from photon_ml_tpu_torch.types import TaskType, VarianceComputationType
from photon_ml_tpu_torch.util.timed import span

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ShardedREBucket:
    """One padded entity block: this rank's block of it on a mesh."""

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
    # on a mesh: this rank's rows of the [coeffs_rows, K] table (it scores
    # only their samples; the other rows of sample_entity_rows are -1)
    owned_rows: Optional[Tensor] = None
    coeffs_rows: Optional[int] = None
    # the bucket solves' CUDA graphs, captured in the first pass
    graphs: BucketGraphs = dataclasses.field(default_factory=BucketGraphs, init=False,
                                             repr=False, compare=False)


@dataclasses.dataclass(frozen=True)
class ShardedGameData:
    """Flagship GLMix training data: the fixed-effect design matrix (dense
    [N, D], or padded-COO sparse) + one ShardedRECoordinate per random
    effect. Over a ``mesh`` of several ranks ``fe_X``, ``labels``,
    ``offsets`` and ``weights`` are this rank's sample block, padded to a
    mesh multiple; ``global_offsets`` is the whole padded [N] offset vector
    and ``n_samples`` the true N."""

    fe_X: DesignMatrix
    labels: Tensor  # [N] (the rank's block on a mesh)
    offsets: Tensor  # [N]
    weights: Tensor  # [N]
    re: tuple
    mesh: Optional[Mesh] = None
    global_offsets: Optional[Tensor] = None
    n_samples: Optional[int] = None

    @property
    def n(self) -> int:
        """The (padded) global sample count."""
        if self.mesh is None:
            return self.labels.shape[0]
        return self.global_offsets.shape[0]

    @property
    def device(self) -> torch.device:
        return self.labels.device


def _on(data: ShardedGameData, device) -> torch.device:
    if data.mesh is not None:
        return data.mesh.device
    dev = resolve_device(device)
    if data.device != dev:
        raise ValueError(f"the data lives on {data.device}, not on {dev}")
    return dev


def build_sharded_game_data(
    fe_X,
    labels: np.ndarray,
    re_datasets: Sequence[RandomEffectDataset],
    mesh: Optional[Mesh] = None,
    *,
    offsets: Optional[np.ndarray] = None,
    weights: Optional[np.ndarray] = None,
    dtype=torch.float32,
    fe_storage_dtype=None,
    re_storage_dtype=None,
    device="cuda",
) -> ShardedGameData:
    """Place the flagship data on ``device`` in ``dtype``.

    ``fe_X`` is a dense [N, D] array or DenseDesignMatrix, or a scipy
    sparse matrix or SparseDesignMatrix (its sums in a fixed order on CUDA,
    data/matrix.py; it is never fused, and takes no storage dtype).
    ``fe_storage_dtype=torch.bfloat16`` stores it in bf16, cast on the host
    before the transfer: the objective then reads half the bytes, through
    kernel B1's and B3's bf16 modes when fused and ``_mxu_dot``'s bf16
    operands with f32 accumulation when not. ``re_storage_dtype`` does the
    same for the random-effect bucket blocks and the per-sample scoring
    values. Labels, weights, offsets, scores and coefficients keep
    ``dtype``.

    ``mesh``: every rank passes the whole input and keeps its blocks
    (parallel/placement.py), on the mesh's device; a mesh over a world of
    one rank keeps the whole as its block and still exchanges through its
    group. A mesh without a group (``make_mesh(1)`` in a plain process)
    takes the one-device layout on its device.
    """
    if mesh is not None:
        if mesh.has_group:
            return _build_on_mesh(fe_X, labels, re_datasets, mesh, offsets=offsets,
                                  weights=weights, dtype=dtype,
                                  fe_storage_dtype=fe_storage_dtype,
                                  re_storage_dtype=re_storage_dtype)
        device = mesh.device
    dev = resolve_device(device)
    fe_mat = as_design_matrix_with_storage(fe_X, fe_storage_dtype, dtype, dev)
    fe = LabeledData.build(fe_mat, labels, offsets, weights, dtype=dtype, device=dev)
    re_store = re_storage_dtype or dtype
    coords = []
    for ds in re_datasets:
        buckets = tuple(
            ShardedREBucket(
                entity_rows=b.entity_rows.to(dev),
                X=b.X.to(dtype=re_store).to(dev),
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
                sample_vals=ds.sample_vals.to(dtype=re_store).to(dev),
                n_entities=ds.n_entities,
                max_k=ds.max_k,
            )
        )
    return ShardedGameData(fe_X=fe.X, labels=fe.labels, offsets=fe.offsets,
                           weights=fe.weights, re=tuple(coords))


def _pad_view(rows: Tensor, cols: Tensor, vals: Tensor, n: int):
    """A scoring view padded to ``n`` samples that score 0."""
    extra = n - rows.shape[0]
    if extra <= 0:
        return rows, cols, vals
    return (torch.cat([rows, rows.new_full((extra,), -1)]),
            torch.cat([cols, cols.new_full((extra, cols.shape[1]), -1)]),
            torch.cat([vals, vals.new_zeros((extra, vals.shape[1]))]))


def _build_on_mesh(fe_X, labels, re_datasets, mesh: Mesh, *, offsets, weights, dtype,
                   fe_storage_dtype, re_storage_dtype) -> ShardedGameData:
    """This rank's blocks of the flagship data (see build_sharded_game_data)."""
    from photon_ml_tpu_torch.parallel.glm import shard_labeled_data
    from photon_ml_tpu_torch.parallel.placement import place_random_effect_dataset

    cpu = torch.device("cpu")
    fe_mat = as_design_matrix_with_storage(fe_X, fe_storage_dtype, dtype, cpu)
    whole = LabeledData.build(fe_mat, labels, offsets, weights, dtype=dtype, device=cpu)
    fe, n = shard_labeled_data(whole, mesh)
    n_pad = padded_rows(n, mesh.size)
    dev = mesh.device
    global_offsets = torch.cat([whole.offsets, whole.offsets.new_zeros(n_pad - n)]).to(dev)
    re_store = re_storage_dtype or dtype
    coords = []
    for ds in re_datasets:
        placed = place_random_effect_dataset(ds, mesh)
        rows, cols, vals = _pad_view(placed.sample_entity_rows, placed.sample_local_cols,
                                     placed.sample_vals, n_pad)
        coords.append(ShardedRECoordinate(
            buckets=tuple(
                ShardedREBucket(entity_rows=b.entity_rows, X=b.X.to(dtype=re_store),
                                labels=b.labels.to(dtype=dtype), weights=b.weights.to(dtype=dtype),
                                sample_ids=b.sample_ids)
                for b in placed.buckets),
            sample_entity_rows=rows, sample_local_cols=cols, sample_vals=vals.to(dtype=re_store),
            n_entities=placed.n_entities, max_k=placed.max_k,
            owned_rows=placed.owned_rows, coeffs_rows=placed.coeffs_rows,
        ))
    return ShardedGameData(fe_X=fe.X, labels=fe.labels, offsets=fe.offsets, weights=fe.weights,
                           re=tuple(coords), mesh=mesh, global_offsets=global_offsets,
                           n_samples=n)


def init_game_params(data: ShardedGameData, device="cuda") -> dict:
    """Zero-initialized parameters: fixed-effect coefficients [D] and one
    [E+1, K] table per random effect (row E is the junk row for bucket
    padding, kept zero by game_train_step). ``device`` may be the data's
    ``Mesh`` (the JAX signature's ``mesh``): over several ranks every table
    is [E+1 rounded up to the mesh size, K], the same on every rank."""
    if isinstance(device, Mesh):
        if data.mesh is not None:
            dtype, dev = data.labels.dtype, data.mesh.device
            fe = torch.zeros((data.fe_X.n_cols,), dtype=dtype, device=dev)
            re = tuple(torch.zeros((rc.coeffs_rows, rc.max_k), dtype=dtype, device=dev)
                       for rc in data.re)
            return {"fixed": fe, "re": re}
        device = device.device
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
    fe_l2=None,
    re_l2=None,
    re_solver: str = "lbfgs",
    device="cuda",
) -> tuple[dict, dict]:
    """One coordinate-descent pass over [fixed, re_0, re_1, ...].

    Each coordinate runs the optimizer of its config (LBFGS, OWLQN, TRON
    or NEWTON); ``re_solver`` picks the random effects' bucket solver.
    ``fuse_fe`` lets the fixed-effect objective take kernels B1, B2 and B3
    when the switch is on (ops/fused_glm.should_fuse). ``fe_l2``/``re_l2``
    override the configs' L2 weights (a scalar, and one per random effect).
    The input params are not modified.

    On data built over a mesh of several ranks (module docstring) every
    rank calls this with the same params, and the fixed-effect objective
    sums each evaluation's data terms over the ranks; with ``fuse_fe`` the
    kernels run on each rank's dense block.

    Returns (new params, diagnostics {fe_value, fe_iterations, total_scores,
    re_iterations_max}); diagnostics stay on the device. On a mesh
    ``total_scores`` is the whole padded [N] vector and
    ``re_iterations_max`` the maxima over this rank's bucket blocks.
    """
    with span("game.pass"):
        _on(data, device)
        task = TaskType(task)
        no_var = VarianceComputationType.NONE
        mesh = data.mesh

        fe_coef = params["fixed"]
        re_coeffs = list(params["re"])
        dtype, dev = fe_coef.dtype, fe_coef.device
        # filled on the device: a Python number through torch.as_tensor is a
        # blocking host-to-device copy on CUDA, a host sync every pass
        fe_l2 = torch.full((), fe_config.l2_weight if fe_l2 is None else float(fe_l2), dtype=dtype,
                           device=dev)
        re_l2 = [torch.full((), cfg.l2_weight if re_l2 is None else float(re_l2[i]), dtype=dtype,
                            device=dev) for i, cfg in enumerate(re_configs)]

        if mesh is None:
            def fe_scores(coef):
                return data.fe_X.matvec(coef)

            offsets = data.offsets
        else:
            def fe_scores(coef):
                return gather_rows(data.fe_X.matvec(coef), mesh)

            offsets = data.global_offsets

        def re_exchange(rc, coeffs, score):
            """The whole [N] score and table from this rank's rows: one all_reduce."""
            if mesh is None:
                return coeffs, score
            mine = torch.where(rc.owned_rows.unsqueeze(-1), coeffs,
                               torch.zeros((), dtype=coeffs.dtype, device=dev))
            coeffs, score = all_reduce_many(mesh.data_axis, [mine, score], "score")
            return coeffs, score

        fe_score = fe_scores(fe_coef)
        re_scores = [re_exchange(rc, w, _re_score(rc, w))[1] for rc, w in zip(data.re, re_coeffs)]
        total = fe_score + sum(re_scores) if re_scores else fe_score

        # ---- fixed-effect coordinate (partial = total - own) ----------------
        partial = total - fe_score
        if mesh is not None:
            partial = local_rows(partial, mesh, data.n)
        d = LabeledData(
            X=data.fe_X,
            labels=data.labels,
            offsets=data.offsets + partial,
            weights=data.weights,
        )
        l1 = fe_config.l1_weight or 0.0
        empty = torch.zeros((0,), dtype=dtype, device=dev)
        fe_solve = glm_solver(
            task, fe_config.optimizer_config, bool(l1), False, False, no_var,
            allow_fused=fuse_fe, psum_axis=None if mesh is None else mesh.sample_axis(),
        )
        fe_res, _ = fe_solve(d, fe_coef, fe_l2, l1, empty, empty, NO_NORMALIZATION)
        fe_coef = fe_res.coefficients
        fe_score = fe_scores(fe_coef)
        total = fe_score + sum(re_scores) if re_scores else fe_score

        # ---- random-effect coordinates --------------------------------------
        re_iter_maxes = []
        for i, (rc, cfg) in enumerate(zip(data.re, re_configs)):
            solve = re_bucket_solver(task, cfg.optimizer_config, bool(cfg.l1_weight), no_var,
                                     re_solver)
            offsets_plus = offsets + (total - re_scores[i])
            coeffs = re_coeffs[i].clone()
            l2_rows = torch.full((coeffs.shape[0],), 1.0, dtype=dtype, device=dev) * re_l2[i]
            with collective_region("entity_solve"):
                _, iters = solve_buckets(solve, rc.buckets, coeffs, None, offsets_plus, l2_rows,
                                         cfg.l1_weight or 0.0, graphs=rc.graphs)
            # the junk row (and the mesh padding rows) must stay zero
            coeffs[rc.n_entities :] = 0.0
            re_coeffs[i], re_scores[i] = re_exchange(rc, coeffs, _re_score(rc, coeffs))
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
    """``step(params) -> (params, diagnostics)`` over ``data`` on one
    device: the one-device form of ``make_jitted_game_step``. The fixed
    effect may fuse (``fuse_fe=True``); ``fuse_fe=False`` keeps it on the
    stock two-matmul path whatever the switch says."""
    dev = _on(data, device)
    re_configs = tuple(re_configs)

    def step(params):
        return game_train_step(data, params, task, fe_config, re_configs,
                               fuse_fe=fuse_fe, re_solver=re_solver, device=dev)

    return step


def make_jitted_game_step(
    data: ShardedGameData,
    task: TaskType,
    fe_config: GLMOptimizationConfiguration,
    re_configs: Sequence[GLMOptimizationConfiguration],
    mesh: Mesh,
    re_solver: str = "lbfgs",
):
    """``step(params) -> (params, diagnostics)``: one pass per call over
    ``mesh``, the data built over it. The fixed effect fuses when the
    switch is on: on one device, or on each rank's block (JAX's
    ``shard_mapped_glm_solver``). A one-rank mesh without a group issues
    no collective, JAX's single-device route; over a world of one rank the
    exchanges are real. ``step.data`` is the data, as on the JAX step."""
    if data.mesh is not None and data.mesh is not mesh:
        raise ValueError("the data was not built over this mesh (build_sharded_game_data(mesh=))")
    re_configs = tuple(re_configs)

    def step(params):
        return game_train_step(data, params, task, fe_config, re_configs, fuse_fe=True,
                               re_solver=re_solver, device=mesh.device)

    step.data = data
    return step


@dataclasses.dataclass(frozen=True)
class PopulationCoordinateSpec:
    """Static description of one coordinate inside the fused population
    sweep (hashable). The data rides separately (``population_sweep_fn``'s
    ``datas`` argument)."""

    cid: str
    kind: str  # "fe" | "re"
    opt_config: object  # OptimizerConfig (frozen dataclass, hashable)
    has_l1: bool
    n_entities: int = 0  # RE only
    down_sampling: bool = False  # FE only


def population_sweep_fn(
    task: TaskType,
    coord_specs: tuple,
    n_iterations: int,
    *,
    re_solver: str = "lbfgs",
    precision=None,
    min_freeze_iterations: int = 1,
    with_domination: bool = False,
    warm_start: bool = False,
    capture_pass_states: bool = False,
):
    """The settings axis on the GAME pass: ONE call covers ALL settings x
    ALL coordinates x ALL descent iterations. The per-coordinate bodies are
    EXACTLY the population update bodies (optimization/solver_cache.
    ``_re_coordinate_update_fn`` / ``_fe_population_update_fn`` with
    ``with_active=True``), so a fused lane and a per-update lane run the
    same update. A lane's offsets come from its own coordinates' scores
    only: no operation mixes lanes.

    Per-lane EARLY EXIT at pass boundaries, on the device (no host read per
    pass):

    - **convergence**: a lane whose total training score moved at most
      ``freeze_tol * (1 + max|score|)`` since the previous pass freezes: its
      remaining solves run zero iterations (masked stationary objective,
      ``solver_cache._masked_value_and_grad``), so the batched solves' trip
      counts follow the slowest SURVIVING lane. A negative ``freeze_tol``
      never freezes and takes the same code path.
    - **domination** (``with_domination=True``): a lane whose weighted mean
      training loss exceeds ``domination_bound`` (a host scalar, never a
      cross-lane reduction) freezes the same way; ``+inf`` disables it.

    Frozen lanes carry their committed state bitwise (the update bodies
    select-freeze), report no rejects and no solver iterations;
    ``frozen_at`` holds the completed passes at freeze time (-1 = ran every
    pass).

    ``sweep(coeffs0, lanes, active0, base_offsets, keep_us, freeze_tol,
    domination_bound, labels, weights, datas) -> (states, stats, guards,
    snapshots)`` with the JAX package's arguments: ``coeffs0`` cid ->
    [P, ...] initial tables (cold: scores are literal zeros; ``warm_start``:
    scored from the tables with the updates' own scorers), ``lanes`` cid ->
    per-lane hyperparameters (``l2_rows``/``l1`` RE, ``l2``/``l1``/``rates``
    FE), ``keep_us`` cid -> [n_iterations, N] down-sampling draws,
    ``labels``/``weights`` [N] (read under ``with_domination`` only),
    ``datas`` cid -> the coordinate's shared data (RE ``{"buckets",
    "norm_tables", "view"}``, FE ``{"data", "norm"}``). ``states`` cid ->
    ``{"coeffs", "score"}``, ``stats`` ``{"active", "frozen_at",
    "lane_iterations"}`` ([P] each), ``guards`` one ``(coefs_ok, value_ok,
    values)`` per update in (iteration, coordinate) order, ``snapshots``
    per-pass state copies under ``capture_pass_states``.
    """
    task = TaskType(task)
    precision = FLOAT32 if precision is None else precision
    reduced = not precision.is_reference
    loss = loss_for_task(task) if with_domination else None

    bodies = {}
    for spec in coord_specs:
        if spec.kind == "re":
            bodies[spec.cid] = _re_coordinate_update_fn(
                task, spec.opt_config, spec.has_l1, VarianceComputationType.NONE,
                spec.n_entities, re_solver, precision, with_active=True,
            )
        else:
            bodies[spec.cid] = _fe_population_update_fn(
                task, spec.opt_config, spec.has_l1, spec.down_sampling, with_active=True,
            )

    def _initial_score(spec, coeffs, data):
        if not warm_start:
            # a zero model scores EXACTLY zero: keep the literal (hostile NaN
            # features must not poison the init), as the per-update path does
            n = data["view"][0].shape[0] if spec.kind == "re" else data["data"].labels.shape[0]
            dtype = torch.promote_types(coeffs.dtype, torch.float32)
            return torch.zeros((coeffs.shape[0], n), dtype=dtype, device=coeffs.device)
        if spec.kind == "re":
            rows, cols, vals = data["view"]
            if reduced:
                return random_effect_view_score(coeffs.to(precision.accum_dtype), rows, cols,
                                                vals.to(precision.accum_dtype))
            return random_effect_view_score(coeffs, rows, cols, vals)
        return population_matvec(data["data"].X, coeffs)

    def sweep(coeffs0, lanes, active0, base_offsets, keep_us, freeze_tol, domination_bound,
              labels, weights, datas):
        specs = {s.cid: s for s in coord_specs}
        states = {cid: {"coeffs": coeffs0[cid],
                        "score": _initial_score(spec, coeffs0[cid], datas[cid])}
                  for cid, spec in specs.items()}
        active = active0
        p = active.shape[0]
        frozen_at = torch.full((p,), -1, dtype=torch.int32, device=active.device)
        lane_iters = torch.zeros((p,), dtype=torch.int32, device=active.device)
        guards, snapshots = [], []
        prev_total = functools.reduce(operator.add, (s["score"] for s in states.values()))
        for it in range(n_iterations):
            total = functools.reduce(operator.add, (s["score"] for s in states.values()))
            for cid, spec in specs.items():
                st, lane, data = states[cid], lanes[cid], datas[cid]
                partial = total - st["score"]
                offsets_pop = base_offsets.unsqueeze(0) + partial
                if spec.kind == "re":
                    coeffs, score, _var, ok, _reasons, iters = bodies[cid](
                        st["coeffs"], st["score"], None, offsets_pop, lane["l2_rows"],
                        lane["l1"], active, data["buckets"], data["norm_tables"], data["view"],
                    )
                    lane_iters = lane_iters + functools.reduce(
                        operator.add, (torch.sum(b, dim=-1).to(torch.int32) for b in iters))
                    guards.append((ok, None, None))
                else:
                    keep_u = keep_us[cid][it] if spec.down_sampling else None
                    coeffs, score, coefs_ok, value_ok, values, iters, _r = bodies[cid](
                        st["coeffs"], st["score"], offsets_pop, lane["l2"], lane["l1"],
                        lane["rates"], keep_u, active, data["data"], data["norm"],
                    )
                    lane_iters = lane_iters + iters.to(torch.int32)
                    guards.append((coefs_ok, value_ok, values))
                states[cid] = {"coeffs": coeffs, "score": score}
                total = partial + score
            if capture_pass_states:
                snapshots.append({cid: dict(s) for cid, s in states.items()})
            if it < n_iterations - 1:
                # the pass-boundary freeze check (not after the final pass: a
                # lane converging there skipped no work)
                delta = torch.amax(torch.abs(total - prev_total), dim=-1)
                scale = 1.0 + torch.amax(torch.abs(total), dim=-1)
                finished = delta <= freeze_tol * scale
                if with_domination:
                    per_sample = loss.loss(base_offsets.unsqueeze(0) + total, labels)
                    lane_loss = lane_sums(per_sample * weights) / torch.sum(weights)
                    finished = finished | (lane_loss > domination_bound)
                if (it + 1) >= min_freeze_iterations:
                    newly = active & finished
                    frozen_at = torch.where(newly, it + 1, frozen_at).to(torch.int32)
                    active = active & ~newly
            prev_total = total
        stats = {"active": active, "frozen_at": frozen_at, "lane_iterations": lane_iters}
        return states, stats, tuple(guards), tuple(snapshots)

    return sweep


def make_population_sweep_program(
    task: TaskType,
    coord_specs: tuple,
    n_iterations: int,
    *,
    re_solver: str = "lbfgs",
    precision=None,
    min_freeze_iterations: int = 1,
    with_domination: bool = False,
    warm_start: bool = False,
    capture_pass_states: bool = False,
    mesh=None,
):
    """The fused population sweep (:func:`population_sweep_fn`) as one
    callable, with the same arguments and outputs on one device and over a
    ``mesh``.

    A 1-D ``mesh`` splits the SETTINGS axis over its ranks, as the JAX
    package shards it over its devices: the lane arguments (``coeffs0``,
    ``lanes``, ``active0``) come whole, padded to a multiple of the rank
    count, and each rank runs the same sweep on its contiguous block of
    lanes over its own whole copy of the shared data (nothing along the
    data is sharded). The sweep has no collective inside (region
    ``settings_sweep``); after it ONE all_gather over the mesh axis (region
    ``settings_gather``, :func:`parallel.mesh.all_gather_lanes`) returns
    every lane's outputs to every rank: tables, scores, per-lane stats,
    guard flags and captured pass states. The lanes' products and sums run
    in fixed blocks of lanes (``function.objective.lane_products``), so a
    lane solves to the same bits on any rank as on one device. ``parallel/hlo_guards.
    assert_settings_axis_collective_free`` checks a trace of it."""
    sweep = population_sweep_fn(
        task, coord_specs, n_iterations, re_solver=re_solver, precision=precision,
        min_freeze_iterations=min_freeze_iterations, with_domination=with_domination,
        warm_start=warm_start, capture_pass_states=capture_pass_states,
    )
    if mesh is None:
        return sweep
    if len(mesh.axis_names) != 1:
        raise ValueError(
            f"population mesh must be 1-D (settings axis); got axes {mesh.axis_names}")
    axis = mesh.axes[mesh.axis_names[0]]

    def sweep_on_mesh(coeffs0, lanes, active0, base_offsets, keep_us, freeze_tol,
                      domination_bound, labels, weights, datas):
        p = active0.shape[0]
        if p % axis.size:
            raise ValueError(f"{p} lanes do not divide over the {axis.size} ranks of the mesh")
        b = p // axis.size
        mine = slice(axis.index * b, (axis.index + 1) * b)
        with collective_region("settings_sweep"):
            out = sweep({cid: t[mine] for cid, t in coeffs0.items()},
                        {cid: {k: v[mine] for k, v in lane.items()} for cid, lane in lanes.items()},
                        active0[mine], base_offsets, keep_us, freeze_tol, domination_bound,
                        labels, weights, datas)
        return all_gather_lanes(axis, out, "settings_gather")

    return sweep_on_mesh
