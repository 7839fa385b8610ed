"""GAME model containers: fixed-effect, random-effect, and the combined GameModel.

Port of photon_ml_tpu/models/game.py (photon-lib model/GameModel.scala:32-168,
photon-api model/FixedEffectModel.scala and model/RandomEffectModel.scala):

- FixedEffectModel: one GLM per feature shard.
- RandomEffectModel: per-entity coefficient rows in a dense [E, K] tensor in
  each entity's projected feature space, plus [E, K] global-column ids (the
  projection). Scoring is a gather and a batched dot over the sample axis.
- GameModel: ordered coordinate -> model map; the total score is the sum of
  the coordinate scores over the global sample axis.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.types import ModelType, TaskType

Tensor = torch.Tensor


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def row_sum(terms: Tensor) -> Tensor:
    """Sum over the last axis in a fixed pairwise order: the axis is padded
    with zeros to a power of two and halved by elementwise adds. Each row's
    bits depend on its own terms alone: not on the number of rows, not on
    trailing zero padding, and not on the device, since no reduction kernel
    (whose split can change with the shape) is involved. The serving engine
    pads requests in both axes, and this is what keeps its scores equal to
    the eager scorer's bit for bit."""
    width = terms.shape[-1]
    p = _pow2_at_least(width)
    if p != width:
        terms = torch.nn.functional.pad(terms, (0, p - width))
    while p > 1:
        p //= 2
        terms = terms[..., :p] + terms[..., p:]
    return terms[..., 0]


# Largest [rows, padded D] product one fixed-effect scoring chunk may hold.
FE_SCORE_CHUNK_BYTES = 64 << 20


def score_chunk_rows(n_cols: int, itemsize: int) -> int:
    """Rows per chunk of :func:`fixed_effect_view_score`: the most rows whose
    product, padded to :func:`row_sum`'s power-of-two width, fits in
    ``FE_SCORE_CHUNK_BYTES`` (one row when a single row is wider than that)."""
    return max(1, FE_SCORE_CHUNK_BYTES // (_pow2_at_least(max(n_cols, 1)) * itemsize))


def fixed_effect_view_score(values: Tensor, means: Tensor) -> Tensor:
    """[N] fixed-effect scores of a dense [N, D] block: the row-wise dot in
    :func:`row_sum`'s fixed order, in the promoted dtype of the two inputs.
    Validation, ``GameTransformer`` and the serving engine score through it;
    training keeps the GEMV (``DenseDesignMatrix.matvec``), whose per-row
    bits change with the row count on CUDA. The product is formed in row
    chunks of at most ``FE_SCORE_CHUNK_BYTES`` (:func:`score_chunk_rows`), never over
    the whole block; ``row_sum`` is row-independent, so the bits do not
    depend on the chunking."""
    itemsize = torch.empty((), dtype=torch.promote_types(values.dtype, means.dtype)).element_size()
    rows = score_chunk_rows(values.shape[-1], itemsize)
    if values.shape[0] <= rows:
        return row_sum(values * means)
    return torch.cat([row_sum(values[i : i + rows] * means)
                      for i in range(0, values.shape[0], rows)])


def random_effect_view_score(coeffs: Tensor, entity_rows: Tensor, local_cols: Tensor,
                             vals: Tensor) -> Tensor:
    """Per-sample gather/dot scoring over a scoring view: score[i] =
    sum_k coeffs[entity_rows[i], local_cols[i, k]] * vals[i, k], with -1
    entity rows (no model) and -1 column slots (padding, or columns the model
    never saw) contributing exactly 0. One implementation for
    ``RandomEffectModel.score_dataset``, the flagship pass, the
    random-effect update program and the serving engine, so every path runs
    the same ops in the same order; the sum over k is :func:`row_sum`, so a
    view padded in either axis scores the same bits. Indices are clamped
    before gathering, as ``jnp.take`` does."""
    has_model = entity_rows >= 0
    w = coeffs[torch.clamp_min(entity_rows, 0).long()]  # [N, K]
    gathered = torch.gather(w, 1, torch.clamp_min(local_cols, 0).long())  # [N, nnz]
    zero = torch.zeros((), dtype=gathered.dtype, device=gathered.device)
    gathered = torch.where(local_cols >= 0, gathered, zero)
    return torch.where(has_model, row_sum(gathered * vals), zero)


@dataclasses.dataclass(frozen=True)
class FixedEffectModel:
    """Global GLM for one feature shard (FixedEffectModel.scala:146)."""

    model: GeneralizedLinearModel
    feature_shard_id: str = "global"

    @property
    def model_type(self) -> ModelType:
        return ModelType.FIXED_EFFECT

    @property
    def task(self) -> TaskType:
        return self.model.task

    def score_dataset(self, dataset) -> Tensor:
        """Score a FixedEffectDataset (margins WITHOUT its offsets: coordinate
        scores exclude offsets so they can be summed across coordinates)."""
        return dataset.data.X.matvec(self.model.coefficients.means)


@dataclasses.dataclass(frozen=True)
class RandomEffectModel:
    """Per-entity GLMs as one dense coefficient tensor (RandomEffectModel.scala:36-304).

    coeffs[e] are entity e's coefficients in its projected space;
    proj_indices[e, k] is the global column id of local slot k (-1 = padding).
    Entities without a model score 0.
    """

    re_type: str  # entity id column, e.g. "userId"
    feature_shard_id: str
    task: TaskType
    entity_ids: tuple  # length E, position = row in coeffs
    coeffs: Tensor  # [E, K]
    proj_indices: Tensor  # [E, K] int32 global col ids, -1 pad
    variances: Optional[Tensor] = None  # [E, K]
    # set when coeffs live in a shared random-projection space (data/projector.py);
    # export goes through to_original_space()
    projector: Optional[object] = None

    def __post_init__(self):
        object.__setattr__(self, "_row_by_entity", {e: i for i, e in enumerate(self.entity_ids)})

    @property
    def model_type(self) -> ModelType:
        return ModelType.RANDOM_EFFECT

    @property
    def n_entities(self) -> int:
        return len(self.entity_ids)

    def row_for_entity(self, entity_id) -> int:
        """-1 if the entity has no model."""
        return self._row_by_entity.get(entity_id, -1)

    def coefficients_for_entity(self, entity_id) -> Optional[np.ndarray]:
        row = self.row_for_entity(entity_id)
        return None if row < 0 else self.coeffs[row].detach().cpu().numpy()

    def aligned_to(self, dataset) -> "RandomEffectModel":
        """This model's coefficients re-laid out in ``dataset``'s entity-row and
        projection-slot order, matched by entity id and global column id.
        Entities the model does not have, and slots whose column the entity's
        model never saw, get 0.

        A model trained on ``dataset`` carries its projection tensor and entity
        tuple and returns itself. Otherwise the re-layout runs as tensor ops on
        the dataset's device (one [E, K, K_model] column match), with no
        device-to-host read; only the entity-id lookup runs on the host."""
        if self.proj_indices is dataset.proj_indices and (
            self.entity_ids is dataset.entity_ids
            or self.entity_ids == tuple(dataset.entity_ids)
        ):
            return self
        dst_proj = dataset.proj_indices
        dev = dst_proj.device
        E, K = dst_proj.shape
        src_rows = torch.as_tensor(
            [self.row_for_entity(e) for e in dataset.entity_ids], dtype=torch.long
        ).to(dev)
        if self.n_entities == 0:  # nothing to gather from: every row stays 0
            src_rows = torch.full_like(src_rows, -1)
        rows = torch.clamp_min(src_rows, 0)
        src_proj = self.proj_indices.to(dev)
        src_proj = src_proj[rows] if self.n_entities else torch.full_like(dst_proj, -1)
        # slot k of entity i takes the model's slot holding the same column
        match = (dst_proj[:, :, None] == src_proj[:, None, :]) & (
            (dst_proj >= 0) & (src_rows >= 0)[:, None]
        )[:, :, None]
        found = match.any(dim=-1)
        slot = torch.argmax(match.to(torch.int32), dim=-1)  # the first match

        def remap(src: Tensor) -> Tensor:
            out = torch.zeros((E, K), dtype=src.dtype, device=dev)
            if self.n_entities == 0:
                return out
            return torch.where(found, torch.gather(src.to(dev)[rows], 1, slot), out)

        return dataclasses.replace(
            self,
            entity_ids=tuple(dataset.entity_ids),
            coeffs=remap(self.coeffs),
            proj_indices=dataset.proj_indices,
            variances=None if self.variances is None else remap(self.variances),
        )

    def score_dataset(self, dataset) -> Tensor:
        """Score a RandomEffectDataset-like object exposing its per-sample
        ``scoring_view()`` -> (entity_rows [N], local_cols [N, nnz], vals [N,
        nnz]) whose local cols index the DATASET's slot layout; the model is
        aligned to that layout first."""
        if getattr(dataset, "projector", None) is not None:
            raise NotImplementedError(
                "scoring a random-projection dataset is not ported yet: ROADMAP A8"
            )
        if self.projector is not None:
            # projected model vs original-space dataset: score via back-projection
            return self.to_original_space().score_dataset(dataset)
        model = self.aligned_to(dataset)
        entity_rows, local_cols, vals = dataset.scoring_view(model)
        return random_effect_view_score(model.coeffs, entity_rows, local_cols, vals)

    def update_entities(self, new_coeffs: Tensor,
                        variances: Optional[Tensor] = None) -> "RandomEffectModel":
        return dataclasses.replace(self, coeffs=new_coeffs, variances=variances)

    def to_original_space(self) -> "RandomEffectModel":
        """Back-project a random-projection model into the original feature
        space (coef_orig = P @ w, margin-invariant), on the host as in the JAX
        package, with the result placed where the coefficients were. No-op
        without a projector; variances do not survive the projection."""
        if self.projector is None:
            return self
        dev, dtype = self.coeffs.device, self.coeffs.dtype
        E = self.n_entities
        if E == 0:
            return dataclasses.replace(
                self,
                coeffs=torch.zeros((0, 1), dtype=dtype, device=dev),
                proj_indices=torch.full((0, 1), -1, dtype=torch.int32, device=dev),
                variances=None,
                projector=None,
            )
        proj_tbl = self.proj_indices.cpu().numpy()
        coeffs_src = self.coeffs.detach().cpu().numpy()
        W_proj = np.zeros((E, self.projector.projected_dim), dtype=coeffs_src.dtype)
        rows_idx, slots = np.nonzero(proj_tbl >= 0)
        W_proj[rows_idx, proj_tbl[rows_idx, slots]] = coeffs_src[rows_idx, slots]
        dense = self.projector.project_coefficients_back(W_proj)  # [E, d]
        nz = [np.flatnonzero(dense[i]) for i in range(E)]
        K = max((len(c) for c in nz), default=1) or 1
        coeffs = np.zeros((E, K), dtype=dense.dtype)
        proj = np.full((E, K), -1, dtype=np.int32)
        for i, cols in enumerate(nz):
            coeffs[i, : len(cols)] = dense[i, cols]
            proj[i, : len(cols)] = cols
        return dataclasses.replace(
            self,
            coeffs=torch.as_tensor(coeffs).to(device=dev, dtype=dtype),
            proj_indices=torch.as_tensor(proj).to(dev),
            variances=None,
            projector=None,
        )


@dataclasses.dataclass(frozen=True)
class GameModel:
    """Ordered coordinateId -> model (GameModel.scala:32-168)."""

    models: Mapping[str, object]  # str -> FixedEffectModel | RandomEffectModel

    def get_model(self, coordinate_id: str):
        return self.models.get(coordinate_id)

    def update_model(self, coordinate_id: str, model) -> "GameModel":
        if coordinate_id not in self.models:
            raise KeyError(f"Unknown coordinate {coordinate_id}")
        old = self.models[coordinate_id]
        if type(old) is not type(model):
            raise TypeError(
                f"Coordinate {coordinate_id}: cannot replace {type(old).__name__} "
                f"with {type(model).__name__} (GameModel type-consistency check)"
            )
        new = dict(self.models)
        new[coordinate_id] = model
        return GameModel(models=new)

    def select(self, coordinate_ids) -> "GameModel":
        """Sub-model over a subset of coordinates, in the given order."""
        missing = [c for c in coordinate_ids if c not in self.models]
        if missing:
            raise KeyError(f"Unknown coordinates {missing}")
        return GameModel(models={c: self.models[c] for c in coordinate_ids})

    @property
    def coordinate_ids(self) -> list[str]:
        return list(self.models.keys())

    @property
    def task(self) -> TaskType:
        for m in self.models.values():
            return m.task
        raise ValueError("Empty GAME model")

    def __iter__(self):
        return iter(self.models.items())

    def __len__(self):
        return len(self.models)
