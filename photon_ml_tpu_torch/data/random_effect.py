"""Random-effect datasets: ragged per-entity data as dense bucketed blocks.

Port of photon_ml_tpu/data/random_effect.py (RandomEffectDataset.scala,
LocalDataset.scala). The host groups samples by entity once, then buckets
entities by (padded sample count, padded feature count) into dense
[E_b, S, K] blocks, so a batched optimizer solves a whole bucket as one set
of lanes; padding rows carry weight 0. A per-sample gathered view over the
full sample axis scores the coordinate without joins.

The build is host numpy, the same as the JAX package's, and only its
tensors are placed on ``device``: the same inputs give the same arrays, bit
for bit, with every option of the JAX build. The reservoir cap on active
data keeps a per-entity sample keyed by a blake2b seed and re-weights it
(RandomEffectDataset.scala:293-420); samples past the cap are passive
(scored, not trained). Entities under the lower bound train no model.
``features_max`` keeps each entity's columns of largest |Pearson
correlation| with the label (LocalDataset.scala:110-138). A
``data.projector.RandomProjector`` moves the features into its shared
projected space before the build, and ``entity_order`` and
``exclude_entities`` pin and shrink the entity rows for incremental
training.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Optional, Sequence

import numpy as np
import scipy.sparse as sp
import torch

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.util.timed import span

Tensor = torch.Tensor


def _entity_seed(entity_id: str, base_seed: int) -> int:
    """The reservoir's per-entity seed: a stable hash of (seed, entity), so
    the sample is reproducible on recomputation (the reference mixes keys
    with byteswap64, RandomEffectDataset.scala:394-402)."""
    h = hashlib.blake2b(f"{base_seed}:{entity_id}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little")


def _next_pow2(n: int, minimum: int) -> int:
    p = minimum
    while p < n:
        p *= 2
    return p


@dataclasses.dataclass(frozen=True)
class EntityBucket:
    """One padded block of entities with similar shapes.

    X is [E, S, K] in each entity's local (projected) space; sample_ids are
    global sample-axis positions (-1 padding).
    """

    entity_rows: Tensor  # [E] int32 - row into the dataset-wide entity table
    X: Tensor  # [E, S, K]
    labels: Tensor  # [E, S]
    weights: Tensor  # [E, S] (0 = padding)
    sample_ids: Tensor  # [E, S] int32 (-1 padding)

    @property
    def shape(self) -> tuple[int, int]:
        return self.X.shape[1], self.X.shape[2]


@dataclasses.dataclass
class RandomEffectDataset:
    """All per-entity training blocks + the per-sample scoring view for one
    (random-effect type, feature shard) coordinate."""

    re_type: str
    feature_shard_id: str
    entity_ids: tuple  # entities with active data, in row order
    buckets: list
    proj_indices: Tensor  # [E, K_max] global col ids (-1 pad)
    sample_entity_rows: Tensor  # [N] int32, -1 = entity has no model
    sample_local_cols: Tensor  # [N, nnz] int32 into the entity's K axis, -1 pad
    sample_vals: Tensor  # [N, nnz]
    n_samples: int
    n_active_samples: int = 0
    n_passive_samples: int = 0
    # a RandomProjector when the dataset lives in a shared projected space
    projector: Optional[object] = None
    # mesh placement (parallel/placement.py): the mesh, the table height
    # (E + 1 rounded up to the mesh size; row E is the junk row of padded
    # bucket lanes), this rank's rows of it ([coeffs_rows] bool), the real
    # lanes of its bucket blocks (host bool arrays) and every rank's entity
    # rows of each bucket block (host int arrays [ranks, lanes], E = padding)
    mesh: Optional[object] = None
    coeffs_rows: Optional[int] = None
    owned_rows: Optional[Tensor] = None
    lane_masks: Optional[tuple] = None
    block_rows: Optional[tuple] = None
    # the bucket solves' CUDA graphs (optimization/bucket_graphs.BucketGraphs),
    # made by the first solve of the buckets that takes them
    graphs: Optional[object] = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def n_entities(self) -> int:
        return len(self.entity_ids)

    @property
    def max_k(self) -> int:
        return self.proj_indices.shape[1]

    def scoring_view(self, model=None):
        """(entity_rows [N], local_cols [N, nnz], vals [N, nnz]) for
        RandomEffectModel.score_dataset."""
        return self.sample_entity_rows, self.sample_local_cols, self.sample_vals


def _resolve_merge_fraction(bucket_merge_fraction: Optional[float], device: torch.device) -> float:
    """The auto (None) bucket-merge policy, keyed on the port's own device.

    Consolidating rare bucket shapes trades padded FLOPs for fewer
    sequential bucket solves per pass: on an accelerator each solve is
    dispatch latency, so the trade wins (0.05); on the CPU the padding is
    real compute (0.0). ``PHOTON_BUCKET_MERGE`` overrides, as in the JAX
    package.
    """
    if bucket_merge_fraction is not None:
        return bucket_merge_fraction
    env = os.environ.get("PHOTON_BUCKET_MERGE", "").strip()
    if env:
        try:
            return float(env)
        except ValueError:
            raise ValueError(f"PHOTON_BUCKET_MERGE must be a number, got {env!r}") from None
    return 0.05 if device.type != "cpu" else 0.0


def _consolidate_buckets(
    bucket_members: dict, n_ent: int, merge_fraction: float
) -> dict:
    """Merge rare bucket shape classes into nearby larger shapes.

    Every bucket is a separate sequential vmapped-solver program per
    coordinate-descent pass — on TPU that is pure latency, so shape classes
    holding fewer than ``merge_fraction`` of the entities are folded into the
    partner bucket that wastes the fewest padded cells. Padding is inert by
    construction (weight-0 rows; zero columns keep their coefficients at 0
    under L2), so only shapes change, never results. A merge is only taken
    when its added padding stays below the current total cell count, which
    blocks pathological merges (e.g. one huge entity inflating everyone's
    sample axis).
    """
    if merge_fraction <= 0 or len(bucket_members) <= 1:
        return bucket_members
    merged = dict(bucket_members)
    # Cumulative padding growth is capped against the PRE-consolidation total
    # (a per-step budget would ratchet: each merge inflates the base the next
    # merge is judged against). At 1.0x the padded cell count can at most
    # double — a deliberate memory-for-latency trade: every removed bucket is
    # one fewer sequential solver program per coordinate-descent pass, and the
    # blocks are small relative to HBM.
    budget = 1.0 * sum(len(m) * s * k for (s, k), m in merged.items())
    added_total = 0.0
    skip: set = set()  # shapes whose every merge exceeds the budget
    while True:
        candidates = sorted(
            (len(m), key) for key, m in merged.items() if key not in skip
        )
        progressed = False
        for cnt, (s1, k1) in candidates:
            if cnt >= merge_fraction * n_ent:
                break  # candidates are sorted: nothing rarer remains
            m1 = merged[(s1, k1)]
            best = None
            for (s2, k2), m2 in merged.items():
                if (s2, k2) == (s1, k1):
                    continue
                S, K = max(s1, s2), max(k1, k2)
                added = (
                    (len(m1) + len(m2)) * S * K
                    - len(m1) * s1 * k1
                    - len(m2) * s2 * k2
                )
                if added_total + added <= budget and (best is None or added < best[0]):
                    best = (added, (s2, k2))
            if best is None:
                skip.add((s1, k1))  # unmergeable; keep trying the others
                continue
            added, (s2, k2) = best
            m2 = merged.pop((s2, k2))
            merged.pop((s1, k1))
            key = (max(s1, s2), max(k1, k2))
            combined = np.sort(np.concatenate([m1, m2]))
            if key in merged:
                combined = np.sort(np.concatenate([merged[key], combined]))
            merged[key] = combined
            added_total += added
            skip.clear()  # a merge changes the partner landscape
            progressed = True
            break  # re-sort candidates against the new bucket set
        if not progressed:
            break
    return merged


def build_random_effect_dataset(
    X: sp.spmatrix,
    entity_ids_per_sample: Sequence,
    re_type: str,
    feature_shard_id: str = "global",
    *,
    active_data_upper_bound: Optional[int] = None,
    active_data_lower_bound: int = 1,
    features_max: Optional[int] = None,
    labels: Optional[np.ndarray] = None,
    weights: Optional[np.ndarray] = None,
    intercept_index: Optional[int] = None,
    normalization=None,
    seed: int = 0,
    dtype=torch.float32,
    min_samples_pad: int = 8,
    min_features_pad: int = 4,
    bucket_merge_fraction: Optional[float] = None,
    scoring_only: bool = False,
    projector=None,
    entity_order: Optional[Sequence] = None,
    exclude_entities: Optional[set] = None,
    device="cuda",
) -> RandomEffectDataset:
    """Host-side construction of the bucketed random-effect dataset, with its
    tensors on ``device``. Same bucket shapes, rows and values as the JAX
    package's build on the same inputs and merge fraction.

    - ``active_data_upper_bound``: reservoir cap; kept samples get weight *
      count/cap, the others become passive.
    - ``active_data_lower_bound``: entities with fewer active samples train
      no model (their samples score 0).
    - ``features_max``: per-entity Pearson selection cap (needs labels); the
      intercept column is always kept.
    - ``normalization``: applied to the materialized training blocks,
      x' = (x - shift) * factor over every valid (sample, observed column)
      cell, zeros included; the scoring view keeps raw values, and the
      coordinate carries coefficients between the spaces.
    - ``scoring_only``: the scoring view alone, no training buckets and no
      labels needed; caps, filtering and selection do not apply.
    - ``projector``: a RandomProjector; the features, with the projector's
      own normalization, are projected first, and the dataset lives in that
      space (every entity observes the same k(+1) columns). Normalization
      must ride on the projector, so that scoring datasets agree.
    - ``entity_order``: entities in this sequence keep its relative order,
      unseen ones append sorted at the tail; ``exclude_entities`` get no
      bucket and no model row.
    """
    device = resolve_device(device)
    if projector is not None:
        if normalization is not None and projector.normalization is None:
            raise ValueError(
                "normalization must be carried BY the projector "
                "(make_projector(..., normalization=...)) so training and scoring "
                "datasets agree on the projected space"
            )
        X = projector.project_features(X)
        normalization = None
        intercept_index = (
            projector.projected_dim - 1 if projector.intercept_index is not None else None
        )
    if scoring_only:
        active_data_upper_bound = None
        active_data_lower_bound = 1
        features_max = None
    elif labels is None:
        raise ValueError(
            "labels are required to build training buckets; pass scoring_only=True "
            "for validation/transform datasets that only need the scoring view"
        )
    X = X.tocsr()
    n, d = X.shape
    base_weights = np.ones(n) if weights is None else np.asarray(weights, dtype=np.float64)
    ent = np.asarray(entity_ids_per_sample)
    if len(ent) != n:
        raise ValueError("entity ids and sample count mismatch")

    # ---- group samples by entity (the one-time 'shuffle') -------------------
    with span("data.re_build.group"):
        order = np.argsort(ent, kind="mergesort")
        sorted_ent = ent[order]
        boundaries = np.flatnonzero(sorted_ent[1:] != sorted_ent[:-1]) + 1
        if n:
            starts = np.concatenate([[0], boundaries])
            stops = np.concatenate([boundaries, [n]])
        else:
            starts = stops = boundaries
        active_rows: dict = {}
        weights_scale: dict = {}
        passive_count = 0
        for a, b in zip(starts, stops):
            e_id = sorted_ent[a]
            rows = order[a:b]
            count = len(rows)
            if active_data_upper_bound is not None and count > active_data_upper_bound:
                keys = np.random.default_rng(_entity_seed(str(e_id), seed)).random(count)
                keep = rows[np.argsort(keys, kind="mergesort")[:active_data_upper_bound]]
                active_rows[e_id] = np.sort(keep)
                weights_scale[e_id] = count / active_data_upper_bound
                passive_count += count - active_data_upper_bound
            else:
                active_rows[e_id] = np.sort(rows)
                weights_scale[e_id] = 1.0

        # lower-bound filter, exclusion, then the row order
        entities = [e for e, rows in active_rows.items() if len(rows) >= active_data_lower_bound]
        if exclude_entities:
            entities = [e for e in entities if e not in exclude_entities]
        if entity_order is not None:
            present = set(entities)
            known = [e for e in entity_order if e in present]
            known_set = set(known)
            entities = known + sorted(e for e in entities if e not in known_set)
        else:
            entities.sort()
        n_ent = len(entities)
        labels_arr = None if labels is None else np.asarray(labels, dtype=np.float64)

        # flat active-sample machinery shared by the observed-column computation
        # and the bucket fill
        lens = np.asarray([len(active_rows[e]) for e in entities], dtype=np.int64)
        act_concat = (
            np.concatenate([active_rows[e] for e in entities]) if n_ent
            else np.zeros(0, dtype=np.int64)
        )
        ent_row_per_act = np.repeat(np.arange(n_ent, dtype=np.int64), lens)
        act_starts = np.concatenate([[0], np.cumsum(lens)[:-1]]) if n_ent else lens
        s_local_per_act = np.arange(len(act_concat)) - np.repeat(act_starts, lens)
        counts_all = np.diff(X.indptr)
        c_act = counts_all[act_concat]
        total_act_nnz = int(c_act.sum())
        nnz_cum = np.concatenate([[0], np.cumsum(c_act)[:-1]]) if len(c_act) else c_act
        act_nnz_idx = (
            np.repeat(X.indptr[act_concat], c_act)
            + (np.arange(total_act_nnz) - np.repeat(nnz_cum, c_act))
        ).astype(np.int64)
        ent_of_act_nnz = np.repeat(ent_row_per_act, c_act)
        s_local_of_act_nnz = np.repeat(s_local_per_act, c_act)

    # ---- per-entity projection: sorted global cols observed in active rows,
    # or the Pearson-selected ones (a per-entity loop on that option only) --
    with span("data.re_build.projection"):
        if n_ent == 0:
            col_of = []
        elif features_max is None:
            keys = ent_of_act_nnz * d + X.indices[act_nnz_idx].astype(np.int64)
            uniq_keys = np.unique(keys)
            obs_counts = np.bincount(uniq_keys // d, minlength=n_ent)
            col_of = np.split((uniq_keys % d).astype(np.int32), np.cumsum(obs_counts)[:-1])
        else:
            col_of = []
            for e in entities:
                rows = active_rows[e]
                sub = X[rows]
                observed = np.unique(sub.indices) if sub.nnz else np.array([], dtype=np.int32)
                if len(observed) > features_max:
                    if labels_arr is None:
                        raise ValueError("features_max (Pearson selection) requires labels")
                    scores = _pearson_scores(sub, observed, labels_arr[rows])
                    keep_order = np.argsort(-scores, kind="mergesort")
                    kept = set(observed[keep_order[:features_max]].tolist())
                    if intercept_index is not None:
                        kept.add(intercept_index)
                    observed = np.asarray(sorted(kept), dtype=observed.dtype)
                col_of.append(observed.astype(np.int32))

    # ---- global nnz -> entity-local column ----------------------------------
    with span("data.re_build.local_cols"):
        s_ent_rows = np.full(n, -1, dtype=np.int32)
        uniq = np.asarray(entities)
        if len(uniq):
            # entity_order may leave the table unsorted: search through a sorter
            sorter = np.argsort(uniq, kind="mergesort")
            pos = np.searchsorted(uniq, ent, sorter=sorter)
            rows = sorter[np.clip(pos, 0, len(uniq) - 1)]
            s_ent_rows = np.where(uniq[rows] == ent, rows, -1).astype(np.int32)

        local = np.full(X.nnz, -1, dtype=np.int32)
        if n and X.nnz:
            rows_per_nnz = np.repeat(np.arange(n), counts_all)
            slot_per_nnz = np.arange(X.nnz) - np.repeat(X.indptr[:-1], counts_all)
            ent_per_nnz = s_ent_rows[rows_per_nnz]
            valid = ent_per_nnz >= 0
            if n_ent * d <= 50_000_000:
                lookup = np.full((max(n_ent, 1), d), -1, dtype=np.int32)
                for i, cols in enumerate(col_of):
                    lookup[i, cols] = np.arange(len(cols), dtype=np.int32)
                local[valid] = lookup[ent_per_nnz[valid], X.indices[valid]]
            else:
                local_of = [{int(c): k for k, c in enumerate(cols)} for cols in col_of]
                for t in np.flatnonzero(valid):
                    local[t] = local_of[ent_per_nnz[t]].get(int(X.indices[t]), -1)

    # ---- bucketing by (padded sample count, padded feature count) -----------
    with span("data.re_build.bucketing"):
        k_counts = np.asarray([len(c) for c in col_of], dtype=np.int64)
        bucket_members: dict = {}
        if n_ent:
            s_pads = np.asarray([_next_pow2(int(c), min_samples_pad) for c in lens])
            k_pads = np.asarray([_next_pow2(max(int(k), 1), min_features_pad) for k in k_counts])
            pad_keys = s_pads * (2**32) + k_pads
            for key in np.unique(pad_keys):
                bucket_members[(int(key >> 32), int(key & (2**32 - 1)))] = np.flatnonzero(
                    pad_keys == key)
            if not scoring_only:  # scoring datasets discard the buckets entirely
                bucket_members = _consolidate_buckets(
                    bucket_members, n_ent, _resolve_merge_fraction(bucket_merge_fraction, device)
                )

        # the projection table is as wide as the widest padded bucket
        max_k_all = max((k for _, k in bucket_members), default=min_features_pad)
        proj_table = np.full((n_ent, max_k_all), -1, dtype=np.int32)
        for i, cols in enumerate(col_of):
            proj_table[i, : len(cols)] = cols
        if scoring_only:
            bucket_members = {}
        scale_arr = np.asarray([weights_scale[e] for e in entities], dtype=np.float64)

        local_of_act_nnz = local[act_nnz_idx] if total_act_nnz else local[:0]
        # one stable sort groups the flat sample/nnz arrays by bucket
        sorted_keys = sorted(bucket_members.items())
        n_buckets = len(sorted_keys)
        bucket_id = np.full(max(n_ent, 1), -1, dtype=np.int64)
        e_local_all = np.zeros(max(n_ent, 1), dtype=np.int64)
        for b, (_, members) in enumerate(sorted_keys):
            bucket_id[members] = b
            e_local_all[members] = np.arange(len(members))
        act_order = (np.argsort(bucket_id[ent_row_per_act], kind="stable") if n_ent
                     else ent_row_per_act)
        act_bounds = np.searchsorted(bucket_id[ent_row_per_act][act_order],
                                     np.arange(n_buckets + 1))
        nnz_bucket = bucket_id[ent_of_act_nnz] if total_act_nnz else ent_of_act_nnz
        nnz_key = np.where(local_of_act_nnz >= 0, nnz_bucket, -1)
        nnz_order = np.argsort(nnz_key, kind="stable")
        nnz_bounds = np.searchsorted(nnz_key[nnz_order], np.arange(n_buckets + 1))

    # ---- each bucket's padded blocks, filled and put on the device ----------
    with span("data.re_build.placement"):
        def put(a, dt=None):
            return torch.as_tensor(a).to(device=device, dtype=dt)

        norm_factors = None
        norm_shifts = None
        if normalization is not None:
            if normalization.factors is not None:
                norm_factors = np.asarray(normalization.factors, dtype=np.float64)
            if normalization.shifts is not None:
                norm_shifts = np.asarray(normalization.shifts, dtype=np.float64)

        buckets = []
        for b, ((s_pad, k_pad), members) in enumerate(sorted_keys):
            eb = len(members)
            Xb = np.zeros((eb, s_pad, k_pad), dtype=np.float64)
            yb = np.zeros((eb, s_pad), dtype=np.float64)
            wb = np.zeros((eb, s_pad), dtype=np.float64)
            sb = np.full((eb, s_pad), -1, dtype=np.int32)
            ai = act_order[act_bounds[b] : act_bounds[b + 1]]
            el_s, sl_s = e_local_all[ent_row_per_act[ai]], s_local_per_act[ai]
            rows_s = act_concat[ai]
            if labels_arr is not None:
                yb[el_s, sl_s] = labels_arr[rows_s]
            wb[el_s, sl_s] = base_weights[rows_s] * scale_arr[ent_row_per_act[ai]]
            sb[el_s, sl_s] = rows_s
            # duplicate (row, col) entries sum, as toarray does
            ni = nnz_order[nnz_bounds[b] : nnz_bounds[b + 1]]
            flat = np.ravel_multi_index(
                (e_local_all[ent_of_act_nnz[ni]], s_local_of_act_nnz[ni], local_of_act_nnz[ni]),
                Xb.shape,
            )
            gv = X.data[act_nnz_idx[ni]].astype(np.float64)
            if norm_factors is not None:
                gv = gv * norm_factors[X.indices[act_nnz_idx[ni]]]
            Xb += np.bincount(flat, weights=gv, minlength=Xb.size).reshape(Xb.shape)
            if norm_shifts is not None:
                # x' = x*factor - shift*factor: the shift term reaches every valid
                # (sample, observed column) cell, zeros included
                base = np.zeros((eb, k_pad))
                for bi, i in enumerate(members):
                    cols = col_of[i]
                    sh = -norm_shifts[cols]
                    if norm_factors is not None:
                        sh = sh * norm_factors[cols]
                    base[bi, : len(cols)] = sh
                row_valid = np.arange(s_pad)[None, :] < lens[members][:, None]
                Xb += base[:, None, :] * row_valid[:, :, None]
            buckets.append(
                EntityBucket(
                    entity_rows=put(members.astype(np.int32)),
                    X=put(Xb, dtype),
                    labels=put(yb, dtype),
                    weights=put(wb, dtype),
                    sample_ids=put(sb),
                )
            )

    # ---- per-sample scoring view over the full sample axis ------------------
    with span("data.re_build.scoring_view"):
        nnz_max = max(int(counts_all.max()) if n else 1, 1)
        s_cols = np.full((n, nnz_max), -1, dtype=np.int32)
        s_vals = np.zeros((n, nnz_max), dtype=np.float64)
        if n and X.nnz:
            keep = local >= 0
            s_cols[rows_per_nnz[keep], slot_per_nnz[keep]] = local[keep]
            s_vals[rows_per_nnz[keep], slot_per_nnz[keep]] = X.data[keep]

        return RandomEffectDataset(
            re_type=re_type,
            feature_shard_id=feature_shard_id,
            entity_ids=tuple(entities),
            buckets=buckets,
            proj_indices=put(proj_table),
            sample_entity_rows=put(s_ent_rows),
            sample_local_cols=put(s_cols),
            sample_vals=put(s_vals, dtype),
            n_samples=n,
            n_active_samples=int(lens.sum()),
            n_passive_samples=passive_count,
            projector=projector,
        )


def _pearson_scores(sub: sp.csr_matrix, observed: np.ndarray, y: np.ndarray) -> np.ndarray:
    """|Pearson correlation| of each observed column with the label
    (LocalDataset.computePearsonCorrelationScore); constant columns, the
    intercept among them, score 1 so that they are kept."""
    dense = np.asarray(sub[:, observed].todense(), dtype=np.float64)
    s = len(y)
    if s <= 1:
        return np.ones(len(observed))
    xm = dense - dense.mean(axis=0, keepdims=True)
    ym = y - y.mean()
    denom = np.sqrt((xm**2).sum(axis=0) * (ym**2).sum())
    num = xm.T @ ym
    return np.where(denom > 0, np.abs(num / np.where(denom > 0, denom, 1.0)), 1.0)
