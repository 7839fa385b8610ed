"""Ratings at MovieLens-20M's published scale, made on the device from a seed.

The per-user and per-movie rating counts follow a heavy tail fitted to the
source's totals: a log-normal in the count above the minimum, with the
configuration's median, cut at its maximum, its spread fitted so that the
counts add up to the rating total. The counts are the same for every seed: a seed only
decides which user or movie gets which count, which movie each rating goes
to, and the features and labels. So every seed gives the program the same
bucket shapes and the same work.

Features and labels follow the repository's flagship logistic process: a
standard-normal [N, D] design, a fixed effect of scale 0.3, per-user and
per-item effects of scale 0.4, Bernoulli labels through the sigmoid, and
random-effect features = intercept + the first ``re_features - 1`` columns.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.special import ndtri


def skewed_counts(total: int, n: int, minimum: int, median: float, maximum: int) -> np.ndarray:
    """``n`` whole counts in [minimum, maximum] that add up to ``total``,
    log-normal above ``minimum`` with the given median, in descending order.
    The same arguments always give the same counts."""
    if not minimum * n <= total <= maximum * n:
        raise ValueError(f"{total} cannot be split into {n} counts in [{minimum}, {maximum}]")
    z = ndtri((np.arange(n, 0, -1) - 0.5) / n)  # descending quantiles

    def counts(sigma: float) -> np.ndarray:
        above = np.floor((median - minimum) * np.exp(sigma * z))
        return minimum + np.minimum(above, maximum - minimum).astype(np.int64)

    # the spread that brings the total, the median held: the sum grows with it
    lo, hi = 0.0, 16.0
    if counts(hi).sum() < total:
        raise ValueError(f"no spread of median {median} reaches {total} under {maximum}")
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        if counts(mid).sum() < total:
            lo = mid
        else:
            hi = mid
    out = counts(lo)
    short = total - int(out.sum())  # 0 <= short; the floors leave a remainder
    room = np.flatnonzero(out < maximum)
    while short > 0:  # one more rating each to the largest counts with room
        take = room[:short]
        out[take] += 1
        short -= len(take)
        room = np.flatnonzero(out < maximum)
    return out


def make_ratings(cfg: dict, seed: int, device) -> dict:
    """The configuration's ratings on ``device``: fe_X [N, D] f32, labels [N]
    f32 (0/1), users and items [N] int64 ids, re_X [N, K] f32 (intercept
    first), and the per-entity counts (numpy, descending)."""
    n, d, k = cfg["num_ratings"], cfg["fe_features"], cfg["re_features"]
    u_counts = skewed_counts(n, cfg["num_users"], cfg["min_ratings_per_user"],
                             cfg["median_ratings_per_user"], cfg["max_ratings_per_user"])
    i_counts = skewed_counts(n, cfg["num_items"], cfg["min_ratings_per_item"],
                             cfg["median_ratings_per_item"], cfg["max_ratings_per_item"])
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(int(seed))

    def ids(counts):
        owners = torch.randperm(len(counts), generator=g, device=dev)
        slots = torch.repeat_interleave(owners, torch.as_tensor(counts, device=dev))
        return slots[torch.randperm(n, generator=g, device=dev)]

    users = ids(u_counts)
    items = ids(i_counts)
    fe_X = torch.randn((n, d), generator=g, device=dev, dtype=torch.float32)
    w = torch.randn((d,), generator=g, device=dev, dtype=torch.float32) * 0.3
    ue = torch.randn((len(u_counts),), generator=g, device=dev, dtype=torch.float32) * 0.4
    ie = torch.randn((len(i_counts),), generator=g, device=dev, dtype=torch.float32) * 0.4
    z = fe_X @ w + ue[users] + ie[items]
    labels = (torch.rand((n,), generator=g, device=dev) < torch.sigmoid(z)).to(torch.float32)
    del z
    re_X = torch.cat([torch.ones((n, 1), device=dev, dtype=torch.float32), fe_X[:, : k - 1]], dim=1)
    return {"fe_X": fe_X, "labels": labels, "users": users, "items": items, "re_X": re_X,
            "user_counts": u_counts, "item_counts": i_counts}


def scaled(cfg: dict, factor: float) -> dict:
    """The configuration with its totals scaled by ``factor`` (for tests on the
    CPU): ratings and entity counts shrink alike, so the mean per entity and
    the per-entity bounds stay."""
    out = dict(cfg)
    for key in ("num_ratings", "num_users", "num_items"):
        out[key] = max(1, int(round(cfg[key] * factor)))
    return out
