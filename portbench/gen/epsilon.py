"""A dense table at the size of LIBSVM's ``epsilon`` (PASCAL Large Scale
Learning Challenge 2008), made on the device: [N, D] standard normal rows
scaled to unit norm, as the source's rows are, and logistic labels from
generating coefficients drawn normal with scale ``margin_scale``.

The table is one draw, from the configuration's ``base_seed``; a run's seed
orders its rows. So every seed poses the same solve in another row order:
a TRON solve's iteration count follows the table's draw, and tables drawn
anew per seed took 7 or 11 iterations by seed, which timed the draw and not
the program."""

from __future__ import annotations

import torch


def make_table(cfg: dict, seed: int, device) -> dict:
    """{"X": [N, D] f32, "labels": [N] f32 0/1}: the configuration's table
    with its rows in the order that ``seed`` draws."""
    n, d = cfg["num_rows"], cfg["num_features"]
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(int(cfg["base_seed"]))
    X = torch.randn((n, d), generator=g, device=dev, dtype=torch.float32)
    X /= torch.linalg.vector_norm(X, dim=1, keepdim=True)
    w = torch.randn((d,), generator=g, device=dev, dtype=torch.float32) * float(cfg["margin_scale"])
    labels = (torch.rand((n,), generator=g, device=dev) < torch.sigmoid(X @ w)).to(torch.float32)
    order = torch.randperm(n, generator=torch.Generator(device=dev).manual_seed(int(seed)),
                           device=dev)
    return {"X": X[order], "labels": labels[order]}


def scaled(cfg: dict, factor: float) -> dict:
    """The configuration with its rows scaled by ``factor`` (for tests on the
    CPU); the width stays."""
    out = dict(cfg)
    out["num_rows"] = max(1, int(round(cfg["num_rows"] * factor)))
    return out
