"""The generators give the source's totals, whatever the seed."""

import numpy as np
import pytest
import torch

from portbench.gen import epsilon, movielens
from portbench.harness import Bench


@pytest.fixture(scope="module")
def ml20m():
    return Bench().load("configs", "glmix-ml20m")


def test_full_size_counts_match_the_source(ml20m):
    users = movielens.skewed_counts(ml20m["num_ratings"], ml20m["num_users"],
                                    ml20m["min_ratings_per_user"], ml20m["median_ratings_per_user"],
                                    ml20m["max_ratings_per_user"])
    items = movielens.skewed_counts(ml20m["num_ratings"], ml20m["num_items"],
                                    ml20m["min_ratings_per_item"], ml20m["median_ratings_per_item"],
                                    ml20m["max_ratings_per_item"])
    assert users.sum() == items.sum() == 20_000_263
    assert len(users) == 138_493 and len(items) == 26_744
    assert users.min() == 20 and users.max() == 9_254
    assert items.min() == 1 and items.max() == 67_310
    assert abs(np.median(users) - 68) <= 1 and abs(np.median(items) - 18) <= 1


@pytest.mark.parametrize("factor", [0.001, 0.004])
def test_scaled_ratings_keep_totals_and_minimum(ml20m, factor):
    cfg = movielens.scaled(ml20m, factor)
    r = movielens.make_ratings(cfg, 2**31 + 7, "cpu")
    n = cfg["num_ratings"]
    assert r["fe_X"].shape == (n, 64) and r["re_X"].shape == (n, 8)
    per_user = torch.bincount(r["users"], minlength=cfg["num_users"])
    per_item = torch.bincount(r["items"], minlength=cfg["num_items"])
    assert int(per_user.sum()) == n and int(per_user.min()) >= 20
    assert len(per_user) == cfg["num_users"] and int(per_item.min()) >= 1
    assert torch.equal(r["re_X"][:, 0], torch.ones(n))
    assert torch.equal(r["re_X"][:, 1:], r["fe_X"][:, :7])
    assert set(r["labels"].unique().tolist()) <= {0.0, 1.0}


def test_seeds_change_the_entities_not_the_work(ml20m):
    cfg = movielens.scaled(ml20m, 0.001)
    a = movielens.make_ratings(cfg, 1, "cpu")
    b = movielens.make_ratings(cfg, 2**31 + 1, "cpu")
    c = movielens.make_ratings(cfg, 1, "cpu")
    for key in ("users", "items"):
        ca = torch.bincount(a[key]).sort().values
        cb = torch.bincount(b[key]).sort().values
        assert torch.equal(ca, cb)  # the same counts, to other entities
        assert not torch.equal(a[key], b[key])
        assert torch.equal(a[key], c[key])
    assert torch.equal(a["fe_X"], c["fe_X"]) and torch.equal(a["labels"], c["labels"])


def test_epsilon_table_shape_and_rows():
    cfg = epsilon.scaled(Bench().load("configs", "glm-epsilon"), 0.005)
    t = epsilon.make_table(cfg, 2**31 + 3, "cpu")
    assert t["X"].shape == (2000, 2000) and t["X"].dtype == torch.float32
    norms = torch.linalg.vector_norm(t["X"], dim=1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-5)
    assert set(t["labels"].unique().tolist()) == {0.0, 1.0}
    again = epsilon.make_table(cfg, 2**31 + 3, "cpu")
    assert torch.equal(t["X"], again["X"]) and torch.equal(t["labels"], again["labels"])


def test_epsilon_seeds_order_the_same_rows():
    cfg = epsilon.scaled(Bench().load("configs", "glm-epsilon"), 0.002)
    a, b = (epsilon.make_table(cfg, s, "cpu") for s in (5, 2**31 + 5))
    assert not torch.equal(a["X"], b["X"])
    key = [torch.cat([t["X"], t["labels"].unsqueeze(1)], dim=1) for t in (a, b)]
    order = [torch.argsort(k[:, 0]) for k in key]
    assert torch.equal(key[0][order[0]], key[1][order[1]])
