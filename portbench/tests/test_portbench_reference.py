"""The reference's Newton solves reach the optimum: every lane's gradient
vanishes, also for lanes of two or three rows under large offsets, where a
Newton step without a line search can cycle."""

import torch

from portbench.reference import newton


def _lane_gradient(Xr, ent, n_ent, y, off, lam, table):
    z = (Xr * table[ent]).sum(dim=1) + off
    g = lam * table.clone()
    g.index_add_(0, ent, Xr * (torch.sigmoid(z) - y).unsqueeze(1))
    return g


def test_grouped_lanes_converge_under_large_offsets():
    gen = torch.Generator().manual_seed(3)
    n_ent, k = 300, 8
    counts = torch.randint(1, 4, (n_ent,), generator=gen)
    counts[:20] = 200
    ent = torch.repeat_interleave(torch.arange(n_ent), counts)
    n = ent.shape[0]
    Xr = torch.cat([torch.ones(n, 1), torch.randn(n, k - 1, generator=gen)], dim=1).double()
    off = (torch.randn(n, generator=gen) * 6.0).double()
    y = (torch.rand(n, generator=gen) < 0.5).double()
    table, it = newton.newton_grouped(Xr, ent, n_ent, y, off, torch.ones(n, dtype=torch.float64),
                                      1.0, torch.zeros(n_ent, k), "f64", rows=97)
    assert it < 50
    g = _lane_gradient(Xr, ent, n_ent, y, off, 1.0, table)
    assert float(g.abs().max()) < 1e-9


def test_dense_solve_converges():
    gen = torch.Generator().manual_seed(4)
    X = torch.randn(2000, 16, generator=gen)
    y = (torch.rand(2000, generator=gen) < torch.sigmoid(X @ torch.randn(16, generator=gen))).float()
    zero, one = torch.zeros(2000, dtype=torch.float64), torch.ones(2000, dtype=torch.float64)
    coef, it = newton.newton_dense(X, y, zero, one, 1.0, torch.zeros(16), "f64", rows=300)
    assert it < 50
    _, g = newton.dense_objective(X, y, zero, one, 1.0, coef, "f64", rows=300)
    assert float(g.abs().max()) < 1e-8
    tf32, _ = newton.newton_dense(X, y, zero, one, 1.0, torch.zeros(16), "tf32", rows=300)
    assert 0 < float((tf32.double() - coef).abs().max()) < 1e-2


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -1.0 - 2.0 ** -12, 3.0])
    assert newton.tf32(x).tolist() == [1.0, 1.0 + 2.0 ** -9, -1.0, 3.0]
