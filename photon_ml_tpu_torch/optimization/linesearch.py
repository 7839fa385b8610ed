"""Strong-Wolfe and Armijo line searches over a batch of lanes.

Port of photon_ml_tpu/optimization/linesearch.py (``strong_wolfe`` and
``backtracking_armijo``, the latter for OWL-QN and LBFGSB). The JAX
search is one ``lax.while_loop`` whose state machine covers both the
bracketing and zoom phases of Nocedal & Wright Alg. 3.5/3.6, vmapped over
lanes in the random-effect solves. Here the state machine is written out
over a leading lane axis: each trip evaluates every lane, and a lane whose
search has ended keeps its state frozen, exactly as a vmapped while_loop
selects it. The loop ends when no lane is still searching (one host sync per
trip, :func:`common.any_lane`).

The Round-5 behaviours of the JAX search are kept: the degenerate-descent
early-out with 2^max_iters expansion headroom, the caller's ``active`` mask,
and one budget of ``max_iters`` shared by both phases.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from photon_ml_tpu_torch.optimization.common import any_lane

Tensor = torch.Tensor

C1 = 1e-4  # sufficient-decrease constant
C2 = 0.9  # curvature constant

_BRACKETING = 0
_ZOOM = 1
_DONE = 2


class LineSearchResult(NamedTuple):
    alpha: Tensor  # [B]
    value: Tensor  # [B]
    grad: Tensor  # [B, d] gradient at x + alpha * d
    success: Tensor  # [B] bool
    evals: Tensor  # [B] int


def _where(c: Tensor, a: Tensor, b: Tensor) -> Tensor:
    """Lane select: ``c`` is [B], ``a``/``b`` are [B] or [B, d]."""
    if a.dim() > c.dim():
        c = c.unsqueeze(-1)
    return torch.where(c, a, b)


def _interp_quadratic(a_lo, f_lo, dphi_lo, a_hi, f_hi):
    """Minimizer of the quadratic through (a_lo, f_lo, dphi_lo) and (a_hi, f_hi)."""
    denom = 2.0 * (f_hi - f_lo - dphi_lo * (a_hi - a_lo))
    num = dphi_lo * (a_hi - a_lo) ** 2
    cand = a_lo - num / torch.where(denom == 0.0, torch.ones_like(denom), denom)
    return torch.where(denom == 0.0, 0.5 * (a_lo + a_hi), cand)


_FIELDS = ("stage", "i", "a", "f_a", "g_a", "dphi_a", "a_lo", "f_lo", "dphi_lo",
           "a_hi", "f_hi", "dphi_hi", "a_best", "f_best", "g_best")


def strong_wolfe(
    phi: Callable[[Tensor], tuple[Tensor, Tensor, Tensor]],
    f0: Tensor,
    g0: Tensor,
    dphi0: Tensor,
    init_alpha: Tensor,
    max_iters: int = 10,
    active=None,
) -> LineSearchResult:
    """Find per-lane alpha satisfying the strong Wolfe conditions.

    ``phi(a)`` maps step sizes [B] to (f [B], grad [B, d], dphi [B]); ``g0``
    is the gradient at alpha = 0, so a failed lane returns (0, f0, g0).

    A lane whose ``|dphi0|`` cannot show as a decrease of f0 at its float
    resolution even after 2^max_iters expansion returns at once as a
    successful no-op (alpha = 0), and so does every lane outside ``active``:
    they never extend the batch's trip count.

    The search is three steps, which the graphed random-effect solve
    (optimization/bucket_graphs.py) replays as they are:
    :func:`wolfe_start`, then :func:`wolfe_trip` while
    :func:`wolfe_running` has a lane, then :func:`wolfe_result`.
    """
    big = torch.full_like(f0, float("inf"))
    st = wolfe_start(phi, f0, g0, dphi0, init_alpha, big, max_iters, active)
    while True:
        running = wolfe_running(st, max_iters)
        if not any_lane(running):
            break
        st = wolfe_trip(st, running, phi, f0, dphi0, big)
    return wolfe_result(st, f0, g0)


def wolfe_start(phi, f0: Tensor, g0: Tensor, dphi0: Tensor, init_alpha: Tensor, big: Tensor,
                max_iters: int, active=None) -> dict:
    """The search's state (:data:`_FIELDS`) after the first trial step.
    ``big`` is an [B] tensor of +inf, the open end of the bracket."""
    dtype, dev = f0.dtype, f0.device
    fin = torch.finfo(dtype)
    zero = torch.zeros_like(f0)
    # ~(>=), not (<): a NaN dphi0 must stay searchable so it reaches failure
    thresh = fin.eps * torch.clamp_min(torch.abs(f0), fin.tiny) / 2.0 ** min(max_iters, 60)
    searchable = ~(dphi0 >= -thresh) | ~torch.isfinite(f0)
    if active is not None:
        searchable = searchable & active

    a1 = torch.where(searchable, torch.as_tensor(init_alpha, dtype=dtype, device=dev), zero)
    f_a1, g_a1, dphi_a1 = phi(a1)
    return dict(
        stage=torch.where(searchable, _BRACKETING, _DONE).to(torch.int32),
        i=torch.ones_like(f0, dtype=torch.int32),
        a=a1,
        f_a=torch.where(searchable, f_a1, f0),
        g_a=_where(searchable, g_a1, g0),
        dphi_a=torch.where(searchable, dphi_a1, dphi0),
        a_lo=zero, f_lo=f0, dphi_lo=dphi0,
        a_hi=big, f_hi=big, dphi_hi=big,
        a_best=zero, f_best=f0, g_best=g0,
    )


def wolfe_running(st: dict, max_iters: int) -> Tensor:
    """[B] the lanes whose search goes on for another trip."""
    return (st["stage"] < _DONE) & (st["i"] < max_iters)


def wolfe_trip(st: dict, running: Tensor, phi, f0: Tensor, dphi0: Tensor, big: Tensor) -> dict:
    """One trip of the search: :func:`_body` for every lane, kept in the
    ``running`` lanes; the others keep their state."""
    new = _body(st, phi, f0, dphi0, big)
    return {k: _where(running, new[k], st[k]) for k in _FIELDS}


def wolfe_result(st: dict, f0: Tensor, g0: Tensor) -> LineSearchResult:
    """The search's answer from its final state."""
    zero = torch.zeros_like(f0)
    success = st["stage"] == _DONE
    has_fallback = st["a_best"] > 0
    alpha = torch.where(success, st["a"], torch.where(has_fallback, st["a_best"], zero))
    value = torch.where(success, st["f_a"], torch.where(has_fallback, st["f_best"], f0))
    grad = _where(success, st["g_a"], st["g_best"])
    return LineSearchResult(alpha=alpha, value=value, grad=grad,
                            success=success | has_fallback, evals=st["i"])


def _body(st: dict, phi, f0: Tensor, dphi0: Tensor, big: Tensor) -> dict:
    """One trip of the bracketing/zoom state machine for every lane."""
    stage, i, a, f_a, g_a, dphi_a = (st[k] for k in ("stage", "i", "a", "f_a", "g_a", "dphi_a"))
    a_lo, f_lo, dphi_lo = st["a_lo"], st["f_lo"], st["dphi_lo"]
    a_hi, f_hi, dphi_hi = st["a_hi"], st["f_hi"], st["dphi_hi"]
    is_bracket = stage == _BRACKETING

    arm = f_a <= f0 + C1 * a * dphi0
    curv = torch.abs(dphi_a) <= -C2 * dphi0

    # track the best Armijo point
    better = arm & (f_a < st["f_best"])
    a_best = torch.where(better, a, st["a_best"])
    f_best = torch.where(better, f_a, st["f_best"])
    g_best = _where(better, g_a, st["g_best"])

    # bracketing phase (Alg 3.5)
    brk_hi = (~arm) | ((f_a >= f_lo) & (i > 1))
    brk_done = arm & curv
    brk_pos = arm & ~curv & (dphi_a >= 0)
    # zoom phase (Alg 3.6)
    zm_shrink_hi = (~arm) | (f_a >= f_lo)
    zm_done = arm & curv
    zm_move_hi = arm & ~curv & (dphi_a * (a_hi - a_lo) >= 0)

    to_zoom = brk_hi | brk_pos
    new_stage = torch.where(
        is_bracket,
        torch.where(brk_done, _DONE, _ZOOM * to_zoom.to(torch.int32) + _BRACKETING * (~to_zoom).to(torch.int32)),
        torch.where(zm_done, _DONE, _ZOOM),
    ).to(torch.int32)

    b_a_lo = torch.where(brk_hi, a_lo, a)
    b_f_lo = torch.where(brk_hi, f_lo, f_a)
    b_dphi_lo = torch.where(brk_hi, dphi_lo, dphi_a)
    b_a_hi = torch.where(brk_hi, a, torch.where(brk_pos, a_lo, big))
    b_f_hi = torch.where(brk_hi, f_a, torch.where(brk_pos, f_lo, big))
    b_dphi_hi = torch.where(brk_hi, dphi_a, torch.where(brk_pos, dphi_lo, big))

    z_a_lo = torch.where(zm_shrink_hi, a_lo, a)
    z_f_lo = torch.where(zm_shrink_hi, f_lo, f_a)
    z_dphi_lo = torch.where(zm_shrink_hi, dphi_lo, dphi_a)
    z_a_hi = torch.where(zm_shrink_hi, a, torch.where(zm_move_hi, a_lo, a_hi))
    z_f_hi = torch.where(zm_shrink_hi, f_a, torch.where(zm_move_hi, f_lo, f_hi))
    z_dphi_hi = torch.where(zm_shrink_hi, dphi_a, torch.where(zm_move_hi, dphi_lo, dphi_hi))

    a_lo = torch.where(is_bracket, b_a_lo, z_a_lo)
    f_lo = torch.where(is_bracket, b_f_lo, z_f_lo)
    dphi_lo = torch.where(is_bracket, b_dphi_lo, z_dphi_lo)
    a_hi = torch.where(is_bracket, b_a_hi, z_a_hi)
    f_hi = torch.where(is_bracket, b_f_hi, z_f_hi)
    dphi_hi = torch.where(is_bracket, b_dphi_hi, z_dphi_hi)

    # next trial: safeguarded quadratic interpolation in zoom, doubling in bracketing
    lo, hi = torch.minimum(a_lo, a_hi), torch.maximum(a_lo, a_hi)
    cand = _interp_quadratic(a_lo, f_lo, dphi_lo, a_hi, f_hi)
    width = hi - lo
    cand = torch.minimum(torch.maximum(cand, lo + 0.1 * width), hi - 0.1 * width)
    a_zoom = torch.where(torch.isfinite(cand), cand, 0.5 * (lo + hi))
    a_next = torch.where(new_stage == _ZOOM, a_zoom, 2.0 * a)
    a_next = torch.where(new_stage == _DONE, a, a_next)

    f_n, g_n, dphi_n = phi(a_next)
    keep = new_stage == _DONE
    return dict(
        stage=new_stage, i=i + 1, a=a_next,
        f_a=torch.where(keep, f_a, f_n), g_a=_where(keep, g_a, g_n),
        dphi_a=torch.where(keep, dphi_a, dphi_n),
        a_lo=a_lo, f_lo=f_lo, dphi_lo=dphi_lo, a_hi=a_hi, f_hi=f_hi, dphi_hi=dphi_hi,
        a_best=a_best, f_best=f_best, g_best=g_best,
    )


def backtracking_armijo(
    phi: Callable[[Tensor], tuple[Tensor, Tensor]],
    f0: Tensor,
    dphi0: Tensor,
    init_alpha: Tensor,
    max_iters: int = 10,
    shrink: float = 0.5,
    active=None,
) -> LineSearchResult:
    """Per-lane Armijo backtracking, the line search of OWL-QN and the
    projected LBFGSB, whose projected paths are not smooth enough for Wolfe.

    ``phi(a)`` maps step sizes [B] to (f [B], grad [B, d]) at the trial
    points; ``dphi0`` is the directional derivative of the (pseudo-)
    gradient. A lane whose ``|dphi0|`` is below the float resolution of f0
    tries alpha = 0 first, an exact no-op that passes at once, and so does
    every lane outside ``active``: they never extend the trip count. One
    host sync per backtracking trip (:func:`common.any_lane`).
    """
    fin = torch.finfo(f0.dtype)
    # same NaN/inf handling as strong_wolfe: non-finite states must search
    searchable = ~(dphi0 >= -(fin.eps * torch.clamp_min(torch.abs(f0), fin.tiny))) | ~torch.isfinite(f0)
    if active is not None:
        searchable = searchable & active
    a = torch.where(searchable, torch.as_tensor(init_alpha, dtype=f0.dtype, device=f0.device),
                    torch.zeros_like(f0))
    f_a, g_a = phi(a)
    i = torch.ones_like(f0, dtype=torch.int32)
    while True:
        running = (f_a > f0 + C1 * a * dphi0) & (i < max_iters)
        if not any_lane(running):
            break
        a_n = torch.where(running, a * shrink, a)
        f_n, g_n = phi(a_n)
        a = a_n
        f_a = torch.where(running, f_n, f_a)
        g_a = _where(running, g_n, g_a)
        i = i + running.to(torch.int32)
    success = f_a <= f0 + C1 * a * dphi0
    return LineSearchResult(alpha=torch.where(success, a, torch.zeros_like(a)),
                            value=torch.where(success, f_a, f0), grad=g_a, success=success, evals=i)
