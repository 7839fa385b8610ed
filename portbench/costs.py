"""Operations and bytes that the algorithm needs, computed from shapes and from
the iteration counts the program reports.

Each input byte is counted once per call and each output byte once, whatever
a kernel reads again; a design matrix X [N, D] is read once per objective
evaluation. Operations are multiply-adds counted as two.
"""

from __future__ import annotations

F32 = 4


def b1_cost(n: int, d: int, elem: int = F32) -> tuple[float, float]:
    """(bytes, operations) of one loss + gradient pass (kernel B1): X once,
    labels, offsets and weights once, the [D + 2] sums written; X w and
    X^T a."""
    return n * d * elem + 3.0 * n * F32 + (d + 2) * F32, 4.0 * n * d


def b2_cost(n: int, d: int, elem: int = F32) -> tuple[float, float]:
    """(bytes, operations) of one Hessian-vector product (kernel B2): X once,
    labels, offsets, weights, the coefficients and the direction once, the
    [D + 2] sums written; X w, X v and X^T u."""
    return n * d * elem + 3.0 * n * F32 + 2.0 * d * F32 + (d + 2) * F32, 6.0 * n * d


def b3_cost(n: int, d: int, elem: int = F32) -> tuple[float, float]:
    """(bytes, operations) of one Hessian matrix (kernel B3): X once, the row
    vectors once, the [D, D] matrix written; the symmetric half of X^T W X
    in split-precision TF32 (three products per term), 3 N D (D + 1)
    operations, taken at the TF32 rate."""
    return n * d * elem + 3.0 * n * F32 + d * d * F32, 3.0 * n * d * (d + 1)


def glm_evaluation_flops(n: int, d: int) -> float:
    """Operations of one value + gradient of a GLM on [N, D]: X w and X^T a."""
    return 4.0 * n * d


def hessian_flops(n: int, d: int) -> float:
    """Operations of the symmetric half of X^T W X."""
    return 1.0 * n * d * (d + 1)


def entity_sums(rows, ks) -> tuple[float, float, float]:
    """(sum r k, sum r k (k + 1), sum k^3) over the entities of a bucket, each
    with its real rows r and real features k (padding left out): one
    evaluation of the bucket is 4 times the first, one Hessian the second, one
    factorization a third of the last."""
    s1 = s2 = s3 = 0.0
    for r, k in zip(rows, ks):
        s1 += float(r) * k
        s2 += float(r) * k * (k + 1)
        s3 += float(k) ** 3
    return s1, s2, s3


def glmix_pass_flops(n: int, d: int, re_nnz, re_buckets, re_iterations, newton: bool) -> float:
    """Operations of one coordinate-descent pass besides the fixed effect's
    solve: the fixed-effect score, each random effect's score over its
    ``re_nnz`` stored features, and each random-effect bucket at one
    evaluation per iteration it ran (and a Hessian and a factorization per
    iteration under NEWTON), over its entities' real rows and features.
    ``re_buckets`` is a list per coordinate of each bucket's
    ``entity_sums``; ``re_iterations`` the matching iteration counts (the
    program reports a bucket's largest, which every lane is counted at). The
    fixed effect's evaluations and Hessians are counted from the kernels'
    launches."""
    flops = 2.0 * n * d
    for nnz, sums, iters in zip(re_nnz, re_buckets, re_iterations):
        flops += 2.0 * nnz
        for (s1, s2, s3), it in zip(sums, iters):
            flops += it * 4.0 * s1
            if newton:
                flops += it * (s2 + s3 / 3.0)
    return flops


def tron_solve_flops(n: int, d: int, evaluations: float, hvps: float) -> float:
    """Operations of one TRON solve: its value + gradient evaluations and its
    Hessian-vector products."""
    return evaluations * glm_evaluation_flops(n, d) + hvps * 6.0 * n * d
