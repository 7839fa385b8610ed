"""The operation and byte counts against hand counts."""

import pytest

from portbench import costs, peaks


def test_kernel_counts_by_hand():
    # X read once (10 x 4 x 4 bytes), labels, offsets, weights (3 x 10 x 4), [D + 2] out
    assert costs.b1_cost(10, 4) == (160 + 120 + 24, 160)
    assert costs.b1_cost(10, 4, elem=2) == (80 + 120 + 24, 160)
    # B2 also reads the coefficients and the direction (2 x 4 x 4)
    assert costs.b2_cost(10, 4) == (160 + 120 + 32 + 24, 240)
    # B3 writes the D x D matrix; 3 N D (D + 1) split-precision operations
    assert costs.b3_cost(10, 4) == (160 + 120 + 64, 3 * 10 * 4 * 5)


def test_pass_and_solve_counts_by_hand():
    # one RE bucket of two entities: 3 rows of 3 features and 4 rows of 2
    assert costs.entity_sums([3, 4], [3, 2]) == (9 + 8, 3 * 3 * 4 + 4 * 2 * 3, 27 + 8)
    # the FE score on 10 x 4, that bucket at 5 iterations, 25 stored RE features scored
    got = costs.glmix_pass_flops(10, 4, [25], [[(17, 60, 35)]], [[5]], newton=False)
    assert got == 2 * 10 * 4 + 2 * 25 + 5 * 4 * 17
    newton = costs.glmix_pass_flops(10, 4, [25], [[(17, 60, 35)]], [[5]], newton=True)
    assert newton == got + 5 * (60 + 35 / 3)
    assert costs.glm_evaluation_flops(10, 4) == 160 and costs.hessian_flops(10, 4) == 200
    assert costs.tron_solve_flops(10, 4, 3, 7) == 3 * 160 + 7 * 240


def test_least_seconds_takes_the_slower_bound():
    assert peaks.least_seconds(3.35e12, 1.0) == pytest.approx(1.0)
    assert peaks.least_seconds(1.0, 67e12) == pytest.approx(1.0)
    assert peaks.least_seconds(1.0, 495e12, peaks.TF32_FLOPS_PER_S) == pytest.approx(1.0)
