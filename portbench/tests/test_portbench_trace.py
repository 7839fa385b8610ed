"""The trace reduction: busy time as the union of device intervals, gaps named
by the innermost host operation running in them."""

import pytest

from portbench import kernels, trace


def test_busy_time_and_gaps():
    spans = [
        (True, 0.0, 1.0, "k1"),
        (True, 0.5, 1.0, "k2"),      # overlaps k1: busy to 1.5
        (True, 3.0, 0.5, "Memcpy HtoD"),  # a 1.5 s gap before it
        (True, 4.0, 1.0, "k1"),      # a 0.5 s gap before it
        (False, 1.4, 2.0, "cudaLaunchKernel"),
        (False, 2.0, 0.5, "cudaStreamSynchronize"),
    ]
    s = trace.summarize(spans, window_s=6.0)
    assert s["busy_s"] == pytest.approx(3.0)
    assert s["kernels"]["k1"] == [2, pytest.approx(2.0)]
    assert s["device_ops"][0][0] == "k1"
    gaps = dict(s["idle_gaps"])
    assert gaps["cudaStreamSynchronize"] == pytest.approx(1.5)  # middle 2.25: innermost
    assert gaps["host"] == pytest.approx(0.5)
    assert trace.kernel_seconds(s, lambda n: n.startswith("k")) == (3, pytest.approx(3.0))


def test_kernel_names():
    b1 = "void (anonymous namespace)::fused_rows_kernel<float, 4, 1, false>(float const*)"
    b2 = "void (anonymous namespace)::fused_rows_kernel<float, 4, 1, true>(float const*)"
    assert kernels.is_b1(b1) and not kernels.is_b2(b1)
    assert kernels.is_b2(b2) and not kernels.is_b1(b2)
    assert kernels.is_b3("void hess_rows_kernel<float, 4, 1, 10>(float const*)")
    assert not kernels.is_b3(b1)
