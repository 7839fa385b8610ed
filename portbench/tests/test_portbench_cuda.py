"""On the card: each cell runs end to end at a small scale and comes out
correct. Skips without a card (decided inside the test)."""

import pytest

from portbench.harness import Bench, run_cell


@pytest.mark.cuda
@pytest.mark.parametrize("cell,scale", [("glmix-ml20m.lbfgs", 0.01), ("glmix-ml20m.newton", 0.01),
                                        ("glm-epsilon.tron", 0.05)])
def test_a_cell_runs_on_the_card(cell, scale):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    result, lines = run_cell(Bench(), cell, 2**31 + 77, 1.0, False, device="cuda", scale=scale,
                             log=lambda m: None)
    assert result["correct"], lines
    assert result["device"]["platform"] == "gpu" and result["device"]["memory_peak_bytes"] > 0
