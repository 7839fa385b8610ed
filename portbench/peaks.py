"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit), and the card's own name and
power limit read beside them."""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12


def least_seconds(bytes_moved: float, flops: float, rate: float = F32_FLOPS_PER_S) -> float:
    """The least time the card could take: bytes at HBM bandwidth or
    operations at ``rate``, whichever is longer."""
    return max(bytes_moved / HBM_BYTES_PER_S, flops / rate)


def card() -> dict:
    """{"name", "power_limit_w"} from nvidia-smi (None where it cannot say)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return {"name": None, "power_limit_w": None}
    first = out.stdout.strip().splitlines()[:1]
    if out.returncode != 0 or not first:
        return {"name": None, "power_limit_w": None}
    name, _, limit = first[0].rpartition(",")
    try:
        return {"name": name.strip(), "power_limit_w": float(limit)}
    except ValueError:
        return {"name": name.strip(), "power_limit_w": None}
