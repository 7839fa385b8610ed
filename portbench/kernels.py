"""The program's kernels as the device trace names them.

B1 and B2 are two instantiations of one template, ``fused_rows_kernel<T,
VEC, LOSS, HVP>`` (``ops/csrc/fused_glm.cu``): HVP false is B1, true is B2.
B3 (``ops/csrc/fused_hess.cu``) is every ``hess_*`` kernel one call
launches."""

from __future__ import annotations


def is_b1(name: str) -> bool:
    return "fused_rows_kernel" in name and "true>" not in name


def is_b2(name: str) -> bool:
    return "fused_rows_kernel" in name and "true>" in name


def is_b3(name: str) -> bool:
    return "hess_rows_kernel" in name or "hess_weights_kernel" in name or "hess_tile_kernel" in name
