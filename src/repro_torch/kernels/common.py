"""The Algorithm-1 epilogue shared by every kernel's plain version.

Port of the epilogue half of ``repro/kernels/common.py``: an optional
relu at ACCUMULATOR scale, then the round-to-nearest shift to the output
scale and a clip to int8. The CUDA kernels repeat the same arithmetic in
``csrc/epilogue.cuh``; the tests and ``chip_smoke.py`` hold them bitwise
equal.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantize import rshift_round


def apply_requant(acc: torch.Tensor, requant_shift) -> torch.Tensor:
    """Round-to-nearest arithmetic shift of an int32 accumulator to the
    output scale, clipped to [-128, 127]. ``requant_shift`` may be
    negative (a left shift) or ``None`` (no-op, float paths)."""
    if requant_shift is None:
        return acc
    return torch.clamp(rshift_round(acc, requant_shift), -128, 127)


def apply_act(acc: torch.Tensor, act) -> torch.Tensor:
    """Fused activation at accumulator scale, before :func:`apply_requant`.

    Requantization is a monotonic shift with ``rshift_round(0) == 0``, so
    relu before the shift is bit-exact with relu on the requantized int8 —
    which is what lets the graph executor fuse conv+BN+ReLU into one
    kernel."""
    if act is None:
        return acc
    if act == "relu":
        return torch.clamp(acc, min=0)
    raise ValueError(f"unknown act {act!r}; expected 'relu' or None")
