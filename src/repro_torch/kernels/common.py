"""Helpers shared by every kernel's plain version and wrapper.

Port of ``repro/kernels/common.py``'s ``cdiv``, ``acc_dtype`` and its
epilogue half: an optional relu at ACCUMULATOR scale, then the
round-to-nearest shift to the output scale and a clip to int8. The CUDA
kernels repeat the same arithmetic in ``csrc/epilogue.cuh``; the tests and
``chip_smoke.py`` hold them bitwise equal.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantize import rshift_round

#: the float modes' element types and the dtype code their C entry points
#: take (csrc/float_io.cuh)
FLOAT_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the one-thread-per-output kernels' default block size (their launch
#: before the tuner existed)
DEFAULT_THREADS = 256


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The accumulator of a kernel over ``dtype`` operands: int32 for
    integer codes, float32 otherwise."""
    return torch.float32 if dtype.is_floating_point else torch.int32


def check_threads(name: str, threads) -> int:
    """A block size the one-thread-per-output kernels launch: a whole
    number of warps, at most 1024."""
    if (not isinstance(threads, int) or isinstance(threads, bool)
            or not 32 <= threads <= 1024 or threads % 32):
        raise ValueError(f"{name}: threads must be a multiple of 32 in "
                         f"[32, 1024], got {threads!r}")
    return threads


def float_code(name: str, t: torch.Tensor) -> int:
    """The C dtype code of a float mode's operand; raises for another
    dtype."""
    if t.dtype not in FLOAT_CODES:
        raise TypeError(f"{name}: the float mode takes float32 or bfloat16, "
                        f"got {t.dtype}")
    return FLOAT_CODES[t.dtype]


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
