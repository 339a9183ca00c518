"""Power-of-two symmetric int8 quantization (paper Eq. 4 + Algorithm 1).

Port of the int8 half of ``repro/core/quantize.py``. The paper writes
Eq. 4 as::

    dec = ceil(log2(max |X_f|));   x_i = floor(x_f * 2^{(8-1)-dec})

i.e. the scale is 2^{dec-7}; ``frac_bits = 7 - dec`` is NNoM's "dec_bits"
(number of fractional bits), so rescaling between scales is a plain
arithmetic shift, never a division. ``frac_bits`` is carried explicitly.

Integer paths accumulate in int32 and shift arithmetically; PyTorch's
``>>`` on int32 is arithmetic and its int32 adds and left shifts wrap, as
JAX's do. The W4 half (``pack_w4`` ... ``quantize_w4``) is not ported yet.

Algorithm 1 (right), the additive inner loop of add-convolution, puts both
operands on a common scale before ``|x - w|``: :func:`addmac_align`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

INT8_MIN, INT8_MAX = -128, 127


@dataclasses.dataclass
class QTensor:
    """int8 values with a power-of-two scale: value ~ q * 2^{-frac_bits}."""

    q: torch.Tensor                    # int8
    frac_bits: int

    @property
    def scale(self) -> float:
        return 2.0 ** (-self.frac_bits)

    def dequantize(self) -> torch.Tensor:
        return self.q.to(torch.float32) * self.scale


def frac_bits_for(x) -> int:
    """7 - ceil(log2(max|x|)) — a Python int (calibration time)."""
    m = float(x.abs().max()) if isinstance(x, torch.Tensor) else abs(float(x))
    if m == 0.0:
        return 7
    return 7 - math.ceil(math.log2(m))


def quantize(x: torch.Tensor, frac_bits: Optional[int] = None) -> QTensor:
    """Eq. 4: floor(x * 2^{frac_bits}) in float32, clipped to int8."""
    fb = frac_bits_for(x) if frac_bits is None else frac_bits
    q = torch.floor(x.to(torch.float32) * (2.0 ** fb))
    q = torch.clamp(q, INT8_MIN, INT8_MAX).to(torch.int8)
    return QTensor(q=q, frac_bits=fb)


def rshift_round(acc: torch.Tensor, shift: int) -> torch.Tensor:
    """Arithmetic right shift with round-to-nearest (half-way cases toward
    +inf): ``(acc + (1 << (shift-1))) >> shift``, as NNoM's default build.
    ``shift`` may be <= 0 (left shift, exact up to int32 wrap-around). The
    single rounding implementation of the port: ``kernels.common.
    apply_requant`` and every plain kernel version delegate here, and the
    CUDA kernels repeat it in ``kernels/csrc/epilogue.cuh``."""
    if shift > 0:
        return (acc + (1 << (shift - 1))) >> shift
    if shift < 0:
        return acc << -shift
    return acc


def requantize(acc: torch.Tensor, acc_frac_bits: int,
               out_frac_bits: int) -> torch.Tensor:
    """int32 accumulator -> int8 at the output scale (Algorithm 1, line 3)."""
    shifted = rshift_round(acc, acc_frac_bits - out_frac_bits)
    return torch.clamp(shifted, INT8_MIN, INT8_MAX).to(torch.int8)


def add_preshifts(fb_x: int, fb_w: int):
    """Algorithm 1 (right) scale alignment as static left shifts:
    ``(x_preshift, w_preshift, acc_frac_bits)``. The coarser operand is
    shifted onto the finer scale, and the accumulator carries
    max(fb_x, fb_w) fractional bits. (The JAX package writes this decision
    twice, as ``qconv._add_preshifts`` and inside ``addmac_align``.)"""
    if fb_x > fb_w:            # weight is coarser: w << (fb_x - fb_w)
        return 0, fb_x - fb_w, fb_x
    if fb_w > fb_x:            # input is coarser: x << (fb_w - fb_x)
        return fb_w - fb_x, 0, fb_w
    return 0, 0, fb_x


def addmac_align(x_q: torch.Tensor, w_q: torch.Tensor, fb_x: int, fb_w: int):
    """int32 operands on a common scale (:func:`add_preshifts`, wrapping as
    int32 does), and that scale's frac bits."""
    x_pre, w_pre, fb = add_preshifts(fb_x, fb_w)
    return wrap_left_shift(x_q, x_pre), wrap_left_shift(w_q, w_pre), fb


def wrap_left_shift(v: torch.Tensor, shift: int) -> torch.Tensor:
    """``v << shift`` as int32, wrapping as JAX's int32 ``left_shift`` does
    (the shift is taken in int64 and cut back to 32 bits)."""
    if not shift:
        return v.to(torch.int32)
    return (v.to(torch.int64) << shift).to(torch.int32)
