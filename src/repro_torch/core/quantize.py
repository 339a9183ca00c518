"""Power-of-two symmetric int8 quantization (paper Eq. 4 + Algorithm 1).

Port of the int8 half of ``repro/core/quantize.py``. The paper writes
Eq. 4 as::

    dec = ceil(log2(max |X_f|));   x_i = floor(x_f * 2^{(8-1)-dec})

i.e. the scale is 2^{dec-7}; ``frac_bits = 7 - dec`` is NNoM's "dec_bits"
(number of fractional bits), so rescaling between scales is a plain
arithmetic shift, never a division. ``frac_bits`` is carried explicitly.

Integer paths accumulate in int32 and shift arithmetically; PyTorch's
``>>`` on int32 is arithmetic and its int32 adds and left shifts wrap, as
JAX's do.

The W4 half (:func:`pack_w4` ... :func:`quantize_w4`) stores weights as two
int4 codes per byte with per-group power-of-two scales folded into
per-element left shifts, so the expanded code ``q4 << shift`` is an
ordinary int8 weight at one base scale and Algorithm 1 is untouched.

Algorithm 1 (right), the additive inner loop of add-convolution, puts both
operands on a common scale before ``|x - w|``: :func:`addmac_align`.
:func:`mac_inner` and :func:`addmac_inner` are Algorithm 1's two inner
loops for one operand pair, the reference the kernels' epilogues repeat.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.tree import tree_map

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


# --------------------------------------------------------------------------
# Algorithm 1's reference inner loops, calibration and tree quantization.
# --------------------------------------------------------------------------

def mac_inner(x_q: torch.Tensor, w_q: torch.Tensor, fb_x: int, fb_w: int,
              fb_y: int) -> torch.Tensor:
    """Algorithm 1 (left), one (input, weight) pair: ``(x * w) >> shift``.
    The accumulator carries fb_x + fb_w frac bits; the output shift is
    fb_x + fb_w - fb_y."""
    acc = x_q.to(torch.int32) * w_q.to(torch.int32)
    return requantize(acc, fb_x + fb_w, fb_y)


def addmac_inner(x_q: torch.Tensor, w_q: torch.Tensor, fb_x: int, fb_w: int,
                 fb_y: int) -> torch.Tensor:
    """Algorithm 1 (right), one pair: ``-|x - w|`` on a common scale
    (:func:`addmac_align`), requantized to ``fb_y``."""
    xi, wi, fb = addmac_align(x_q, w_q, fb_x, fb_w)
    return requantize(-(xi - wi).abs(), fb, fb_y)


def calibrate(fn, *sample_args) -> int:
    """Output frac bits of a float ``fn`` on sample data (Eq. 4)."""
    return frac_bits_for(fn(*sample_args))


def quantize_params(params):
    """Quantize a tree of float weights leaf by leaf (per-tensor scales).
    The tree is nested dicts, lists and tuples of tensors; a leaf that is
    not floating point (a shift table) is kept as it is."""
    return tree_map(lambda t: quantize(t) if t.is_floating_point() else t,
                    params)


# --------------------------------------------------------------------------
# W4: packed sub-byte weights (two int4 codes per byte, per-group scales).
#
# The kernels read the packed bytes and unpack each nibble in registers, then
# run the unchanged int8 body, so the packed path is bitwise equal to the
# int8 plain version on the expanded codes.
# --------------------------------------------------------------------------

W4_MIN, W4_MAX = -8, 7
W4_MAX_GROUP_SHIFT = 4         # |q4| <= 8, 8 << 4 = 128: still an int8 code


def _take(t: torch.Tensor, axis: int, start: int, step: int = 1):
    idx = [slice(None)] * t.dim()
    idx[axis] = slice(start, None, step)
    return t[tuple(idx)]


def pack_w4(q: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Pack int4-valued codes (each in [-8, 7]) two per byte along ``axis``.

    Element ``2i`` lands in the low nibble of byte ``i``, element ``2i+1``
    in the high nibble; an odd extent is zero-padded. Output is a
    contiguous int8 tensor (the kernels' layout) with ``shape[axis] =
    ceil(n / 2)``."""
    axis = axis % q.dim()
    qi = q.to(torch.int32)
    if q.shape[axis] % 2:
        pad = list(qi.shape)
        pad[axis] = 1
        qi = torch.cat([qi, qi.new_zeros(pad)], dim=axis)
    b = (_take(qi, axis, 0, 2) & 0xF) | ((_take(qi, axis, 1, 2) & 0xF) << 4)
    return torch.where(b >= 128, b - 256, b).to(torch.int8).contiguous()


def unpack_w4(packed: torch.Tensor, size: int, axis: int = 0) -> torch.Tensor:
    """Inverse of :func:`pack_w4`: nibble-packed int8 -> int8 codes in
    [-8, 7] with ``shape[axis] = size`` (the pad element, if any, dropped).
    Each nibble is sign-extended by an int32 shift pair, as the kernels do."""
    axis = axis % packed.dim()
    pi = packed.to(torch.int32)
    lo = (pi << 28) >> 28                    # sign-extend bits 0-3
    hi = (pi << 24) >> 28                    # sign-extend bits 4-7
    out = torch.stack([lo, hi], dim=axis + 1)
    shape = list(packed.shape)
    shape[axis] *= 2
    return out.reshape(shape).narrow(axis, 0, size).to(torch.int8)


def expand_w4(packed: torch.Tensor, shifts: torch.Tensor, size: int,
              axis: int = 0) -> torch.Tensor:
    """Unpack and apply the per-element group shifts: the int8 weight codes
    (``q4 << shift`` at the base scale) every W4 kernel must match. Fits
    int8 because group shifts are at most :data:`W4_MAX_GROUP_SHIFT`."""
    w4 = unpack_w4(packed, size, axis).to(torch.int32)
    bshape = [1] * w4.dim()
    bshape[axis % w4.dim()] = size
    s = shifts.to(device=w4.device, dtype=torch.int32).reshape(bshape)
    return (w4 << s).to(torch.int8)


@dataclasses.dataclass
class QTensorW4:
    """Nibble-packed int4 weights with per-group power-of-two scales.

    ``q`` holds two codes per byte along ``axis`` (extent ``ceil(size/2)``);
    ``shifts`` (int8, length ``size``) is the per-element left shift,
    constant within a scale group, that brings each group's codes to the
    shared base scale ``2^-frac_bits``. ``expand()`` is the int8 weight
    tensor every W4 kernel must match bit for bit."""

    q: torch.Tensor                    # int8, nibble-packed along `axis`
    shifts: torch.Tensor               # int8, (size,)
    frac_bits: int
    size: int
    axis: int

    @property
    def scale(self) -> float:
        return 2.0 ** (-self.frac_bits)

    def expand(self) -> torch.Tensor:
        """Unpacked int8 codes at the base scale (the W8 weights)."""
        return expand_w4(self.q, self.shifts, self.size, self.axis)


def quantize_w4(w: torch.Tensor, *, axis: int = 0, group_size: int = 32,
                frac_bits: Optional[int] = None) -> QTensorW4:
    """Quantize float weights to packed int4 with per-group pow2 scales.

    Groups are ``group_size`` consecutive elements along ``axis`` (scales
    shared across every other axis). Group g gets its natural int4 scale
    ``fb_g = 3 - ceil(log2 max|w_g|)`` (a zero group the sentinel 127),
    clamped so that the group shift ``frac_bits - fb_g`` stays in [0, 4].
    The base ``frac_bits`` defaults to the finest usable common scale.
    Maxima are taken in float32 and the codes floored in float32, so the
    result equals the JAX package's bit for bit on the same weights."""
    axis = axis % w.dim()
    n = w.shape[axis]
    if group_size <= 0:
        raise ValueError(f"quantize_w4: group_size must be > 0, "
                         f"got {group_size}")
    n_groups = -(-n // group_size)
    wa = torch.movedim(w.to(torch.float32), axis, 0)
    natural = []
    for g in range(n_groups):
        m = float(wa[g * group_size:(g + 1) * group_size].abs().max())
        # int4: 3 usable magnitude bits; zero groups get a large sentinel
        # that the clamp below pins to the base scale (codes are all zero)
        natural.append(3 - math.ceil(math.log2(m)) if m > 0.0 else 127)
    if frac_bits is None:
        frac_bits = min(min(natural) + W4_MAX_GROUP_SHIFT, max(natural))
    q_groups, shift_groups = [], []
    for g, nat in enumerate(natural):
        fb_g = min(max(nat, frac_bits - W4_MAX_GROUP_SHIFT), frac_bits)
        q4 = torch.floor(wa[g * group_size:(g + 1) * group_size]
                         * (2.0 ** fb_g))
        q_groups.append(torch.clamp(q4, W4_MIN, W4_MAX).to(torch.int8))
        shift_groups.append(frac_bits - fb_g)
    q4 = torch.movedim(torch.cat(q_groups, dim=0), 0, axis)
    shifts = torch.tensor([shift_groups[i // group_size] for i in range(n)],
                          dtype=torch.int8, device=w.device)
    return QTensorW4(q=pack_w4(q4, axis), shifts=shifts, frac_bits=frac_bits,
                     size=n, axis=axis)
