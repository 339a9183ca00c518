"""Plain PyTorch oracles for the ported kernels, under the JAX package's
names (``repro/kernels/ref.py``).

The int8 oracles are the kernels' plain versions, re-exported from the
kernel modules: int8 operands, exact int32 accumulation and the same
Algorithm-1 epilogue as the CUDA kernels, so the kernels are bitwise equal
to them. The W4 oracles expand the nibble-packed weights
(``core.quantize.expand_w4``) and run the unchanged int8 oracle. The
float oracles pad as the JAX ones do: XLA's SAME, and (HK//2, (HK-1)//2)
for add-conv.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import primitives as P

from .common import apply_act
from .conv1d_causal import causal_conv1d_plain as causal_conv1d_f32
from .conv_add import add_conv2d_q8_plain as add_conv2d_q8_ref
from .conv_add import add_conv2d_w4_plain as add_conv2d_w4_ref
from .conv_dw import depthwise2d_q8_plain as depthwise2d_q8_ref
from .conv_dw import depthwise2d_w4_plain as depthwise2d_w4_ref
from .conv_im2col import conv2d_q8_plain as conv2d_q8_ref
from .conv_im2col import conv2d_w4_plain as conv2d_w4_ref
from .conv_shift import shift_conv2d_q8_plain as shift_conv2d_q8_ref
from .conv_shift import shift_conv2d_w4_plain as shift_conv2d_w4_ref
from .matmul_q8 import matmul_q8_plain
from .matmul_q8 import matmul_w4_plain as matmul_w4_ref
from .pool import maxpool2d_plain as maxpool2d_ref

__all__ = ["add_conv2d_ref", "add_conv2d_q8_ref", "add_conv2d_w4_ref",
           "causal_conv1d_f32", "causal_conv1d_ref", "conv2d_ref",
           "conv2d_q8_ref", "conv2d_w4_ref", "depthwise2d_ref",
           "depthwise2d_q8_ref", "depthwise2d_w4_ref", "matmul_ref",
           "matmul_w4_ref", "maxpool2d_ref",
           "shift_conv2d_ref", "shift_conv2d_q8_ref", "shift_conv2d_w4_ref"]


def conv2d_ref(x, w, bias=None, *, groups: int = 1, act=None):
    y = P.standard_conv(x, w, groups=groups)
    if bias is not None:
        y = y + bias
    return apply_act(y, act)


def depthwise2d_ref(x, w_dw, *, act=None):
    w4 = w_dw[..., None] if w_dw.dim() == 3 else w_dw
    return apply_act(P.depthwise_conv(x, w4), act)


def shift_conv2d_ref(x, shifts, w_pw, *, max_shift=None, act=None):
    w4 = w_pw[None, None] if w_pw.dim() == 2 else w_pw
    return apply_act(P.standard_conv(
        P.shift_channels(x, shifts, max_shift=max_shift), w4), act)


def add_conv2d_ref(x, w, *, act=None):
    return apply_act(P.add_conv(x, w), act)


def matmul_ref(a, b, *, requant_shift=None, act=None):
    """``a @ b``. With ``requant_shift``: int8 codes, exact int32 sums and
    the common epilogue (:func:`~repro_torch.kernels.matmul_q8.
    matmul_q8_plain`). Without: the float product, accumulated in float32
    and returned in ``a``'s dtype, as the JAX oracle does."""
    if requant_shift is not None:
        return matmul_q8_plain(a, b, requant_shift=requant_shift, act=act)
    y = torch.matmul(a.to(torch.float32), b.to(torch.float32))
    return apply_act(y, act).to(a.dtype)


def causal_conv1d_ref(x, w, *, act=None):
    """x: (B,L,D); w: (K,D) or (K,1,D). Zero history before t=0. The JAX
    oracle: products and sums in ``x``'s dtype (at bfloat16 it rounds after
    every operation, where the kernel rounds once)."""
    if w.dim() == 3:
        w = w[:, 0]
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for kk in range(k):
        out = out + xp[:, kk:kk + x.shape[1]] * w[kk]
    return apply_act(out, act)
