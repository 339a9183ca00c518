"""int8 add (AdderNet) convolution: the CUDA kernel wrapper, its plain
PyTorch version and its launch counter.

Replaces the TPU kernel ``repro/kernels/conv_add.py`` (``add_conv2d`` /
``_add_conv2d``) in its int8 mode; the source is ``csrc/conv_add.cu``.
``-sum |x - w|`` is not a contraction, so neither the TPU's matrix unit nor
Hopper's tensor cores apply: the kernel runs on the CUDA cores' int32 lanes
and is bound by operations (one ``|x - w|`` accumulate per tap, channel
and filter, about 0.72 G of them per 256-image forward of the add plan),
not by bytes. The design: one thread per output element, taps outside the
image read as zero (a padded zero is not neutral under L1), every step in
wrapping 32-bit arithmetic so the result equals JAX's int32 bit for bit.

On a CPU tensor :func:`add_conv2d_q8` runs :func:`add_conv2d_q8_plain`; on a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.core.primitives import add_conv
from repro_torch.core.quantize import wrap_left_shift

from ._build import check_launch, library
from .common import apply_act, apply_requant
from .conv_im2col import (check_act, check_cuda_operand, check_elements,
                          check_shift)


def add_conv2d_q8_plain(x, w, bias=None, *, requant_shift: int = 0,
                        x_preshift: int = 0, w_preshift: int = 0, act=None):
    """Plain PyTorch version: the pre-shifts, then ``primitives.add_conv``
    on the integer codes (tap by tap, wrapping as int32), bias at
    accumulator scale, the common epilogue."""
    acc = add_conv(wrap_left_shift(x, x_preshift),
                   wrap_left_shift(w, w_preshift))
    if bias is not None:
        acc = acc + bias.to(torch.int32)
    acc = apply_act(acc, act)
    return apply_requant(acc, requant_shift).to(torch.int8)


def _check_preshift(name: str, v):
    if not isinstance(v, int) or not 0 <= v <= 31:
        raise ValueError(f"add_conv2d_q8: {name} must be an int in [0, 31], "
                         f"got {v!r}")


def add_conv2d_q8(x, w, bias=None, *, requant_shift: int = 0,
                  x_preshift: int = 0, w_preshift: int = 0, act=None):
    """x (N,H,W,Cx) int8, w (HK,HK,Cx,Cy) int8, bias (Cy,) int32 or None
    -> (N,H,W,Cy) int8, SAME stride 1."""
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"add_conv2d_q8: x and w must be 4-D, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    n, h, wd, cx = x.shape
    hk, hk2, wcx, cy = w.shape
    if hk != hk2 or wcx != cx:
        raise ValueError(f"add_conv2d_q8: weight {tuple(w.shape)} does not "
                         f"fit x {tuple(x.shape)}")
    if bias is not None and tuple(bias.shape) != (cy,):
        raise ValueError(f"add_conv2d_q8: bias shape {tuple(bias.shape)} != "
                         f"({cy},)")
    _check_preshift("x_preshift", x_preshift)
    _check_preshift("w_preshift", w_preshift)
    check_shift("add_conv2d_q8", requant_shift)
    check_act("add_conv2d_q8", act)
    check_elements("add_conv2d_q8", x.shape, (n, h, wd, cy))
    if x.device.type == "cpu":
        return add_conv2d_q8_plain(x, w, bias, requant_shift=requant_shift,
                                   x_preshift=x_preshift,
                                   w_preshift=w_preshift, act=act)
    for t in (x, w):
        check_cuda_operand("add_conv2d_q8", t, x.device, torch.int8)
    if bias is not None:
        check_cuda_operand("add_conv2d_q8", bias, x.device, torch.int32)
    y = torch.empty((n, h, wd, cy), dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        rc = library().repro_add_conv2d_q8(
            x.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            n, h, wd, cx, cy, hk, x_preshift, w_preshift, requant_shift,
            int(act == "relu"), torch.cuda.current_stream().cuda_stream)
    check_launch("add_conv2d_q8", rc)
    add_conv2d_q8.launches += 1
    return y


add_conv2d_q8.launches = 0
