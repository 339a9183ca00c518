"""int8 SAME stride-1 depthwise convolution: the CUDA kernel wrapper, its
plain PyTorch version and its launch counter.

Replaces the TPU kernel ``repro/kernels/conv_dw.py`` (``depthwise2d`` /
``_depthwise2d``) in its int8 mode; the source is ``csrc/conv_dw.cu``.
What bounds it on an H100: HK^2 MACs per output and no channel
contraction, so it is bound by the bytes it moves (about 2 MB per launch
at the model's shapes, under a microsecond of HBM time); this first kernel
takes 10-25x that, in one-byte loads with no reuse of the input taps. The design: one thread per output element, channels
fastest so a warp reads consecutive bytes, the epilogue of
``csrc/epilogue.cuh``.

On a CPU tensor :func:`depthwise2d_q8` runs :func:`depthwise2d_q8_plain`;
on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.core.primitives import conv_nhwc

from ._build import check_launch, library
from .common import apply_act, apply_requant
from .conv_im2col import (MAX_CONTRACTION, check_act, check_cuda_operand,
                          check_elements, check_shift, kernel_pads)


def depthwise2d_q8_plain(x, w_dw, *, requant_shift: int = 0, act=None):
    """Plain PyTorch version; ``w_dw`` is (HK,HK,C) or (HK,HK,C,1)."""
    w4 = w_dw[..., None] if w_dw.dim() == 3 else w_dw
    acc = conv_nhwc(x.to(torch.int32), w4.permute(0, 1, 3, 2).to(torch.int32),
                    pads=kernel_pads(w4.shape[0]), groups=x.shape[-1])
    acc = apply_act(acc, act)
    return apply_requant(acc, requant_shift).to(torch.int8)


def depthwise2d_q8(x, w_dw, *, requant_shift: int = 0, act=None):
    """x (N,H,W,C) int8, w_dw (HK,HK,C) or (HK,HK,C,1) int8 -> (N,H,W,C)
    int8."""
    if x.dim() != 4 or w_dw.dim() not in (3, 4):
        raise ValueError(f"depthwise2d_q8: bad ranks x {tuple(x.shape)}, "
                         f"w {tuple(w_dw.shape)}")
    n, h, wd, c = x.shape
    if w_dw.dim() == 4:
        if w_dw.shape[3] != 1:
            raise ValueError(f"depthwise2d_q8: weight {tuple(w_dw.shape)} "
                             "must be (HK,HK,C) or (HK,HK,C,1)")
        w_dw = w_dw[..., 0]
    hk = w_dw.shape[0]
    if tuple(w_dw.shape) != (hk, hk, c):
        raise ValueError(f"depthwise2d_q8: weight {tuple(w_dw.shape)} does "
                         f"not fit x {tuple(x.shape)}")
    if hk * hk > MAX_CONTRACTION:
        raise ValueError("depthwise2d_q8: kernel too large for int32")
    check_shift("depthwise2d_q8", requant_shift)
    check_act("depthwise2d_q8", act)
    check_elements("depthwise2d_q8", x.shape)
    if x.device.type == "cpu":
        return depthwise2d_q8_plain(x, w_dw, requant_shift=requant_shift,
                                    act=act)
    for t in (x, w_dw):
        check_cuda_operand("depthwise2d_q8", t, x.device, torch.int8)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = library().repro_depthwise2d_q8(
            x.data_ptr(), w_dw.data_ptr(), y.data_ptr(), n, h, wd, c, hk,
            requant_shift, int(act == "relu"),
            torch.cuda.current_stream().cuda_stream)
    check_launch("depthwise2d_q8", rc)
    depthwise2d_q8.launches += 1
    return y


depthwise2d_q8.launches = 0
