"""int8 shift convolution (per-channel shift fused into the pointwise
contraction): the CUDA kernel wrapper, its plain PyTorch version and its
launch counter.

Replaces the TPU kernel ``repro/kernels/conv_shift.py`` (``shift_conv2d``)
in its int8 mode; the source is ``csrc/conv_shift.cu``. What bounds it on an
H100: a 1x1 contraction over C channels, a few MB and well under a GFLOP per
launch at the model's shapes, so its floor is about a microsecond of HBM
time. The design: one thread per output element reads each channel at its
own displacement (no channel sort, which the TPU needed for its matrix unit)
and shares the epilogue of ``csrc/epilogue.cuh``.

The shift table stays on the device and is never read back per call: the
kernel's bounds checks are exact for any displacement, and its bound
(``max_shift``) is checked on the host once, when a plan is lowered or
loaded (``weights.plan_from_numpy``).

On a CPU tensor :func:`shift_conv2d_q8` runs :func:`shift_conv2d_q8_plain`;
on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.core.primitives import conv_nhwc, shift_channels

from ._build import check_launch, library
from .common import apply_act, apply_requant
from .conv_im2col import (MAX_CONTRACTION, check_act, check_cuda_operand,
                          check_elements, check_shift)


def _pointwise(w_pw):
    """(C,Cy) or (1,1,C,Cy) -> (C,Cy)."""
    return w_pw[0, 0] if w_pw.dim() == 4 else w_pw


def shift_conv2d_q8_plain(x, shifts, w_pw, bias=None, *,
                          requant_shift: int = 0, max_shift=None, act=None):
    """Plain PyTorch version: the shifted map gathered explicitly, an exact
    1x1 contraction (int32 on the host, float64 on a card), bias at
    accumulator scale, the common epilogue. Reads the table's bound on the
    host (a sync on a card)."""
    shifted = shift_channels(x.to(torch.int32), shifts, max_shift=max_shift)
    acc = conv_nhwc(shifted, _pointwise(w_pw)[None, None].to(torch.int32))
    if bias is not None:
        acc = acc + bias.to(torch.int32)
    acc = apply_act(acc, act)
    return apply_requant(acc, requant_shift).to(torch.int8)


def shift_conv2d_q8(x, shifts, w_pw, bias=None, *, requant_shift: int = 0,
                    max_shift=None, act=None):
    """x (N,H,W,C) int8, shifts (C,2) int32, w_pw (C,Cy) or (1,1,C,Cy) int8,
    bias (Cy,) int32 or None -> (N,H,W,Cy) int8. ``max_shift`` is used by the
    plain version only (see the module docstring)."""
    if x.dim() != 4 or w_pw.dim() not in (2, 4):
        raise ValueError(f"shift_conv2d_q8: bad ranks x {tuple(x.shape)}, "
                         f"w_pw {tuple(w_pw.shape)}")
    n, h, wd, c = x.shape
    wp = _pointwise(w_pw)
    cy = wp.shape[-1]
    if tuple(wp.shape) != (c, cy) or (w_pw.dim() == 4
                                      and w_pw.shape[:2] != (1, 1)):
        raise ValueError(f"shift_conv2d_q8: weight {tuple(w_pw.shape)} does "
                         f"not fit x {tuple(x.shape)}")
    if tuple(shifts.shape) != (c, 2):
        raise ValueError(f"shift_conv2d_q8: shift table "
                         f"{tuple(shifts.shape)} != ({c}, 2)")
    if bias is not None and tuple(bias.shape) != (cy,):
        raise ValueError(f"shift_conv2d_q8: bias shape {tuple(bias.shape)} "
                         f"!= ({cy},)")
    if c > MAX_CONTRACTION:
        raise ValueError(f"shift_conv2d_q8: contraction of {c} channels "
                         "could overflow the int32 accumulator")
    check_shift("shift_conv2d_q8", requant_shift)
    check_act("shift_conv2d_q8", act)
    check_elements("shift_conv2d_q8", x.shape, (n, h, wd, cy))
    if x.device.type == "cpu":
        return shift_conv2d_q8_plain(x, shifts, w_pw, bias,
                                     requant_shift=requant_shift,
                                     max_shift=max_shift, act=act)
    for t in (x, wp):
        check_cuda_operand("shift_conv2d_q8", t, x.device, torch.int8)
    check_cuda_operand("shift_conv2d_q8", shifts, x.device, torch.int32)
    if bias is not None:
        check_cuda_operand("shift_conv2d_q8", bias, x.device, torch.int32)
    y = torch.empty((n, h, wd, cy), dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        rc = library().repro_shift_conv2d_q8(
            x.data_ptr(), shifts.data_ptr(), wp.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            n, h, wd, c, cy, requant_shift, int(act == "relu"),
            torch.cuda.current_stream().cuda_stream)
    check_launch("shift_conv2d_q8", rc)
    shift_conv2d_q8.launches += 1
    return y


shift_conv2d_q8.launches = 0
