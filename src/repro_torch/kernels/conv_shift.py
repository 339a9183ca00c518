"""int8, W4A8 and float shift convolution (per-channel shift fused into the
pointwise contraction): the CUDA kernel wrappers, their plain PyTorch
versions and their launch counters.

Replaces the TPU kernel ``repro/kernels/conv_shift.py`` (``shift_conv2d``)
in all its modes; the source is ``csrc/conv_shift.cu``. What bounds
it on an H100: a 1x1 contraction over C channels, a few MB and well under a
GFLOP per launch at the model's shapes, so its floor is about a microsecond
of HBM time. The design: one thread per output element reads each channel at
its own displacement (no channel sort, which the TPU needed for its matrix
unit) and shares the epilogue of ``csrc/epilogue.cuh``.

The shift table stays on the device and is never read back per call: the
kernel's bounds checks are exact for any displacement, and its bound
(``max_shift``) is checked on the host once, when a plan is lowered or
loaded (``weights.plan_from_numpy``).

The W4 mode (:func:`shift_conv2d_w4`) takes the pointwise weight packed
along C with one int8 group shift per channel. The TPU wrapper re-packs
the nibbles along its channel sort; with no sort there is nothing to
re-pack.

The float mode (:func:`shift_conv2d_f`, float32 or bfloat16) sums the
input channels in index order, each at its own shift, in float32; its
plain version repeats that order one multiply and one add at a time, so the
two are bitwise equal. The TPU kernel sums per shift group on its matrix
unit, so the float mode agrees with the JAX package within a tolerance
(ROADMAP.md, section C: float shift is not bitwise even inside the
reference).

Every wrapper takes ``threads``, the block size of its launch (the tuner's
knob); it changes no output.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.core.primitives import conv_nhwc, shift_channels
from repro_torch.core.quantize import expand_w4

from ._build import check_launch, library
from .common import (DEFAULT_THREADS, acc_dtype, apply_act, apply_requant,
                     check_threads, float_code)
from .conv_im2col import (MAX_CONTRACTION, check_act, check_cuda_operand,
                          check_elements, check_shift, check_w4)


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


def _check_shift_conv(name, x, shifts, wp_shape, bias, requant_shift, act,
                      integer=True):
    """Shapes and options of one shift-conv call; ``wp_shape`` is the
    unpacked (C,Cy). Returns (n, h, w, c, cy). The float mode
    (``integer=False``) has no requant shift and no int32 to overflow."""
    n, h, wd, c = x.shape
    cy = wp_shape[-1]
    if tuple(wp_shape) != (c, cy):
        raise ValueError(f"{name}: weight {tuple(wp_shape)} does not fit "
                         f"x {tuple(x.shape)}")
    if tuple(shifts.shape) != (c, 2):
        raise ValueError(f"{name}: shift table {tuple(shifts.shape)} != "
                         f"({c}, 2)")
    if bias is not None and tuple(bias.shape) != (cy,):
        raise ValueError(f"{name}: bias shape {tuple(bias.shape)} != "
                         f"({cy},)")
    if integer:
        if c > MAX_CONTRACTION:
            raise ValueError(f"{name}: contraction of {c} channels could "
                             "overflow the int32 accumulator")
        check_shift(name, requant_shift)
    check_act(name, act)
    check_elements(name, x.shape, (n, h, wd, cy))
    return n, h, wd, c, cy


def _check_ranks(name, x, w_pw):
    if x.dim() != 4 or w_pw.dim() not in (2, 4) or (
            w_pw.dim() == 4 and w_pw.shape[:2] != (1, 1)):
        raise ValueError(f"{name}: bad ranks x {tuple(x.shape)}, w_pw "
                         f"{tuple(w_pw.shape)}")


def shift_conv2d_q8(x, shifts, w_pw, bias=None, *, requant_shift: int = 0,
                    max_shift=None, act=None, threads: int = DEFAULT_THREADS):
    """x (N,H,W,C) int8, shifts (C,2) int32, w_pw (C,Cy) or (1,1,C,Cy) int8,
    bias (Cy,) int32 or None -> (N,H,W,Cy) int8. ``max_shift`` is used by the
    plain version only (see the module docstring)."""
    _check_ranks("shift_conv2d_q8", x, w_pw)
    wp = _pointwise(w_pw)
    n, h, wd, c, cy = _check_shift_conv("shift_conv2d_q8", x, shifts,
                                        wp.shape, bias, requant_shift, act)
    check_threads("shift_conv2d_q8", threads)
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
            n, h, wd, c, cy, requant_shift, int(act == "relu"), threads,
            torch.cuda.current_stream().cuda_stream)
    check_launch("shift_conv2d_q8", rc)
    shift_conv2d_q8.launches += 1
    return y


shift_conv2d_q8.launches = 0


def shift_conv2d_w4_plain(x, shifts, w_pw_p, w_shifts, bias=None, *,
                          requant_shift: int = 0, max_shift=None, act=None):
    """Plain W4 version: the pointwise codes expanded (``expand_w4`` along
    C), then :func:`shift_conv2d_q8_plain` unchanged."""
    w = expand_w4(_pointwise(w_pw_p), w_shifts, x.shape[-1], 0)
    return shift_conv2d_q8_plain(x, shifts, w, bias,
                                 requant_shift=requant_shift,
                                 max_shift=max_shift, act=act)


def shift_conv2d_w4(x, shifts, w_pw_p, w_shifts, bias=None, *,
                    requant_shift=None, max_shift=None, act=None,
                    threads: int = DEFAULT_THREADS):
    """x (N,H,W,C) int8, shifts (C,2) int32, w_pw_p (ceil(C/2),Cy) or
    (1,1,ceil(C/2),Cy) int8 nibble-packed along C, w_shifts (C,) int8, bias
    (Cy,) int32 or None -> (N,H,W,Cy) int8. ``max_shift`` is used by the
    plain version only."""
    _check_ranks("shift_conv2d_w4", x, w_pw_p)
    wp = _pointwise(w_pw_p)
    c = x.shape[-1]
    check_w4("shift_conv2d_w4", wp, 0, c, w_shifts, requant_shift)
    n, h, wd, c, cy = _check_shift_conv("shift_conv2d_w4", x, shifts,
                                        (c, wp.shape[-1]), bias,
                                        requant_shift, act)
    check_threads("shift_conv2d_w4", threads)
    if x.device.type == "cpu":
        return shift_conv2d_w4_plain(x, shifts, w_pw_p, w_shifts, bias,
                                     requant_shift=requant_shift,
                                     max_shift=max_shift, act=act)
    for t in (x, wp, w_shifts):
        check_cuda_operand("shift_conv2d_w4", t, x.device, torch.int8)
    check_cuda_operand("shift_conv2d_w4", shifts, x.device, torch.int32)
    if bias is not None:
        check_cuda_operand("shift_conv2d_w4", bias, x.device, torch.int32)
    y = torch.empty((n, h, wd, cy), dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        rc = library().repro_shift_conv2d_w4(
            x.data_ptr(), shifts.data_ptr(), wp.data_ptr(),
            w_shifts.data_ptr(), None if bias is None else bias.data_ptr(),
            y.data_ptr(), n, h, wd, c, cy, requant_shift, int(act == "relu"),
            threads, torch.cuda.current_stream().cuda_stream)
    check_launch("shift_conv2d_w4", rc)
    shift_conv2d_w4.launches += 1
    return y


shift_conv2d_w4.launches = 0


def shift_conv2d_f_plain(x, shifts, w_pw, *, max_shift=None, act=None):
    """Plain float version in the kernel's order: the shifted map gathered
    explicitly (zero outside the image), then float32 products and sums as
    separate operations from a zero accumulator over the channels in index
    order; relu; one rounding to x's dtype. Reads the table's bound on the
    host (a sync on a card)."""
    shifted = shift_channels(x.to(torch.float32), shifts, max_shift=max_shift)
    wp = _pointwise(w_pw).to(torch.float32)
    n, h, wd, c = x.shape
    acc = torch.zeros((n, h, wd, wp.shape[-1]), dtype=acc_dtype(x.dtype),
                      device=x.device)
    for ch in range(c):
        acc = acc + shifted[..., ch:ch + 1] * wp[ch]
    return apply_act(acc, act).to(x.dtype)


def shift_conv2d_f(x, shifts, w_pw, *, max_shift=None, act=None,
                   threads: int = DEFAULT_THREADS):
    """x (N,H,W,C) float32 or bfloat16, shifts (C,2) int32, w_pw (C,Cy) or
    (1,1,C,Cy) in x's dtype -> (N,H,W,Cy) in x's dtype. ``max_shift`` is
    used by the plain version only."""
    _check_ranks("shift_conv2d_f", x, w_pw)
    wp = _pointwise(w_pw)
    n, h, wd, c, cy = _check_shift_conv("shift_conv2d_f", x, shifts,
                                        wp.shape, None, None, act,
                                        integer=False)
    check_threads("shift_conv2d_f", threads)
    if x.device.type == "cpu":
        return shift_conv2d_f_plain(x, shifts, w_pw, max_shift=max_shift,
                                    act=act)
    code = float_code("shift_conv2d_f", x)
    for t in (x, wp):
        check_cuda_operand("shift_conv2d_f", t, x.device, x.dtype)
    check_cuda_operand("shift_conv2d_f", shifts, x.device, torch.int32)
    y = torch.empty((n, h, wd, cy), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = library().repro_shift_conv2d_f(
            x.data_ptr(), shifts.data_ptr(), wp.data_ptr(), y.data_ptr(),
            n, h, wd, c, cy, int(act == "relu"), code, threads,
            torch.cuda.current_stream().cuda_stream)
    check_launch("shift_conv2d_f", rc)
    shift_conv2d_f.launches += 1
    return y


shift_conv2d_f.launches = 0
