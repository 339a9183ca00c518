"""int8, W4A8 and float SAME stride-1 depthwise convolution: the CUDA
kernel wrappers, their plain PyTorch versions and their launch counters.

Replaces the TPU kernel ``repro/kernels/conv_dw.py`` (``depthwise2d`` /
``_depthwise2d``) in all its modes; the source is ``csrc/conv_dw.cu``.
What bounds it on an H100: HK^2 MACs per output and no channel
contraction, so it is bound by the bytes it moves (about 2 MB per launch
at the model's shapes, under a microsecond of HBM time); this first kernel
takes 10-25x that, in one-byte loads with no reuse of the input taps. The design: one thread per output element, channels
fastest so a warp reads consecutive bytes, the epilogue of
``csrc/epilogue.cuh``.

The W4 mode (:func:`depthwise2d_w4`) takes the weight packed along the
tap-row axis, ``(ceil(HK/2), HK, C)``, so that channels stay the
contiguous axis, with one int8 group shift per tap row.

The float mode (:func:`depthwise2d_f`, float32 or bfloat16) is the same
design with a float32 accumulator, summed over the taps (i, j) in order;
its plain version repeats that order, one multiply and one add at a time,
so the two are bitwise equal. Bound by bytes, as the int8 mode.

Every wrapper takes ``threads``, the block size of its launch (the tuner's
knob); it changes no output.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.primitives import conv_nhwc
from repro_torch.core.quantize import expand_w4

from ._build import check_launch, library
from .common import (DEFAULT_THREADS, acc_dtype, apply_act, apply_requant,
                     check_threads, float_code)
from .conv_im2col import (MAX_CONTRACTION, check_act, check_cuda_operand,
                          check_elements, check_shift, check_w4, kernel_pads)


def depthwise2d_q8_plain(x, w_dw, *, requant_shift: int = 0, act=None):
    """Plain PyTorch version; ``w_dw`` is (HK,HK,C) or (HK,HK,C,1)."""
    w4 = w_dw[..., None] if w_dw.dim() == 3 else w_dw
    acc = conv_nhwc(x.to(torch.int32), w4.permute(0, 1, 3, 2).to(torch.int32),
                    pads=kernel_pads(w4.shape[0]), groups=x.shape[-1])
    acc = apply_act(acc, act)
    return apply_requant(acc, requant_shift).to(torch.int8)


def _check_dw(name, x, w_dw):
    """Shapes of one depthwise call: ``w_dw`` (HK,HK,C) or (HK,HK,C,1) ->
    the (HK,HK,C) view of it."""
    if x.dim() != 4 or w_dw.dim() not in (3, 4):
        raise ValueError(f"{name}: bad ranks x {tuple(x.shape)}, "
                         f"w {tuple(w_dw.shape)}")
    if w_dw.dim() == 4:
        if w_dw.shape[3] != 1:
            raise ValueError(f"{name}: weight {tuple(w_dw.shape)} "
                             "must be (HK,HK,C) or (HK,HK,C,1)")
        w_dw = w_dw[..., 0]
    hk = w_dw.shape[0]
    if tuple(w_dw.shape) != (hk, hk, x.shape[3]):
        raise ValueError(f"{name}: weight {tuple(w_dw.shape)} does "
                         f"not fit x {tuple(x.shape)}")
    check_elements(name, x.shape)
    return w_dw


def depthwise2d_q8(x, w_dw, *, requant_shift: int = 0, act=None,
                   threads: int = DEFAULT_THREADS):
    """x (N,H,W,C) int8, w_dw (HK,HK,C) or (HK,HK,C,1) int8 -> (N,H,W,C)
    int8."""
    w_dw = _check_dw("depthwise2d_q8", x, w_dw)
    n, h, wd, c = x.shape
    hk = w_dw.shape[0]
    if hk * hk > MAX_CONTRACTION:
        raise ValueError("depthwise2d_q8: kernel too large for int32")
    check_shift("depthwise2d_q8", requant_shift)
    check_act("depthwise2d_q8", act)
    check_threads("depthwise2d_q8", threads)
    if x.device.type == "cpu":
        return depthwise2d_q8_plain(x, w_dw, requant_shift=requant_shift,
                                    act=act)
    for t in (x, w_dw):
        check_cuda_operand("depthwise2d_q8", t, x.device, torch.int8)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = library().repro_depthwise2d_q8(
            x.data_ptr(), w_dw.data_ptr(), y.data_ptr(), n, h, wd, c, hk,
            requant_shift, int(act == "relu"), threads,
            torch.cuda.current_stream().cuda_stream)
    check_launch("depthwise2d_q8", rc)
    depthwise2d_q8.launches += 1
    return y


depthwise2d_q8.launches = 0


def _rank3(name, w):
    """(A,HK,C) or (A,HK,C,1) -> (A,HK,C)."""
    if w.dim() == 4:
        if w.shape[3] != 1:
            raise ValueError(f"{name}: weight {tuple(w.shape)} must be "
                             "rank 3 or end in a unit axis")
        return w[..., 0]
    if w.dim() != 3:
        raise ValueError(f"{name}: weight {tuple(w.shape)} must be rank 3 "
                         "or 4")
    return w


def depthwise2d_w4_plain(x, w_dw_p, w_shifts, *, requant_shift: int = 0,
                         act=None):
    """Plain W4 version: the tap rows expanded (``expand_w4`` along axis 0),
    then :func:`depthwise2d_q8_plain` unchanged."""
    w_dw_p = _rank3("depthwise2d_w4", w_dw_p)
    w = expand_w4(w_dw_p, w_shifts, w_dw_p.shape[1], 0)
    return depthwise2d_q8_plain(x, w, requant_shift=requant_shift, act=act)


def depthwise2d_w4(x, w_dw_p, w_shifts, *, requant_shift=None, act=None,
                   threads: int = DEFAULT_THREADS):
    """x (N,H,W,C) int8, w_dw_p (ceil(HK/2),HK,C) or (ceil(HK/2),HK,C,1)
    int8 nibble-packed along the tap rows, w_shifts (HK,) int8 ->
    (N,H,W,C) int8."""
    if x.dim() != 4:
        raise ValueError(f"depthwise2d_w4: x must be 4-D, got "
                         f"{tuple(x.shape)}")
    w_dw_p = _rank3("depthwise2d_w4", w_dw_p)
    n, h, wd, c = x.shape
    hk = w_dw_p.shape[1]
    check_w4("depthwise2d_w4", w_dw_p, 0, hk, w_shifts, requant_shift)
    if w_dw_p.shape[2] != c:
        raise ValueError(f"depthwise2d_w4: weight {tuple(w_dw_p.shape)} "
                         f"does not fit x {tuple(x.shape)}")
    if hk * hk > MAX_CONTRACTION:
        raise ValueError("depthwise2d_w4: kernel too large for int32")
    check_shift("depthwise2d_w4", requant_shift)
    check_act("depthwise2d_w4", act)
    check_elements("depthwise2d_w4", x.shape)
    check_threads("depthwise2d_w4", threads)
    if x.device.type == "cpu":
        return depthwise2d_w4_plain(x, w_dw_p, w_shifts,
                                    requant_shift=requant_shift, act=act)
    for t in (x, w_dw_p, w_shifts):
        check_cuda_operand("depthwise2d_w4", t, x.device, torch.int8)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = library().repro_depthwise2d_w4(
            x.data_ptr(), w_dw_p.data_ptr(), w_shifts.data_ptr(),
            y.data_ptr(), n, h, wd, c, hk, requant_shift, int(act == "relu"),
            threads, torch.cuda.current_stream().cuda_stream)
    check_launch("depthwise2d_w4", rc)
    depthwise2d_w4.launches += 1
    return y


depthwise2d_w4.launches = 0


def depthwise2d_f_plain(x, w_dw, *, act=None):
    """Plain float version in the kernel's order: float32 products and sums
    as separate operations from a zero accumulator over the taps (i, j) in
    order, on the kernel's zero padding; relu; one rounding to x's dtype."""
    w = (w_dw[..., 0] if w_dw.dim() == 4 else w_dw).to(torch.float32)
    _, h, wd, _ = x.shape
    hk = w.shape[0]
    (pt, pb), (pl, pr) = kernel_pads(hk)
    xp = F.pad(x.to(torch.float32), (0, 0, pl, pr, pt, pb))
    acc = torch.zeros(x.shape, dtype=acc_dtype(x.dtype), device=x.device)
    for i in range(hk):
        for j in range(hk):
            acc = acc + xp[:, i:i + h, j:j + wd] * w[i, j]
    return apply_act(acc, act).to(x.dtype)


def depthwise2d_f(x, w_dw, *, act=None, threads: int = DEFAULT_THREADS):
    """x (N,H,W,C) float32 or bfloat16, w_dw (HK,HK,C) or (HK,HK,C,1) in
    x's dtype -> (N,H,W,C) in x's dtype."""
    w_dw = _check_dw("depthwise2d_f", x, w_dw)
    check_act("depthwise2d_f", act)
    check_threads("depthwise2d_f", threads)
    if x.device.type == "cpu":
        return depthwise2d_f_plain(x, w_dw, act=act)
    code = float_code("depthwise2d_f", x)
    for t in (x, w_dw):
        check_cuda_operand("depthwise2d_f", t, x.device, x.dtype)
    n, h, wd, c = x.shape
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = library().repro_depthwise2d_f(
            x.data_ptr(), w_dw.data_ptr(), y.data_ptr(), n, h, wd, c,
            w_dw.shape[0], int(act == "relu"), code, threads,
            torch.cuda.current_stream().cuda_stream)
    check_launch("depthwise2d_f", rc)
    depthwise2d_f.launches += 1
    return y


depthwise2d_f.launches = 0
