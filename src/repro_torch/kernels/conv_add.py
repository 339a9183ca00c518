"""int8, W4A8 and float add (AdderNet) convolution: the CUDA kernel
wrappers, their plain PyTorch versions and their launch counters.

Replaces the TPU kernel ``repro/kernels/conv_add.py`` (``add_conv2d`` /
``_add_conv2d``) in all its modes; the source is ``csrc/conv_add.cu``.
``-sum |x - w|`` is not a contraction, so neither the TPU's matrix unit nor
Hopper's tensor cores apply: the kernel runs on the CUDA cores' int32
lanes and is bound by operations (one ``|x - w|`` accumulate per tap,
channel and filter, about 0.72 G of them per 256-image forward of the add
plan, at least three int32 instructions each), not by bytes. Every mode
runs the implicit GEMM of ``csrc/fgemm.cuh`` (shared with the float conv):
a block stages its pixels' input window and its weights once, and each
thread sums :func:`~repro_torch.kernels.conv_im2col.pixels_a_thread`
pixels x ``q`` channels in registers, so every weight read from shared
memory serves a thread's pixels and every input ``q`` channels; a tap
outside the image reads a staged zero (a padded zero is not neutral under
L1: it adds ``|0 - w|``).

The integer modes stage ``x << x_preshift`` and ``w << w_preshift`` as
uint32 and sum ``|d|`` of the wrapped difference in uint32, so the result
equals JAX's int32 bit for bit at every tile (the sum is associative).
The W4 mode (:func:`add_conv2d_w4`) takes the weight packed along Cx
with one int8 group shift per input channel: each code is shifted to the
base scale first, then by ``w_preshift``, as the TPU kernel orders them,
and the pad nibble of an odd Cx is never summed (a zero weight is not
neutral under L1).

The float mode (:func:`add_conv2d_f`, float32 or bfloat16) has no
pre-shifts and no bias: ``acc = acc - |x - w|`` in float32 over taps
(i, j), then input channels, in order, bound by the CUDA cores' float32
rate (a subtract and a subtract of the absolute value per term, no FMA
form). Its plain version repeats that order, so the two are bitwise
equal; the TPU kernel sums each tap's channels before subtracting, so the
JAX package agrees within a tolerance.

:func:`add_f_plan` is every mode's launch arithmetic (the float conv's at
``groups=1``: each staged element is 4 bytes in every mode). Every
wrapper takes the tile ``bp`` (pixels a block) and ``q`` (channels a
thread), the tuner's knobs; they change no output.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.primitives import add_conv
from repro_torch.core.quantize import expand_w4, wrap_left_shift

from ._build import check_launch, library
from .common import acc_dtype, apply_act, apply_requant, float_code
from .conv_im2col import (check_act, check_cuda_operand, check_elements,
                          check_shift, check_tile, check_w4, conv_f_plan,
                          kernel_pads)


def add_f_plan(n: int, h: int, w: int, cx: int, cy: int, hk: int, bp: int,
               q: int) -> dict:
    """Every mode's launch arithmetic, as ``repro_add_conv2d_f_plan``
    computes it: the float conv's (``conv_im2col.conv_f_plan``) at
    ``groups=1``. Memoized: do not mutate the dict."""
    return conv_f_plan(n, h, w, cx, cy, hk, 1, bp, q)


def _tile(name, shape, bp, q) -> dict:
    """The tile an add-conv wrapper launches on ``shape`` = (n, h, w, cx,
    cy, hk): the float implicit GEMM's, whose plan every mode shares."""
    return check_tile(name, shape + (1,), bp, q, integer=False)


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


def _check_preshift(kernel: str, name: str, v):
    if not isinstance(v, int) or not 0 <= v <= 31:
        raise ValueError(f"{kernel}: {name} must be an int in [0, 31], "
                         f"got {v!r}")


def _check_add(name, x, w_shape, bias, requant_shift, x_preshift,
               w_preshift, act, integer=True):
    """Shapes and options of one add-conv call; ``w_shape`` is the unpacked
    (HK,HK,Cx,Cy). Returns (n, h, w, cx, cy, hk). The float mode
    (``integer=False``) has no pre-shifts and no requant shift."""
    if x.dim() != 4 or len(w_shape) != 4:
        raise ValueError(f"{name}: x and w must be 4-D, got "
                         f"{tuple(x.shape)} and {tuple(w_shape)}")
    n, h, wd, cx = x.shape
    hk, hk2, wcx, cy = w_shape
    if hk != hk2 or wcx != cx:
        raise ValueError(f"{name}: weight {tuple(w_shape)} does not fit "
                         f"x {tuple(x.shape)}")
    if bias is not None and tuple(bias.shape) != (cy,):
        raise ValueError(f"{name}: bias shape {tuple(bias.shape)} != "
                         f"({cy},)")
    if integer:
        _check_preshift(name, "x_preshift", x_preshift)
        _check_preshift(name, "w_preshift", w_preshift)
        check_shift(name, requant_shift)
    check_act(name, act)
    check_elements(name, x.shape, (n, h, wd, cy))
    return n, h, wd, cx, cy, hk


def add_conv2d_q8(x, w, bias=None, *, requant_shift: int = 0,
                  x_preshift: int = 0, w_preshift: int = 0, act=None,
                  bp=None, q=None):
    """x (N,H,W,Cx) int8, w (HK,HK,Cx,Cy) int8, bias (Cy,) int32 or None
    -> (N,H,W,Cy) int8, SAME stride 1. ``bp`` and ``q`` default to
    ``conv_im2col.default_f_tile`` at ``groups=1``."""
    n, h, wd, cx, cy, hk = _check_add("add_conv2d_q8", x, w.shape, bias,
                                      requant_shift, x_preshift, w_preshift,
                                      act)
    tile = _tile("add_conv2d_q8", (n, h, wd, cx, cy, hk), bp, q)
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
            int(act == "relu"), tile["bp"], tile["q"],
            torch.cuda.current_stream().cuda_stream)
    check_launch("add_conv2d_q8", rc)
    add_conv2d_q8.launches += 1
    return y


add_conv2d_q8.launches = 0


def add_conv2d_w4_plain(x, w_p, w_shifts, bias=None, *,
                        requant_shift: int = 0, x_preshift: int = 0,
                        w_preshift: int = 0, act=None):
    """Plain W4 version: the codes expanded to the base scale
    (``expand_w4`` along Cx, the pad nibble dropped), then
    :func:`add_conv2d_q8_plain` unchanged, which applies ``w_preshift``."""
    w = expand_w4(w_p, w_shifts, x.shape[-1], 2)
    return add_conv2d_q8_plain(x, w, bias, requant_shift=requant_shift,
                               x_preshift=x_preshift, w_preshift=w_preshift,
                               act=act)


def add_conv2d_w4(x, w_p, w_shifts, bias=None, *, requant_shift=None,
                  x_preshift: int = 0, w_preshift: int = 0, act=None,
                  bp=None, q=None):
    """x (N,H,W,Cx) int8, w_p (HK,HK,ceil(Cx/2),Cy) int8 nibble-packed
    along Cx, w_shifts (Cx,) int8, bias (Cy,) int32 or None -> (N,H,W,Cy)
    int8, SAME stride 1. ``bp`` and ``q`` default to
    ``conv_im2col.default_f_tile`` at ``groups=1``."""
    if x.dim() != 4 or w_p.dim() != 4:
        raise ValueError(f"add_conv2d_w4: x and w must be 4-D, got "
                         f"{tuple(x.shape)} and {tuple(w_p.shape)}")
    cx = x.shape[-1]
    check_w4("add_conv2d_w4", w_p, 2, cx, w_shifts, requant_shift)
    hk, hk2, _, cy = w_p.shape
    n, h, wd, cx, cy, hk = _check_add("add_conv2d_w4", x, (hk, hk2, cx, cy),
                                      bias, requant_shift, x_preshift,
                                      w_preshift, act)
    tile = _tile("add_conv2d_w4", (n, h, wd, cx, cy, hk), bp, q)
    if x.device.type == "cpu":
        return add_conv2d_w4_plain(x, w_p, w_shifts, bias,
                                   requant_shift=requant_shift,
                                   x_preshift=x_preshift,
                                   w_preshift=w_preshift, act=act)
    for t in (x, w_p, w_shifts):
        check_cuda_operand("add_conv2d_w4", t, x.device, torch.int8)
    if bias is not None:
        check_cuda_operand("add_conv2d_w4", bias, x.device, torch.int32)
    y = torch.empty((n, h, wd, cy), dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        rc = library().repro_add_conv2d_w4(
            x.data_ptr(), w_p.data_ptr(), w_shifts.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            n, h, wd, cx, cy, hk, x_preshift, w_preshift, requant_shift,
            int(act == "relu"), tile["bp"], tile["q"],
            torch.cuda.current_stream().cuda_stream)
    check_launch("add_conv2d_w4", rc)
    add_conv2d_w4.launches += 1
    return y


add_conv2d_w4.launches = 0


def add_conv2d_f_plain(x, w, *, act=None):
    """Plain float version in the kernel's order: ``acc = acc - |x - w|``
    in float32 from zero over taps (i, j), then input channels c, in order,
    each subtraction its own operation, on the kernel's zero padding (a
    padded zero still adds ``|0 - w|``); relu; one rounding to x's
    dtype."""
    _, h, wd, _ = x.shape
    hk, _, cx, cy = w.shape
    (pt, pb), (pl, pr) = kernel_pads(hk)
    xp = F.pad(x.to(torch.float32), (0, 0, pl, pr, pt, pb))
    w32 = w.to(torch.float32)
    acc = torch.zeros(x.shape[:3] + (cy,), dtype=acc_dtype(x.dtype),
                      device=x.device)
    for i in range(hk):
        for j in range(hk):
            win = xp[:, i:i + h, j:j + wd]
            for c in range(cx):
                acc = acc - (win[..., c:c + 1] - w32[i, j, c]).abs()
    return apply_act(acc, act).to(x.dtype)


def add_conv2d_f(x, w, *, act=None, bp=None, q=None):
    """x (N,H,W,Cx) float32 or bfloat16, w (HK,HK,Cx,Cy) in x's dtype ->
    (N,H,W,Cy) in x's dtype, SAME stride 1. ``bp`` and ``q`` default to
    ``conv_im2col.default_f_tile`` at ``groups=1``."""
    n, h, wd, cx, cy, hk = _check_add("add_conv2d_f", x, w.shape, None, None,
                                      0, 0, act, integer=False)
    tile = _tile("add_conv2d_f", (n, h, wd, cx, cy, hk), bp, q)
    if x.device.type == "cpu":
        return add_conv2d_f_plain(x, w, act=act)
    code = float_code("add_conv2d_f", x)
    for t in (x, w):
        check_cuda_operand("add_conv2d_f", t, x.device, x.dtype)
    y = torch.empty((n, h, wd, cy), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = library().repro_add_conv2d_f(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), n, h, wd, cx, cy, hk,
            int(act == "relu"), code, tile["bp"], tile["q"],
            torch.cuda.current_stream().cuda_stream)
    check_launch("add_conv2d_f", rc)
    add_conv2d_f.launches += 1
    return y


add_conv2d_f.launches = 0
