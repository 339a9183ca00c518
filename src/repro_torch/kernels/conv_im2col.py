"""int8, W4A8 and float SAME stride-1 standard / grouped convolution: the
CUDA kernel wrappers, their plain PyTorch versions and their launch
counters.

Replaces the TPU kernel ``repro/kernels/conv_im2col.py`` (``conv2d_im2col``
/ ``_conv2d_im2col``) in all its modes; the source is
``csrc/conv_im2col.cu``. What bounds it on an H100: at the model's shapes
(B=256, up to 32x32x16 outputs) each launch moves a few MB and does well
under a GFLOP of int8 work, so its floor is a microsecond or two of HBM
time. This first kernel is far from that floor: one thread per output
element issues two one-byte loads per multiply-add and reuses nothing in
registers, so load-instruction throughput bounds it (the 3->16 stem at B=256
takes over a hundred microseconds on an H100 SXM at 700 W; PERF.md has the
numbers). The design answers correctness first: exact int32 accumulation and
the epilogue of ``csrc/epilogue.cuh``; register blocking over output
channels, tensor cores and input tiling come later.

The W4 mode (:func:`conv2d_w4`) reads the nibble-packed weight bytes and
the int8 group shifts and unpacks each code in registers, so the weight
bytes it moves are half the int8 mode's; its plain version expands the
codes (``expand_w4``) and runs the int8 plain version.

The float mode (:func:`conv2d_f`, float32 or bfloat16) runs the same
one-thread-per-output design with a float32 accumulator: at Table-2's
``ci=128, k=3`` layer each output sums 1,152 products, about 30 MFLOP per
image, so it is bound by operations at the card's float32 rate (not
tensor cores), and this first kernel, reloading every operand from L1 or
L2, is far from that too. Its plain version sums in the kernel's order,
tap row, tap column, then input channel, one float32 multiply and one add
at a time, so the two are bitwise equal; JAX's oracle and the Pallas
kernel sum in other orders and agree within a tolerance.

Every wrapper takes ``threads``, the block size of its launch (the tuner's
knob, ``repro_torch.tune``); it changes no output.

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

#: largest Cx/g * HK^2 whose int8 x int8 sum cannot leave int32
MAX_CONTRACTION = (2 ** 31 - 1) // (128 * 128)
#: the kernels index with 32-bit ints: every tensor stays below this size
MAX_ELEMENTS = 2 ** 31 - 2 ** 16


def kernel_pads(hk: int):
    """The TPU kernel's SAME padding, (HK//2, (HK-1)//2) per spatial axis
    (asymmetric for even HK; XLA's SAME pads the other way round)."""
    return ((hk // 2, (hk - 1) // 2),) * 2


def conv2d_q8_plain(x, w, bias=None, *, groups: int = 1,
                    requant_shift: int = 0, act=None):
    """Plain PyTorch version: int32 contraction (float64 on a card, which is
    exact for these sums), bias at accumulator scale, the common epilogue."""
    acc = conv_nhwc(x.to(torch.int32), w.to(torch.int32),
                    pads=kernel_pads(w.shape[0]), groups=groups)
    if bias is not None:
        acc = acc + bias.to(torch.int32)
    acc = apply_act(acc, act)
    return apply_requant(acc, requant_shift).to(torch.int8)


def check_shift(name: str, requant_shift):
    if not isinstance(requant_shift, int) or not -31 <= requant_shift <= 31:
        raise ValueError(f"{name}: requant_shift must be an int in "
                         f"[-31, 31], got {requant_shift!r}")


def check_act(name: str, act):
    if act not in (None, "relu"):
        raise ValueError(f"{name}: unknown act {act!r}; expected 'relu' or "
                         "None")


def check_elements(name: str, *shapes):
    for shape in shapes:
        if torch.Size(shape).numel() > MAX_ELEMENTS:
            raise ValueError(f"{name}: {tuple(shape)} has more elements than "
                             "the kernel's 32-bit indexing allows")


def check_cuda_operand(name: str, t: torch.Tensor, device, dtype):
    if t.device != device:
        raise ValueError(f"{name}: operand on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: operand dtype {t.dtype}, kernel takes "
                        f"{dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: operands must be contiguous")


def check_w4(name: str, w_p, axis: int, size: int, w_shifts,
             requant_shift):
    """A W4 weight operand: int8 bytes packed along ``axis`` (extent
    ``ceil(size/2)``) and an int8 shift vector of length ``size``. W4 has
    no float mode, so ``requant_shift`` must be given."""
    if requant_shift is None:
        raise ValueError(f"{name}: W4 weights need the quantized path "
                         "(requant_shift); there is no float W4 mode")
    if w_p.dtype != torch.int8 or w_shifts.dtype != torch.int8:
        raise TypeError(f"{name}: packed weights and shifts must be int8, "
                        f"got {w_p.dtype} and {w_shifts.dtype}")
    if w_p.shape[axis] != (size + 1) // 2:
        raise ValueError(f"{name}: packed extent {w_p.shape[axis]} along "
                         f"axis {axis} != ceil({size}/2)")
    if tuple(w_shifts.shape) != (size,):
        raise ValueError(f"{name}: shifts {tuple(w_shifts.shape)} != "
                         f"({size},)")


def _check_conv(name, x, w_shape, bias, groups, requant_shift, act,
                integer=True):
    """Shapes and options of one conv call; ``w_shape`` is the unpacked
    (HK,HK,Cx/g,Cy). Returns (n, h, w, cx, cy, hk). The float mode
    (``integer=False``) has no requant shift and no int32 to overflow."""
    if x.dim() != 4 or len(w_shape) != 4:
        raise ValueError(f"{name}: x and w must be 4-D, got "
                         f"{tuple(x.shape)} and {tuple(w_shape)}")
    n, h, wd, cx = x.shape
    hk, hk2, cxg, cy = w_shape
    if hk != hk2 or groups < 1 or cx != cxg * groups or cy % groups:
        raise ValueError(f"{name}: weight {tuple(w_shape)} does not fit "
                         f"x {tuple(x.shape)} with groups={groups}")
    if bias is not None and tuple(bias.shape) != (cy,):
        raise ValueError(f"{name}: bias shape {tuple(bias.shape)} != "
                         f"({cy},)")
    if integer:
        if cxg * hk * hk > MAX_CONTRACTION:
            raise ValueError(f"{name}: contraction of {cxg * hk * hk} taps "
                             "could overflow the int32 accumulator")
        check_shift(name, requant_shift)
    check_act(name, act)
    check_elements(name, x.shape, (n, h, wd, cy))
    return n, h, wd, cx, cy, hk


def conv2d_q8(x, w, bias=None, *, groups: int = 1, requant_shift: int = 0,
              act=None, threads: int = DEFAULT_THREADS):
    """x (N,H,W,Cx) int8, w (HK,HK,Cx/g,Cy) int8, bias (Cy,) int32 or None
    -> (N,H,W,Cy) int8."""
    n, h, wd, cx, cy, hk = _check_conv("conv2d_q8", x, w.shape, bias, groups,
                                       requant_shift, act)
    check_threads("conv2d_q8", threads)
    if x.device.type == "cpu":
        return conv2d_q8_plain(x, w, bias, groups=groups,
                               requant_shift=requant_shift, act=act)
    for t in (x, w):
        check_cuda_operand("conv2d_q8", t, x.device, torch.int8)
    if bias is not None:
        check_cuda_operand("conv2d_q8", bias, x.device, torch.int32)
    y = torch.empty((n, h, wd, cy), dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        rc = library().repro_conv2d_q8(
            x.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            n, h, wd, cx, cy, hk, groups, requant_shift, int(act == "relu"),
            threads, torch.cuda.current_stream().cuda_stream)
    check_launch("conv2d_q8", rc)
    conv2d_q8.launches += 1
    return y


conv2d_q8.launches = 0


def conv2d_w4_plain(x, w_p, w_shifts, bias=None, *, groups: int = 1,
                    requant_shift: int = 0, act=None):
    """Plain W4 version: the weight codes expanded (``expand_w4`` along
    Cx/g), then :func:`conv2d_q8_plain` unchanged."""
    w = expand_w4(w_p, w_shifts, x.shape[-1] // groups, 2)
    return conv2d_q8_plain(x, w, bias, groups=groups,
                           requant_shift=requant_shift, act=act)


def conv2d_w4(x, w_p, w_shifts, bias=None, *, groups: int = 1,
              requant_shift=None, act=None, threads: int = DEFAULT_THREADS):
    """x (N,H,W,Cx) int8, w_p (HK,HK,ceil(Cx/g/2),Cy) int8 nibble-packed
    along Cx/g, w_shifts (Cx/g,) int8, bias (Cy,) int32 or None ->
    (N,H,W,Cy) int8."""
    if x.dim() != 4 or w_p.dim() != 4:
        raise ValueError(f"conv2d_w4: x and w must be 4-D, got "
                         f"{tuple(x.shape)} and {tuple(w_p.shape)}")
    cxg = x.shape[-1] // max(groups, 1)
    check_w4("conv2d_w4", w_p, 2, cxg, w_shifts, requant_shift)
    hk, _, _, cy = w_p.shape
    n, h, wd, cx, cy, hk = _check_conv("conv2d_w4", x, (hk, hk, cxg, cy),
                                       bias, groups, requant_shift, act)
    check_threads("conv2d_w4", threads)
    if x.device.type == "cpu":
        return conv2d_w4_plain(x, w_p, w_shifts, bias, groups=groups,
                               requant_shift=requant_shift, act=act)
    for t in (x, w_p, w_shifts):
        check_cuda_operand("conv2d_w4", t, x.device, torch.int8)
    if bias is not None:
        check_cuda_operand("conv2d_w4", bias, x.device, torch.int32)
    y = torch.empty((n, h, wd, cy), dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        rc = library().repro_conv2d_w4(
            x.data_ptr(), w_p.data_ptr(), w_shifts.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            n, h, wd, cx, cy, hk, groups, requant_shift, int(act == "relu"),
            threads, torch.cuda.current_stream().cuda_stream)
    check_launch("conv2d_w4", rc)
    conv2d_w4.launches += 1
    return y


conv2d_w4.launches = 0


def conv2d_f_plain(x, w, bias=None, *, groups: int = 1, act=None):
    """Plain float version in the kernel's order: float32 products and sums
    as separate operations from a zero accumulator, tap row i, tap column j,
    then input channel c of the output's group, over the kernel's zero
    padding; then the bias in float32, relu and one rounding to x's
    dtype."""
    n, h, wd, cx = x.shape
    hk, _, cxg, cy = w.shape
    (pt, pb), (pl, pr) = kernel_pads(hk)
    xp = F.pad(x.to(torch.float32), (0, 0, pl, pr, pt, pb))
    w32 = w.to(torch.float32)
    acc = torch.zeros((n, h, wd, cy), dtype=acc_dtype(x.dtype),
                      device=x.device)
    for i in range(hk):
        for j in range(hk):
            win = xp[:, i:i + h, j:j + wd]
            for c in range(cxg):
                # channel g * cxg + c of every group g, one per output
                xs = win[..., c::cxg]
                if groups > 1:
                    xs = xs.repeat_interleave(cy // groups, dim=-1)
                acc = acc + xs * w32[i, j, c]
    if bias is not None:
        acc = acc + bias.to(torch.float32)
    return apply_act(acc, act).to(x.dtype)


def conv2d_f(x, w, bias=None, *, groups: int = 1, act=None,
             threads: int = DEFAULT_THREADS):
    """x (N,H,W,Cx) float32 or bfloat16, w (HK,HK,Cx/g,Cy) and bias (Cy,)
    or None in x's dtype -> (N,H,W,Cy) in x's dtype."""
    n, h, wd, cx, cy, hk = _check_conv("conv2d_f", x, w.shape, bias, groups,
                                       None, act, integer=False)
    check_threads("conv2d_f", threads)
    if x.device.type == "cpu":
        return conv2d_f_plain(x, w, bias, groups=groups, act=act)
    code = float_code("conv2d_f", x)
    for t in (x, w) + (() if bias is None else (bias,)):
        check_cuda_operand("conv2d_f", t, x.device, x.dtype)
    y = torch.empty((n, h, wd, cy), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = library().repro_conv2d_f(
            x.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            n, h, wd, cx, cy, hk, groups, int(act == "relu"), code, threads,
            torch.cuda.current_stream().cuda_stream)
    check_launch("conv2d_f", rc)
    conv2d_f.launches += 1
    return y


conv2d_f.launches = 0
