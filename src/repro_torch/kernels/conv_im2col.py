"""int8 SAME stride-1 standard / grouped convolution: the CUDA kernel
wrapper, its plain PyTorch version and its launch counter.

Replaces the TPU kernel ``repro/kernels/conv_im2col.py``
(``conv2d_im2col`` / ``_conv2d_im2col``) in its int8 mode; the source is
``csrc/conv_im2col.cu``. What bounds it on an H100: at the model's shapes
(B=256, up to 32x32x16 outputs) each launch moves a few MB and does well
under a GFLOP of int8 work, so its floor is a microsecond or two of HBM
time. This first kernel is far from that floor: one thread per output
element issues two one-byte loads per multiply-add and reuses nothing in
registers, so load-instruction throughput bounds it (the 3->16 stem at
B=256 takes over a hundred microseconds on an H100 SXM at 700 W; PERF.md
has the numbers). The design answers correctness first: exact int32
accumulation and the epilogue of ``csrc/epilogue.cuh``; register blocking
over output channels, tensor cores and input tiling come later.

On a CPU tensor :func:`conv2d_q8` runs :func:`conv2d_q8_plain`; on a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.core.primitives import conv_nhwc

from ._build import check_launch, library
from .common import apply_act, apply_requant

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


def conv2d_q8(x, w, bias=None, *, groups: int = 1, requant_shift: int = 0,
              act=None):
    """x (N,H,W,Cx) int8, w (HK,HK,Cx/g,Cy) int8, bias (Cy,) int32 or None
    -> (N,H,W,Cy) int8."""
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"conv2d_q8: x and w must be 4-D, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    n, h, wd, cx = x.shape
    hk, hk2, cxg, cy = w.shape
    if hk != hk2 or groups < 1 or cx != cxg * groups or cy % groups:
        raise ValueError(f"conv2d_q8: weight {tuple(w.shape)} does not fit "
                         f"x {tuple(x.shape)} with groups={groups}")
    if bias is not None and tuple(bias.shape) != (cy,):
        raise ValueError(f"conv2d_q8: bias shape {tuple(bias.shape)} != "
                         f"({cy},)")
    if cxg * hk * hk > MAX_CONTRACTION:
        raise ValueError(f"conv2d_q8: contraction of {cxg * hk * hk} taps "
                         "could overflow the int32 accumulator")
    check_shift("conv2d_q8", requant_shift)
    check_act("conv2d_q8", act)
    check_elements("conv2d_q8", x.shape, (n, h, wd, cy))
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
            torch.cuda.current_stream().cuda_stream)
    check_launch("conv2d_q8", rc)
    conv2d_q8.launches += 1
    return y


conv2d_q8.launches = 0
