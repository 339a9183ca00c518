"""int8 and float VALID max-pool: the CUDA kernel wrappers, their plain
PyTorch version and their launch counters.

Replaces the TPU kernel ``repro/kernels/pool.py`` (``maxpool2d`` /
``_maxpool2d``) in its int8 and float modes; the source is
``csrc/pool.cu``. Max
commutes with the positive power-of-two scale, so pooling int8 codes is
exact and activations stay int8 across the pool. What bounds it on an
H100: pure data movement (input read once, a quarter of it written for
2x2/2), a few MB per launch at the model's shapes, so HBM time is about a
microsecond and a launch's fixed cost is of the same order. The int8
design: where C is a multiple of 16 and x and y are 16-byte aligned (every
pool of the CNN plans), a thread owns 16 channels of one output pixel, one
16-byte load a window tap and a bytewise signed max (``__vmaxs4``); else
one thread per output byte, channels fastest. :func:`pool_plan` mirrors
the source's choice and grid (``repro_maxpool2d_s8_plan``). The float mode
(:func:`maxpool2d_f`, float32 or bfloat16) has the same two paths: where
C * elsize is a multiple of 16 and x and y are 16-byte aligned, a thread
owns one 16-byte vector of a pixel's channels (4 float32 or 8 bf16), else
one thread per output element; :func:`pool_f_plan` mirrors
``repro_maxpool2d_f_plan``. A max rounds nothing, so it is exact, and
bitwise equal to JAX's oracle as well as to the plain version (NaN
propagates, as in ``jnp.max``; the first NaN tap's bits win, as
``torch.maximum`` keeps them). Both wrappers take ``threads``, the block
size of the launch (the tuner's knob); it changes no output.

On a CPU tensor each wrapper runs :func:`maxpool2d_plain`; on a CUDA
tensor it launches its kernel or raises.
"""
from __future__ import annotations

import torch

from ._build import check_launch, library
from .common import DEFAULT_THREADS, cdiv, check_threads, float_code
from .conv_im2col import check_cuda_operand, check_elements

#: bytes a thread of the vector paths owns (one 16-byte load a tap): 16
#: int8 channels, 4 float32 or 8 bfloat16
POOL_VEC = 16


def pool_out(size: int, window: int, stride: int) -> int:
    return (size - window) // stride + 1


def pool_plan(n: int, hout: int, wout: int, c: int, aligned: bool,
              threads: int = DEFAULT_THREADS) -> dict:
    """The int8 launch, as ``repro_maxpool2d_s8_plan`` in ``csrc/pool.cu``
    computes it: ``vector`` (C a multiple of 16 and x and y 16-byte
    ``aligned``: 16 channels a thread), ``blocks`` and ``threads``."""
    vector = c % POOL_VEC == 0 and bool(aligned)
    total = n * hout * wout * (c // POOL_VEC if vector else c)
    return dict(blocks=cdiv(total, threads), threads=threads, vector=vector)


def pool_f_plan(n: int, hout: int, wout: int, c: int, esize: int,
                aligned: bool, threads: int = DEFAULT_THREADS) -> dict:
    """The float launch, as ``repro_maxpool2d_f_plan`` in ``csrc/pool.cu``
    computes it: ``vector`` (C * ``esize`` a multiple of 16 and x and y
    16-byte ``aligned``: a 16-byte vector a thread), ``blocks`` and
    ``threads``."""
    vector = c * esize % POOL_VEC == 0 and bool(aligned)
    total = n * hout * wout * (c * esize // POOL_VEC if vector else c)
    return dict(blocks=cdiv(total, threads), threads=threads, vector=vector)


def maxpool2d_plain(x, *, window: int = 2, stride=None):
    """Plain PyTorch version, int8 or float: the elementwise max of the
    window's ``window**2`` strided views."""
    stride = stride or window
    _, h, wd, _ = x.shape
    hout, wout = pool_out(h, window, stride), pool_out(wd, window, stride)
    out = None
    for i in range(window):
        for j in range(window):
            v = x[:, i:i + (hout - 1) * stride + 1:stride,
                  j:j + (wout - 1) * stride + 1:stride, :]
            out = v if out is None else torch.maximum(out, v)
    return out.contiguous()


def _check_pool(name, x, window, stride, threads):
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be 4-D, got {tuple(x.shape)}")
    _, h, wd, _ = x.shape
    if window < 1 or stride < 1 or window > min(h, wd):
        raise ValueError(f"{name}: window={window} stride={stride} "
                         f"do not fit x {tuple(x.shape)}")
    check_elements(name, x.shape)
    check_threads(name, threads)


def maxpool2d_s8(x, *, window: int = 2, stride=None,
                 threads: int = DEFAULT_THREADS):
    """x (N,H,W,C) int8 -> (N,Hout,Wout,C) int8, VALID windows."""
    stride = stride or window
    _check_pool("maxpool2d_s8", x, window, stride, threads)
    if x.dtype != torch.int8:
        raise TypeError(f"maxpool2d_s8: takes int8, got {x.dtype}")
    n, h, wd, c = x.shape
    if x.device.type == "cpu":
        return maxpool2d_plain(x, window=window, stride=stride)
    check_cuda_operand("maxpool2d_s8", x, x.device, torch.int8)
    hout, wout = pool_out(h, window, stride), pool_out(wd, window, stride)
    y = torch.empty((n, hout, wout, c), dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        rc = library().repro_maxpool2d_s8(
            x.data_ptr(), y.data_ptr(), n, h, wd, c, hout, wout, window,
            stride, threads, torch.cuda.current_stream().cuda_stream)
    check_launch("maxpool2d_s8", rc)
    maxpool2d_s8.launches += 1
    return y


maxpool2d_s8.launches = 0


def maxpool2d_f(x, *, window: int = 2, stride=None,
                threads: int = DEFAULT_THREADS):
    """x (N,H,W,C) float32 or bfloat16 -> (N,Hout,Wout,C) in x's dtype,
    VALID windows."""
    stride = stride or window
    _check_pool("maxpool2d_f", x, window, stride, threads)
    if x.device.type == "cpu":
        return maxpool2d_plain(x, window=window, stride=stride)
    code = float_code("maxpool2d_f", x)
    check_cuda_operand("maxpool2d_f", x, x.device, x.dtype)
    n, h, wd, c = x.shape
    hout, wout = pool_out(h, window, stride), pool_out(wd, window, stride)
    y = torch.empty((n, hout, wout, c), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = library().repro_maxpool2d_f(
            x.data_ptr(), y.data_ptr(), n, h, wd, c, hout, wout, window,
            stride, code, threads, torch.cuda.current_stream().cuda_stream)
    check_launch("maxpool2d_f", rc)
    maxpool2d_f.launches += 1
    return y


maxpool2d_f.launches = 0
