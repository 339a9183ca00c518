"""Depthwise causal conv1d, float32 or bfloat16: the CUDA kernel wrapper, its
plain PyTorch version and its launch counter.

Replaces the TPU kernel ``repro/kernels/conv1d_causal.py``
(``causal_conv1d`` / ``_causal_conv1d``), the paper's depthwise primitive
carried into the Mamba block; the source is ``csrc/conv1d_causal.cu``.
``out[b,l,d] = sum_k w[k,d] * x[b, l-K+1+k, d]`` with zero history before
``l = 0``, summed in float32 from a zero accumulator with the taps in
order, then an optional relu and one rounding to ``x``'s dtype, as the
Pallas kernel computes it (the JAX oracle ``causal_conv1d_ref`` sums in
``x``'s dtype instead; ``ref.causal_conv1d_ref`` is its port).

What bounds it on an H100: 2K flops per output against one element read
and one written, so the bytes it moves (x once, out once, w) over HBM
bandwidth, about a microsecond at Falcon-Mamba's prefill shapes; the
design (one thread per channel and run of 32 positions, the K-1 previous
inputs in registers, no shared memory) is in the source's header.

On a CPU tensor the wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import check_launch, library
from .common import FLOAT_CODES, apply_act
from .conv_im2col import check_act, check_cuda_operand

#: the kernel's register window is a template argument up to this width
MAX_K = 8
#: grid limits of the launch: runs of 32 positions along y, batch along z
MAX_RUNS, MAX_BATCH = 65535, 65535
_RUN = 32
#: channels per block: each a template instantiation (the tuner's knob)
THREADS = (64, 128, 256)
DEFAULT_THREADS = 128


def _taps(name, x, w):
    """(B,L,D) x and (K,D) or (K,1,D) w -> the (K,D) view of w."""
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (B, L, D), got {tuple(x.shape)}")
    if w.dim() == 3:
        if w.shape[1] != 1:
            raise ValueError(f"{name}: weight {tuple(w.shape)} must be "
                             "(K, D) or (K, 1, D)")
        w = w[:, 0]
    if w.dim() != 2 or w.shape[1] != x.shape[2] or w.shape[0] < 1:
        raise ValueError(f"{name}: weight {tuple(w.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    return w


def causal_conv1d_plain(x, w, *, act=None):
    """Plain PyTorch version: float32 products and sums as separate
    operations, taps k = 0..K-1 from a zero accumulator, relu, one rounding
    to ``x.dtype``. The same arithmetic, in the same order, as the kernel
    (and as the Pallas kernel)."""
    w = _taps("causal_conv1d", x, w)
    check_act("causal_conv1d", act)
    k, l = w.shape[0], x.shape[1]
    xp = F.pad(x.to(torch.float32), (0, 0, k - 1, 0))
    w32 = w.to(torch.float32)
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for kk in range(k):
        acc = acc + xp[:, kk:kk + l] * w32[kk]
    return apply_act(acc, act).to(x.dtype)


def causal_conv1d(x, w, *, act=None, threads: int = DEFAULT_THREADS):
    """x (B,L,D) float32 or bfloat16, w (K,D) or (K,1,D) in x's dtype ->
    (B,L,D) in x's dtype. ``threads`` (channels per block: 64, 128 or 256)
    changes only the launch shape."""
    w = _taps("causal_conv1d", x, w)
    check_act("causal_conv1d", act)
    if threads not in THREADS:
        raise ValueError(f"causal_conv1d: threads must be one of {THREADS}, "
                         f"got {threads!r}")
    if x.device.type == "cpu":
        return causal_conv1d_plain(x, w, act=act)
    if x.dtype not in FLOAT_CODES:
        raise TypeError(f"causal_conv1d: the kernel takes float32 or "
                        f"bfloat16, got {x.dtype}")
    for t in (x, w):
        check_cuda_operand("causal_conv1d", t, x.device, x.dtype)
    b, l, d = x.shape
    k = w.shape[0]
    if k > MAX_K:
        raise ValueError(f"causal_conv1d: the kernel takes K <= {MAX_K}, "
                         f"got {k}")
    if b > MAX_BATCH or -(-l // _RUN) > MAX_RUNS:
        raise ValueError(f"causal_conv1d: x {tuple(x.shape)} exceeds the "
                         "kernel's grid")
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = library().repro_causal_conv1d(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), b, l, d, k,
            int(act == "relu"), FLOAT_CODES[x.dtype], threads,
            torch.cuda.current_stream().cuda_stream)
    check_launch("causal_conv1d", rc)
    causal_conv1d.launches += 1
    return y


causal_conv1d.launches = 0
