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
and one written, so the bytes it moves (x once, out once, w), under a
microsecond of HBM time at Falcon-Mamba's prefill shapes; x was written by
``in_proj`` just before and sits in L2, so a launch is bound by latency
and issue slots. The design (the source's header): where D * elsize, x,
w and x's row stride are 16-byte aligned (every Falcon-Mamba shape), a
thread owns one 16-byte vector of channels and a run of R positions, all
its R + K - 1 loads in flight before its first sum; else the first design,
a thread a channel and a run of 32 positions. :func:`c1d_plan` mirrors the
source's choice and grid (``repro_causal_conv1d_plan``);
:func:`default_c1d_config` is the wrapper's launch when given none.

x's channel axis must be contiguous; its rows may lie further apart (a
row stride of at least D, batch rows L row strides apart), so the x half
of Mamba's ``in_proj`` output, ``xz.chunk(2, -1)[0]``, is read in place.
The output is contiguous.

On a CPU tensor the wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.energy import H100_SXM

from ._build import check_launch, library
from .common import FLOAT_CODES, apply_act, cdiv
from .conv_im2col import check_act, check_cuda_operand

#: the kernel's register window is a template argument up to this width
MAX_K = 8
#: grid limits of the launch: runs of positions along y, batch along z
MAX_RUNS, MAX_BATCH = 65535, 65535
#: positions a thread of the vector path (the tuner's knob ``run``) and of
#: the scalar path
RUNS, SCALAR_RUN = (1, 2, 4, 8), 32
#: threads a block: each a template instantiation (the tuner's knob)
THREADS = (64, 128, 256)
#: bytes a vector-path load moves
VEC_BYTES = 16
#: the launch's cost model, fitted to every config's device time at
#: Falcon-Mamba-7B's prefill shapes (scripts/torch_conv1d_tiles.py on an
#: NVIDIA H100 80GB HBM3 at 700 W, PERF.md; mean error 12.5%): a launch and
#: a trip to L2; the scale of the longest other term; a warp's cycles an
#: instruction of its chain, and the warps a scheduler holds per chain;
#: schedulers an SM and the L2 rate (tune.runner's); the card's SMs and
#: clock are core.energy.H100's
C1D_BASE_S, C1D_SCALE, C1D_CPI, C1D_HIDE = 1.72e-6, 1.24, 2, 2
ISSUE_PER_CLK, L2_BPS = 4, 6e12
SMS, CLOCK_HZ = H100_SXM.sms, H100_SXM.boost_hz


def c1d_plan(b: int, l: int, d: int, esize: int, aligned: bool, run: int,
             threads: int) -> dict:
    """The launch, as ``repro_causal_conv1d_plan`` in
    ``csrc/conv1d_causal.cu`` computes it: ``vector`` (D * esize a
    multiple of 16 and x, w, y and the row stride 16-byte ``aligned``: a
    thread owns 16 / esize channels and ``run`` positions; else a channel
    and 32 positions), the ``grid`` (channel blocks, runs, batch),
    ``threads`` and ``run``, the positions a thread."""
    vector = bool(aligned) and d * esize % VEC_BYTES == 0
    lanes = VEC_BYTES // esize if vector else 1
    r = run if vector else SCALAR_RUN
    return dict(grid=(cdiv(d // lanes, threads), cdiv(l, r), b),
                threads=threads, run=r, vector=vector)


def c1d_cost_s(b: int, l: int, d: int, k: int, esize: int, run: int,
               threads: int) -> float:
    """Device seconds of a launch on aligned tensors, its input resident in
    L2 (in_proj wrote it just before): C1D_BASE_S, then C1D_SCALE x the
    longest of the SMs' issue of the grid's instructions (a thread's R + K
    - 1 loads, its R x lanes x K multiply-adds as two instructions each
    plus a rounding a lane, its R stores), a warp's chain of them at
    C1D_CPI cycles each for every C1D_HIDE warps a scheduler holds, and the
    halo rows re-read from L2."""
    plan = c1d_plan(b, l, d, esize, True, run, threads)
    gx, gy, gz = plan["grid"]
    blocks, r = max(1, gx * gy * gz), plan["run"]
    lanes = VEC_BYTES // esize if plan["vector"] else 1
    instr = (r + k - 1) + r * (lanes * (2 * k + 1) + 1)
    warps_per_sm = blocks * threads / 32 / min(SMS, blocks)
    issue = warps_per_sm * instr / (ISSUE_PER_CLK * CLOCK_HZ)
    chain = (instr * C1D_CPI / CLOCK_HZ
             * math.ceil(warps_per_sm / (ISSUE_PER_CLK * C1D_HIDE)))
    l2 = esize * b * l * d * (r + k - 1) / r / L2_BPS
    return C1D_BASE_S + C1D_SCALE * max(issue, chain, l2)


def default_c1d_config(b: int, l: int, d: int, k: int, esize: int) -> dict:
    """The wrapper's launch: the cheapest (run, threads) under
    :func:`c1d_cost_s`, the longest run and then the smallest block on a
    tie (1 x 96 x 8192 bf16, K = 4: runs of 4, 64 threads, 16 x 24
    blocks). The tuner's analytic model prices with the same function, so
    its pick is this default."""
    best, best_s = None, float("inf")
    for run in sorted(RUNS, reverse=True):
        for threads in THREADS:
            cost = c1d_cost_s(b, l, d, k, esize, run, threads)
            if cost < best_s:
                best, best_s = {"run": run, "threads": threads}, cost
    return best


def row_stride(name: str, x) -> int:
    """x's row stride in elements, which the kernel takes: x's channel
    axis must be contiguous, its rows at least D apart and its batch rows
    L rows apart (a contiguous x, or the x half of a (B, L, 2D) product).
    Raises for any other layout."""
    b, l, d = x.shape
    if d > 1 and x.stride(2) != 1:
        raise ValueError(f"{name}: x's channel stride is {x.stride(2)}; the "
                         "kernel reads channels contiguously")
    # one position a batch row: the batch rows are the rows
    rs = x.stride(1) if l > 1 else x.stride(0) if b > 1 else d
    if rs < d or (b > 1 and x.stride(0) != l * rs):
        raise ValueError(f"{name}: x's strides {x.stride()} do not lay its "
                         f"rows end to end; the kernel takes rows at least "
                         f"D apart and batch rows L rows apart")
    return rs


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


def causal_conv1d(x, w, *, act=None, run=None, threads=None):
    """x (B,L,D) float32 or bfloat16 with contiguous channels (see
    :func:`row_stride`), w (K,D) or (K,1,D) in x's dtype -> (B,L,D)
    contiguous in x's dtype. ``run`` (positions a thread of the vector
    path: 1, 2, 4 or 8) and ``threads`` (64, 128 or 256 a block; each
    None: :func:`default_c1d_config`'s) change only the launch shape."""
    w = _taps("causal_conv1d", x, w)
    check_act("causal_conv1d", act)
    if threads is not None and threads not in THREADS:
        raise ValueError(f"causal_conv1d: threads must be one of {THREADS}, "
                         f"got {threads!r}")
    if run is not None and run not in RUNS:
        raise ValueError(f"causal_conv1d: run must be one of {RUNS}, got "
                         f"{run!r}")
    rs = row_stride("causal_conv1d", x)
    if x.device.type == "cpu":
        return causal_conv1d_plain(x, w, act=act)
    if x.dtype not in FLOAT_CODES:
        raise TypeError(f"causal_conv1d: the kernel takes float32 or "
                        f"bfloat16, got {x.dtype}")
    check_cuda_operand("causal_conv1d", w, x.device, x.dtype)
    b, l, d = x.shape
    k = w.shape[0]
    if k > MAX_K:
        raise ValueError(f"causal_conv1d: the kernel takes K <= {MAX_K}, "
                         f"got {k}")
    if run is None or threads is None:
        default = default_c1d_config(b, l, d, k, x.element_size())
        run = default["run"] if run is None else run
        threads = default["threads"] if threads is None else threads
    y = torch.empty((b, l, d), dtype=x.dtype, device=x.device)
    aligned = (x.data_ptr() % VEC_BYTES == 0 and w.data_ptr() % VEC_BYTES == 0
               and rs * x.element_size() % VEC_BYTES == 0)
    plan = c1d_plan(b, l, d, x.element_size(), aligned, run, threads)
    if b > MAX_BATCH or plan["grid"][1] > MAX_RUNS or rs >= 2 ** 31:
        raise ValueError(f"causal_conv1d: x {tuple(x.shape)} exceeds the "
                         "kernel's grid")
    with torch.cuda.device(x.device):
        rc = library().repro_causal_conv1d(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), b, l, d, rs, k,
            int(act == "relu"), FLOAT_CODES[x.dtype], run, threads,
            torch.cuda.current_stream().cuda_stream)
    check_launch("causal_conv1d", rc)
    causal_conv1d.launches += 1
    return y


causal_conv1d.launches = 0
