"""int8, W4A8 and float SAME stride-1 standard / grouped convolution: the
CUDA kernel wrappers, their plain PyTorch versions and their launch
counters.

Replaces the TPU kernel ``repro/kernels/conv_im2col.py`` (``conv2d_im2col``
/ ``_conv2d_im2col``) in all its modes; the source is
``csrc/conv_im2col.cu``. What bounds it on an H100: at the model's shapes
(B=256, up to 32x32x16 outputs) each launch moves a few MB and does well
under a GFLOP of int8 work, so bytes bound it: its floor is a microsecond
or two of HBM time. The integer modes run an implicit GEMM per group (M =
output pixels, N = Cy/g, K = HK*HK*Cx/g): a block stages its run of
pixels' input window and the group's filter slice (as words of four int8
K-consecutive codes) in shared memory once, and each thread sums 32
accumulators (PT pixels x Q channels) with ``__dp4a``; exact int32 sums,
then the epilogue of ``csrc/epilogue.cuh``. The body is
``csrc/igemm.cuh``, shared with the integer shift conv (``conv_shift``),
whose K-offset builder differs. The block's pixels ``bp`` and a thread's
channels ``q`` are the tuner's knobs; :func:`conv_plan` is the launch
arithmetic the source computes (grid, threads, K words, shared bytes),
and :func:`default_tile` the wrappers' choice.

The W4 mode (:func:`conv2d_w4`) reads the nibble-packed weight bytes and
the int8 group shifts; each block unpacks and shifts every code once, while
it stages the filter, and from there runs the int8 body. Its plain version
expands the codes (``expand_w4``) and runs the int8 plain version.

The float mode (:func:`conv2d_f`, float32 or bfloat16) runs the float
implicit GEMM (``csrc/fgemm.cuh``, shared with the float add conv): a
block stages its run of pixels' input window once as float32 and the
block's weights (all of K where they fit, else chunk by chunk), and each
thread sums :func:`pixels_a_thread` pixels x ``q`` channels in registers,
indexing the window by each K element's offset without dividing. At
Table-2's ``ci=128, k=3`` layer each output sums 1,152 products, so it is
bound by operations at the card's float32 rate (two instructions a term:
no FMA) and, at n = 1, by the latency of those chains; at the B=256
layers a thread's several pixels keep the shared-memory loads a step
below its float instructions. Its plain version sums in
the kernel's order, tap row, tap column, then input channel, one float32
multiply and one add at a time, so the two are bitwise equal; JAX's oracle
and the Pallas kernel sum in other orders and agree within a tolerance.
:func:`conv_f_plan` is its launch arithmetic and :func:`default_f_tile`
its default tile.

Every wrapper takes the tile ``bp`` (pixels a block) and ``q`` (channels a
thread), the tuner's knobs (``repro_torch.tune``); they change no output.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.core.primitives import conv_nhwc
from repro_torch.core.quantize import expand_w4

from ._build import check_launch, library
from .common import (acc_dtype, apply_act, apply_requant, cdiv,
                     float_code)

#: largest Cx/g * HK^2 whose int8 x int8 sum cannot leave int32
MAX_CONTRACTION = (2 ** 31 - 1) // (128 * 128)
#: the kernels index with 32-bit ints: every tensor stays below this size
MAX_ELEMENTS = 2 ** 31 - 2 ** 16
#: the integer modes' knobs: pixels a block and channels a thread, each
#: thread owning 32 // q pixels. The tuner's space holds these values; a
#: launch takes any whole number of 32-pixel runs up to 256 as bp
#: (csrc/igemm.cuh valid_tile); the shift conv takes the same knobs
#: (conv_shift.py)
CONV_BP = (32, 64, 128, 256)
CONV_Q = (4, 8, 16)
#: K words a staged chunk, and threads a block at most and at least
#: (csrc/igemm.cuh KC, MAX_THREADS, MIN_THREADS: a small tile's block is
#: padded with threads that only stage)
CONV_KC, CONV_MAX_THREADS, CONV_MIN_THREADS = 32, 256, 128
#: blocks the default tile's grid aims for: about one per SM of an H100
DEFAULT_BLOCKS = 128
#: the shared memory a block can use on an H100 (the tiled kernels' tiles
#: are dynamic shared memory: above 48 KB after cudaFuncSetAttribute, which
#: the sources call) and the grid's y limit
MAX_DYNAMIC_SMEM, MAX_GRID_Y = 232448, 65535
#: the float implicit GEMM's threads a block below bp = 128, its K
#: elements a staged chunk at most, and the weights a thread stages a chunk
#: at most (csrc/fgemm.cuh FG_THREADS, FG_KC, FG_UW)
F_THREADS, F_KC, F_UW = 128, 128, 8
#: the float default tile's largest block: at the B=256 layers 128-pixel
#: blocks beat 256-pixel ones, whose windows cross more image boundaries
#: and whose shared memory leaves fewer blocks resident
F_DEFAULT_BP = 128


@functools.lru_cache(maxsize=4096)
def conv_plan(n: int, h: int, w: int, cx: int, cy: int, hk: int,
              groups: int, bp: int, q: int) -> dict:
    """The integer modes' launch arithmetic, as ``igemm_plan`` in
    ``csrc/igemm.cuh`` computes it for ``csrc/conv_im2col.cu``: ``grid``
    (x, y), ``threads``, ``smem`` (dynamic shared bytes), ``k_words`` (K =
    HK*HK*Cx/g padded to a multiple of 4, in words of four int8),
    ``window`` (the input window's shared bytes) and ``block_channels``. A
    pointwise conv (HK = 1) runs as one image of one row of N*H*W pixels.
    Memoized: do not mutate the dict."""
    return igemm_plan(n, h, w, cx, cy, hk, groups, hk * hk * (cx // groups),
                      bp, q)


def igemm_plan(n: int, h: int, w: int, cx: int, cy: int, hk: int,
               groups: int, kk: int, bp: int, q: int) -> dict:
    """The implicit GEMM's launch arithmetic (``csrc/igemm.cuh``
    ``igemm_plan``) for an HK x HK window and a contraction of ``kk`` K
    elements: the integer conv's (:func:`conv_plan`) and the integer shift
    conv's (``conv_shift.shift_plan``)."""
    if hk == 1:
        n, h, w = 1, 1, n * h * w
    pt = 32 // q
    cxg, ng = cx // groups, cy // groups
    k_words = cdiv(kk, 4)
    kcw = min(CONV_KC, k_words)
    ct = min(cdiv(ng, q), CONV_MAX_THREADS // (bp // pt))
    bn = ct * q
    ps = cxg + 4 if cxg % 4 == 0 and cx % 4 == 0 else cxg
    # rows a run of bp pixels (starting at a multiple of bp) spans, and the
    # window's width
    if h == 1 or w % bp == 0:
        rows, ww = 1, min(bp, w) + hk - 1
    elif bp % w == 0:
        rows, ww = min(h, bp // w), w + hk - 1
    else:
        rows, ww = min(h, bp // w + 2), w + hk - 1
    window = -(-(rows + hk - 1) * ww * ps // 16) * 16
    smem = window + 4 * (kcw * bp + kcw * bn + 4 * kcw + bp)
    return dict(grid=(n * cdiv(h * w, bp), groups * cdiv(ng, bn)),
                threads=max((bp // pt) * ct, CONV_MIN_THREADS), smem=smem,
                k_words=k_words, window=window, block_channels=bn)


@functools.lru_cache(maxsize=4096)
def conv_f_plan(n: int, h: int, w: int, cx: int, cy: int, hk: int,
                groups: int, bp: int, q: int) -> dict:
    """The float mode's launch arithmetic, as ``repro_conv2d_f_plan``
    computes it (:func:`fgemm_plan`). Memoized: do not mutate the dict."""
    return fgemm_plan(n, h, w, cx, cy, hk, groups, bp, q)


def fgemm_plan(n: int, h: int, w: int, cx: int, cy: int, hk: int,
               groups: int, bp: int, q: int) -> dict:
    """The float implicit GEMM's launch arithmetic (``csrc/fgemm.cuh``
    ``fgemm_plan``), shared by the float conv and the float add conv:
    ``grid`` (pixel blocks over all N*H*W pixels, group x channel blocks),
    ``threads`` (bp / ``pixels`` x the block's channel groups, at most 128
    below 128 threads a group), ``pixels`` (a thread's pixels,
    :func:`pixels_a_thread`), ``smem`` (dynamic shared bytes: the window,
    the weights of ``k_chunk`` K elements and their offsets, each pixel's
    base and each window row's input offset, 4 bytes each; all K elements
    where they fit in a block's shared memory, else chunks of min(128, 8 x
    threads a group / q)), ``window`` (the input window's bytes: the
    padded rows a run of bp pixels spans, plus HK-1 padding rows for each
    image boundary it crosses, x the padded columns x (Cx/g) | 1 floats a
    pixel, rounded to 4 floats), ``block_channels`` and ``k_chunk``. A
    pointwise conv (HK = 1) runs as one image of one row of N*H*W
    pixels."""
    if hk == 1:
        n, h, w = 1, 1, n * h * w
    cxg, ng = cx // groups, cy // groups
    pt = pixels_a_thread(bp, q)
    npx = bp // pt
    ct = min(cdiv(ng, q), F_THREADS // npx if npx < F_THREADS else 1)
    bn = ct * q
    kk = hk * hk * cxg
    ps = cxg | 1
    nh = n * h
    # output rows a run of bp pixels (starting at a multiple of bp) spans,
    # the image boundaries they cross, and the window's width
    if nh == 1 or w % bp == 0:
        rows, ww = 1, min(bp, w) + hk - 1
    elif bp % w == 0:
        rows, ww = min(nh, bp // w), w + hk - 1
    else:
        rows, ww = min(nh, bp // w + 2), w + hk - 1
    cross = min(n - 1, cdiv(rows - 1, h))
    wrows = rows + cross * (hk - 1) + hk - 1
    win = -(-wrows * ww * ps // 4) * 4
    # all K elements' weights and offsets resident where they fit, else
    # chunks of at most F_UW weights a thread
    fixed = win + bp + wrows
    kc = (kk if 4 * (fixed + kk * bn + kk) <= MAX_DYNAMIC_SMEM
          else min(F_KC, F_UW * npx // q))
    smem = 4 * (fixed + kc * bn + kc)
    return dict(grid=(cdiv(n * h * w, bp), groups * cdiv(ng, bn)),
                threads=npx * ct, smem=smem, window=4 * win,
                block_channels=bn, k_chunk=kc, pixels=pt)


def pixels_a_thread(bp: int, q: int) -> int:
    """A float GEMM thread's pixels (``csrc/fgemm.cuh``
    ``pixels_a_thread``): the largest power of two that divides bp / 32
    and keeps pixels x q at most 32 accumulators."""
    pt = 1
    while (bp // 32) % (2 * pt) == 0 and 2 * pt * q <= 32:
        pt *= 2
    return pt


def knob_errors(bp, q) -> list:
    """Why (bp, q) is not a tile the integer kernel takes: bp a whole
    number of 32-pixel runs up to 256, q one of :data:`CONV_Q`."""
    errs = []
    if (not isinstance(bp, int) or isinstance(bp, bool)
            or not 32 <= bp <= 256 or bp % 32):
        errs.append(f"bp must be a multiple of 32 in [32, 256], got {bp!r}")
    if q not in CONV_Q or isinstance(q, bool):
        errs.append(f"q must be one of {CONV_Q}, got {q!r}")
    return errs


def tile_errors(plan: dict) -> list:
    """Why a :func:`conv_plan` or :func:`conv_f_plan` (or a shift conv's
    plan, ``conv_shift.shift_plan`` / ``shift_f_plan``, or the float add
    conv's, ``conv_add.add_f_plan``) cannot launch on an H100: its shared
    bytes and its grid. Empty if it can."""
    errs = []
    if plan["smem"] > MAX_DYNAMIC_SMEM:
        errs.append(f"{plan['smem']} bytes of shared memory exceed the "
                    f"{MAX_DYNAMIC_SMEM} a block can use")
    if plan["grid"][1] > MAX_GRID_Y:
        errs.append(f"{plan['grid'][1]} channel blocks exceed the grid's y "
                    "limit")
    return errs


def default_tile(n, h, w, cx, cy, hk, groups) -> dict:
    """The wrappers' own tile: 16 channels a thread where the group has 16
    or more (8 or 4 for a narrower one), and the largest block of pixels,
    at most twice the run a block can cover (an image; all pixels at HK =
    1) rounded up to a power of two, whose grid still holds
    ``DEFAULT_BLOCKS`` blocks; 32 pixels where none does (a small batch:
    the most blocks). On an H100 the fastest tile, or within 9% of it, at
    every shape timed but Table-2's Cx = 128, g = 1 job (PERF.md); a
    smaller block where a tile does not fit."""
    return dict(zip(("bp", "q"), _default_tile(n, h, w, cx, cy, hk,
                                                groups)))


@functools.lru_cache(maxsize=4096)
def _default_tile(n, h, w, cx, cy, hk, groups) -> tuple:
    return tile_rule(cy // groups, n * h * w if hk == 1 else h * w,
                     lambda bp, q: conv_plan(n, h, w, cx, cy, hk, groups,
                                             bp, q))


def tile_rule(ng: int, run: int, plan) -> tuple:
    """:func:`default_tile`'s rule for an implicit GEMM of ``ng`` channels
    a group whose block covers at most ``run`` pixels, ``plan(bp, q)`` its
    launch arithmetic: (bp, q)."""
    q = 16 if ng >= 16 else (8 if ng >= 8 else 4)
    cap = max(CONV_BP[0], 2 * (1 << max(0, run - 1).bit_length()))
    for bp in sorted(CONV_BP, reverse=True):
        p = plan(bp, q)
        gx, gy = p["grid"]
        if (bp <= cap and gx * gy >= DEFAULT_BLOCKS
                and not tile_errors(p)):
            return bp, q
    return CONV_BP[0], q


def default_f_tile(n, h, w, cx, cy, hk, groups) -> dict:
    """The float wrappers' own tile (the float conv's and the float add
    conv's, ``groups=1``): 16 channels a thread where the group has 16 or
    more (8 or 4 for a narrower one) and the largest block of at most
    ``F_DEFAULT_BP`` pixels whose grid still holds ``DEFAULT_BLOCKS``
    blocks; where none does (Table-2's n = 1 jobs), 32 pixels x 4
    channels, the most blocks and threads. On an H100 the fastest tile,
    or within 12% of it, at Table-2's float jobs and the B=256 layers
    (PERF.md, ``scripts/torch_float_tiles.py``)."""
    return dict(zip(("bp", "q"), _default_f_tile(n, h, w, cx, cy, hk,
                                                  groups)))


@functools.lru_cache(maxsize=4096)
def _default_f_tile(n, h, w, cx, cy, hk, groups) -> tuple:
    ng = cy // groups
    q = 16 if ng >= 16 else (8 if ng >= 8 else 4)
    for bp in sorted((b for b in CONV_BP if b <= F_DEFAULT_BP),
                     reverse=True):
        p = conv_f_plan(n, h, w, cx, cy, hk, groups, bp, q)
        gx, gy = p["grid"]
        if gx * gy >= DEFAULT_BLOCKS and not tile_errors(p):
            return bp, q
    return CONV_BP[0], 4


def check_tile(name: str, shape: tuple, bp, q, integer=True) -> dict:
    """The tile a conv wrapper launches on ``shape`` = (n, h, w, cx, cy,
    hk, groups): ``bp`` and ``q`` (None: the default's), each one of its
    knob's values, and a launch that fits. ``integer=False``: the float
    implicit GEMM's (the float conv's and the float add conv's)."""
    if bp is None or q is None:
        d = (_default_tile if integer else _default_f_tile)(*shape)
        bp = d[0] if bp is None else bp
        q = d[1] if q is None else q
    errs = knob_errors(bp, q)
    if errs:
        raise ValueError(f"{name}: " + "; ".join(errs))
    errs = tile_errors((conv_plan if integer else conv_f_plan)(*shape, bp,
                                                                q))
    if errs:
        raise ValueError(f"{name}: tile bp={bp}, q={q} cannot launch: "
                         + "; ".join(errs))
    return {"bp": bp, "q": q}


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
              act=None, bp=None, q=None):
    """x (N,H,W,Cx) int8, w (HK,HK,Cx/g,Cy) int8, bias (Cy,) int32 or None
    -> (N,H,W,Cy) int8. ``bp`` and ``q`` default to :func:`default_tile`."""
    n, h, wd, cx, cy, hk = _check_conv("conv2d_q8", x, w.shape, bias, groups,
                                       requant_shift, act)
    tile = check_tile("conv2d_q8", (n, h, wd, cx, cy, hk, groups), bp, q)
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
            tile["bp"], tile["q"], torch.cuda.current_stream().cuda_stream)
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
              requant_shift=None, act=None, bp=None, q=None):
    """x (N,H,W,Cx) int8, w_p (HK,HK,ceil(Cx/g/2),Cy) int8 nibble-packed
    along Cx/g, w_shifts (Cx/g,) int8, bias (Cy,) int32 or None ->
    (N,H,W,Cy) int8. ``bp`` and ``q`` default to :func:`default_tile`."""
    if x.dim() != 4 or w_p.dim() != 4:
        raise ValueError(f"conv2d_w4: x and w must be 4-D, got "
                         f"{tuple(x.shape)} and {tuple(w_p.shape)}")
    cxg = x.shape[-1] // max(groups, 1)
    check_w4("conv2d_w4", w_p, 2, cxg, w_shifts, requant_shift)
    hk, _, _, cy = w_p.shape
    n, h, wd, cx, cy, hk = _check_conv("conv2d_w4", x, (hk, hk, cxg, cy),
                                       bias, groups, requant_shift, act)
    tile = check_tile("conv2d_w4", (n, h, wd, cx, cy, hk, groups), bp, q)
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
            tile["bp"], tile["q"], torch.cuda.current_stream().cuda_stream)
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


def conv2d_f(x, w, bias=None, *, groups: int = 1, act=None, bp=None,
             q=None):
    """x (N,H,W,Cx) float32 or bfloat16, w (HK,HK,Cx/g,Cy) and bias (Cy,)
    or None in x's dtype -> (N,H,W,Cy) in x's dtype. ``bp`` and ``q``
    default to :func:`default_f_tile`."""
    n, h, wd, cx, cy, hk = _check_conv("conv2d_f", x, w.shape, bias, groups,
                                       None, act, integer=False)
    tile = check_tile("conv2d_f", (n, h, wd, cx, cy, hk, groups), bp, q,
                      integer=False)
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
            n, h, wd, cx, cy, hk, groups, int(act == "relu"), code,
            tile["bp"], tile["q"], torch.cuda.current_stream().cuda_stream)
    check_launch("conv2d_f", rc)
    conv2d_f.launches += 1
    return y


conv2d_f.launches = 0
