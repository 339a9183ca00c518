"""int8, W4A8 and float SAME stride-1 depthwise convolution: the CUDA
kernel wrappers, their plain PyTorch versions and their launch counters.

Replaces the TPU kernel ``repro/kernels/conv_dw.py`` (``depthwise2d`` /
``_depthwise2d``) in all its modes; the source is ``csrc/conv_dw.cu``.
What bounds it on an H100: HK^2 MACs per output and no channel
contraction, so it is bound by the bytes it moves (about 2 MB per launch
at the model's shapes, under a microsecond of HBM time) and, at that
size, by the latency of one trip through device memory. The design, a
staged-row kernel: a block owns ``rows`` output rows of one image x a run
of columns x a slab of channels and stages its input rows with their HK-1
halo rows and columns once in shared memory (``cp.async`` copies of 16, 8
or 4 bytes where the slab's channels and x's address allow, zero outside
the image); each thread owns ``pt`` consecutive output pixels of a row x
4 channels; at HK = 3 it keeps its 3 x 3 x 4 weights in registers and
slides along each tap row, so a staged input is read once a tap row; the
epilogue of ``csrc/epilogue.cuh``. :func:`dw_plan` is the launch
arithmetic the source computes (``repro_depthwise2d_plan`` exports it) and
:func:`default_dw_tile` the wrappers' tile.

The W4 mode (:func:`depthwise2d_w4`) takes the weight packed along the
tap-row axis, ``(ceil(HK/2), HK, C)``, so that channels stay the
contiguous axis, with one int8 group shift per tap row; each block unpacks
and shifts its weights once, while it stages them.

The float mode (:func:`depthwise2d_f`, float32 or bfloat16) is the same
kernel with a float32 accumulator, summed over the taps (i, j) in order;
its plain version repeats that order, one multiply and one add at a time,
on the same zero padding, so the two are bitwise equal.

Every wrapper takes the tile ``pt`` (pixels a thread) and ``rows`` (output
rows a block), the tuner's knobs; they change no output.

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
from .common import acc_dtype, apply_act, apply_requant, cdiv, float_code
from .conv_im2col import (DEFAULT_BLOCKS, MAX_CONTRACTION, MAX_DYNAMIC_SMEM,
                          MAX_GRID_Y, check_act, check_cuda_operand,
                          check_elements, check_shift, check_w4, kernel_pads)

#: the tile's knobs: pixels a thread along a row, output rows a block
DW_PT, DW_ROWS = (1, 2, 4), (1, 2, 4, 8)
#: a block's threads where channel vectors are added to fill it, and at
#: most (csrc/conv_dw.cu DW_THREADS, DW_MAX_THREADS)
DW_THREADS, DW_MAX_THREADS = 128, 256
#: bytes an element of each mode's x: the plan's ``esize``
DW_ESIZE = {torch.int8: 1, torch.bfloat16: 2, torch.float32: 4}


@functools.lru_cache(maxsize=4096)
def dw_plan(n: int, h: int, w: int, c: int, hk: int, esize: int, pt: int,
            rows: int) -> dict:
    """The launch arithmetic of ``csrc/conv_dw.cu`` (``dw_plan``) for
    elements of ``esize`` bytes (1 int8 and W4, 2 bfloat16, 4 float32):
    ``grid`` (images x row blocks x column blocks, channel slabs),
    ``threads`` (channel vectors x column groups x rows), ``smem`` (the
    window, 16-byte aligned, then the weights [tap][channel] as int8 or
    float32), ``window`` (its bytes: rows + HK-1 x columns + HK-1 x the
    slab's channels), ``rows``, ``columns`` and ``channels`` a block. A
    block's row of ceil(W / pt) column groups x ``rows`` (at most H) takes
    as many 4-channel vectors as keep it at most ``DW_THREADS`` threads (at
    least one); a row of more than ``DW_MAX_THREADS`` groups is cut into
    runs of ``DW_MAX_THREADS // rows``. Memoized: do not mutate the
    dict."""
    rows = min(rows, h)
    cvec, cgw = cdiv(c, 4), cdiv(w, pt)
    if rows * cgw <= DW_MAX_THREADS:
        cg, csv = cgw, min(cvec, max(1, DW_THREADS // (rows * cgw)))
    else:
        cg, csv = DW_MAX_THREADS // rows, 1
    bw, ps = cg * pt, 4 * csv
    window = -(-(rows + hk - 1) * (bw + hk - 1) * ps * esize // 16) * 16
    smem = window + hk * hk * ps * (1 if esize == 1 else 4)
    return dict(grid=(n * cdiv(h, rows) * cdiv(w, bw), cdiv(cvec, csv)),
                threads=csv * cg * rows, smem=smem, window=window,
                rows=rows, columns=bw, channels=ps)


def dw_knob_errors(pt, rows) -> list:
    """Why (pt, rows) is not a tile the kernel takes."""
    errs = []
    for name, v, allowed in (("pt", pt, DW_PT), ("rows", rows, DW_ROWS)):
        if (not isinstance(v, int) or isinstance(v, bool)
                or v not in allowed):
            errs.append(f"{name} must be one of {allowed}, got {v!r}")
    return errs


def dw_tile_errors(plan: dict) -> list:
    """Why a :func:`dw_plan` cannot launch on an H100: its shared bytes and
    its grid. Empty if it can."""
    errs = []
    if plan["smem"] > MAX_DYNAMIC_SMEM:
        errs.append(f"{plan['smem']} bytes of shared memory exceed the "
                    f"{MAX_DYNAMIC_SMEM} a block can use")
    if plan["grid"][1] > MAX_GRID_Y:
        errs.append(f"{plan['grid'][1]} channel slabs exceed the grid's y "
                    "limit")
    return errs


def default_dw_tile(n, h, w, c, hk, esize) -> dict:
    """The wrappers' own tile: the most pixels a thread whose grid still
    holds ``DEFAULT_BLOCKS`` blocks, with the most rows that keep at least
    two 4-channel vectors (or all of C) a block, else the most rows that
    hold the grid; one pixel and one row where no tile does (a small job:
    the most blocks). More pixels a thread means fewer column groups, so
    more channels a block: wider staging copies and fewer of them. On an
    H100 the fastest tile at the dws plan's rows at B=256 and Table-2's
    1x32x32x64 job in every mode (PERF.md,
    ``scripts/torch_float_tiles.py``)."""
    return dict(zip(("pt", "rows"), _default_dw_tile(n, h, w, c, hk,
                                                      esize)))


@functools.lru_cache(maxsize=4096)
def _default_dw_tile(n, h, w, c, hk, esize) -> tuple:
    want = min(cdiv(c, 4), 2)
    for pt in sorted(DW_PT, reverse=True):
        fits = []
        for rows in sorted(DW_ROWS, reverse=True):
            p = dw_plan(n, h, w, c, hk, esize, pt, rows)
            gx, gy = p["grid"]
            if gx * gy >= DEFAULT_BLOCKS and not dw_tile_errors(p):
                fits.append((rows, p["channels"] // 4))
        for rows, vectors in fits:
            if vectors >= want:
                return pt, rows
        if fits:
            return pt, fits[0][0]
    for rows in DW_ROWS:
        if not dw_tile_errors(dw_plan(n, h, w, c, hk, esize, 1, rows)):
            return 1, rows
    return 1, 1


def check_dw_tile(name: str, shape: tuple, esize: int, pt, rows) -> dict:
    """The tile a depthwise wrapper launches on ``shape`` = (n, h, w, c,
    hk): ``pt`` and ``rows`` (None: the default's), each one of its knob's
    values, and a launch that fits."""
    if pt is None or rows is None:
        d = _default_dw_tile(*shape, esize)
        pt = d[0] if pt is None else pt
        rows = d[1] if rows is None else rows
    errs = dw_knob_errors(pt, rows)
    if errs:
        raise ValueError(f"{name}: " + "; ".join(errs))
    errs = dw_tile_errors(dw_plan(*shape, esize, pt, rows))
    if errs:
        raise ValueError(f"{name}: tile pt={pt}, rows={rows} cannot launch: "
                         + "; ".join(errs))
    return {"pt": pt, "rows": rows}


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
                   pt=None, rows=None):
    """x (N,H,W,C) int8, w_dw (HK,HK,C) or (HK,HK,C,1) int8 -> (N,H,W,C)
    int8. ``pt`` and ``rows`` default to :func:`default_dw_tile`."""
    w_dw = _check_dw("depthwise2d_q8", x, w_dw)
    n, h, wd, c = x.shape
    hk = w_dw.shape[0]
    if hk * hk > MAX_CONTRACTION:
        raise ValueError("depthwise2d_q8: kernel too large for int32")
    check_shift("depthwise2d_q8", requant_shift)
    check_act("depthwise2d_q8", act)
    tile = check_dw_tile("depthwise2d_q8", (n, h, wd, c, hk), 1, pt, rows)
    if x.device.type == "cpu":
        return depthwise2d_q8_plain(x, w_dw, requant_shift=requant_shift,
                                    act=act)
    for t in (x, w_dw):
        check_cuda_operand("depthwise2d_q8", t, x.device, torch.int8)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = library().repro_depthwise2d_q8(
            x.data_ptr(), w_dw.data_ptr(), y.data_ptr(), n, h, wd, c, hk,
            requant_shift, int(act == "relu"), tile["pt"], tile["rows"],
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
                   pt=None, rows=None):
    """x (N,H,W,C) int8, w_dw_p (ceil(HK/2),HK,C) or (ceil(HK/2),HK,C,1)
    int8 nibble-packed along the tap rows, w_shifts (HK,) int8 ->
    (N,H,W,C) int8. ``pt`` and ``rows`` default to
    :func:`default_dw_tile`."""
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
    tile = check_dw_tile("depthwise2d_w4", (n, h, wd, c, hk), 1, pt, rows)
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
            tile["pt"], tile["rows"], torch.cuda.current_stream().cuda_stream)
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


def depthwise2d_f(x, w_dw, *, act=None, pt=None, rows=None):
    """x (N,H,W,C) float32 or bfloat16, w_dw (HK,HK,C) or (HK,HK,C,1) in
    x's dtype -> (N,H,W,C) in x's dtype. ``pt`` and ``rows`` default to
    :func:`default_dw_tile`."""
    w_dw = _check_dw("depthwise2d_f", x, w_dw)
    check_act("depthwise2d_f", act)
    n, h, wd, c = x.shape
    hk = w_dw.shape[0]
    tile = check_dw_tile("depthwise2d_f", (n, h, wd, c, hk),
                         DW_ESIZE.get(x.dtype, 4), pt, rows)
    if x.device.type == "cpu":
        return depthwise2d_f_plain(x, w_dw, act=act)
    code = float_code("depthwise2d_f", x)
    for t in (x, w_dw):
        check_cuda_operand("depthwise2d_f", t, x.device, x.dtype)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = library().repro_depthwise2d_f(
            x.data_ptr(), w_dw.data_ptr(), y.data_ptr(), n, h, wd, c, hk,
            int(act == "relu"), code, tile["pt"], tile["rows"],
            torch.cuda.current_stream().cuda_stream)
    check_launch("depthwise2d_f", rc)
    depthwise2d_f.launches += 1
    return y


depthwise2d_f.launches = 0
