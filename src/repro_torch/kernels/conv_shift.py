"""int8, W4A8 and float shift convolution (per-channel shift fused into the
pointwise contraction): the CUDA kernel wrappers, their plain PyTorch
versions, their launch arithmetic and their launch counters.

Replaces the TPU kernel ``repro/kernels/conv_shift.py`` (``shift_conv2d``)
in all its modes; the source is ``csrc/conv_shift.cu``. The paper's shift
primitive is im2col whose sampling step reads each channel at its own
offset, and so is the design here. What bounds it on an H100: a 1x1
contraction over C channels, a few MB and well under a GFLOP per launch at
the model's shapes, so its floor is about a microsecond of HBM time.

The integer modes (:func:`shift_conv2d_q8`, :func:`shift_conv2d_w4`) run
the integer conv's implicit GEMM (``csrc/igemm.cuh``) with M = N*H*W, N =
Cy and K = C: a shift with |shift| <= d has the geometry of a (2d+1) x
(2d+1) SAME conv with one tap per input channel, so a block stages its
pixels' input window with a halo of d and gathers each channel's byte at
its own displacement, read from the device shift table once a block.
:func:`shift_plan` is the launch arithmetic the source computes and
:func:`default_shift_tile` the wrappers' choice. The window depends on d,
so on the card ``max_shift`` is required: the table's bound is checked on
the host once, when a plan is lowered or loaded
(``weights.plan_from_numpy``, ``core.primitives.shift_bound``), never per
call. The kernel's contract is |shift| <= max_shift; it never reads outside
its staged window (an entry past the bound reads a zero, and the output is
then not the shift conv's).

The W4 mode (:func:`shift_conv2d_w4`) takes the pointwise weight packed
along C, K's order, with one int8 group shift per channel; each block
unpacks the nibbles once, while it stages the filter. The TPU wrapper
re-packs the nibbles along its channel sort; with no sort there is nothing
to re-pack.

The float mode (:func:`shift_conv2d_f`, float32 or bfloat16) stages each
block's shifted input tile and weight slice in shared memory as float32,
and each thread sums one pixel x q channels in registers over the input
channels in index order (:func:`shift_f_plan`); its plain version repeats
that order one multiply and one add at a time, so the two are bitwise
equal. The TPU kernel sums per shift group on its matrix unit, so the float
mode agrees with the JAX package within a tolerance (ROADMAP.md, section C:
float shift is not bitwise even inside the reference).

Every wrapper takes the tile ``bp`` (pixels a block) and ``q`` (channels a
thread), the tuner's knobs, the integer conv's; they change no output.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.primitives import conv_nhwc, shift_bound, shift_channels
from repro_torch.core.quantize import expand_w4

from ._build import check_launch, library
from .common import acc_dtype, apply_act, apply_requant, cdiv, float_code
from .conv_im2col import (CONV_BP, MAX_CONTRACTION, check_act,
                          check_cuda_operand, check_elements, check_shift,
                          check_w4, igemm_plan, knob_errors, tile_errors,
                          tile_rule)

#: the float mode's input channels a staged chunk, and its threads a block
#: below bp = 256 (csrc/conv_shift.cu FKC, F_THREADS)
F_KC, F_THREADS = 64, 128


@functools.lru_cache(maxsize=4096)
def shift_plan(n: int, h: int, w: int, c: int, cy: int, d: int, bp: int,
               q: int) -> dict:
    """The integer modes' launch arithmetic, as ``repro_shift_conv2d_i8_plan``
    in ``csrc/conv_shift.cu`` computes it: the implicit GEMM of a
    (2d+1)-wide window over K = C (``conv_im2col.igemm_plan``'s keys).
    Memoized: do not mutate the dict."""
    return igemm_plan(n, h, w, c, cy, 2 * d + 1, 1, c, bp, q)


@functools.lru_cache(maxsize=4096)
def shift_f_plan(n: int, h: int, w: int, c: int, cy: int, bp: int,
                 q: int) -> dict:
    """The float mode's launch arithmetic, as ``repro_shift_conv2d_f_plan``
    computes it: ``grid`` (pixel blocks over all N*H*W pixels, channel
    blocks), ``threads`` (bp x the block's channel groups, at most 128
    below bp = 256), ``smem`` (the staged inputs, bp + 1 floats a channel
    row, and weights of a chunk, each pixel's row, column and image as an
    int4, the chunk's shift pairs) and ``block_channels``. Memoized."""
    ct = min(cdiv(cy, q), F_THREADS // bp if bp < F_THREADS else 1)
    bn = ct * q
    smem = 4 * (F_KC * (bp + 1) + F_KC * bn + 4 * bp + 2 * F_KC)
    return dict(grid=(cdiv(n * h * w, bp), cdiv(cy, bn)), threads=bp * ct,
                smem=smem, block_channels=bn)


def default_shift_tile(n, h, w, c, cy, d, integer=True) -> dict:
    """The wrappers' own tile. The integer modes: :func:`default_tile`'s
    rule (``conv_im2col``) on :func:`shift_plan` (a block covers at most an
    image). The float mode: 4 channels a thread and 32 pixels a block, the
    most blocks and threads (Table-2's job has 65,536 outputs: latency, not
    tile depth, bounds it)."""
    return dict(zip(("bp", "q"), _default_shift_tile(n, h, w, c, cy, d,
                                                     integer)))


@functools.lru_cache(maxsize=4096)
def _default_shift_tile(n, h, w, c, cy, d, integer) -> tuple:
    if not integer:
        return CONV_BP[0], 4
    return tile_rule(cy, h * w,
                     lambda bp, q: shift_plan(n, h, w, c, cy, d, bp, q))


def window_shift(name: str, shifts, max_shift, device) -> int:
    """The shift table's bound d that sizes the window: ``max_shift`` (at
    least 1, as ``shift_bound`` reads it). Required on a card, where the
    table is never read back; on the host the table's own bound."""
    if max_shift is None:
        if device.type != "cpu":
            raise ValueError(f"{name}: max_shift is required on the card "
                             "(the kernel's window depends on it; pass "
                             "kernel_size // 2)")
        return shift_bound(shifts)
    if (not isinstance(max_shift, int) or isinstance(max_shift, bool)
            or max_shift < 0):
        raise ValueError(f"{name}: max_shift must be an int >= 0, got "
                         f"{max_shift!r}")
    return max(1, max_shift)


def check_shift_tile(name: str, shape: tuple, bp, q,
                     integer=True) -> dict:
    """The tile a shift wrapper launches on ``shape`` = (n, h, w, c, cy,
    d): ``bp`` and ``q`` (None: the default's), each one of its knob's
    values, and a launch that fits."""
    if bp is None or q is None:
        dflt = _default_shift_tile(*shape, integer)
        bp = dflt[0] if bp is None else bp
        q = dflt[1] if q is None else q
    errs = knob_errors(bp, q)
    if errs:
        raise ValueError(f"{name}: " + "; ".join(errs))
    n, h, w, c, cy, d = shape
    plan = (shift_plan(n, h, w, c, cy, d, bp, q) if integer
            else shift_f_plan(n, h, w, c, cy, bp, q))
    errs = tile_errors(plan)
    if errs:
        raise ValueError(f"{name}: tile bp={bp}, q={q} cannot launch: "
                         + "; ".join(errs))
    return {"bp": bp, "q": q}


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
                    max_shift=None, act=None, bp=None, q=None):
    """x (N,H,W,C) int8, shifts (C,2) int32, w_pw (C,Cy) or (1,1,C,Cy) int8,
    bias (Cy,) int32 or None -> (N,H,W,Cy) int8. ``max_shift`` (the table's
    bound, |shift| <= max_shift) is required on the card; ``bp`` and ``q``
    default to :func:`default_shift_tile`."""
    _check_ranks("shift_conv2d_q8", x, w_pw)
    wp = _pointwise(w_pw)
    n, h, wd, c, cy = _check_shift_conv("shift_conv2d_q8", x, shifts,
                                        wp.shape, bias, requant_shift, act)
    d = window_shift("shift_conv2d_q8", shifts, max_shift, x.device)
    tile = check_shift_tile("shift_conv2d_q8", (n, h, wd, c, cy, d), bp, q)
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
            n, h, wd, c, cy, d, requant_shift, int(act == "relu"),
            tile["bp"], tile["q"], torch.cuda.current_stream().cuda_stream)
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
                    requant_shift=None, max_shift=None, act=None, bp=None,
                    q=None):
    """x (N,H,W,C) int8, shifts (C,2) int32, w_pw_p (ceil(C/2),Cy) or
    (1,1,ceil(C/2),Cy) int8 nibble-packed along C, w_shifts (C,) int8, bias
    (Cy,) int32 or None -> (N,H,W,Cy) int8. ``max_shift`` is required on the
    card; ``bp`` and ``q`` default to :func:`default_shift_tile`."""
    _check_ranks("shift_conv2d_w4", x, w_pw_p)
    wp = _pointwise(w_pw_p)
    c = x.shape[-1]
    check_w4("shift_conv2d_w4", wp, 0, c, w_shifts, requant_shift)
    n, h, wd, c, cy = _check_shift_conv("shift_conv2d_w4", x, shifts,
                                        (c, wp.shape[-1]), bias,
                                        requant_shift, act)
    d = window_shift("shift_conv2d_w4", shifts, max_shift, x.device)
    tile = check_shift_tile("shift_conv2d_w4", (n, h, wd, c, cy, d), bp, q)
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
            y.data_ptr(), n, h, wd, c, cy, d, requant_shift,
            int(act == "relu"), tile["bp"], tile["q"],
            torch.cuda.current_stream().cuda_stream)
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


def shift_conv2d_f(x, shifts, w_pw, *, max_shift=None, act=None, bp=None,
                   q=None):
    """x (N,H,W,C) float32 or bfloat16, shifts (C,2) int32, w_pw (C,Cy) or
    (1,1,C,Cy) in x's dtype -> (N,H,W,Cy) in x's dtype. ``max_shift`` is
    required on the card, as in the integer modes (the float kernel's reads
    are bounds-checked, but the table's bound is one contract for every
    mode); ``bp`` and ``q`` default to :func:`default_shift_tile`."""
    _check_ranks("shift_conv2d_f", x, w_pw)
    wp = _pointwise(w_pw)
    n, h, wd, c, cy = _check_shift_conv("shift_conv2d_f", x, shifts,
                                        wp.shape, None, None, act,
                                        integer=False)
    d = window_shift("shift_conv2d_f", shifts, max_shift, x.device)
    tile = check_shift_tile("shift_conv2d_f", (n, h, wd, c, cy, d), bp, q,
                            integer=False)
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
            n, h, wd, c, cy, int(act == "relu"), code, tile["bp"], tile["q"],
            torch.cuda.current_stream().cuda_stream)
    check_launch("shift_conv2d_f", rc)
    shift_conv2d_f.launches += 1
    return y


shift_conv2d_f.launches = 0
