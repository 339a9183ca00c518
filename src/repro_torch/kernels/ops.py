"""Public entry points of the port's kernel layer.

``method="cuda"`` mirrors the JAX package's ``"pallas"``: the hand-written
CUDA kernels. ``method="torch"`` mirrors ``"xla"``: the plain PyTorch
versions. The tensor's device decides what runs:

* a CPU tensor always runs the plain version;
* a CUDA tensor with ``"cuda"`` launches the kernel or raises;
* a CUDA tensor with ``"torch"`` runs the plain version (tests and
  ``chip_smoke.py`` compare the two this way).

There is no fallback from a kernel to its plain version: a kernel that
fails to build or launch raises. Every mode is ported: int8 codes with
``requant_shift``; W4A8, where a call with ``w_shifts`` takes
nibble-packed weights (``core.quantize.QTensorW4``'s ``q`` and
``shifts``) and needs ``requant_shift``; and float32 / bfloat16, where
``"cuda"`` runs the float kernel (its plain version on host tensors) and
``"torch"`` the JAX-facing oracle of ``ref``. :func:`causal_conv1d` is a
float kernel and differentiable: its backward mirrors the JAX package's
custom VJP.

Launch configs (``repro_torch.tune``): every ``"cuda"`` call without
``config=`` launches the config ``tune.get_config`` returns (memo, then
the installed cache, then the analytic model); an explicit ``config=`` is
checked against the tuner's space (``tune.check_config``, a
``ValueError`` outside it). ``config=`` with ``"torch"`` is a
``ValueError``: the plain versions have no launch to configure. No config
changes an output.

Every call counts into the process metrics registry as
``kernels.dispatch.<kernel>.<method>``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.obs import metrics as _obs_metrics

from . import ref
from .conv1d_causal import causal_conv1d as _c1d_kernel
from .conv_add import add_conv2d_f, add_conv2d_q8, add_conv2d_w4
from .conv_dw import depthwise2d_f, depthwise2d_q8, depthwise2d_w4
from .conv_im2col import conv2d_f, conv2d_q8, conv2d_w4
from .conv_shift import (shift_conv2d_f, shift_conv2d_q8, shift_conv2d_w4,
                         window_shift)
from .matmul_q8 import matmul_f, matmul_q8, matmul_w4
from .pool import maxpool2d_f, maxpool2d_s8

METHODS = ("cuda", "torch")


def _check_method(method: str):
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; expected one of "
                         f"{METHODS}")


def _count_dispatch(kernel: str, method: str):
    _obs_metrics.counter(f"kernels.dispatch.{kernel}.{method}").inc()


def _check_w4(kernel: str, x, requant_shift):
    if requant_shift is None:
        raise ValueError(f"{kernel}: W4 weights need the quantized path "
                         "(requant_shift); there is no float W4 mode")
    if x.dtype != torch.int8:
        raise ValueError(f"{kernel}: W4 weights require int8 activations "
                         f"(W4A8), got {x.dtype}")


def _launch_config(kernel: str, method: str, config, sig_fn, dims, x,
                   w_shifts=None) -> dict:
    """The launch config of one call: ``{}`` under ``"torch"`` (which takes
    none), else the explicit ``config`` checked against the tuner's space,
    or the tuner's lookup for x's device, keyed "w4a8" for packed weights
    and by x's dtype otherwise. Imported lazily: the tuner measures
    through these entry points."""
    if method == "torch":
        if config is not None:
            raise ValueError(
                f"{kernel}: method='torch' runs the plain version, which "
                "has no launch config; drop config= or use method='cuda'")
        return {}
    from repro_torch import tune
    sig = getattr(tune, sig_fn)(*dims)
    dtype = "w4a8" if w_shifts is not None else tune.dtype_key(x.dtype)
    if config is None:
        return tune.get_config(sig, dtype, x.device)
    return tune.check_config(sig, config, dtype)


def conv2d(x, w, bias=None, *, groups: int = 1, method: str = "cuda",
           requant_shift: Optional[int] = None, act: Optional[str] = None,
           w_shifts=None, config: Optional[dict] = None):
    """SAME stride-1 standard / grouped conv, NHWC x HWIO. With
    ``w_shifts``, ``w`` is packed W4 (HK,HK,ceil(Cx/g/2),Cy)."""
    _check_method(method)
    _count_dispatch("conv2d", method)
    n, h, wd, cx = x.shape
    cfg = _launch_config("conv2d", method, config, "sig_conv2d",
                         (n, h, wd, cx, w.shape[-1], w.shape[0], groups), x,
                         w_shifts)
    if w_shifts is not None:
        _check_w4("conv2d", x, requant_shift)
        if method == "torch":
            return ref.conv2d_w4_ref(x, w, w_shifts, bias, groups=groups,
                                     requant_shift=requant_shift, act=act)
        return conv2d_w4(x, w, w_shifts, bias, groups=groups,
                         requant_shift=requant_shift, act=act, **cfg)
    if requant_shift is None:
        if method == "torch":
            return ref.conv2d_ref(x, w, bias, groups=groups, act=act)
        return conv2d_f(x, w, bias, groups=groups, act=act, **cfg)
    if method == "torch":
        return ref.conv2d_q8_ref(x, w, bias, groups=groups,
                                 requant_shift=requant_shift, act=act)
    return conv2d_q8(x, w, bias, groups=groups, requant_shift=requant_shift,
                     act=act, **cfg)


def depthwise2d(x, w_dw, *, method: str = "cuda",
                requant_shift: Optional[int] = None,
                act: Optional[str] = None, w_shifts=None,
                config: Optional[dict] = None):
    """SAME stride-1 depthwise conv; ``w_dw`` is (HK,HK,C) or (HK,HK,C,1),
    or with ``w_shifts`` packed W4 along the tap rows (ceil(HK/2),HK,C)."""
    _check_method(method)
    _count_dispatch("depthwise2d", method)
    n, h, wd, c = x.shape
    hk = w_dw.shape[1] if w_shifts is not None else w_dw.shape[0]
    cfg = _launch_config("depthwise2d", method, config, "sig_depthwise2d",
                         (n, h, wd, c, hk), x, w_shifts)
    if w_shifts is not None:
        _check_w4("depthwise2d", x, requant_shift)
        if method == "torch":
            return ref.depthwise2d_w4_ref(x, w_dw, w_shifts,
                                          requant_shift=requant_shift,
                                          act=act)
        return depthwise2d_w4(x, w_dw, w_shifts, requant_shift=requant_shift,
                              act=act, **cfg)
    if requant_shift is None:
        if method == "torch":
            return ref.depthwise2d_ref(x, w_dw, act=act)
        return depthwise2d_f(x, w_dw, act=act, **cfg)
    if method == "torch":
        return ref.depthwise2d_q8_ref(x, w_dw, requant_shift=requant_shift,
                                      act=act)
    return depthwise2d_q8(x, w_dw, requant_shift=requant_shift, act=act,
                          **cfg)


def shift_conv2d(x, shifts, w_pw, bias=None, *, method: str = "cuda",
                 requant_shift: Optional[int] = None,
                 act: Optional[str] = None, max_shift: Optional[int] = None,
                 w_shifts=None, config: Optional[dict] = None):
    """Per-channel shift fused into a pointwise conv; ``shifts`` is (C,2),
    ``w_pw`` (C,Cy) or (1,1,C,Cy), packed W4 along C with ``w_shifts``.
    ``max_shift`` bounds |shift| (pass ``kernel_size // 2``; required on a
    card under ``"cuda"``, where it sizes the kernel's window); ``bias`` is
    added at accumulator scale (quantized paths only)."""
    _check_method(method)
    _count_dispatch("shift_conv2d", method)
    n, h, wd, c = x.shape
    d = 1 if method == "torch" else window_shift("shift_conv2d", shifts,
                                                 max_shift, x.device)
    cfg = _launch_config("shift_conv2d", method, config, "sig_shift_conv2d",
                         (n, h, wd, c, w_pw.shape[-1], d), x, w_shifts)
    kw = dict(requant_shift=requant_shift, max_shift=max_shift, act=act)
    if w_shifts is not None:
        _check_w4("shift_conv2d", x, requant_shift)
        if method == "torch":
            return ref.shift_conv2d_w4_ref(x, shifts, w_pw, w_shifts, bias,
                                           **kw)
        return shift_conv2d_w4(x, shifts, w_pw, w_shifts, bias, **kw, **cfg)
    if requant_shift is None:
        if bias is not None:
            raise ValueError("shift_conv2d: bias without requant_shift is "
                             "only supported on the quantized path")
        if method == "torch":
            return ref.shift_conv2d_ref(x, shifts, w_pw, max_shift=max_shift,
                                        act=act)
        return shift_conv2d_f(x, shifts, w_pw, max_shift=max_shift, act=act,
                              **cfg)
    if method == "torch":
        return ref.shift_conv2d_q8_ref(x, shifts, w_pw, bias, **kw)
    return shift_conv2d_q8(x, shifts, w_pw, bias, **kw, **cfg)


def add_conv2d(x, w, bias=None, *, method: str = "cuda",
               requant_shift: Optional[int] = None, x_preshift: int = 0,
               w_preshift: int = 0, act: Optional[str] = None,
               w_shifts=None, config: Optional[dict] = None):
    """SAME stride-1 AdderNet conv, NHWC x HWIO (packed W4 along Cx with
    ``w_shifts``). ``x_preshift`` and ``w_preshift`` are the Algorithm-1
    (right) left shifts that align the operands' scales; they and ``bias``
    (at accumulator scale) belong to the quantized paths only."""
    _check_method(method)
    _count_dispatch("add_conv2d", method)
    n, h, wd, cx = x.shape
    cfg = _launch_config("add_conv2d", method, config, "sig_add_conv2d",
                         (n, h, wd, cx, w.shape[-1], w.shape[0]), x,
                         w_shifts)
    kw = dict(requant_shift=requant_shift, x_preshift=x_preshift,
              w_preshift=w_preshift, act=act)
    if w_shifts is not None:
        _check_w4("add_conv2d", x, requant_shift)
        if method == "torch":
            return ref.add_conv2d_w4_ref(x, w, w_shifts, bias, **kw)
        return add_conv2d_w4(x, w, w_shifts, bias, **kw, **cfg)
    if requant_shift is None:
        if bias is not None or x_preshift or w_preshift:
            raise ValueError("add_conv2d: bias/preshifts without "
                             "requant_shift are only supported on the "
                             "quantized path")
        if method == "torch":
            return ref.add_conv2d_ref(x, w, act=act)
        return add_conv2d_f(x, w, act=act, **cfg)
    if method == "torch":
        return ref.add_conv2d_q8_ref(x, w, bias, **kw)
    return add_conv2d_q8(x, w, bias, **kw, **cfg)


def maxpool2d(x, *, window: int = 2, stride: Optional[int] = None,
              method: str = "cuda", config: Optional[dict] = None):
    """VALID max-pool, int8 or float32 / bfloat16."""
    _check_method(method)
    _count_dispatch("maxpool2d", method)
    n, h, wd, c = x.shape
    cfg = _launch_config("maxpool2d", method, config, "sig_maxpool2d",
                         (n, h, wd, c, window, stride or window), x)
    if method == "torch":
        return ref.maxpool2d_ref(x, window=window, stride=stride)
    if x.dtype.is_floating_point:
        return maxpool2d_f(x, window=window, stride=stride, **cfg)
    return maxpool2d_s8(x, window=window, stride=stride, **cfg)


def matmul(a, b, *, method: str = "cuda", requant_shift: Optional[int] = None,
           act: Optional[str] = None, w_shifts=None,
           config: Optional[dict] = None):
    """``a`` (M,K) or (B,M,K) @ ``b`` (K,N): int8 codes with
    ``requant_shift``, or float32 / bfloat16. A 3-D ``a`` folds its batch
    into M (and the tuner's signature sees the folded M), so one launch
    covers the whole batch. With ``w_shifts``, ``b`` is packed W4 along K,
    (ceil(K/2), N)."""
    _check_method(method)
    _count_dispatch("matmul", method)
    if a.dim() == 3:
        nb, m, k = a.shape
        out = _matmul(a.reshape(nb * m, k), b, method, requant_shift, act,
                      w_shifts, config)
        return out.reshape(nb, m, out.shape[-1])
    return _matmul(a, b, method, requant_shift, act, w_shifts, config)


def _matmul(a, b, method, requant_shift, act, w_shifts, config):
    cfg = _launch_config("matmul", method, config, "sig_matmul",
                         (a.shape[0], a.shape[-1], b.shape[-1]), a,
                         w_shifts)
    if w_shifts is not None:
        _check_w4("matmul", a, requant_shift)
        if method == "torch":
            return ref.matmul_w4_ref(a, b, w_shifts,
                                     requant_shift=requant_shift, act=act)
        return matmul_w4(a, b, w_shifts, requant_shift=requant_shift,
                         act=act, **cfg)
    if requant_shift is None:
        if method == "torch":
            return ref.matmul_ref(a, b, act=act)
        return matmul_f(a, b, act=act, **cfg)
    if method == "torch":
        return ref.matmul_ref(a, b, requant_shift=requant_shift, act=act)
    return matmul_q8(a, b, requant_shift=requant_shift, act=act, **cfg)


def _c1d(x, w, method, cfg):
    if method == "torch":
        return ref.causal_conv1d_f32(x, w)
    return _c1d_kernel(x, w, **cfg)


class _CausalConv1d(torch.autograd.Function):
    """The kernel forward and the analytic backward of the JAX package's
    custom VJP (``repro/kernels/ops.py`` ``_c1d_bwd``): dx is the kernel
    run on the flipped gradient, flipped back (the anti-causal conv with the
    same taps); dw[k,d] = sum_{b,l} g[b,l,d] * x_leftpad[b,l+k,d], summed in
    float32 as plain PyTorch and returned in w's dtype."""

    @staticmethod
    def forward(ctx, x, w, method, cfg):
        ctx.save_for_backward(x, w)
        ctx.method, ctx.cfg = method, cfg
        return _c1d(x, w, method, cfg)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.flip(_c1d(torch.flip(g, [1]).contiguous(), w,
                                 ctx.method, ctx.cfg), [1])
        if ctx.needs_input_grad[1]:
            k, l = w.shape[0], x.shape[1]
            xp = F.pad(x, (0, 0, k - 1, 0)).to(torch.float32)
            g32 = g.to(torch.float32)
            gw = torch.stack([torch.einsum("bld,bld->d", g32,
                                           xp[:, kk:kk + l])
                              for kk in range(k)]).to(w.dtype)
            gw = gw.reshape(w.shape)
        return gx, gw, None, None


def causal_conv1d(x, w, *, method: str = "cuda",
                  config: Optional[dict] = None):
    """Differentiable depthwise causal conv1d, x (B,L,D) * w (K,D) or
    (K,1,D): the kernel (``"cuda"``) or its plain version (``"torch"``),
    forward and in the backward's dx. Like the JAX entry point it takes no
    ``act`` (the backward assumes a linear kernel); the kernel-level
    wrapper has one. The backward's dx launches with the forward's
    config."""
    _check_method(method)
    _count_dispatch("causal_conv1d", method)
    b, l, d = x.shape
    cfg = _launch_config("causal_conv1d", method, config,
                         "sig_causal_conv1d", (b, l, d, w.shape[0]), x)
    return _CausalConv1d.apply(x, w, method, cfg)
