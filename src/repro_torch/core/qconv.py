"""Integer-only quantized forward of the five primitives (port of
``repro/core/qconv.py``).

NNoM's execution model: int8 operands, int32 accumulation, one arithmetic
shift to the output scale (Algorithm 1), an optional bias added at
accumulator scale. BN is folded beforehand for the multiplicative
primitives (``folding.fold``); add-conv is followed by an integer BN node
(``graph.lower``).

Every layer routes through the kernel layer (``repro_torch.kernels.ops``):

* ``method="cuda"`` — the hand-written CUDA kernels with their fused int8
  epilogues, the analogue of the JAX package's ``"pallas"``;
* ``method="torch"`` — the plain PyTorch versions, the analogue of
  ``"xla"``.

Both accumulate exactly in int32 and share the Algorithm-1 epilogue, so
they are bitwise equal. ``configs=`` pins the kernels' launch configs per
stage (``repro_torch.tune``); without it each ``"cuda"`` call looks its
config up in the tuner. Layers the kernels cannot express (stride != 1 or
non-SAME padding) run :func:`_qconv_apply_lax` under ``"torch"`` and raise
under ``"cuda"``.

W4A8: a :class:`~repro_torch.core.quantize.QTensorW4` weight leaf stays
nibble-packed on its way to the kernel layer, which unpacks it in
registers; its ``frac_bits`` is the base scale its expanded codes live at,
so the scale arithmetic is the same as for an int8 leaf. The plain integer
path outside the kernels' envelope expands W4 leaves first.
"""
from __future__ import annotations

from typing import Optional

import torch

from .primitives import ConvSpec, add_conv, shift_channels, standard_conv
from .quantize import (QTensor, QTensorW4, add_preshifts, addmac_align,
                       quantize, quantize_w4, requantize, rshift_round)


def _bias_acc(bias: Optional[QTensor], acc_fb: int) -> Optional[torch.Tensor]:
    """Bias rescaled to the int32 accumulator scale (Algorithm 1, line 2)."""
    if bias is None:
        return None
    return rshift_round(bias.q.to(torch.int32), bias.frac_bits - acc_fb)


def _kernel_layer_ok(spec: ConvSpec) -> bool:
    return spec.stride == 1 and spec.padding == "SAME"


def _wq(w):
    """(weight tensor, w_shifts or None) for the kernel layer: a QTensorW4
    leaf stays packed, a QTensor passes through."""
    if isinstance(w, QTensorW4):
        return w.q, w.shifts
    return w.q, None


def _expand_w4_qparams(qparams: dict) -> dict:
    """W4 leaves -> the equivalent int8 QTensors (for the plain path outside
    the kernels' envelope, which has no packed-weight form)."""
    return {k: QTensor(v.expand(), v.frac_bits)
            if isinstance(v, QTensorW4) else v for k, v in qparams.items()}


def qconv_apply(qparams: dict, x: QTensor, spec: ConvSpec, out_frac_bits: int,
                *, method: str = "cuda", act: Optional[str] = None,
                configs: Optional[dict] = None) -> QTensor:
    """Run one quantized primitive layer; returns an int8 QTensor.

    ``act="relu"`` fuses the activation into the layer's LAST kernel stage
    at accumulator scale (the graph executor's fused conv+BN+ReLU block).
    ``configs`` pins the launch configs per stage: ``{"main": {...}}`` for
    the single-kernel primitives, ``{"dw": ..., "pw": ...}`` for dws; only
    with ``method="cuda"`` (the plain versions have no launch).
    """
    from repro_torch.kernels import ops as K

    if method not in ("cuda", "torch"):
        raise ValueError(f"unknown method {method!r}; expected 'cuda' or "
                         "'torch'")
    if configs is not None and method != "cuda":
        raise ValueError("qconv_apply: configs= pins CUDA launch configs; "
                         "method='torch' has none (drop configs or use "
                         "'cuda')")
    p = spec.primitive
    bias = qparams.get("b")
    cfgs = configs or {}

    if not _kernel_layer_ok(spec):
        if method == "cuda":
            raise NotImplementedError(
                f"qconv_apply(method='cuda'): the CUDA kernels only support "
                f"stride=1 SAME layers, got stride={spec.stride} "
                f"padding={spec.padding!r}; use method='torch'")
        return _qconv_apply_lax(_expand_w4_qparams(qparams), x, spec,
                                out_frac_bits, act=act)

    if p in ("standard", "grouped"):
        w = qparams["w"]
        wq, ws = _wq(w)
        groups = spec.groups if p == "grouped" else 1
        acc_fb = x.frac_bits + w.frac_bits
        y = K.conv2d(x.q, wq, _bias_acc(bias, acc_fb), groups=groups,
                     method=method, requant_shift=acc_fb - out_frac_bits,
                     act=act, w_shifts=ws, config=cfgs.get("main"))
        return QTensor(y, out_frac_bits)

    if p == "dws":
        w_dw, w_pw = qparams["w_dw"], qparams["w_pw"]
        wdq, wds = _wq(w_dw)
        wpq, wps = _wq(w_pw)
        # depthwise at an intermediate scale, then pointwise
        mid_fb = qparams.get("mid_frac_bits", out_frac_bits)
        h = K.depthwise2d(x.q, wdq, method=method,
                          requant_shift=x.frac_bits + w_dw.frac_bits - mid_fb,
                          w_shifts=wds, config=cfgs.get("dw"))
        acc_fb = mid_fb + w_pw.frac_bits
        y = K.conv2d(h, wpq, _bias_acc(bias, acc_fb), method=method,
                     requant_shift=acc_fb - out_frac_bits, act=act,
                     w_shifts=wps, config=cfgs.get("pw"))
        return QTensor(y, out_frac_bits)

    if p == "shift":
        # the shift is pure data movement, exact in the integer domain: the
        # kernel reads each channel at its displacement inside the
        # pointwise contraction
        w_pw = qparams["w_pw"]
        wpq, wps = _wq(w_pw)
        acc_fb = x.frac_bits + w_pw.frac_bits
        y = K.shift_conv2d(x.q, qparams["shifts"], wpq,
                           _bias_acc(bias, acc_fb), method=method,
                           requant_shift=acc_fb - out_frac_bits, act=act,
                           max_shift=spec.kernel_size // 2, w_shifts=wps,
                           config=cfgs.get("main"))
        return QTensor(y, out_frac_bits)

    if p == "add":
        w = qparams["w"]
        wq, ws = _wq(w)
        x_pre, w_pre, acc_fb = add_preshifts(x.frac_bits, w.frac_bits)
        y = K.add_conv2d(x.q, wq, _bias_acc(bias, acc_fb), method=method,
                         requant_shift=acc_fb - out_frac_bits,
                         x_preshift=x_pre, w_preshift=w_pre, act=act,
                         w_shifts=ws, config=cfgs.get("main"))
        return QTensor(y, out_frac_bits)

    raise ValueError(p)


def _conv_int(x_q, w_q, *, stride=1, padding="SAME", groups=1):
    """int8 x int8 -> exact int32 convolution with XLA's padding rules."""
    return standard_conv(x_q.to(torch.int32), w_q.to(torch.int32),
                         stride=stride, padding=padding, groups=groups)


def _qconv_apply_lax(qparams: dict, x: QTensor, spec: ConvSpec,
                     out_frac_bits: int, act: Optional[str] = None) -> QTensor:
    """Plain integer path for layer shapes outside the kernels' stride-1 /
    SAME envelope: the same Algorithm-1 arithmetic (int32 accumulation,
    accumulator-scale bias, fused act, round-to-nearest requantization)."""
    from repro_torch.kernels.common import apply_act

    p = spec.primitive
    bias = qparams.get("b")

    def finish(acc, acc_fb):
        b_acc = _bias_acc(bias, acc_fb)
        if b_acc is not None:
            acc = acc + b_acc
        acc = apply_act(acc, act)
        return QTensor(requantize(acc, acc_fb, out_frac_bits), out_frac_bits)

    if p in ("standard", "grouped"):
        w = qparams["w"]
        groups = spec.groups if p == "grouped" else 1
        acc = _conv_int(x.q, w.q, stride=spec.stride, padding=spec.padding,
                        groups=groups)
        return finish(acc, x.frac_bits + w.frac_bits)

    if p == "dws":
        w_dw, w_pw = qparams["w_dw"], qparams["w_pw"]
        mid_fb = qparams.get("mid_frac_bits", out_frac_bits)
        acc = _conv_int(x.q, w_dw.q.permute(0, 1, 3, 2), stride=spec.stride,
                        padding=spec.padding, groups=spec.in_channels)
        h = requantize(acc, x.frac_bits + w_dw.frac_bits, mid_fb)
        acc2 = _conv_int(h, w_pw.q, stride=1, padding="SAME")
        return finish(acc2, mid_fb + w_pw.frac_bits)

    if p == "shift":
        w_pw = qparams["w_pw"]
        shifted = shift_channels(x.q, qparams["shifts"],
                                 max_shift=spec.kernel_size // 2)
        acc = _conv_int(shifted, w_pw.q, stride=spec.stride, padding="SAME")
        return finish(acc, x.frac_bits + w_pw.frac_bits)

    if p == "add":
        # stride 1 whatever spec.stride says, as the JAX package's add path
        # (and its float add_conv) computes it
        xi, wi, acc_fb = addmac_align(x.q, qparams["w"].q, x.frac_bits,
                                      qparams["w"].frac_bits)
        return finish(add_conv(xi, wi, padding=spec.padding), acc_fb)

    raise ValueError(p)


def _w4_axis(key: str, v) -> int:
    """W4 packing axis per parameter key, the axis the kernels unpack
    along: input channels for the contraction weights (``ndim - 2``, so a
    2-D pointwise layout works too), tap rows for depthwise (channels stay
    the contiguous axis)."""
    return 0 if key == "w_dw" else v.dim() - 2


def quantize_conv_params(params: dict, spec: ConvSpec, *, bits: int = 8,
                         group_size: int = 32) -> dict:
    """Power-of-two PTQ of a float primitive layer.

    ``bits=8``: per-tensor int8 QTensors. ``bits=4``: the weight tensors
    (``w``, ``w_dw``, ``w_pw``) become nibble-packed :class:`QTensorW4`
    with per-group scales (``group_size`` consecutive elements along the
    unpack axis); biases stay int8 (they are added at int32 accumulator
    scale, packing them buys nothing). The shift table is kept as it is."""
    if bits not in (8, 4):
        raise ValueError(f"quantize_conv_params: bits must be 8 or 4, "
                         f"got {bits}")
    out = {}
    for k, v in params.items():
        if k == "shifts":
            out[k] = v
        elif bits == 4 and k in ("w", "w_dw", "w_pw"):
            out[k] = quantize_w4(v, axis=_w4_axis(k, v),
                                 group_size=group_size)
        else:
            out[k] = quantize(v)
    return out
