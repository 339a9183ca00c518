"""The paper's convolution primitives as PyTorch functions on NHWC tensors.

Port of ``repro/core/primitives.py``:

  * standard   : dense 2-D convolution (Eq. 1)
  * grouped    : G filter groups (Ioannou et al.)
  * dws        : depthwise-separable = depthwise + pointwise (Szegedy et al.)
  * shift      : per-channel spatial shift + pointwise (Jeon & Kim, Eq. 2)
  * add        : AdderNet L1 "convolution" (Chen et al., Eq. 3)

These float versions serve the calibration sweep and the oracles; the
served int8 path runs the CUDA kernels (``repro_torch.kernels``).
Activations are NHWC and weights HWIO, as in the JAX package, so tensors
compare with no transposes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

Primitives = ("standard", "grouped", "dws", "shift", "add")


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """Structural description of one convolution layer (paper Table 2 axes)."""

    primitive: str = "standard"
    in_channels: int = 16
    out_channels: int = 16
    kernel_size: int = 3
    groups: int = 1           # grouped only
    stride: int = 1
    padding: str = "SAME"
    use_bias: bool = True
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.primitive not in Primitives:
            raise ValueError(f"unknown primitive {self.primitive!r}")
        if self.primitive == "grouped":
            if self.in_channels % self.groups or self.out_channels % self.groups:
                raise ValueError("groups must divide both channel counts")
        if self.primitive in ("dws", "shift") and self.padding != "SAME":
            raise ValueError(f"{self.primitive} requires SAME padding")

    # ---- paper Table 1: analytic parameter / MAC counts -----------------
    def param_count(self) -> int:
        hk2 = self.kernel_size ** 2
        cx, cy = self.in_channels, self.out_channels
        if self.primitive == "standard":
            return hk2 * cx * cy
        if self.primitive == "grouped":
            return hk2 * (cx // self.groups) * cy
        if self.primitive == "dws":
            return cx * (hk2 + cy)
        if self.primitive == "shift":
            return cx * (2 + cy)   # 2 shift ints per channel + pointwise
        if self.primitive == "add":
            return hk2 * cx * cy
        raise AssertionError

    def mac_count(self, out_width: int) -> int:
        hy2 = out_width ** 2
        hk2 = self.kernel_size ** 2
        cx, cy = self.in_channels, self.out_channels
        if self.primitive == "standard":
            return hk2 * cx * hy2 * cy
        if self.primitive == "grouped":
            return hk2 * (cx // self.groups) * hy2 * cy
        if self.primitive == "dws":
            return cx * hy2 * (hk2 + cy)
        if self.primitive == "shift":
            return cx * cy * hy2
        if self.primitive == "add":
            return hk2 * cx * hy2 * cy
        raise AssertionError


# --------------------------------------------------------------------------
# Parameter initialisation
# --------------------------------------------------------------------------

def init(generator: torch.Generator, spec: ConvSpec) -> dict:
    """He-normal weights for the given primitive, drawn from ``generator``
    on its own device."""
    hk, cx, cy = spec.kernel_size, spec.in_channels, spec.out_channels

    def he(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=generator.device)
        return (w * (2.0 / fan_in) ** 0.5).to(spec.dtype)

    params: dict = {}
    if spec.primitive == "standard":
        params["w"] = he((hk, hk, cx, cy), hk * hk * cx)
    elif spec.primitive == "grouped":
        params["w"] = he((hk, hk, cx // spec.groups, cy),
                         hk * hk * cx // spec.groups)
    elif spec.primitive == "dws":
        params["w_dw"] = he((hk, hk, cx, 1), hk * hk)
        params["w_pw"] = he((1, 1, cx, cy), cx)
    elif spec.primitive == "shift":
        # Jeon & Kim: shifts are assigned, not learned: channels go round
        # the HK x HK displacement grid in order.
        disp = hk // 2
        grid = [(a, b) for a in range(-disp, disp + 1)
                for b in range(-disp, disp + 1)]
        params["shifts"] = torch.tensor(
            [grid[i % len(grid)] for i in range(cx)], dtype=torch.int32,
            device=generator.device)
        params["w_pw"] = he((1, 1, cx, cy), cx)
    elif spec.primitive == "add":
        params["w"] = he((hk, hk, cx, cy), hk * hk * cx)
    if spec.use_bias:
        params["b"] = torch.zeros((cy,), dtype=spec.dtype,
                                  device=generator.device)
    return params


def init_block(generator: torch.Generator, spec: ConvSpec,
               with_bn: bool = True) -> dict:
    params = {"conv": init(generator, spec)}
    if with_bn:
        cy, dev = spec.out_channels, generator.device
        params["bn"] = {
            "gamma": torch.ones((cy,), dtype=spec.dtype, device=dev),
            "beta": torch.zeros((cy,), dtype=spec.dtype, device=dev),
            "mean": torch.zeros((cy,), dtype=torch.float32, device=dev),
            "var": torch.ones((cy,), dtype=torch.float32, device=dev),
        }
    return params


# --------------------------------------------------------------------------
# Forward passes
# --------------------------------------------------------------------------

def same_pads(size: int, k: int, stride: int):
    """XLA's SAME padding of one spatial axis: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_nhwc(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
              pads=((0, 0), (0, 0)), groups: int = 1) -> torch.Tensor:
    """NHWC x HWIO convolution with explicit (low, high) zero pads per
    spatial axis; returns NHWC.

    Integer operands accumulate exactly: in int32 on the CPU, and in
    float64 on a card (PyTorch has no integer convolution there; float64
    is exact because every int8 x int8 sum the port forms stays below
    2^53 in magnitude), cast back to int32."""
    (pt, pb), (pl, pr) = pads
    xc = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb))
    wc = w.permute(3, 2, 0, 1)
    integer = not x.dtype.is_floating_point
    if integer and x.device.type == "cpu":
        y = F.conv2d(xc.to(torch.int32), wc.to(torch.int32), stride=stride,
                     groups=groups)
    elif integer:
        y = F.conv2d(xc.to(torch.float64), wc.to(torch.float64),
                     stride=stride, groups=groups).to(torch.int32)
    else:
        y = F.conv2d(xc, wc.to(xc.dtype), stride=stride, groups=groups)
    return y.permute(0, 2, 3, 1).contiguous()


def _xla_pads(x, k, stride, padding):
    if padding == "SAME":
        return (same_pads(x.shape[1], k, stride),
                same_pads(x.shape[2], k, stride))
    if padding == "VALID":
        return ((0, 0), (0, 0))
    raise ValueError(f"unknown padding {padding!r}; expected 'SAME' or "
                     "'VALID'")


def standard_conv(x, w, *, stride=1, padding="SAME", groups=1):
    """Dense or grouped conv with XLA's SAME/VALID padding semantics."""
    return conv_nhwc(x, w, stride=stride,
                     pads=_xla_pads(x, w.shape[0], stride, padding),
                     groups=groups)


def depthwise_conv(x, w_dw, *, stride=1, padding="SAME"):
    """Depthwise conv; ``w_dw`` is HWIO ``(hk, hk, C, 1)``."""
    cx = x.shape[-1]
    w = w_dw.permute(0, 1, 3, 2)             # (hk, hk, 1, C): one filter
    return conv_nhwc(x, w, stride=stride,    # per channel group
                     pads=_xla_pads(x, w.shape[0], stride, padding),
                     groups=cx)


def shift_bound(shifts, max_shift=None) -> int:
    """The zero-padding a shift table needs, max(1, max |shift|), read on
    the host; raises if it exceeds the declared ``max_shift``."""
    a = np.abs(np.asarray(shifts.cpu() if isinstance(shifts, torch.Tensor)
                          else shifts))
    pad = max(1, int(a.max()) if a.size else 1)
    if max_shift is not None and pad > max(1, int(max_shift)):
        raise ValueError(
            f"shift_channels: shift table contains |shift|={pad} exceeding "
            f"the declared max_shift={int(max_shift)}")
    return pad


def shift_channels(x, shifts, *, max_shift=None):
    """Per-channel spatial shift (Eq. 2): I[k,l,m] = X[k+a_m, l+b_m, m], zero
    outside the image; a gather on a padded copy, as the JAX package does.
    ``shifts`` is an integer (C, 2) table. With ``max_shift`` given the
    padding is ``max(1, max_shift)`` on every device, as the shift kernels'
    windows take it, and the table is checked against that bound: on the
    host by reading it (``ValueError``), on a card by a device-side assert,
    so the table is never read back and a captured CUDA graph can hold this
    gather. Without ``max_shift`` the bound is read from the table."""
    _, h, w, c = x.shape
    if max_shift is None:
        pad = shift_bound(shifts)
    else:
        pad = max(1, int(max_shift))
        if shifts.device.type == "cpu":
            shift_bound(shifts, max_shift)
        elif shifts.numel():
            torch._assert_async(shifts.abs().max() <= pad,
                                f"shift_channels: shift table exceeds the "
                                f"declared max_shift={int(max_shift)}")
    s = shifts.to(device=x.device, dtype=torch.long)
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    rows = torch.arange(h, device=x.device)[:, None, None] + pad + s[:, 0]
    cols = torch.arange(w, device=x.device)[None, :, None] + pad + s[:, 1]
    chan = torch.arange(c, device=x.device)[None, None, :]
    return xp[:, rows, cols, chan]


def add_conv(x, w, *, padding="SAME"):
    """AdderNet convolution (Eq. 3): Y = -sum_{i,j,c} |patch - W|, SAME
    padded (HK//2, (HK-1)//2) as the TPU kernel and the JAX oracle pad.

    Accumulated tap by tap, so no (B,H,W,Cx*HK^2,Cy) difference tensor is
    ever held. Integer operands give JAX's int32 result bit for bit: each
    difference wraps to int32 before its absolute value (|INT32_MIN| stays
    INT32_MIN, congruent to 2^31), and the sum and the negation are taken in
    int64 and cut back to 32 bits, which equals int32 wrap-around."""
    hk, _, _, cy = w.shape
    if padding == "SAME":
        pads = (hk // 2, (hk - 1) // 2)
    elif padding == "VALID":
        pads = (0, 0)
    else:
        raise ValueError(f"unknown padding {padding!r}; expected 'SAME' or "
                         "'VALID'")
    integer = not x.dtype.is_floating_point
    work = torch.int64 if integer else x.dtype
    xp = F.pad(x.to(work), (0, 0) + pads + pads)
    wk = w.to(work)
    n, hp, wp, _ = xp.shape
    hy, wy = hp - hk + 1, wp - hk + 1
    acc = torch.zeros((n, hy, wy, cy), dtype=work, device=x.device)
    for i in range(hk):
        for j in range(hk):
            d = xp[:, i:i + hy, j:j + wy, :, None] - wk[i, j]
            if integer:
                d = d.to(torch.int32).to(torch.int64)
            acc += d.abs().sum(dim=3)
    return (-acc).to(torch.int32) if integer else -acc


def _maybe_bias(y, params):
    b = params.get("b")
    return y if b is None else y + b.to(y.dtype)


def apply(params: dict, x: torch.Tensor, spec: ConvSpec) -> torch.Tensor:
    """Run one primitive layer forward (float path)."""
    p = spec.primitive
    if p == "standard":
        y = standard_conv(x, params["w"], stride=spec.stride,
                          padding=spec.padding)
    elif p == "grouped":
        y = standard_conv(x, params["w"], stride=spec.stride,
                          padding=spec.padding, groups=spec.groups)
    elif p == "dws":
        h = depthwise_conv(x, params["w_dw"], stride=spec.stride,
                           padding=spec.padding)
        y = standard_conv(h, params["w_pw"], stride=1, padding="SAME")
    elif p == "shift":
        h = shift_channels(x, params["shifts"],
                           max_shift=spec.kernel_size // 2)
        y = standard_conv(h, params["w_pw"], stride=spec.stride,
                          padding="SAME")
    elif p == "add":
        y = add_conv(x, params["w"], padding=spec.padding)
    else:
        raise ValueError(p)
    return _maybe_bias(y, params)


def batchnorm_apply(bn: dict, y: torch.Tensor, eps: float = 1e-5):
    inv = torch.rsqrt(bn["var"] + eps).to(y.dtype)
    return ((y - bn["mean"].to(y.dtype)) * inv * bn["gamma"].to(y.dtype)
            + bn["beta"].to(y.dtype))


def apply_block(params: dict, x: torch.Tensor, spec: ConvSpec, *,
                train_stats=None, act=torch.relu) -> torch.Tensor:
    """Conv + BatchNorm + activation (the paper couples every primitive
    with BN; add-conv needs it to recover positive activations, section
    2.2). With ``train_stats`` (a dict), BN normalises with the batch's
    statistics, the biased variance as ``jnp.var`` takes it, and writes
    them into ``train_stats["mean"]`` / ``["var"]``; the caller owns any
    running average. Differentiable by autograd through the float
    primitives; an integer leaf (a shift table) takes no gradient."""
    y = apply(params["conv"], x, spec)
    if "bn" in params:
        if train_stats is not None:
            mean = y.mean(dim=(0, 1, 2))
            var = y.var(dim=(0, 1, 2), correction=0)
            train_stats["mean"], train_stats["var"] = mean, var
            bn = dict(params["bn"], mean=mean, var=var)
        else:
            bn = params["bn"]
        y = batchnorm_apply(bn, y)
    return act(y) if act is not None else y
