"""The paper's convolution primitives as PyTorch functions on NHWC tensors.

Port of ``repro/core/primitives.py`` for the primitives this package runs:

  * standard   : dense 2-D convolution (Eq. 1)
  * grouped    : G filter groups (Ioannou et al.)
  * dws        : depthwise-separable = depthwise + pointwise (Szegedy et al.)

``shift`` and ``add`` keep their :class:`ConvSpec` rows (parameter and MAC
counts) but their layers raise ``NotImplementedError`` until their kernels
are ported (ROADMAP.md, queue B). Activations are NHWC and weights HWIO,
as in the JAX package, so tensors compare with no transposes.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

Primitives = ("standard", "grouped", "dws", "shift", "add")


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md, 'Next, in "
        "order')")


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
    else:
        raise _not_ported(f"init of the {spec.primitive!r} primitive")
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


def shift_channels(x, shifts, *, max_shift=None):
    raise _not_ported("shift_channels")


def add_conv(x, w, *, padding="SAME"):
    raise _not_ported("add_conv")


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
    elif p in ("shift", "add"):
        raise _not_ported(f"the float {p!r} primitive")
    else:
        raise ValueError(p)
    return _maybe_bias(y, params)


def batchnorm_apply(bn: dict, y: torch.Tensor, eps: float = 1e-5):
    inv = torch.rsqrt(bn["var"] + eps).to(y.dtype)
    return ((y - bn["mean"].to(y.dtype)) * inv * bn["gamma"].to(y.dtype)
            + bn["beta"].to(y.dtype))
