"""Public entry points of the port's kernel layer.

``method="cuda"`` mirrors the JAX package's ``"pallas"``: the hand-written
CUDA kernels. ``method="torch"`` mirrors ``"xla"``: the plain PyTorch
versions. The tensor's device decides what runs:

* a CPU tensor always runs the plain version;
* a CUDA tensor with ``"cuda"`` launches the kernel or raises;
* a CUDA tensor with ``"torch"`` runs the plain version (tests and
  ``chip_smoke.py`` compare the two this way).

There is no fallback from a kernel to its plain version: a kernel that
fails to build or launch raises. Only the int8 modes are ported; the
float modes run their plain version on the host and raise on a card under
``"cuda"`` (ROADMAP.md, queue B).

Every call counts into the process metrics registry as
``kernels.dispatch.<kernel>.<method>``.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.obs import metrics as _obs_metrics

from . import ref
from .conv_dw import depthwise2d_q8
from .conv_im2col import conv2d_q8
from .pool import maxpool2d_s8

METHODS = ("cuda", "torch")


def _check_method(method: str):
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; expected one of "
                         f"{METHODS}")


def _count_dispatch(kernel: str, method: str):
    _obs_metrics.counter(f"kernels.dispatch.{kernel}.{method}").inc()


def _float_mode(kernel: str, x, method: str):
    if method == "cuda" and x.device.type != "cpu":
        raise NotImplementedError(
            f"{kernel}: the float mode of the CUDA kernel is not ported yet "
            "(ROADMAP.md, queue B); pass int8 codes with requant_shift, or "
            "method='torch'")


def conv2d(x, w, bias=None, *, groups: int = 1, method: str = "cuda",
           requant_shift: Optional[int] = None, act: Optional[str] = None):
    """SAME stride-1 standard / grouped conv, NHWC x HWIO."""
    _check_method(method)
    _count_dispatch("conv2d", method)
    if requant_shift is None:
        _float_mode("conv2d", x, method)
        return ref.conv2d_ref(x, w, bias, groups=groups, act=act)
    if method == "torch":
        return ref.conv2d_q8_ref(x, w, bias, groups=groups,
                                 requant_shift=requant_shift, act=act)
    return conv2d_q8(x, w, bias, groups=groups, requant_shift=requant_shift,
                     act=act)


def depthwise2d(x, w_dw, *, method: str = "cuda",
                requant_shift: Optional[int] = None,
                act: Optional[str] = None):
    """SAME stride-1 depthwise conv; ``w_dw`` is (HK,HK,C) or (HK,HK,C,1)."""
    _check_method(method)
    _count_dispatch("depthwise2d", method)
    if requant_shift is None:
        _float_mode("depthwise2d", x, method)
        return ref.depthwise2d_ref(x, w_dw, act=act)
    if method == "torch":
        return ref.depthwise2d_q8_ref(x, w_dw, requant_shift=requant_shift,
                                      act=act)
    return depthwise2d_q8(x, w_dw, requant_shift=requant_shift, act=act)


def maxpool2d(x, *, window: int = 2, stride: Optional[int] = None,
              method: str = "cuda"):
    """VALID max-pool, int8 (the kernel) or float (plain version only)."""
    _check_method(method)
    _count_dispatch("maxpool2d", method)
    if x.dtype.is_floating_point:
        _float_mode("maxpool2d", x, method)
        return ref.maxpool2d_ref(x, window=window, stride=stride)
    if method == "torch":
        return ref.maxpool2d_ref(x, window=window, stride=stride)
    return maxpool2d_s8(x, window=window, stride=stride)
