"""State carried into the port as plain numpy data.

Every function takes numpy arrays and Python scalars only, so the port
never touches an object of another framework: a caller converts the
other side's state leaf by leaf (``np.asarray``) first.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.primitives import ConvSpec, shift_bound
from repro_torch.core.quantize import W4_MAX_GROUP_SHIFT, QTensor, QTensorW4
from repro_torch.device import resolve_device
from repro_torch.graph.lower import Plan, PlanNode

#: ConvSpec fields a plain-data node may carry
SPEC_FIELDS = ("primitive", "in_channels", "out_channels", "kernel_size",
               "groups", "stride", "padding", "use_bias")


def _tensor(a, dev) -> torch.Tensor:
    return torch.tensor(np.asarray(a), device=dev)


def params_from_numpy(tree, device="cuda"):
    """A CNN parameter tree of numpy arrays (``{"blocks": [{"conv": {w |
    w_dw | w_pw | b}, "bn": {gamma, beta, mean, var}}, ...], "head": ...}``)
    -> the same tree of tensors on ``device``, dtypes kept."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [conv(v) for v in t]
        return _tensor(t, dev)
    return conv(tree)


def _w4_leaf(v: dict, dev) -> QTensorW4:
    """A W4 leaf's plain data -> QTensorW4 on ``dev``, checked on the host
    once: int8 bytes of extent ceil(size/2) along ``axis``, and ``size``
    int8 group shifts in [0, W4_MAX_GROUP_SHIFT] (the kernels read them
    from the device and never check them per call). A layer-stacked leaf
    carries one more leading axis on both arrays; ``axis`` and ``size``
    then describe one layer's slice."""
    q, shifts = np.asarray(v["q"]), np.asarray(v["shifts"])
    size, axis = int(v["size"]), int(v["axis"])
    lead = shifts.ndim - 1                   # 1 for a layer-stacked leaf
    if q.dtype != np.int8 or shifts.dtype != np.int8:
        raise TypeError(f"W4 bytes and shifts must be int8, got {q.dtype} "
                        f"and {shifts.dtype}")
    if lead not in (0, 1) or q.shape[lead + axis] != (size + 1) // 2 \
            or shifts.shape[lead:] != (size,) \
            or q.shape[:lead] != shifts.shape[:lead]:
        raise ValueError(f"W4 leaf: bytes {q.shape} and shifts "
                         f"{shifts.shape} do not fit size {size} along "
                         f"axis {axis}")
    if size and not 0 <= shifts.min() <= shifts.max() <= W4_MAX_GROUP_SHIFT:
        raise ValueError(f"W4 leaf: group shifts must lie in [0, "
                         f"{W4_MAX_GROUP_SHIFT}]")
    return QTensorW4(_tensor(q, dev), _tensor(shifts, dev),
                     int(v["frac_bits"]), size, axis)


def _qparam(v, dev):
    if isinstance(v, dict):                  # a packed W4 weight
        return _w4_leaf(v, dev)
    if isinstance(v, tuple):                 # (int8 codes, frac_bits)
        q, fb = v
        q = np.asarray(q)
        if q.dtype != np.int8:
            raise TypeError(f"quantized codes must be int8, got {q.dtype}")
        return QTensor(_tensor(q, dev), int(fb))
    if isinstance(v, np.ndarray) and v.ndim:
        # the dense head (float), a shift table or a qbn node's a/b (int32)
        return _tensor(v, dev)
    return int(v)              # a scale: mid_frac_bits, a_frac_bits


def plan_from_numpy(nodes, in_fb: int, device="cuda") -> Plan:
    """Build a :class:`~repro_torch.graph.lower.Plan` from plain dicts.

    Each node dict holds ``name``, ``op``, ``spec`` (a dict of ConvSpec
    fields, or None), ``qparams`` (values: ``(int8 ndarray, frac_bits)``
    pairs for int8 tensors, ``{"q", "shifts", "frac_bits", "size",
    "axis"}`` dicts for nibble-packed W4 weights, float or int32 ndarrays,
    or ints; a 0-d array counts as an int), ``in_fb``, ``out_fb``, ``act``
    and ``attrs``.
    A shift node's table is checked against its ``kernel_size // 2`` here,
    once, so the kernel never reads it back."""
    dev = resolve_device(device)
    out = []
    for nd in nodes:
        spec = nd.get("spec")
        if spec is not None:
            spec = ConvSpec(**{k: spec[k] for k in SPEC_FIELDS if k in spec})
        qp = nd.get("qparams")
        if spec is not None and spec.primitive == "shift":
            shift_bound(qp["shifts"], spec.kernel_size // 2)
        if qp is not None:
            qp = {k: _qparam(v, dev) for k, v in qp.items()}
        out.append(PlanNode(
            name=nd["name"], op=nd["op"], spec=spec, qparams=qp,
            in_fb=nd.get("in_fb"), out_fb=nd.get("out_fb"),
            act=nd.get("act"), attrs=dict(nd.get("attrs") or {})))
    return Plan(tuple(out), int(in_fb))


#: the keys of a W4 leaf's plain data
W4_KEYS = frozenset({"q", "shifts", "frac_bits", "size", "axis"})


def lm_params_from_numpy(tree, device="cuda"):
    """An LM parameter tree of numpy arrays (the JAX package's
    ``init_params`` layout, layer-stacked: a dense model's ``{"ln1", "ln2",
    "attn", "mlp"}`` layers or an ssm model's ``{"ln", "mamba"}``) -> the
    same tree of tensors on ``device``, dtypes kept. A quantized FFN tree
    may ride along under ``tree["layers"]["qmlp"]``: an int8 weight as an
    ``(int8 codes, frac_bits)`` pair, a W4 weight as a ``{"q", "shifts",
    "frac_bits", "size", "axis"}`` dict (stacked or not), checked as
    :func:`plan_from_numpy` checks them."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict) and W4_KEYS <= set(t):
            return _w4_leaf(t, dev)
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, tuple):
            return _qparam(t, dev)
        return _tensor(t, dev)
    return conv(tree)
