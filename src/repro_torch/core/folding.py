"""Batch-normalization folding (Jacob et al. 2018; paper section 3.2).

Port of ``repro/core/folding.py``. Folds an inference-time BN layer into the
preceding convolution's weights and bias so the fused layer computes
``BN(conv(x))`` exactly::

    W' = W * gamma / sqrt(var + eps)        (per output channel)
    b' = beta + (b - mean) * gamma / sqrt(var + eps)

Add-convolution cannot fold (|W - x| is not linear in W).
"""
from __future__ import annotations

import torch

from .primitives import ConvSpec

FOLDABLE = ("standard", "grouped", "dws", "shift")


def fold(conv_params: dict, bn: dict, spec: ConvSpec, eps: float = 1e-5) -> dict:
    if spec.primitive not in FOLDABLE:
        raise ValueError(f"BN folding not applicable to {spec.primitive!r} "
                         "(add-conv keeps explicit BN)")
    inv = bn["gamma"] * (bn["var"] + eps) ** -0.5          # (Cy,)
    out = dict(conv_params)
    wkey = "w_pw" if spec.primitive in ("dws", "shift") else "w"
    w = conv_params[wkey]
    out[wkey] = (w * inv.to(w.dtype)).to(w.dtype)          # last dim = Cy
    b = conv_params.get("b")
    if b is None:
        b = torch.zeros(w.shape[-1], dtype=w.dtype, device=w.device)
    out["b"] = (bn["beta"] + (b - bn["mean"]) * inv).to(w.dtype)
    return out
