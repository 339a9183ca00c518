"""Shared LM blocks: RMSNorm, the float and the integer FFN, RoPE.

Port of the parts of ``repro/models/blocks.py`` that the dense serve path
runs. The integer FFN (:func:`qmlp`) is the paper's Eq. 4 / Algorithm 1
applied to the LM's feed-forward matmuls, the largest weight volume of a
decode step: weights are PTQ'd once (:func:`quantize_mlp_params`, at engine
init), activations are quantized on the fly at a fixed power-of-two scale,
so every requantization is a static shift fused into the ``matmul_q8``
kernel's epilogue, and the nonlinearity runs in float between the integer
matmuls (W8A8, or W4A8 with nibble-packed weights).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.quantize import QTensorW4, quantize, quantize_w4
from repro_torch.kernels import ops as K

ACT_FRAC_BITS = 4      # activation scale 2^-4: post-rmsnorm streams are O(1)


def rmsnorm(x, w, eps=1e-5):
    dt = x.dtype
    x32 = x.to(torch.float32)
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (y * w.to(torch.float32)).to(dt)


def _act(x, act: str):
    if act == "silu":
        return F.silu(x)
    return F.gelu(x, approximate="tanh")       # jax.nn.gelu's default


def mlp(h, p, act: str, cdt):
    """SwiGLU (3 mats) or GELU (2 mats) feed-forward."""
    h = h.to(cdt)
    if act == "silu":
        g = h @ p["w_gate"].to(cdt)
        u = h @ p["w_up"].to(cdt)
        z = F.silu(g) * u
    else:
        z = _act(h @ p["w_up"].to(cdt), act)
    return z @ p["w_down"].to(cdt)


def quantize_mlp_params(p, *, bits: int = 8, group_size: int = 32):
    """PTQ of one (possibly layer-stacked) MLP parameter tree.

    ``bits=8``: a QTensor per weight; a stacked (L, d, ff) tensor shares
    one scale across its layers. ``bits=4``: a nibble-packed QTensorW4 per
    weight, with per-layer group scales along the contraction (K) axis but
    ONE base ``frac_bits`` across the stack (the min of the per-layer
    defaults, the clip-safe choice), so layer ``l``'s slice ``(q[l],
    shifts[l])`` is exactly the 2-D packed operand ``matmul_w4`` takes. The
    same rules, bit for bit, as the JAX package's."""
    if bits not in (8, 4):
        raise ValueError(f"quantize_mlp_params: bits must be 8 or 4, "
                         f"got {bits}")
    if bits == 8:
        return {k: quantize(v) for k, v in p.items()}
    out = {}
    for k, v in p.items():
        if v.dim() == 2:                      # single layer: (d_in, d_out)
            out[k] = quantize_w4(v, axis=0, group_size=group_size)
            continue
        layers = [quantize_w4(v[l], axis=0, group_size=group_size)
                  for l in range(v.shape[0])]
        fb = min(t.frac_bits for t in layers)
        if any(t.frac_bits != fb for t in layers):
            layers = [quantize_w4(v[l], axis=0, group_size=group_size,
                                  frac_bits=fb)
                      for l in range(v.shape[0])]
        out[k] = QTensorW4(torch.stack([t.q for t in layers]),
                           torch.stack([t.shifts for t in layers]),
                           frac_bits=fb, size=v.shape[1], axis=0)
    return out


def qmlp(h, qp, act: str, cdt, *, a_fb: int = ACT_FRAC_BITS,
         method: str = "cuda"):
    """Integer FFN: every matmul runs int8 x int8 -> int32 -> shift -> int8
    through the kernel layer (``matmul_q8`` / ``matmul_w4`` under
    ``method="cuda"``, their plain versions under ``"torch"``; the two are
    bitwise equal). ``qp`` holds one layer's QTensor or QTensorW4 leaves."""
    b, s, d = h.shape
    x = quantize(h.reshape(b * s, d), frac_bits=a_fb)

    def mm(xq, w):
        # acc frac bits = a_fb + w.fb; requantize back to the activation
        # scale => shift by w.fb (static per tensor)
        if isinstance(w, QTensorW4):
            return K.matmul(xq.q, w.q, method=method,
                            requant_shift=w.frac_bits, w_shifts=w.shifts)
        return K.matmul(xq.q, w.q, method=method, requant_shift=w.frac_bits)

    scale = 2.0 ** -a_fb
    if act == "silu":
        g = mm(x, qp["w_gate"]).to(torch.float32) * scale
        u = mm(x, qp["w_up"]).to(torch.float32) * scale
        z = F.silu(g) * u
    else:
        z = _act(mm(x, qp["w_up"]).to(torch.float32) * scale, act)
    zq = quantize(z, frac_bits=a_fb)
    y = mm(zq, qp["w_down"]).to(torch.float32) * scale
    return y.reshape(b, s, -1).to(cdt)


def init_mlp(generator, d, ff, act, dtype):
    """Random FFN weights drawn from ``generator`` on its device."""
    def normal(shape, std):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=generator.device) * std
    s_in, s_out = d ** -0.5, ff ** -0.5
    p = {"w_up": normal((d, ff), s_in), "w_down": normal((ff, d), s_out)}
    if act == "silu":
        p["w_gate"] = normal((d, ff), s_in)
    return p


def rope(x, positions, theta: float):
    """x: (..., S, H, Dh); positions: (..., S). Rotates pairs (d, d+Dh/2)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freq      # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)
