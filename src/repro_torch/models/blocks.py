"""Shared LM blocks: RMSNorm, the float and the integer FFN, RoPE, and the
training loss (:func:`cross_entropy`, :func:`chunked_softmax_ce`).

Port of ``repro/models/blocks.py``. The integer
FFN (:func:`qmlp`) is the paper's Eq. 4 / Algorithm 1 applied to the LM's
feed-forward matmuls, the largest weight volume of a decode step: weights
are PTQ'd once (:func:`quantize_mlp_params`, at engine init), activations
are quantized on the fly at a fixed power-of-two scale, so every
requantization is a static shift fused into the ``matmul_q8`` kernel's
epilogue, and the nonlinearity runs in float between the integer matmuls
(W8A8, or W4A8 with nibble-packed weights).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.quantize import QTensorW4, quantize, quantize_w4
from repro_torch.kernels import ops as K
from repro_torch.parallel.sharding import (axis_index, constrain, pmax,
                                           psum, split_axes)

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


def row_mm(x, w, rows=None):
    """``x (..., k) @ w (k, n)``. With ``rows``, on a card, the rows of x
    go through it in blocks of ``rows`` (the last one zero-padded), each
    block its own GEMM of one shape: cuBLAS picks a GEMM's kernel, and so
    the order of its sums, by the row count, so a row then gets the same
    bits whatever the call's row count. On the host (whose GEMM rows do
    not depend on the row count) and without ``rows``: ``x @ w``."""
    if rows is None or not x.is_cuda:
        return x @ w
    k = x.shape[-1]
    x2 = x.reshape(-1, k)
    m = x2.shape[0]
    x2 = F.pad(x2, (0, 0, 0, -m % rows))
    out = x2.new_empty((x2.shape[0], w.shape[1]))
    for i in range(0, x2.shape[0], rows):
        torch.mm(x2[i:i + rows], w, out=out[i:i + rows])
    return out[:m].reshape(x.shape[:-1] + (w.shape[1],))


def mlp(h, p, act: str, cdt, rows=None):
    """SwiGLU (3 mats) or GELU (2 mats) feed-forward; each matmul
    :func:`row_mm` in blocks of ``rows`` rows. Where the active rules
    split ``ffn``, ``p`` holds this rank's columns of ``w_gate`` /
    ``w_up`` and rows of ``w_down``, and the partial products are summed
    over the ranks (:func:`~repro_torch.parallel.sharding.psum`)."""
    h = h.to(cdt)
    if act == "silu":
        g = row_mm(h, p["w_gate"].to(cdt), rows)
        u = row_mm(h, p["w_up"].to(cdt), rows)
        z = F.silu(g) * u
    else:
        z = _act(row_mm(h, p["w_up"].to(cdt), rows), act)
    z = constrain(z, "batch", "seq", "ffn")
    y = row_mm(z, p["w_down"].to(cdt), rows)
    ax = split_axes("ffn")
    return psum(y, ax) if ax else y


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


def stacked_normal(generator, shapes: dict, dtype, n_layers: int = 0, *,
                   device=None):
    """``{name: normal(shape) * std}`` for ``shapes = {name: (shape,
    std)}``, drawn from ``generator`` on its device (or on ``device``: a
    ``"meta"`` device gives the shapes and allocates nothing) in the order
    of ``shapes``. With ``n_layers`` every leaf gets a leading layer axis;
    each stacked leaf is allocated once and filled layer by layer (the
    draws of one layer after another, as ``n_layers`` single-layer calls
    make them), so a stack is never held twice."""
    lead = (n_layers,) if n_layers else ()
    dev = generator.device if device is None else device
    out = {k: torch.empty(lead + shape, dtype=dtype, device=dev)
           for k, (shape, _) in shapes.items()}
    for layer in range(max(n_layers, 1)):
        for k, (shape, std) in shapes.items():
            dst = out[k][layer] if n_layers else out[k]
            torch.randn(shape, generator=generator, dtype=dtype, device=dev,
                        out=dst)
            dst.mul_(std)
    return out


def init_mlp(generator, d, ff, act, dtype, *, n_layers: int = 0,
             device=None):
    """Random FFN weights drawn from ``generator`` on its device (stacked
    over ``n_layers``: :func:`stacked_normal`)."""
    s_in, s_out = d ** -0.5, ff ** -0.5
    shapes = {"w_up": ((d, ff), s_in), "w_down": ((ff, d), s_out)}
    if act == "silu":
        shapes["w_gate"] = ((d, ff), s_in)
    return stacked_normal(generator, shapes, dtype, n_layers, device=device)


def mlp_specs(act, prefix_layers=True):
    """The FFN leaves' logical axis names (JAX's ``blocks.mlp_specs``)."""
    L = ("layers",) if prefix_layers else ()
    p = {"w_up": L + ("embed", "ffn"), "w_down": L + ("ffn", "embed")}
    if act == "silu":
        p["w_gate"] = L + ("embed", "ffn")
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


def _lse_ll(logits, labels):
    """(logsumexp, the label's logit) of float32 ``logits`` over the last
    dim, ``labels`` >= 0. Where the active rules split ``vocab``, ``logits``
    are this rank's block of the vocabulary: the max is the ranks' ``pmax``
    (no gradient, as logsumexp's shift has none), the sum of exponentials
    their ``psum``, and the label's logit comes from the rank whose block
    holds it, ``psum`` ed."""
    ax = split_axes("vocab")
    if not ax:
        return (torch.logsumexp(logits, dim=-1),
                torch.gather(logits, -1, labels[..., None])[..., 0])
    vl = logits.shape[-1]
    m = pmax(torch.amax(logits.detach(), dim=-1), ax)
    lse = m + torch.log(psum(torch.sum(torch.exp(logits - m[..., None]),
                                       dim=-1), ax))
    loc = labels - axis_index(ax) * vl
    mine = (loc >= 0) & (loc < vl)
    ll = torch.gather(logits, -1, loc.clamp(0, vl - 1)[..., None])[..., 0]
    return lse, psum(torch.where(mine, ll, torch.zeros_like(ll)), ax)


def _batch_sums(*sums):
    """``sums`` summed over the ranks of the batch axes the active rules
    split (one collective), or as they are."""
    ax = split_axes("batch")
    if not ax:
        return sums
    return tuple(psum(torch.stack(sums), ax).unbind(0))


def cross_entropy(logits, labels, mask=None):
    """Mean token cross-entropy in float32; labels < 0 are ignored (or
    ``mask`` picks the counted tokens). In a sharded step ``logits`` may
    be this rank's block of the vocabulary (:func:`_lse_ll`), and the mean
    is over every rank's tokens."""
    logits = logits.to(torch.float32)
    valid = (labels >= 0) if mask is None else mask
    lab = torch.clamp(labels, min=0).long()
    lse, ll = _lse_ll(logits, lab)
    nll = (lse - ll) * valid
    if not split_axes("batch"):
        return torch.sum(nll) / torch.clamp(torch.sum(valid), min=1)
    total, count = _batch_sums(torch.sum(nll),
                               torch.sum(valid).to(torch.float32))
    return total / torch.clamp(count, min=1)


def _ce_chunk(h_c, w, y_c):
    """One chunk's (nll sum, squared-lse sum) over its valid labels, the
    (B, chunk, V) float32 logits made and dropped inside (this rank's
    block of V where the rules split ``vocab``)."""
    logits = constrain(h_c.to(torch.float32) @ w.to(torch.float32),
                       "batch", None, "vocab")
    valid = y_c >= 0
    lab = torch.clamp(y_c, min=0).long()
    lse, ll = _lse_ll(logits, lab)
    return torch.sum((lse - ll) * valid), torch.sum(torch.square(lse) * valid)


def chunked_softmax_ce(h, w_unembed, labels, *, chunk: int = 512,
                       z_loss: float = 1e-4):
    """Cross-entropy over a large vocabulary without (B, S, V) logits.

    The sequence is cut into chunks of ``min(chunk, S)`` (the tail padded
    with labels -1); each chunk's logits are computed, reduced to its nll
    and z sums and dropped, under a non-reentrant checkpoint, so the
    backward recomputes them chunk by chunk: the peak holds one chunk's
    (B, chunk, V) float32 logits, as JAX's ``@jax.checkpoint`` scan body
    does. Returns mean nll + ``z_loss`` * mean lse^2 over the valid
    labels. In a sharded step ``w_unembed`` holds this rank's columns of
    the vocabulary where the rules split it, and the sums and the count of
    valid labels are summed over the batch axes' ranks (ranks may count
    different tokens), so every rank returns the global mean."""
    b, s, _ = h.shape
    c = min(chunk, s)
    pad = (-s) % c
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    l_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    z_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, s + pad, c):
        y_c = labels[:, i:i + c]
        nll, zs = checkpoint(_ce_chunk, h[:, i:i + c], w_unembed, y_c,
                             use_reentrant=False)
        l_sum = l_sum + nll
        z_sum = z_sum + zs
    if split_axes("batch"):
        l_sum, z_sum, count = _batch_sums(
            l_sum, z_sum, torch.sum(labels >= 0).to(torch.float32))
        denom = torch.clamp(count, min=1)
    else:
        denom = torch.clamp(torch.sum(labels >= 0), min=1).to(torch.float32)
    return l_sum / denom + z_loss * z_sum / denom
