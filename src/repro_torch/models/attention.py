"""GQA attention for serving: prefill (``"full"`` and ``"flash"``) and
one-token decode against a contiguous KV cache, float or int8.

Port of the inference half of ``repro/models/attention.py``. Attention is
not a TPU kernel in the JAX package, so it is plain PyTorch here. Layouts
are the JAX package's: q (B,Sq,Hq,D), k and v (B,Sk,Hkv,D); the ``Hq``
query heads split into ``Hkv`` groups of ``G = Hq / Hkv``. Scores and the
softmax run in float32; the probabilities are cast to q's dtype before the
product with v, as the JAX package does.

The int8 KV cache stores each position's K or V as int8 codes plus one
float32 scale per (position, kv-head), a 127-max symmetric quantizer over
the head_dim vector (:func:`quantize_kv`); per-token scales mean a slot
refill or retirement never re-scales a neighbouring position. Decode
dequantizes on read (:func:`decode_attention_q8`), so the attention
arithmetic is the float path's on the same codes.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _gqa_scores(q, k):
    """q: (B,Sq,Hkv,G,D); k: (B,Sk,Hkv,D) -> (B,Hkv,G,Sq,Sk) f32."""
    return torch.einsum("bqhgd,bkhd->bhgqk", q.to(torch.float32),
                        k.to(torch.float32))


def _split_gqa(q, n_kv):
    b, s, hq, d = q.shape
    return q.reshape(b, s, n_kv, hq // n_kv, d)


def full_attention(q, k, v, *, causal: bool, q_offset=0):
    """Einsum attention. q:(B,Sq,Hq,D), k/v:(B,Sk,Hkv,D) -> (B,Sq,Hq,D)."""
    b, sq, hq, d = q.shape
    qg = _split_gqa(q, k.shape[2]) * (d ** -0.5)
    s = _gqa_scores(qg, k)
    if causal:
        s = torch.where(_causal_mask(sq, k.shape[1], q_offset, q.device),
                        s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(q.dtype))
    return o.reshape(b, sq, hq, d)


def _causal_mask(sq, sk, q_offset, device, k_offset=0):
    qpos = q_offset + torch.arange(sq, device=device)
    kpos = k_offset + torch.arange(sk, device=device)
    return qpos[:, None] >= kpos[None, :]


def flash_attention(q, k, v, *, causal: bool, block_k: int = 256,
                    q_offset=0):
    """Blockwise online-softmax attention over KV blocks of ``block_k``
    (the largest divisor of Sk not above it), forward only."""
    b, sq, hq, d = q.shape
    n_kv = k.shape[2]
    sk = k.shape[1]
    bk = min(block_k, sk)
    while sk % bk:
        bk -= 1
    qg = _split_gqa(q, n_kv) * (d ** -0.5)
    g = hq // n_kv
    m = torch.full((b, n_kv, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, n_kv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, n_kv, g, sq, d), dtype=torch.float32,
                      device=q.device)
    for kk in range(sk // bk):
        kc = k[:, kk * bk:(kk + 1) * bk]
        vc = v[:, kk * bk:(kk + 1) * bk]
        s = _gqa_scores(qg, kc)                       # (B,Hkv,G,Sq,bk) f32
        if causal:
            s = torch.where(_causal_mask(sq, bk, q_offset, q.device,
                                         k_offset=kk * bk), s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(kc.dtype), vc).to(torch.float32)
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)


def attention(q, k, v, *, causal: bool, impl: str = "full", q_offset=0,
              block_k: int = 256):
    if impl == "flash":
        return flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                               block_k=block_k)
    if impl == "full":
        return full_attention(q, k, v, causal=causal, q_offset=q_offset)
    raise NotImplementedError(
        f"attention impl {impl!r} is not ported; the port has 'full' and "
        "'flash' (ROADMAP.md, queue A)")


def decode_attention(q, k_cache, v_cache, cache_len):
    """One-token attention over a (possibly longer-than-filled) cache.

    q: (B,1,Hq,D); caches: (B,S,Hkv,D); cache_len: a (B,) int tensor of
    per-slot lengths — row i masks positions >= cache_len[i], so stale K/V
    in retired or padded slots never scores. A slot of length 0 attends to
    nothing (a uniform softmax over NEG_INF scores); its output is garbage
    confined to its own row.
    """
    b, _, hq, d = q.shape
    s = k_cache.shape[1]
    qg = _split_gqa(q, k_cache.shape[2]) * (d ** -0.5)
    sc = _gqa_scores(qg, k_cache)                       # (B,Hkv,G,1,S)
    mask = torch.arange(s, device=q.device)[None, :] < cache_len[:, None]
    sc = torch.where(mask[:, None, None, None, :], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1).to(q.dtype)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v_cache.to(q.dtype))
    return o.reshape(b, 1, hq, d)


def quantize_kv(x):
    """x: (..., H, D) -> (int8 codes, float32 scales (..., H)): scale =
    amax / 127 over the head_dim vector (1.0 for an all-zero vector, whose
    codes stay zero), codes rounded half to even, as ``jnp.round``."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q, scale, dtype):
    """Inverse of :func:`quantize_kv` (up to the rounding step)."""
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


def decode_attention_q8(q, k_cache, v_cache, k_scale, v_scale, cache_len):
    """:func:`decode_attention` over an int8 KV cache: int8 (B,S,Hkv,D)
    codes and (B,S,Hkv) float32 scales, dequantized on read to q's
    dtype."""
    k = dequantize_kv(k_cache, k_scale, q.dtype)
    v = dequantize_kv(v_cache, v_scale, q.dtype)
    return decode_attention(q, k, v, cache_len)
