"""GQA attention: full and flash attention over a sequence (``"full"``,
``"flash"`` and ``"flash_tri"``; differentiable, for training and
prefill) and one-token decode against a contiguous or a paged KV cache,
float or int8.

Port of ``repro/models/attention.py``. The sequence-parallel decode of a
mesh: each rank's flash statistics over its own positions of the cache
(:func:`decode_attention_partial`), combined across the ranks of the SP
axis (:func:`sp_combine`). Attention is
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

The paged KV cache keeps K/V in a pool of fixed-size pages, (NB, bs, Hkv,
D) per layer, and each decode slot an ordered block table of ``max_len //
bs`` page ids. Gathering the pool by table (:func:`gather_kv_blocks`)
rebuilds exactly the contiguous cache a slot would own at every position
below its length; table entries past the allocated span name the reserved
garbage page 0, whose positions are at or past the length and masked to
an exact-zero softmax weight. So the paged decode variants equal their
contiguous counterparts bitwise, provided ``bs`` divides ``max_len``.
"""
from __future__ import annotations

import torch

from repro_torch.parallel.sharding import pmax, psum

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


def _flash_fwd(q, k, v, causal: bool, bk: int, q_offset):
    """The online-softmax scan over KV blocks of ``bk``: ``(out (B,Sq,Hq,D)
    in q's dtype, o (B,Hkv,G,Sq,D) float32, m, l (B,Hkv,G,Sq) float32)``,
    m the running max and l the running sum of each row."""
    b, sq, hq, d = q.shape
    n_kv = k.shape[2]
    sk = k.shape[1]
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
    out = o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)
    return out, o, m, l


class _Flash(torch.autograd.Function):
    """Flash attention with the FlashAttention-style backward of the JAX
    package's custom VJP (``repro/models/attention.py`` ``_flash_vjp_bwd``,
    plain jnp there, plain PyTorch here): the forward keeps only q, k, v,
    the float32 output and each row's logsumexp; the backward re-scans
    the KV blocks, recomputes p from the logsumexp, accumulates dq in
    float32 and writes dk and dv block by block, so no (Sq, Sk) tensor is
    ever held."""

    @staticmethod
    def forward(ctx, q, k, v, causal, bk, q_offset):
        out, o, m, l = _flash_fwd(q, k, v, causal, bk, q_offset)
        lse = m + torch.log(torch.clamp(l, min=1e-30))     # (B,Hkv,G,Sq)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.bk, ctx.q_offset = causal, bk, q_offset
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        b, sq, hq, d = q.shape
        n_kv, bk = k.shape[2], ctx.bk
        scale = d ** -0.5
        qg = (_split_gqa(q, n_kv) * scale).to(torch.float32) \
            .permute(0, 2, 3, 1, 4)                        # (B,Hkv,G,Sq,D)
        dog = _split_gqa(do, n_kv).to(torch.float32).permute(0, 2, 3, 1, 4)
        delta = torch.sum(dog * o, dim=-1)                 # (B,Hkv,G,Sq)
        dq = torch.zeros_like(qg)
        dks, dvs = [], []
        for kk in range(k.shape[1] // bk):
            kc = k[:, kk * bk:(kk + 1) * bk].to(torch.float32)
            vc = v[:, kk * bk:(kk + 1) * bk].to(torch.float32)
            s = torch.einsum("bhgqd,bkhd->bhgqk", qg, kc)
            if ctx.causal:
                s = torch.where(_causal_mask(sq, bk, ctx.q_offset, q.device,
                                             k_offset=kk * bk), s, NEG_INF)
            p = torch.exp(s - lse[..., None])              # (B,Hkv,G,Sq,bk)
            dvs.append(torch.einsum("bhgqk,bhgqd->bkhd", p, dog).to(v.dtype))
            dp = torch.einsum("bhgqd,bkhd->bhgqk", dog, vc)
            ds = p * (dp - delta[..., None])
            dq = dq + torch.einsum("bhgqk,bkhd->bhgqd", ds, kc) * scale
            dks.append(torch.einsum("bhgqk,bhgqd->bkhd", ds, qg).to(k.dtype))
        dq = dq.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)
        return dq, torch.cat(dks, 1), torch.cat(dvs, 1), None, None, None


def flash_attention(q, k, v, *, causal: bool, block_k: int = 256,
                    q_offset=0):
    """Blockwise online-softmax attention over KV blocks of ``block_k``
    (the largest divisor of Sk not above it). Differentiable: where a
    gradient is wanted it runs as :class:`_Flash`; otherwise (serving) the
    same scan alone, which keeps no residuals and gives the same output
    bits."""
    sk = k.shape[1]
    bk = min(block_k, sk)
    while sk % bk:
        bk -= 1
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Flash.apply(q, k, v, causal, bk, q_offset)
    return _flash_fwd(q, k, v, causal, bk, q_offset)[0]


def flash_attention_tri(q, k, v, *, block_k: int = 256, n_chunks: int = 8):
    """Causal flash with a static triangle schedule: q splits into
    ``n_chunks`` chunks (the largest count up to it that divides Sq), and
    chunk i visits only the KV prefix [0, (i+1) * Sq / n_chunks), so the
    fully masked upper blocks of the plain schedule are never computed."""
    sq = q.shape[1]
    nc = n_chunks
    while sq % nc:
        nc -= 1
    cq = sq // nc
    outs = []
    for i in range(nc):
        kv_end = (i + 1) * cq
        outs.append(flash_attention(q[:, i * cq:kv_end], k[:, :kv_end],
                                    v[:, :kv_end], causal=True,
                                    block_k=min(block_k, kv_end),
                                    q_offset=i * cq))
    return torch.cat(outs, dim=1)


def prefix_chunk_attention(q, k, v, rows: int):
    """Causal self-attention (Sq == Sk, a multiple of ``rows``) in query
    chunks of ``rows``: chunk i attends its key prefix [0, (i + 1) * rows)
    in one :func:`full_attention`, so every tensor of chunk i has a shape
    set by i alone and a row gets the same bits whatever S is
    (``transformer.shared_prefill``)."""
    return torch.cat([full_attention(q[:, i:i + rows], k[:, :i + rows],
                                     v[:, :i + rows], causal=True,
                                     q_offset=i)
                      for i in range(0, q.shape[1], rows)], dim=1)


def attention(q, k, v, *, causal: bool, impl: str = "full", q_offset=0,
              block_k: int = 256):
    """``"flash_tri"`` takes the triangle schedule for causal
    self-attention (Sq == Sk) and the plain flash scan otherwise, as the
    JAX package does; any other ``impl`` than the flash ones is
    ``"full"``."""
    if impl == "flash_tri" and causal and q.shape[1] == k.shape[1]:
        return flash_attention_tri(q, k, v, block_k=block_k)
    if impl in ("flash", "flash_tri"):
        return flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                               block_k=block_k)
    return full_attention(q, k, v, causal=causal, q_offset=q_offset)


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


def decode_attention_partial(q, k_shard, v_shard, valid_mask):
    """Per-shard flash statistics for SP decode: ``(m, l, o)``, each row's
    max score and sum of exp(score - m) over this shard's valid positions
    (``valid_mask``, (S_loc,) bool) and its unnormalised output, all
    float32, (B, Hkv, G, 1[, D]). A shard with no valid position has m =
    ``NEG_INF``."""
    n_kv = k_shard.shape[2]
    d = q.shape[-1]
    qg = _split_gqa(q, n_kv) * (d ** -0.5)
    sc = _gqa_scores(qg, k_shard)                       # (B,Hkv,G,1,Sloc)
    sc = torch.where(valid_mask[None, None, None, None], sc, NEG_INF)
    m = sc.amax(dim=-1)
    p = torch.exp(sc - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p.to(q.dtype), v_shard.to(q.dtype))
    return m, l, o.to(torch.float32)


def sp_combine(m, l, o, axis_name: str):
    """Combine per-shard ``(m, l, o)`` across the ranks of ``axis_name``:
    the global max, each shard's sums rescaled by exp(m - m_glob) (0 for a
    shard with no valid position: exp(NEG_INF - m_glob)), summed, and the
    output normalised. The collectives carry O(heads * head_dim) a rank,
    not O(S)."""
    m_glob = pmax(m, axis_name)
    corr = torch.exp(m - m_glob)
    l_glob = psum(l * corr, axis_name)
    o_glob = psum(o * corr[..., None], axis_name)
    return o_glob / torch.clamp(l_glob, min=1e-30)[..., None]


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


# ----------------------------------------------------------- paged KV cache --

def gather_kv_blocks(pool, block_table):
    """pool: (NB, bs, ...); block_table: (B, nb) int -> (B, nb * bs, ...):
    row i is slot i's logical cache, page ``block_table[i, j]`` holding
    positions [j * bs, (j + 1) * bs)."""
    g = pool[block_table.long()]                   # (B, nb, bs, ...)
    return g.reshape((g.shape[0], g.shape[1] * g.shape[2]) + g.shape[3:])


def decode_attention_paged(q, k_pool, v_pool, block_table, cache_len):
    """:func:`decode_attention` over one layer's paged pools, (NB, bs, Hkv,
    D) each: the gathered view equals the contiguous cache below each
    row's length, and so does the output, bitwise."""
    k = gather_kv_blocks(k_pool, block_table)
    v = gather_kv_blocks(v_pool, block_table)
    return decode_attention(q, k, v, cache_len)


def decode_attention_paged_q8(q, k_pool, v_pool, k_scale_pool, v_scale_pool,
                              block_table, cache_len):
    """:func:`decode_attention_q8` over int8 paged pools: int8 (NB, bs, Hkv,
    D) codes and (NB, bs, Hkv) float32 scales, gathered by the block table,
    then dequantized on read."""
    k = gather_kv_blocks(k_pool, block_table)
    v = gather_kv_blocks(v_pool, block_table)
    ks = gather_kv_blocks(k_scale_pool, block_table)
    vs = gather_kv_blocks(v_scale_pool, block_table)
    return decode_attention_q8(q, k, v, ks, vs, cache_len)
