"""Model API of the serve path: init, prefill (whole prompts, or a suffix
against cached prefix K/V), decode and the KV cache helpers of continuous
batching, contiguous and paged.

Port of the dense, vlm, moe and ssm part of ``repro/models/api.py``
(vlm and moe keep the dense family's caches). The continuous-batching
engine keeps ONE live batched decode cache with per-slot lengths and
splices freshly prefilled requests into free slots between decode rounds;
these helpers own the cache layout (:func:`slot_batch_axes`): (L, B, S,
Hkv, D) K and V for the attention families (in the cache dtype, or int8
codes with (L, B, S, Hkv) float32 ``k_scale`` / ``v_scale``), (L, B, K-1,
d_inner) conv and (L, B, d_inner, d_state) ssm state for the ssm family,
plus a (B,) ``"len"`` vector. The paged layout (:func:`init_paged_cache`,
attention families only)
keeps K/V in pools of fixed-size pages instead, (L, NB, bs, Hkv, D) each
(int8 codes with (L, NB, bs, Hkv) scale pools beside them), plus a (B,
max_len // bs) int32 ``"block_table"`` shared by every layer and the (B,)
``"len"``; page 0 is the reserved garbage page that a retired slot's
zeroed table row writes into. The engine owns the pages (its
``BlockPool``) and the table on the host. Unlike the JAX helpers, which
return new arrays, the slot and page writes here update the live cache in
place and return a dict holding the same tensors, so a captured decode
step that reads the cache by address stays valid across them.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device

from . import attention as A
from . import transformer as T


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device="cuda"):
    """Random parameters drawn from ``generator`` (on its own device), on
    ``device``."""
    dev = resolve_device(device)
    params = T.init_lm(cfg, generator)

    def to(tree):
        if isinstance(tree, dict):
            return {k: to(v) for k, v in tree.items()}
        return tree.to(dev)
    return to(params)


def prefill_fn(cfg: ModelConfig, max_len: int, *, attn_impl="flash",
               precision: str = "float", attn_block_k: int = 256):
    """``fn(params, batch)``: :func:`~repro_torch.models.transformer.
    prefill` of ``batch["tokens"]``, with a vlm model's ``batch["embeds"]``
    ahead of them and ``batch["prompt_lens"]`` where given."""
    T.check_family(cfg, "prefill_fn")
    T.check_precision(precision)
    T.check_ssm_precision(cfg, precision, "prefill")

    def fn(params, batch):
        return T.prefill(params, batch["tokens"], cfg, max_len,
                         embeds=batch.get("embeds"), attn_impl=attn_impl,
                         prompt_lens=batch.get("prompt_lens"),
                         precision=precision, attn_block_k=attn_block_k)
    return fn


def prefill_suffix_fn(cfg: ModelConfig, *, attn_impl="flash",
                      attn_block_k: int = 256, precision: str = "float"):
    """JAX's prefix-cache hit path: only the suffix of a prompt runs, against
    gathered prefix K/V (:func:`~repro_torch.models.transformer.
    prefill_suffix`). The prefix length is ``batch["prefix_k"].shape[2]``.
    Attention layer stacks only."""
    if cfg.family in T.NOT_DENSE_KV:
        raise NotImplementedError(
            "prefill_suffix covers attention-family dense layer stacks only")
    T.check_family(cfg, "prefill_suffix_fn")
    T.check_precision(precision)

    def fn(params, batch):
        pk = batch["prefix_k"]
        return T.prefill_suffix(params, batch["tokens"], pk,
                                batch["prefix_v"], pk.shape[2], cfg,
                                suffix_lens=batch["suffix_lens"],
                                attn_impl=attn_impl,
                                attn_block_k=attn_block_k,
                                precision=precision)
    return fn


def decode_fn(cfg: ModelConfig, *, precision: str = "float"):
    T.check_family(cfg, "decode_fn")
    T.check_precision(precision)
    T.check_ssm_precision(cfg, precision, "decode")
    return functools.partial(T.decode_step, cfg=cfg, precision=precision)


def slot_batch_axes(cfg: ModelConfig) -> dict:
    """Batch axis of every slotted cache leaf (``"len"`` excluded), as the
    JAX package lays them out: dense/moe/vlm {k, v} (L, B, S, Hkv, Dh);
    ssm recurrent state (L, B, ...); hybrid mamba state per super-block
    (nb, nm, B, ...). encdec's cross-attention cache is not slotted."""
    if cfg.family == "encdec":
        raise NotImplementedError(
            "slot surgery: encdec cross-attention caches are per-batch, "
            "not per-slot; serve encdec through the static scheduler")
    if cfg.family == "ssm":
        return {"conv": 1, "ssm": 1}
    if cfg.family == "hybrid":
        return {"k": 1, "v": 1, "conv": 2, "ssm": 2}
    return {"k": 1, "v": 1}


def init_slot_cache(cfg: ModelConfig, batch: int, max_len: int,
                    dtype=torch.bfloat16, kv: str = "float", device="cuda"):
    """A batched decode cache with per-slot lengths: ``transformer.
    init_cache`` with ``"len"`` a (batch,) int32 vector of zeros, so every
    slot starts empty (length 0 masks the whole row out of attention).

    ``kv="int8"`` stores K/V as int8 codes (zeros) with per-(position,
    head) float32 scales ``k_scale`` / ``v_scale``, (L, B, S, Hkv), of
    ones: about half the bytes of a bf16 cache. Attention-family caches
    only."""
    if kv not in ("float", "int8"):
        raise ValueError(f"init_slot_cache: kv must be 'float' or 'int8', "
                         f"got {kv!r}")
    if kv == "int8" and cfg.family in T.NOT_DENSE_KV:
        raise NotImplementedError(
            "int8 KV slot cache only covers attention-family dense caches")
    dev = resolve_device(device)
    cache = T.init_cache(cfg, batch, max_len, dtype, device=dev)
    if kv == "int8":
        sc = cache["k"].shape[:-1]          # (L, B, S, Hkv)
        cache["k"] = torch.zeros(cache["k"].shape, dtype=torch.int8,
                                 device=dev)
        cache["v"] = torch.zeros(cache["v"].shape, dtype=torch.int8,
                                 device=dev)
        cache["k_scale"] = torch.ones(sc, dtype=torch.float32, device=dev)
        cache["v_scale"] = torch.ones(sc, dtype=torch.float32, device=dev)
    cache["len"] = torch.zeros((batch,), dtype=torch.int32, device=dev)
    return cache


def cache_clear(live: dict) -> dict:
    """Every slot of a live cache back to :func:`init_slot_cache`'s (or a
    paged arena to :func:`init_paged_cache`'s) state, in place: zero
    lengths, K/V (pools), recurrent state and block table, int8 scales of
    one."""
    for key, t in live.items():
        t.fill_(1 if key.endswith("_scale") else 0)
    return live


def cache_write_slot(cfg: ModelConfig, live: dict, new: dict, slot: int,
                     src: int = 0) -> dict:
    """Write row ``src`` of a freshly prefilled cache into slot ``slot`` of
    the live cache, K/V (or recurrent state) and length, in place.
    ``new["len"]`` may be a scalar (plain prefill) or the (B,) vector of a
    ``prompt_lens`` prefill. Into an int8 KV cache (one with
    ``k_scale``), the prefilled float K/V row is quantized on the way in
    (``attention.quantize_kv``): prefill always runs float."""
    T.check_family(cfg, "cache_write_slot")
    for key, ax in slot_batch_axes(cfg).items():
        row = new[key].select(ax, src)
        if key + "_scale" in live:
            row, scale = A.quantize_kv(row)   # (L,S,Hkv,D) -> (L,S,Hkv)
            live[key + "_scale"].select(ax, slot).copy_(scale)
        live[key].select(ax, slot).copy_(row.to(live[key].dtype))
    nl = new["len"]
    live["len"][slot] = nl[src] if nl.dim() else nl
    return dict(live)


def cache_free_slot(live: dict, slot: int) -> dict:
    """Retire a slot by zeroing its length: the per-slot attention mask
    makes its stale K/V unreachable, and the next admission overwrites a
    recurrent state, so no data moves."""
    live["len"][slot] = 0
    return dict(live)


# ------------------------------------------------------------ paged KV pool --

def init_paged_cache(cfg: ModelConfig, batch: int, num_blocks: int,
                     block_size: int, max_len: int, dtype=torch.bfloat16,
                     kv: str = "float", device="cuda"):
    """A paged decode cache: K/V pools, per-slot block tables and lengths,
    all zero (``kv="int8"``: int8 code pools and float32 scale pools of
    ones, the same per-token quantization as the contiguous int8 cache).
    Attention-family caches only; ``block_size`` must divide
    ``max_len``, so the gathered view spans exactly ``max_len``
    positions."""
    if kv not in ("float", "int8"):
        raise ValueError(f"init_paged_cache: kv must be 'float' or 'int8', "
                         f"got {kv!r}")
    if cfg.family in T.NOT_DENSE_KV:
        raise NotImplementedError(
            "paged KV cache only covers attention-family dense caches")
    if max_len % block_size:
        raise ValueError(f"init_paged_cache: block_size={block_size} must "
                         f"divide max_len={max_len}")
    if num_blocks < 2:
        raise ValueError("init_paged_cache: need >= 2 blocks (page 0 is the "
                         "reserved garbage page)")
    dev = resolve_device(device)
    shape = (cfg.n_layers, num_blocks, block_size, cfg.n_kv_heads,
             cfg.head_dim)
    if kv == "int8":
        cache = {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                 "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                 "k_scale": torch.ones(shape[:-1], dtype=torch.float32,
                                       device=dev),
                 "v_scale": torch.ones(shape[:-1], dtype=torch.float32,
                                       device=dev)}
    else:
        cache = {"k": torch.zeros(shape, dtype=dtype, device=dev),
                 "v": torch.zeros(shape, dtype=dtype, device=dev)}
    cache["block_table"] = torch.zeros((batch, max_len // block_size),
                                       dtype=torch.int32, device=dev)
    cache["len"] = torch.zeros((batch,), dtype=torch.int32, device=dev)
    return cache


def _page_ids(live: dict, block_ids) -> torch.Tensor:
    return torch.as_tensor(block_ids, dtype=torch.long,
                           device=live["k"].device)


def _scatter_pages(live: dict, key: str, seg, ids):
    """Write a (L, n * bs, ...) contiguous segment into pages ``ids`` of
    pool ``key``, in place (quantized on the way into an int8 pool)."""
    L, n, bs = seg.shape[0], ids.numel(), live["k"].shape[2]
    if key + "_scale" in live:
        seg, scale = A.quantize_kv(seg)       # (L,n*bs,Hkv,D) -> (L,n*bs,Hkv)
        live[key + "_scale"][:, ids] = scale.reshape(
            (L, n, bs) + scale.shape[2:])
    live[key][:, ids] = seg.reshape((L, n, bs) + seg.shape[2:]).to(
        live[key].dtype)


def paged_write_prompt(cfg: ModelConfig, live: dict, new: dict, block_ids,
                       *, src: int = 0, skip_blocks: int = 0) -> dict:
    """Scatter row ``src`` of a freshly prefilled contiguous cache into
    pool pages ``block_ids`` of a paged cache, in place: the pages of
    prompt blocks ``skip_blocks .. skip_blocks + len(block_ids) - 1`` (a
    prefix hit skips its shared leading pages). An int8 pool gets the codes
    and scales :func:`cache_write_slot` would write at the same positions.
    The caller keeps the block table and ``"len"``."""
    T.check_family(cfg, "paged_write_prompt")
    if not len(block_ids):
        return dict(live)
    ids = _page_ids(live, block_ids)
    bs = live["k"].shape[2]
    lo = skip_blocks * bs
    for key in ("k", "v"):
        row = new[key].select(1, src)                    # (L, S, Hkv, D)
        _scatter_pages(live, key, row[:, lo:lo + ids.numel() * bs], ids)
    return dict(live)


def paged_write_kv(live: dict, k_new, v_new, block_ids, *,
                   src: int = 0) -> dict:
    """Scatter freshly computed K/V rows, (L, B, S, Hkv, D) (the suffix K/V
    of :func:`prefill_suffix_fn`), into pool pages ``block_ids`` in place,
    the sequence zero-padded or cut to the pages' span; positions past the
    real length hold pad K/V, masked as in the contiguous cache."""
    if not len(block_ids):
        return dict(live)
    ids = _page_ids(live, block_ids)
    span = ids.numel() * live["k"].shape[2]
    for key, new in (("k", k_new), ("v", v_new)):
        row = new.select(1, src)                         # (L, S, Hkv, D)
        if row.shape[1] < span:
            row = torch.nn.functional.pad(
                row, (0, 0, 0, 0, 0, span - row.shape[1]))
        _scatter_pages(live, key, row[:, :span], ids)
    return dict(live)


def paged_gather_prefix(live: dict, block_ids):
    """Pages ``block_ids`` gathered into contiguous (L, 1, n * bs, Hkv, D)
    prefix K/V for :func:`prefill_suffix_fn`. Float pools only: a
    dequantized int8 prefix is not the float prefix its donor computed, so
    an int8 hit shares storage and recomputes the prompt instead."""
    if "k_scale" in live:
        raise NotImplementedError(
            "paged_gather_prefix: int8 pools share storage only — recompute "
            "the prompt and skip the shared-page writes")
    ids = _page_ids(live, block_ids)
    outs = []
    for key in ("k", "v"):
        g = live[key][:, ids]                            # (L, n, bs, Hkv, D)
        outs.append(g.reshape((g.shape[0], 1, g.shape[1] * g.shape[2])
                              + g.shape[3:]))
    return tuple(outs)
