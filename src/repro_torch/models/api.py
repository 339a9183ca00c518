"""Model API of the serve path: init, prefill, decode and the per-slot KV
cache helpers of continuous batching.

Port of the dense and ssm, contiguous-cache part of
``repro/models/api.py``. The continuous-batching engine keeps ONE live
batched decode cache with per-slot lengths and splices freshly prefilled
requests into free slots between decode rounds; these helpers own the
cache layout (:func:`slot_batch_axes`): (L, B, S, Hkv, D) K and V for the
dense family (in the cache dtype, or int8 codes with (L, B, S, Hkv)
float32 ``k_scale`` / ``v_scale``), (L, B, K-1, d_inner) conv and (L, B,
d_inner, d_state) ssm state for the ssm family, plus a (B,) ``"len"``
vector. Unlike the JAX helpers, which return new arrays, the slot writes
here update the live cache in place and return a dict holding the same
tensors, so a captured decode step that reads the cache by address stays
valid across them.
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
    T.check_family(cfg, "prefill_fn")
    T.check_precision(precision)
    T.check_ssm_precision(cfg, precision, "prefill")

    def fn(params, batch):
        if batch.get("embeds") is not None:
            raise NotImplementedError(
                "prefill: modality embeddings (vlm/audio) are not ported "
                "(ROADMAP.md, queue A)")
        return T.prefill(params, batch["tokens"], cfg, max_len,
                         attn_impl=attn_impl,
                         prompt_lens=batch.get("prompt_lens"),
                         precision=precision, attn_block_k=attn_block_k)
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
    ones: about half the bytes of a bf16 cache. Attention-family dense
    caches only."""
    if kv not in ("float", "int8"):
        raise ValueError(f"init_slot_cache: kv must be 'float' or 'int8', "
                         f"got {kv!r}")
    if kv == "int8" and cfg.family in ("ssm", "hybrid", "encdec"):
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
    """Every slot of a live cache back to :func:`init_slot_cache`'s state,
    in place: zero lengths, K/V and recurrent state, int8 scales of one."""
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
