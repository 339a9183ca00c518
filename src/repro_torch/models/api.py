"""Model API of the serve path: init, prefill, decode and the per-slot KV
cache helpers of continuous batching.

Port of the dense, contiguous-cache part of ``repro/models/api.py``. The
continuous-batching engine keeps ONE live batched decode cache with
per-slot lengths and splices freshly prefilled requests into free slots
between decode rounds; these helpers own the cache layout, (L, B, S, Hkv,
D) K and V plus a (B,) ``"len"`` vector. Unlike the JAX helpers, which
return new arrays, the slot writes here update the live cache in place and
return a dict holding the same tensors.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device

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
    T.check_dense(cfg, "prefill_fn")
    T.check_precision(precision)

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
    T.check_dense(cfg, "decode_fn")
    T.check_precision(precision)
    return functools.partial(T.decode_step, cfg=cfg, precision=precision)


def init_slot_cache(cfg: ModelConfig, batch: int, max_len: int,
                    dtype=torch.bfloat16, kv: str = "float", device="cuda"):
    """A batched decode cache with per-slot lengths: ``transformer.
    init_cache`` with ``"len"`` a (batch,) int32 vector of zeros, so every
    slot starts empty (length 0 masks the whole row out of attention)."""
    if kv not in ("float", "int8"):
        raise ValueError(f"init_slot_cache: kv must be 'float' or 'int8', "
                         f"got {kv!r}")
    if kv == "int8":
        raise NotImplementedError(
            "init_slot_cache: the int8 KV cache is not ported (ROADMAP.md, "
            "queue A)")
    dev = resolve_device(device)
    cache = T.init_cache(cfg, batch, max_len, dtype, device=dev)
    cache["len"] = torch.zeros((batch,), dtype=torch.int32, device=dev)
    return cache


def cache_write_slot(cfg: ModelConfig, live: dict, new: dict, slot: int,
                     src: int = 0) -> dict:
    """Write row ``src`` of a freshly prefilled cache into slot ``slot`` of
    the live cache, K/V and length, in place. ``new["len"]`` may be a
    scalar (plain prefill) or the (B,) vector of a ``prompt_lens``
    prefill."""
    T.check_dense(cfg, "cache_write_slot")
    for key in ("k", "v"):
        live[key][:, slot] = new[key][:, src].to(live[key].dtype)
    nl = new["len"]
    live["len"][slot] = nl[src] if nl.dim() else nl
    return dict(live)


def cache_free_slot(live: dict, slot: int) -> dict:
    """Retire a slot by zeroing its length: the per-slot attention mask
    makes its stale K/V unreachable, so no data moves."""
    live["len"][slot] = 0
    return dict(live)
