"""Decoder-only LM, dense family: init, prefill and one-token decode.

Port of the dense half of ``repro/models/transformer.py``. Parameters keep
the JAX package's layer-stacked layout (every leaf of ``params["layers"]``
carries a leading layer axis), so a JAX parameter tree carries across leaf
by leaf (``repro_torch.weights.lm_params_from_numpy``). Where the JAX
package scans over the stack, the port loops over it in Python, taking
each layer as views of the stacked tensors.

Serving state is a contiguous float KV cache, ``{"k", "v"}`` of (L, B, S,
Hkv, D) plus ``"len"``: a (B,) vector of per-slot lengths, or a scalar for
a plain prefill. Decode writes each row's new K/V into the cache IN PLACE
at that row's own length (eager PyTorch would otherwise copy the whole
cache every step); the returned dict holds the same tensors.

``precision`` picks the FFN: ``"float"``, or the integer modes of the
serving engine — ``"int8"`` / ``"w4a8"`` through the ``matmul_q8`` /
``matmul_w4`` CUDA kernels and ``"int8-torch"`` / ``"w4a8-torch"`` through
their plain versions (the JAX package's ``"int8-xla"``); those need the
quantized ``"qmlp"`` tree beside ``"mlp"`` in each layer.

Not ported yet, and raising ``NotImplementedError``: the moe, ssm, hybrid
and encdec families, the paged and int8 KV caches, training
(ROADMAP.md, queue A).
"""
from __future__ import annotations

import torch

from repro_torch.check.config import PRECISIONS
from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.core.quantize import QTensor, QTensorW4

from . import attention as A
from .blocks import init_mlp, mlp, qmlp, rmsnorm, rope


def _cdt(cfg: ModelConfig):
    return torch_dtype(cfg.compute_dtype)


def check_dense(cfg: ModelConfig, what: str):
    """Raise unless ``cfg`` is of the one family the port builds."""
    if cfg.family != "dense" or cfg.moe is not None:
        raise NotImplementedError(
            f"{what}: the port builds the dense family only, not "
            f"{cfg.family!r}{' with moe' if cfg.moe is not None else ''} "
            "(ROADMAP.md, queue A: moe, ssm, hybrid and encdec follow)")


def check_precision(precision: str):
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision: {precision!r} "
                         f"(choose from {PRECISIONS})")


# ===================================================================== init

def init_lm(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Random parameters drawn from ``generator`` on its device, in the JAX
    package's layout and scales (normal embeddings * 0.02, normal matmul
    weights * fan_in^-1/2, zero biases, unit norms), in ``param_dtype``."""
    check_dense(cfg, "init_lm")
    pdt = torch_dtype(cfg.param_dtype)
    dev = generator.device
    d, hq, hkv, dh, nl = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, cfg.n_layers)

    def normal(shape, std):
        return torch.randn(shape, generator=generator, dtype=pdt,
                           device=dev) * std

    def ones(*shape):
        return torch.ones(shape, dtype=pdt, device=dev)

    params = {"embed": normal((cfg.vocab, d), 0.02), "final_norm": ones(d)}
    if not cfg.tied_embeddings:
        params["unembed"] = normal((d, cfg.vocab), d ** -0.5)
    attn = {"wq": normal((nl, d, hq * dh), d ** -0.5),
            "wk": normal((nl, d, hkv * dh), d ** -0.5),
            "wv": normal((nl, d, hkv * dh), d ** -0.5),
            "wo": normal((nl, hq * dh, d), (hq * dh) ** -0.5)}
    if cfg.qkv_bias:
        for name, width in (("bq", hq * dh), ("bk", hkv * dh),
                            ("bv", hkv * dh)):
            attn[name] = torch.zeros((nl, width), dtype=pdt, device=dev)
    mlps = [init_mlp(generator, d, cfg.d_ff, cfg.act, pdt)
            for _ in range(nl)]
    params["layers"] = {
        "ln1": ones(nl, d), "ln2": ones(nl, d), "attn": attn,
        "mlp": {k: torch.stack([m[k] for m in mlps]) for k in mlps[0]}}
    return params


def cast_params(params: dict, cfg: ModelConfig, *, mlp_too: bool = True):
    """A copy of ``params`` whose attention weights and biases (and, with
    ``mlp_too``, the float FFN weights) are in the compute dtype: the
    values every call would otherwise get from a per-use cast, made once.
    The embedding (read in float32 by :func:`unembed`), the norms and any
    quantized tree are kept as they are."""
    cdt = _cdt(cfg)
    layers = dict(params["layers"])
    layers["attn"] = {k: v.to(cdt) for k, v in layers["attn"].items()}
    if mlp_too:
        layers["mlp"] = {k: v.to(cdt) for k, v in layers["mlp"].items()}
    return dict(params, layers=layers)


def _take(tree, l: int):
    """Layer ``l`` of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _take(v, l) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return QTensor(tree.q[l], tree.frac_bits)
    if isinstance(tree, QTensorW4):
        return QTensorW4(tree.q[l], tree.shifts[l], tree.frac_bits,
                         tree.size, tree.axis)
    return tree[l]


def _layers(params: dict, cfg: ModelConfig):
    return [_take(params["layers"], l) for l in range(cfg.n_layers)]


# ==================================================================== layers

def _qkv(lp, x, cfg: ModelConfig, cdt, positions):
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ lp["wq"].to(cdt)
    k = x @ lp["wk"].to(cdt)
    v = x @ lp["wv"].to(cdt)
    if cfg.qkv_bias:
        q = q + lp["bq"].to(cdt)
        k = k + lp["bk"].to(cdt)
        v = v + lp["bv"].to(cdt)
    q = rope(q.reshape(b, s, hq, dh), positions, cfg.rope_theta)
    k = rope(k.reshape(b, s, hkv, dh), positions, cfg.rope_theta)
    return q, k, v.reshape(b, s, hkv, dh)


def attn_forward(lp, x, cfg: ModelConfig, cdt, *, impl: str, q_offset=0,
                 block_k: int = 256):
    b, s, _ = x.shape
    positions = q_offset + torch.arange(s, device=x.device)[None, :]
    q, k, v = _qkv(lp, x, cfg, cdt, positions)
    o = A.attention(q, k, v, causal=True, impl=impl, block_k=block_k)
    out = o.reshape(b, s, cfg.n_heads * cfg.head_dim) @ lp["wo"].to(cdt)
    return out, (k, v)


def attn_decode(lp, x, cfg: ModelConfig, cdt, k_cache, v_cache, cache_len):
    """One decode step against one layer's cache, (B,S,Hkv,D) each.

    ``cache_len`` is a (B,) vector: row i writes its new K/V at position
    ``cache_len[i]`` (in place) and attends its own prefix. A row whose
    length is past the end of the cache writes nothing."""
    b = x.shape[0]
    s = k_cache.shape[1]
    q, k, v = _qkv(lp, x, cfg, cdt, cache_len[:, None])
    rows = torch.arange(b, device=x.device)
    pos = torch.clamp(cache_len, max=s - 1)
    live = (cache_len < s)[:, None, None]
    for cache, new in ((k_cache, k), (v_cache, v)):
        cache[rows, pos] = torch.where(live, new[:, 0].to(cache.dtype),
                                       cache[rows, pos])
    o = A.decode_attention(q, k_cache, v_cache, cache_len + 1)
    return o.reshape(b, 1, cfg.n_heads * cfg.head_dim) @ lp["wo"].to(cdt)


def ffn_forward(lp, x, cfg: ModelConfig, cdt, precision: str = "float"):
    """The float FFN, or with an integer ``precision`` the quantized one
    (:func:`~repro_torch.models.blocks.qmlp`; the layer must carry a
    ``"qmlp"`` tree)."""
    if precision != "float":
        check_precision(precision)
        if "qmlp" not in lp:
            raise ValueError(
                f"precision={precision!r} needs quantized FFN params; run "
                "blocks.quantize_mlp_params (serve.Engine does this when "
                "ServeConfig.precision != 'float')")
        return qmlp(x, lp["qmlp"], cfg.act, cdt,
                    method="torch" if precision.endswith("-torch")
                    else "cuda")
    return mlp(x, lp["mlp"], cfg.act, cdt)


def embed_tokens(params, tokens, cfg: ModelConfig, cdt):
    return params["embed"][tokens].to(cdt)


def unembed(params, h, cfg: ModelConfig):
    w = params["embed"].t() if cfg.tied_embeddings else params["unembed"]
    return h.to(torch.float32) @ w.to(torch.float32)


# ==================================================================== decode

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda"):
    check_dense(cfg, "init_cache")
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": torch.zeros((), dtype=torch.int32, device=device)}


def _check_cache(cache):
    if "block_table" in cache or "k_scale" in cache:
        raise NotImplementedError(
            "decode_step: the paged and int8 KV caches are not ported; the "
            "port decodes a contiguous float cache (ROADMAP.md, queue A)")


def decode_step(params, token, cache, cfg: ModelConfig, *,
                precision: str = "float"):
    """One-token serve step. token: (B, 1) int. Returns ``(logits (B,1,V)
    float32, cache)`` with the cache's K/V written in place and ``"len"``
    advanced by one."""
    check_dense(cfg, "decode_step")
    _check_cache(cache)
    cdt = _cdt(cfg)
    h = embed_tokens(params, token, cfg, cdt)
    b = token.shape[0]
    clen = cache["len"]
    cl = clen.expand(b) if clen.dim() == 0 else clen
    for l, lp in enumerate(_layers(params, cfg)):
        x = rmsnorm(h, lp["ln1"], cfg.norm_eps)
        h = h + attn_decode(lp["attn"], x, cfg, cdt, cache["k"][l],
                            cache["v"][l], cl)
        h = h + ffn_forward(lp, rmsnorm(h, lp["ln2"], cfg.norm_eps), cfg,
                            cdt, precision=precision)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return unembed(params, h, cfg), dict(cache, len=clen + 1)


def prefill(params, tokens, cfg: ModelConfig, max_len: int, *,
            attn_impl: str = "flash", prompt_lens=None,
            precision: str = "float", attn_block_k: int = 256):
    """Run the prompt, build the cache, return ``(last_logits, cache)``.

    With ``prompt_lens`` (a (B,) int vector) the batch is RIGHT-padded: row
    i's real tokens occupy positions [0, prompt_lens[i]); causality keeps
    them from attending the trailing pads, pad K/V land at positions the
    per-slot decode mask never reads, logits are taken at each row's last
    real position, and ``cache["len"]`` is the length vector."""
    check_dense(cfg, "prefill")
    cdt = _cdt(cfg)
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_len, device=tokens.device)
    h = embed_tokens(params, tokens, cfg, cdt)
    for l, lp in enumerate(_layers(params, cfg)):
        x = rmsnorm(h, lp["ln1"], cfg.norm_eps)
        a, (k, v) = attn_forward(lp["attn"], x, cfg, cdt, impl=attn_impl,
                                 block_k=attn_block_k)
        h = h + a
        f = ffn_forward(lp, rmsnorm(h, lp["ln2"], cfg.norm_eps), cfg, cdt,
                        precision=precision)
        cache["k"][l, :, :s] = k.to(cache["k"].dtype)
        cache["v"][l, :, :s] = v.to(cache["v"].dtype)
        h = h + f
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    if prompt_lens is None:
        cache["len"] = torch.tensor(s, dtype=torch.int32,
                                    device=tokens.device)
        return unembed(params, h[:, -1:], cfg), cache
    pl = torch.as_tensor(prompt_lens, dtype=torch.int32,
                         device=tokens.device)
    cache["len"] = pl
    idx = (pl.long() - 1)[:, None, None].expand(b, 1, h.shape[-1])
    return unembed(params, torch.gather(h, 1, idx), cfg), cache
