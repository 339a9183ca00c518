"""Decoder-only LM, dense and ssm families: init, prefill and one-token
decode.

Port of the dense and ssm parts of ``repro/models/transformer.py``.
Parameters keep the JAX package's layer-stacked layout (every leaf of
``params["layers"]`` carries a leading layer axis), so a JAX parameter
tree carries across leaf by leaf
(``repro_torch.weights.lm_params_from_numpy``). Where the JAX package
scans over the stack, the port loops over it in Python, taking each layer
as views of the stacked tensors.

Serving state is a contiguous KV cache, ``{"k", "v"}`` of (L, B, S, Hkv,
D) plus ``"len"``: a (B,) vector of per-slot lengths, or a scalar for a
plain prefill. K/V are in the cache dtype, or int8 codes with
``{"k_scale", "v_scale"}`` of (L, B, S, Hkv) float32 beside them (the int8
KV cache, which prefill never builds: ``api.cache_write_slot`` quantizes
a prefilled row on the way in). Or it is a paged cache (``api.
init_paged_cache``): pools of (L, NB, bs, Hkv, D) pages (int8 with scale
pools, or float) and a (B, S / bs) ``"block_table"``, a row's position p
living at offset p % bs of page ``block_table[row, p // bs]``. Decode
writes each row's new K/V into the cache IN PLACE at that row's own
length (eager PyTorch would otherwise copy the whole cache every step);
the returned dict holds the same tensors, and a new ``"len"``. An ssm
(Mamba) model's state is ``{"conv"}`` (L, B, K-1, d_inner) in the cache
dtype and ``{"ssm"}`` (L, B, d_inner, d_state) in float32, plus
``"len"``; decode overwrites it in place too. Its prefill runs the
``causal_conv1d`` CUDA kernel once per layer; its recurrence is
position-exact, so a prompt is prefilled at its exact length.

``precision`` picks the FFN: ``"float"``, or the integer modes of the
serving engine — ``"int8"`` / ``"w4a8"`` through the ``matmul_q8`` /
``matmul_w4`` CUDA kernels and ``"int8-torch"`` / ``"w4a8-torch"`` through
their plain versions (the JAX package's ``"int8-xla"``); those need the
quantized ``"qmlp"`` tree beside ``"mlp"`` in each layer.

:func:`prefill_suffix` is JAX's prefix-hit prefill: only a prompt's
suffix runs, against its prefix's cached K/V. Bitwise the full prefill on
the host; the port's engine serves no hit with it (on a card a suffix's
rows do not get the bits the whole prompt's get).

Not ported yet, and raising ``NotImplementedError``: the moe, hybrid and
encdec families, training (ROADMAP.md, queue A). The ssm family runs in
``"float"`` precision only, as in the JAX package.
"""
from __future__ import annotations

import torch

from repro_torch.check.config import PRECISIONS
from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.core.quantize import QTensor, QTensorW4

from . import attention as A
from .blocks import init_mlp, mlp, qmlp, rmsnorm, rope
from .mamba import (init_mamba, mamba_decode_step, mamba_forward_with_state,
                    mamba_init_state)


def _cdt(cfg: ModelConfig):
    return torch_dtype(cfg.compute_dtype)


def check_family(cfg: ModelConfig, what: str):
    """Raise unless ``cfg`` is of a family the port builds: dense (without
    moe) or ssm."""
    if cfg.family not in ("dense", "ssm") or cfg.moe is not None:
        raise NotImplementedError(
            f"{what}: the port builds the dense and ssm families only, not "
            f"{cfg.family!r}{' with moe' if cfg.moe is not None else ''} "
            "(ROADMAP.md, queue A: moe, hybrid and encdec follow)")


def check_ssm_precision(cfg: ModelConfig, precision: str, what: str):
    """The JAX package's gate: the integer FFN covers dense MLPs only."""
    if precision != "float" and cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"integer-FFN {what} only covers attention-family dense MLPs")


def check_precision(precision: str):
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision: {precision!r} "
                         f"(choose from {PRECISIONS})")


# ===================================================================== init

def init_lm(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Random parameters drawn from ``generator`` on its device, in the JAX
    package's layout and scales (normal embeddings * 0.02, normal matmul
    weights * fan_in^-1/2, zero biases, unit norms; Mamba's as
    :func:`~repro_torch.models.mamba.init_mamba` draws them), in
    ``param_dtype``."""
    check_family(cfg, "init_lm")
    pdt = torch_dtype(cfg.param_dtype)
    dev = generator.device
    d, hq, hkv, dh, nl = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, cfg.n_layers)

    def normal(shape, std):
        return torch.randn(shape, generator=generator, dtype=pdt,
                           device=dev).mul_(std)

    def ones(*shape):
        return torch.ones(shape, dtype=pdt, device=dev)

    params = {"embed": normal((cfg.vocab, d), 0.02), "final_norm": ones(d)}
    if not cfg.tied_embeddings:
        params["unembed"] = normal((d, cfg.vocab), d ** -0.5)
    if cfg.family == "ssm":
        params["layers"] = {"ln": ones(nl, d),
                            "mamba": init_mamba(generator, d, cfg.mamba, pdt,
                                                n_layers=nl)}
        return params
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
    For an ssm model: every Mamba leaf but ``A_log``, which stays float32
    (A = -exp(A_log) is computed from the float32 parameter, as in JAX).
    The embedding (read in float32 by :func:`unembed`), the norms and any
    quantized tree are kept as they are."""
    cdt = _cdt(cfg)
    layers = dict(params["layers"])
    if cfg.family == "ssm":
        layers["mamba"] = {k: v if k == "A_log" else v.to(cdt)
                           for k, v in layers["mamba"].items()}
        return dict(params, layers=layers)
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


def attn_decode(lp, x, cfg: ModelConfig, cdt, k_cache, v_cache, cache_len,
                kv_scales=None, lockstep: bool = False):
    """One decode step against one layer's cache, (B,S,Hkv,D) each.

    ``cache_len`` is a (B,) vector: row i writes its new K/V at position
    ``cache_len[i]`` (in place) and attends its own prefix. A row whose
    length is past the end of the cache writes nothing; with ``lockstep``
    (a scalar length, the static scheduler's) it writes at the last
    position instead, as JAX's clamped ``dynamic_update_slice`` does.
    ``kv_scales=(k_scale, v_scale)``, each (B,S,Hkv) float32, marks an
    int8 cache: the new K/V row is quantized on write at its own position
    (its scale beside it) and the cache is dequantized on read."""
    b = x.shape[0]
    s = k_cache.shape[1]
    q, k, v = _qkv(lp, x, cfg, cdt, cache_len[:, None])
    rows = torch.arange(b, device=x.device)
    pos = torch.clamp(cache_len, max=s - 1)
    live = (cache_len < s)[:, None]
    writes = [(k_cache, k), (v_cache, v)]
    if kv_scales is not None:
        (kq, ks), (vq, vs) = A.quantize_kv(k), A.quantize_kv(v)
        writes = [(k_cache, kq), (v_cache, vq), (kv_scales[0], ks),
                  (kv_scales[1], vs)]
    for cache, new in writes:
        new = new[:, 0].to(cache.dtype)
        if not lockstep:
            lv = live.reshape((b,) + (1,) * (cache.dim() - 2))
            new = torch.where(lv, new, cache[rows, pos])
        cache[rows, pos] = new
    if kv_scales is not None:
        o = A.decode_attention_q8(q, k_cache, v_cache, *kv_scales,
                                  cache_len + 1)
    else:
        o = A.decode_attention(q, k_cache, v_cache, cache_len + 1)
    return o.reshape(b, 1, cfg.n_heads * cfg.head_dim) @ lp["wo"].to(cdt)


def attn_decode_paged(lp, x, cfg: ModelConfig, cdt, k_pool, v_pool,
                      block_table, cache_len, scale_pools=None):
    """One decode step against one layer's paged pools, (NB, bs, Hkv, D)
    each, with ``block_table`` (B, S / bs) and ``cache_len`` (B,).

    Row i writes its new K/V in place into page ``block_table[i,
    cache_len[i] // bs]`` at offset ``cache_len[i] % bs``, then attends the
    pages gathered by its table, which equal its contiguous cache below
    its length. A retired row (length 0, zeroed table row) writes into the
    garbage page 0. ``scale_pools=(k_scale_pool, v_scale_pool)``, each
    (NB, bs, Hkv) float32, marks int8 pools: quantize on write at the
    page slot, dequantize on read."""
    b = x.shape[0]
    bs = k_pool.shape[1]
    q, k, v = _qkv(lp, x, cfg, cdt, cache_len[:, None])
    # the engine retires a row at max_len, so a live row's page index is
    # in the table; the clamp only keeps an idle row's gather in range
    col = torch.clamp(cache_len // bs, max=block_table.shape[1] - 1)
    bi = block_table.gather(1, col[:, None].long())[:, 0].long()
    off = (cache_len % bs).long()
    writes = [(k_pool, k), (v_pool, v)]
    if scale_pools is not None:
        (kq, ks), (vq, vs) = A.quantize_kv(k), A.quantize_kv(v)
        writes = [(k_pool, kq), (v_pool, vq), (scale_pools[0], ks),
                  (scale_pools[1], vs)]
    for pool, new in writes:
        pool[bi, off] = new[:, 0].to(pool.dtype)
    if scale_pools is not None:
        o = A.decode_attention_paged_q8(q, k_pool, v_pool, *scale_pools,
                                        block_table, cache_len + 1)
    else:
        o = A.decode_attention_paged(q, k_pool, v_pool, block_table,
                                     cache_len + 1)
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
    check_family(cfg, "init_cache")
    if cfg.family == "ssm":
        st = mamba_init_state(cfg.d_model, cfg.mamba, batch, dtype, device)
        return {"conv": st["conv"].expand((cfg.n_layers,)
                                          + st["conv"].shape).contiguous(),
                "ssm": st["ssm"].expand((cfg.n_layers,)
                                        + st["ssm"].shape).contiguous(),
                "len": torch.zeros((), dtype=torch.int32, device=device)}
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": torch.zeros((), dtype=torch.int32, device=device)}


def _check_cache(cfg: ModelConfig, cache):
    if "block_table" in cache and cfg.family != "dense":
        raise NotImplementedError(
            "paged KV decode only covers attention-family dense caches")
    if "k_scale" in cache and cfg.family != "dense":
        raise NotImplementedError(
            "int8 KV decode only covers attention-family dense caches")


def decode_step(params, token, cache, cfg: ModelConfig, *,
                precision: str = "float"):
    """One-token serve step. token: (B, 1) int. Returns ``(logits (B,1,V)
    float32, cache)`` with the cache's K/V (an int8 cache: codes and
    scales; a paged cache: its pools' page slots; an ssm model: its conv
    and ssm states) written in place and ``"len"`` a new tensor, advanced
    by one."""
    check_family(cfg, "decode_step")
    check_ssm_precision(cfg, precision, "decode")
    _check_cache(cfg, cache)
    cdt = _cdt(cfg)
    h = embed_tokens(params, token, cfg, cdt)
    b = token.shape[0]
    clen = cache["len"]
    if cfg.family == "ssm":
        for l, lp in enumerate(_layers(params, cfg)):
            x = rmsnorm(h, lp["ln"], cfg.norm_eps)
            conv, ssm = cache["conv"][l], cache["ssm"][l]
            y, st = mamba_decode_step(lp["mamba"], x,
                                      {"conv": conv, "ssm": ssm}, cfg.mamba,
                                      cdt)
            conv.copy_(st["conv"])
            ssm.copy_(st["ssm"])
            h = h + y
        h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
        return unembed(params, h, cfg), dict(cache, len=clen + 1)
    lockstep = clen.dim() == 0
    cl = clen.expand(b) if lockstep else clen
    for l, lp in enumerate(_layers(params, cfg)):
        x = rmsnorm(h, lp["ln1"], cfg.norm_eps)
        scales = ((cache["k_scale"][l], cache["v_scale"][l])
                  if "k_scale" in cache else None)
        if "block_table" in cache:
            a = attn_decode_paged(lp["attn"], x, cfg, cdt, cache["k"][l],
                                  cache["v"][l], cache["block_table"], cl,
                                  scale_pools=scales)
        else:
            a = attn_decode(lp["attn"], x, cfg, cdt, cache["k"][l],
                            cache["v"][l], cl, kv_scales=scales,
                            lockstep=lockstep)
        h = h + a
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
    real position, and ``cache["len"]`` is the length vector. Right-padding
    is exact for the dense family only: an ssm recurrence folds every
    position into its state, so its callers pass exact lengths
    (``prompt_lens[i] == S``), as the serving engine does."""
    check_family(cfg, "prefill")
    check_ssm_precision(cfg, precision, "prefill")
    cdt = _cdt(cfg)
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_len, device=tokens.device)
    h = embed_tokens(params, tokens, cfg, cdt)
    if cfg.family == "ssm":
        h = _ssm_prefill_layers(params, h, cfg, cdt, cache)
    else:
        h = _dense_prefill_layers(params, h, cfg, cdt, cache, attn_impl,
                                  precision, attn_block_k)
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


def _ssm_prefill_layers(params, h, cfg: ModelConfig, cdt, cache):
    """The Mamba stack over the prompt; each layer's final conv and ssm
    state goes into ``cache``."""
    for l, lp in enumerate(_layers(params, cfg)):
        x = rmsnorm(h, lp["ln"], cfg.norm_eps)
        y, st = mamba_forward_with_state(lp["mamba"], x, cfg.mamba, cdt)
        cache["conv"][l] = st["conv"].to(cache["conv"].dtype)
        cache["ssm"][l] = st["ssm"]
        h = h + y
    return h


def _dense_prefill_layers(params, h, cfg: ModelConfig, cdt, cache, attn_impl,
                          precision, attn_block_k):
    """The attention stack over the prompt; each layer's K/V go into
    ``cache``."""
    s = h.shape[1]
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
    return h


def prefill_suffix(params, tokens, prefix_k, prefix_v, prefix_len: int,
                   cfg: ModelConfig, *, suffix_lens, attn_impl: str = "flash",
                   attn_block_k: int = 256, precision: str = "float"):
    """Prefill only a prompt's suffix against its cached prefix: the JAX
    engine's prefix-hit path (module docstring).

    ``tokens`` (B, S_sfx), the right-padded suffix, sits at global
    positions ``prefix_len ..``; per layer its queries attend the
    concatenation of the prefix K/V (L, B, prefix_len, Hkv, D) and its own
    fresh K/V, with ``q_offset=prefix_len``. Causality keeps the prefix's
    hidden states independent of the suffix, and a fixed ``attn_block_k``
    keeps the flash schedule of each suffix row the full prompt's, so the
    logits and suffix K/V are what a prefill of the whole prompt gives
    (bitwise where the row products do not depend on the row count).
    Returns ``(last_logits, k_sfx, v_sfx)``, K/V (L, B, S_sfx, Hkv, D) in
    the compute dtype, for the caller to scatter into its pages. Dense
    layer stacks only."""
    check_family(cfg, "prefill_suffix")
    if cfg.family != "dense":
        raise NotImplementedError(
            "prefill_suffix covers attention-family dense layer stacks only")
    cdt = _cdt(cfg)
    b, s = tokens.shape
    h = embed_tokens(params, tokens, cfg, cdt)
    positions = prefix_len + torch.arange(s, device=tokens.device)[None, :]
    ks, vs = [], []
    for l, lp in enumerate(_layers(params, cfg)):
        x = rmsnorm(h, lp["ln1"], cfg.norm_eps)
        q, k, v = _qkv(lp["attn"], x, cfg, cdt, positions)
        o = A.attention(q, torch.cat([prefix_k[l].to(k.dtype), k], dim=1),
                        torch.cat([prefix_v[l].to(v.dtype), v], dim=1),
                        causal=True, impl=attn_impl, q_offset=prefix_len,
                        block_k=attn_block_k)
        h = h + o.reshape(b, s, cfg.n_heads * cfg.head_dim) \
            @ lp["attn"]["wo"].to(cdt)
        h = h + ffn_forward(lp, rmsnorm(h, lp["ln2"], cfg.norm_eps), cfg,
                            cdt, precision=precision)
        ks.append(k)
        vs.append(v)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    sl = torch.as_tensor(suffix_lens, dtype=torch.int32,
                         device=tokens.device)
    idx = (sl.long() - 1)[:, None, None].expand(b, 1, h.shape[-1])
    return (unembed(params, torch.gather(h, 1, idx), cfg), torch.stack(ks),
            torch.stack(vs))
