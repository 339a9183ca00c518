"""Encoder-decoder backbone (SeamlessM4T-large-v2): init, encode, prefill and
one-token decode.

Port of the serving half of ``repro/models/encdec.py``. The speech frontend
is a stub, as in the JAX package: the encoder takes precomputed frame
embeddings (B, S_enc, d_model). The encoder is a stack of non-causal
self-attention and FFN layers with a final ``enc_norm``; each decoder
layer runs causal self-attention, cross-attention over the encoder output
and the FFN. Parameters keep the JAX package's layout, ``{"embed",
"enc_layers", "dec_layers", "enc_norm", "final_norm"}``, every leaf of a
layer stack with a leading layer axis, so a JAX tree carries across leaf
by leaf (``repro_torch.weights.lm_params_from_numpy``). The output
projection is tied to the token embedding, read in float32.

The arithmetic is the reference's, two of its choices included: the
cross-attention queries are rotated (rope) at their decoder positions, and
the cross-attention keys at their encoder positions.

The cache is ``{"k", "v"}`` (L, B, max_len, Hkv, D), the decoder's
self-attention K/V, ``{"xk", "xv"}`` (L, B, S_enc, Hkv, D), the cross K/V
computed once at prefill, all bfloat16, and a scalar ``"len"``: every row
of a batch decodes in lockstep (the JAX package's cross cache is
per-batch, not per-slot). :func:`encdec_decode_step` writes the new
token's K/V into ``k`` / ``v`` in place, so a captured step that reads the
cache by address stays valid; it returns a new ``"len"``.

Training: :func:`encdec_loss`, each encoder and decoder layer under the
decoder-only stack's ``_remat`` and its stacks taken apart with
``_unstack``. In a sharded step (``make_rules(..., "train", fsdp=True)``)
it splits what the rules split, as the decoder-only stack does: each
layer's weights come gathered along their ``embed`` dim inside its
checkpointed function (FSDP), every attention (the encoder's, the
decoder's self- and cross-attention, whose K/V heads come from the
encoder output) runs on this rank's heads with a ``psum`` after ``wo``
(:func:`_attend`), the FFN on its columns (``blocks.mlp``), and the token
lookup and the tied output projection on its block of the vocabulary.

:func:`encdec_decode_step` with ``sp_axis`` decodes sequence-parallel
inside a mesh, each rank holding its block of the cache under
:func:`encdec_cache_specs` (``kv_seq`` of the self and the cross K/V): the
self-attention as the decoder-only stack's, the cross-attention as its
``_sp_decode`` over every encoder position.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.parallel.sharding import (axis_size, constrain,
                                           current_mesh, psum, split_axes)

from . import attention as A
from .blocks import chunked_softmax_ce, init_mlp, mlp, mlp_specs, rmsnorm
from .transformer import (TABLE_SPECS, _cdt, _kv, _own_groups, _q, _remat,
                          _sp_decode, _take, _unstack, attn_decode,
                          attn_specs, embed_tokens, gather_tables, init_attn,
                          layer_gather)


def init_encdec(cfg: ModelConfig, generator: torch.Generator, *,
                device=None) -> dict:
    """Random parameters drawn from ``generator`` on its device, in the JAX
    package's layout and scales (normal embedding * 0.02, attention as
    :func:`~repro_torch.models.transformer.init_attn`, the FFN as
    :func:`~repro_torch.models.blocks.init_mlp`, unit norms), in
    ``param_dtype``. Every stacked leaf is allocated once and filled in
    place. ``device`` overrides the generator's (``"meta"``: shapes
    only)."""
    pdt = torch_dtype(cfg.param_dtype)
    dev = generator.device if device is None else torch.device(device)
    d = cfg.d_model

    def ones(*shape):
        return torch.ones(shape, dtype=pdt, device=dev)

    def stack(n, norms):
        layers = {name: ones(n, d) for name in norms}
        layers["attn"] = init_attn(generator, cfg, pdt, n, device=dev)
        if "lnx" in norms:
            layers["xattn"] = init_attn(generator, cfg, pdt, n, device=dev)
        layers["mlp"] = init_mlp(generator, d, cfg.d_ff, cfg.act, pdt,
                                 n_layers=n, device=dev)
        return layers
    embed = torch.randn((cfg.vocab, d), generator=generator, dtype=pdt,
                        device=dev).mul_(0.02)
    return {"embed": embed,
            "enc_layers": stack(cfg.n_encoder_layers, ("ln1", "ln2")),
            "dec_layers": stack(cfg.n_layers, ("ln1", "lnx", "ln2")),
            "enc_norm": ones(d), "final_norm": ones(d)}


def encdec_param_specs(cfg: ModelConfig) -> dict:
    """The logical axis names of :func:`init_encdec`'s leaves (JAX's
    ``encdec_param_specs``)."""
    a = attn_specs(cfg)
    enc = {"ln1": ("layers", None), "ln2": ("layers", None),
           "attn": a, "mlp": mlp_specs(cfg.act)}
    dec = dict(enc, lnx=("layers", None), xattn=a)
    return {"embed": TABLE_SPECS["embed"],
            "enc_layers": enc, "dec_layers": dec,
            "enc_norm": (None,), "final_norm": (None,)}


def _attend(lp, x, src, cfg: ModelConfig, cdt, q_pos, kv_pos, *,
            causal: bool, impl: str):
    """The attention of ``x``'s queries (rotated at ``q_pos``) over the
    keys (rotated at ``kv_pos``) and values of ``src`` (``x`` itself for
    self-attention), through ``wo``: ``(out, (k, v))``. Where the rules
    split ``heads``, ``lp`` holds this rank's heads (the counts come from
    the local weight widths), its query heads meet the key/value heads of
    their own GQA groups and the ranks' partial outputs are summed."""
    b, s, _ = x.shape
    q = _q(lp, x, cfg, cdt, q_pos)
    k, v = _kv(lp, src, cfg, cdt, kv_pos)
    heads = split_axes("heads")
    o = A.attention(q, _own_groups(k, q.shape[2], cfg, heads),
                    _own_groups(v, q.shape[2], cfg, heads), causal=causal,
                    impl=impl)
    out = o.reshape(b, s, -1) @ lp["wo"].to(cdt)
    return (psum(out, heads) if heads else out), (k, v)


def encode(params, frames, cfg: ModelConfig, *, attn_impl="full",
           remat="full"):
    """frames: (B, S_enc, d_model) stub embeddings -> the encoder output,
    (B, S_enc, d_model) in the compute dtype; each layer under
    ``_remat(.., remat)`` (which changes nothing outside autograd), its
    weights gathered inside it under FSDP rules."""
    cdt = _cdt(cfg)
    h = constrain(frames.to(cdt), "batch", None, None)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    whole = layer_gather(encdec_param_specs(cfg)["enc_layers"])

    def body(hh, lp):
        lp = whole(lp)
        x = rmsnorm(hh, lp["ln1"], cfg.norm_eps)
        hh = hh + _attend(lp["attn"], x, x, cfg, cdt, positions, positions,
                          causal=False, impl=attn_impl)[0]
        return hh + mlp(rmsnorm(hh, lp["ln2"], cfg.norm_eps), lp["mlp"],
                        cfg.act, cdt)
    body = _remat(body, remat)
    for lp in _unstack(params["enc_layers"], cfg.n_encoder_layers):
        h = body(h, lp)
    return rmsnorm(h, params["enc_norm"], cfg.norm_eps)


def _decoder_layer(hh, lp, enc_out, cfg: ModelConfig, cdt, attn_impl):
    """One decoder layer over the prompt: returns ``(hh, ((k, v), (kx,
    vx)))``, its self-attention K/V and the cross K/V of ``enc_out``
    (this rank's heads where the rules split them)."""
    x = rmsnorm(hh, lp["ln1"], cfg.norm_eps)
    positions = torch.arange(hh.shape[1], device=hh.device)[None, :]
    a, kv = _attend(lp["attn"], x, x, cfg, cdt, positions, positions,
                    causal=True, impl=attn_impl)
    hh = hh + a
    xx = rmsnorm(hh, lp["lnx"], cfg.norm_eps)
    epos = torch.arange(enc_out.shape[1], device=hh.device)[None, :]
    ax, xkv = _attend(lp["xattn"], xx, enc_out, cfg, cdt, positions, epos,
                      causal=False, impl=attn_impl)
    hh = hh + ax
    f = mlp(rmsnorm(hh, lp["ln2"], cfg.norm_eps), lp["mlp"], cfg.act, cdt)
    return hh + f, (kv, xkv)


def _unembed(params, h):
    """Logits of the tied projection, in float32. A float32 embedding is
    read as it is; ``cast_params`` makes one once, so that a step over
    its weights copies none."""
    return h.to(torch.float32) @ params["embed"].t().to(torch.float32)


def encdec_loss(params, batch, cfg: ModelConfig, *, attn_impl="full",
                remat="full", z_loss: float = 1e-4, loss_chunk: int = 512):
    """Next-token loss of ``batch["tokens"]`` (B, S + 1) given the encoder
    output of ``batch["frames"]``: the decoder over tokens[:, :-1], each
    layer under ``_remat(.., remat)``, then
    :func:`~repro_torch.models.blocks.chunked_softmax_ce` against
    tokens[:, 1:] through the output projection tied to ``embed`` (in a
    sharded step: the table gathered along ``embed_table`` once, then
    this rank's block of the vocabulary, as the decoder-only loss
    reads it)."""
    cdt = _cdt(cfg)
    params = gather_tables(params)
    enc_out = encode(params, batch["frames"], cfg, attn_impl=attn_impl,
                     remat=remat)
    tokens = batch["tokens"]
    h = embed_tokens(params, tokens[:, :-1], cfg, cdt)
    whole = layer_gather(encdec_param_specs(cfg)["dec_layers"])
    body = _remat(lambda hh, lp: _decoder_layer(hh, whole(lp), enc_out, cfg,
                                                cdt, attn_impl)[0], remat)
    for lp in _unstack(params["dec_layers"], cfg.n_layers):
        h = body(h, lp)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return chunked_softmax_ce(h, params["embed"].t(), tokens[:, 1:],
                              chunk=loss_chunk, z_loss=z_loss)


def init_encdec_cache(cfg: ModelConfig, batch: int, max_len: int,
                      enc_len: int, dtype=torch.bfloat16,
                      device="cuda") -> dict:
    """The decode cache, all zeros: ``k`` / ``v`` (L, B, max_len, Hkv, D),
    ``xk`` / ``xv`` (L, B, enc_len, Hkv, D), ``enc_len`` the frames'
    length (JAX's cache structure has ``max_len`` there, the length its
    dry run assumes), and a scalar ``len``."""
    kv = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    xkv = kv[:2] + (enc_len,) + kv[3:]
    return {"k": torch.zeros(kv, dtype=dtype, device=device),
            "v": torch.zeros(kv, dtype=dtype, device=device),
            "xk": torch.zeros(xkv, dtype=dtype, device=device),
            "xv": torch.zeros(xkv, dtype=dtype, device=device),
            "len": torch.zeros((), dtype=torch.int32, device=device)}


def encdec_cache_specs():
    """The logical axis names of the decode cache's leaves (JAX's
    ``encdec_cache_specs``)."""
    kv = (None, "batch", "kv_seq", "kv_heads", None)
    return {"k": kv, "v": kv, "xk": kv, "xv": kv, "len": ()}


def encdec_prefill(params, frames, tokens, cfg: ModelConfig, max_len: int,
                   *, attn_impl="flash"):
    """Encode ``frames``, then the decoder over the prompt ``tokens`` (B,
    S): returns ``(last_logits (B, 1, V) float32, cache)``, the cache
    holding the prompt's K/V (zeros past S), the cross K/V and ``len`` =
    S."""
    cdt = _cdt(cfg)
    enc_out = encode(params, frames, cfg, attn_impl=attn_impl, remat="none")
    b, s = tokens.shape
    cache = init_encdec_cache(cfg, b, max_len, enc_out.shape[1],
                              device=tokens.device)
    h = params["embed"][tokens].to(cdt)
    for l in range(cfg.n_layers):
        h, ((k, v), (kx, vx)) = _decoder_layer(
            h, _take(params["dec_layers"], l), enc_out, cfg, cdt, attn_impl)
        cache["k"][l, :, :s] = k.to(cache["k"].dtype)
        cache["v"][l, :, :s] = v.to(cache["v"].dtype)
        cache["xk"][l] = kx.to(cache["xk"].dtype)
        cache["xv"][l] = vx.to(cache["xv"].dtype)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    cache["len"].fill_(s)
    return _unembed(params, h[:, -1:]), cache


def encdec_decode_step(params, token, cache, cfg: ModelConfig, *,
                       sp_axis=None):
    """One token for every row of the batch. token: (B, 1) int. Returns
    ``(logits (B, 1, V) float32, cache)``: the new K/V written into
    ``k`` / ``v`` in place at position ``len``, cross-attention over the
    whole ``xk`` / ``xv``, ``"len"`` a new tensor, advanced by one.
    ``sp_axis``: sequence-parallel over that mesh axis (module
    docstring); outside a mesh it changes nothing."""
    cdt = _cdt(cfg)
    h = params["embed"][token].to(cdt)
    b = token.shape[0]
    clen = cache["len"]
    cl = clen.expand(b)
    n_enc = cache["xk"].shape[2]
    sp = sp_axis is not None and current_mesh() is not None \
        and axis_size(sp_axis) > 1
    enc_len = torch.full((b,), n_enc, dtype=torch.int32, device=h.device)
    for l in range(cfg.n_layers):
        lp = _take(params["dec_layers"], l)
        x = rmsnorm(h, lp["ln1"], cfg.norm_eps)
        h = h + attn_decode(lp["attn"], x, cfg, cdt, cache["k"][l],
                            cache["v"][l], cl, lockstep=True,
                            sp_axis=sp_axis)
        xx = rmsnorm(h, lp["lnx"], cfg.norm_eps)
        qx = _q(lp["xattn"], xx, cfg, cdt, cl[:, None])
        if sp:
            ox = _sp_decode(qx, cache["xk"][l].to(cdt),
                            cache["xv"][l].to(cdt), enc_len[0] * axis_size(
                                sp_axis), sp_axis)
        else:
            ox = A.decode_attention(qx, cache["xk"][l].to(cdt),
                                    cache["xv"][l].to(cdt), enc_len)
        h = h + ox.reshape(b, 1, -1) @ lp["xattn"]["wo"].to(cdt)
        h = h + mlp(rmsnorm(h, lp["ln2"], cfg.norm_eps), lp["mlp"], cfg.act,
                    cdt)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return _unembed(params, h), dict(cache, len=clen + 1)
