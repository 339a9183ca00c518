"""Decoder-only LM, dense, vlm, moe, ssm and hybrid families: init, prefill
and one-token decode.

Port of the decoder-only parts of ``repro/models/transformer.py``. A vlm
model is the dense stack with a prefix of modality embeddings:
:func:`prefill` takes ``embeds`` (B, P, d_model) ahead of the tokens (the
frontend that makes them is a stub in the JAX package too). A moe model's
layers carry a ``"moe"`` tree (router, stacked expert weights;
:mod:`~repro_torch.models.moe`) in place of the ``"mlp"`` one, or beside
it where ``dense_residual`` adds a dense FFN. Parameters keep the JAX
package's layer-stacked layout (every leaf of ``params["layers"]`` carries
a leading layer axis), so a JAX parameter tree carries across leaf by leaf
(``repro_torch.weights.lm_params_from_numpy``). Where the JAX package
scans over the stack, the port loops over it in Python, taking each layer
as views of the stacked tensors.

A hybrid (Jamba) model stacks super-blocks of ``attn_period`` sublayers
instead, ``params["blocks"]``: sublayer ``attn_offset`` mixes with
attention, the others with a Mamba block, and every sublayer ``i`` with
``i % moe.every_n_layers == 1`` takes the MoE FFN, the others the dense
one. Its leaves are ``ln_mix`` / ``ln_ffn`` (nb, period, d), ``attn``
(nb, ...), ``mamba`` (nb, period - 1, ...), ``moe`` (nb, n_moe, E, ...)
and ``mlp`` (nb, n_dense, ...), as JAX lays them out. The encoder-decoder
family is :mod:`~repro_torch.models.encdec`'s.

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
position-exact, so a prompt is prefilled at its exact length. A hybrid
model's state is both: K/V (nb, B, S, Hkv, D) of its nb attention
sublayers, and conv (nb, period - 1, B, K-1, d_inner) and ssm (nb,
period - 1, B, d_inner, d_state) of its Mamba sublayers; its prefill runs
``causal_conv1d`` once per Mamba sublayer.

``precision`` picks the FFN: ``"float"``, or the integer modes of the
serving engine — ``"int8"`` / ``"w4a8"`` through the ``matmul_q8`` /
``matmul_w4`` CUDA kernels and ``"int8-torch"`` / ``"w4a8-torch"`` through
their plain versions (the JAX package's ``"int8-xla"``); those need the
quantized ``"qmlp"`` tree beside ``"mlp"`` in each layer.

:func:`prefill_suffix` is JAX's prefix-hit prefill: only a prompt's
suffix runs, against its prefix's cached K/V. Bitwise the full prefill on
the host; the port's engine serves no hit with it (on a card a suffix's
rows do not get the bits the whole prompt's get).

Training (:func:`lm_loss` over :func:`forward_hidden`): each layer (a
super-block for a hybrid model) runs stateless, :func:`dense_layer`,
:func:`ssm_layer` or :func:`hybrid_block`, under :func:`_remat`'s
checkpointing. The training path takes each stacked leaf apart with one
``unbind(0)`` a forward (:func:`_unstack`): indexing the stack once per
layer, as the serve path's views do, would make every layer's gradient a
zero tensor the size of the whole stack.

The ssm and hybrid families run in ``"float"`` precision only, as in the
JAX package; the serving engine keeps moe in ``"float"`` too (JAX's
gate).

Inside a mesh (``parallel.sharding``) every function computes on its
rank's block of the data as it is; :func:`decode_step`'s ``sp_axis`` is
JAX's sequence-parallel decode (:func:`attn_decode`, :func:`_sp_decode`)
and a moe FFN is expert-parallel (``moe.moe_ffn_sharded``). The training
path of the dense, vlm, moe and ssm families also splits what the active
rules split (``sharding.split_axes``; ``make_rules(..., "train",
fsdp=True)``): heads (each rank's query heads meet the key/value heads of
their own GQA groups; the head counts come from the local weight widths)
with a ``psum`` after ``wo``, the FFN (``blocks.mlp``), the Mamba
channels (``mamba._mixer``), the vocabulary (:func:`embed_tokens`, the
loss), and the weights' ``embed`` dim, gathered at the start of each
layer inside its checkpointed function (FSDP: the recompute gathers
again, the backward reduce-scatters). It does not split the ``seq`` and
``d_model_act`` dims of the activations: each rank holds its batch rows
whole (those rules change activation memory, not results). A hybrid or
encdec model refuses rules that split anything but the batch, the cache
and the experts (``sharding.split_dims``). On a card a
dense or vlm :func:`shared_prefill` (the prefill of a serving engine whose
prefix cache shares prompt pages) runs in row blocks of one GEMM shape, so
a prompt's rows get the same bits in every prefill bucket.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.check.config import PRECISIONS
from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.core.quantize import QTensor, QTensorW4
from repro_torch.parallel.sharding import (active_rules, axis_index,
                                           axis_size, constrain,
                                           current_mesh, gather_dims, psum,
                                           split_axes, split_dims)

from . import attention as A
from .blocks import (chunked_softmax_ce, init_mlp, mlp, mlp_specs, qmlp,
                     rmsnorm, rope, row_mm)
from .mamba import (init_mamba, mamba_decode_step, mamba_forward,
                    mamba_forward_with_state, mamba_init_state, mamba_specs)
from .moe import init_moe, moe_ffn, moe_specs

#: the families :func:`check_family` admits: every family a config uses
FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec")
#: the families whose cache is not the attention stack's (L, B, S, Hkv, D)
#: K/V (JAX's gates: no paged or int8 KV cache, no integer FFN for them)
NOT_DENSE_KV = ("ssm", "hybrid", "encdec")
#: the row block of a dense or vlm :func:`shared_prefill` on a card
PREFILL_ROWS = 128


def _cdt(cfg: ModelConfig):
    return torch_dtype(cfg.compute_dtype)


def check_family(cfg: ModelConfig, what: str):
    """Raise unless ``cfg`` names a family the port builds."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{what}: unknown model family {cfg.family!r}; the port builds "
            f"{', '.join(FAMILIES)}")


def _check_decoder(cfg: ModelConfig, what: str):
    """This module's entry points build the decoder-only families."""
    check_family(cfg, what)
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{what}: an encdec model is models/encdec.py's (api.init_params"
            ", prefill_fn and decode_fn dispatch to it)")


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

def init_attn(generator: torch.Generator, cfg: ModelConfig, dtype,
              n_layers: int, *, device=None) -> dict:
    """Stacked attention weights drawn from ``generator`` on its device, in
    the JAX package's layout and scales: ``wq`` / ``wk`` / ``wv`` (n, d,
    H * Dh) * d^-1/2, ``wo`` (n, Hq * Dh, d) * (Hq * Dh)^-1/2, zero biases
    where the config has ``qkv_bias``."""
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dev = generator.device if device is None else device

    def normal(shape, std):
        return torch.randn((n_layers,) + shape, generator=generator,
                           dtype=dtype, device=dev).mul_(std)
    attn = {"wq": normal((d, hq * dh), d ** -0.5),
            "wk": normal((d, hkv * dh), d ** -0.5),
            "wv": normal((d, hkv * dh), d ** -0.5),
            "wo": normal((hq * dh, d), (hq * dh) ** -0.5)}
    if cfg.qkv_bias:
        for name, width in (("bq", hq * dh), ("bk", hkv * dh),
                            ("bv", hkv * dh)):
            attn[name] = torch.zeros((n_layers, width), dtype=dtype,
                                     device=dev)
    return attn


def attn_specs(cfg: ModelConfig, prefix_layers=True):
    """The attention leaves' logical axis names (JAX's ``attn_specs``)."""
    L = ("layers",) if prefix_layers else ()
    p = {"wq": L + ("embed", "heads"), "wk": L + ("embed", "kv_heads"),
         "wv": L + ("embed", "kv_heads"), "wo": L + ("heads", "embed")}
    if cfg.qkv_bias:
        p.update({"bq": L + ("heads",), "bk": L + ("kv_heads",),
                  "bv": L + ("kv_heads",)})
    return p


def init_lm(cfg: ModelConfig, generator: torch.Generator, *,
            device=None) -> dict:
    """Random parameters drawn from ``generator`` on its device, in the JAX
    package's layout and scales (normal embeddings * 0.02, normal matmul
    weights * fan_in^-1/2, zero biases, unit norms; Mamba's as
    :func:`~repro_torch.models.mamba.init_mamba` draws them, the experts'
    as :func:`~repro_torch.models.moe.init_moe`), in ``param_dtype``. Each
    stacked FFN leaf is allocated once and filled layer by layer, so the
    FFN stack is never held twice (granite-34b's bf16 FFN alone is 53
    GB). A hybrid model's super-blocks: :func:`_init_hybrid_blocks`.
    ``device`` overrides the generator's: ``"meta"`` gives the tree's
    shapes and dtypes and allocates nothing (``api.param_structs``)."""
    _check_decoder(cfg, "init_lm")
    pdt = torch_dtype(cfg.param_dtype)
    dev = generator.device if device is None else torch.device(device)
    d, nl = cfg.d_model, cfg.n_layers

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
                                                n_layers=nl, device=dev)}
        return params
    if cfg.family == "hybrid":
        params["blocks"] = _init_hybrid_blocks(cfg, generator, pdt, dev)
        return params
    layers = {"ln1": ones(nl, d), "ln2": ones(nl, d),
              "attn": init_attn(generator, cfg, pdt, nl, device=dev)}
    if cfg.moe is not None:
        layers["moe"] = init_moe(generator, d, cfg.moe, cfg.act, pdt,
                                 n_layers=nl, device=dev)
    if cfg.moe is None or cfg.moe.dense_residual:
        layers["mlp"] = init_mlp(generator, d, cfg.d_ff, cfg.act, pdt,
                                 n_layers=nl, device=dev)
    params["layers"] = layers
    return params


def _hybrid_counts(cfg: ModelConfig) -> tuple:
    """(super-blocks, Mamba sublayers a block, MoE FFNs a block, dense FFNs
    a block)."""
    period = cfg.attn_period
    n_moe = period // cfg.moe.every_n_layers
    return cfg.n_layers // period, period - 1, n_moe, period - n_moe


def _init_hybrid_blocks(cfg: ModelConfig, generator: torch.Generator, pdt,
                        dev):
    """Jamba super-blocks, stacked as JAX's ``_init_hybrid_blocks`` lays
    them out. Each sublayer stack is drawn over nb * n layers (each leaf
    allocated once and filled in place) and viewed as (nb, n, ...)."""
    nb, nm, n_moe, n_dense = _hybrid_counts(cfg)
    d = cfg.d_model

    def per_block(tree, n):
        return {k: v.view((nb, n) + tuple(v.shape[1:]))
                for k, v in tree.items()}
    return {
        "ln_mix": torch.ones((nb, cfg.attn_period, d), dtype=pdt, device=dev),
        "ln_ffn": torch.ones((nb, cfg.attn_period, d), dtype=pdt, device=dev),
        "mamba": per_block(init_mamba(generator, d, cfg.mamba, pdt,
                                      n_layers=nb * nm, device=dev), nm),
        "attn": init_attn(generator, cfg, pdt, nb, device=dev),
        "moe": per_block(init_moe(generator, d, cfg.moe, cfg.act, pdt,
                                  n_layers=nb * n_moe, device=dev), n_moe),
        "mlp": per_block(init_mlp(generator, d, cfg.d_ff, cfg.act, pdt,
                                  n_layers=nb * n_dense, device=dev),
                         n_dense),
    }


def lm_param_specs(cfg: ModelConfig) -> dict:
    """The logical axis names of every leaf of :func:`init_lm`'s tree, a
    tuple per leaf in the same structure (JAX's ``lm_param_specs``)."""
    specs: dict = {"embed": ("vocab", "embed_table"),
                   "final_norm": (None,)}
    if not cfg.tied_embeddings:
        specs["unembed"] = ("embed_table", "vocab")
    if cfg.family == "ssm":
        specs["layers"] = {"ln": ("layers", None), "mamba": mamba_specs()}
    elif cfg.family == "hybrid":
        def per_block(tree):
            return {k: ("layers", None) + v[1:] for k, v in tree.items()}
        specs["blocks"] = {
            "ln_mix": ("layers", None, None), "ln_ffn": ("layers", None, None),
            "mamba": per_block(mamba_specs()), "attn": attn_specs(cfg),
            "moe": per_block(moe_specs(cfg.act)),
            "mlp": per_block(mlp_specs(cfg.act))}
    else:
        lp = {"ln1": ("layers", None), "ln2": ("layers", None),
              "attn": attn_specs(cfg)}
        if cfg.moe is not None:
            lp["moe"] = moe_specs(cfg.act)
        if cfg.moe is None or cfg.moe.dense_residual:
            lp["mlp"] = mlp_specs(cfg.act)
        specs["layers"] = lp
    return specs


def _cast(tree: dict, cdt, keep=()) -> dict:
    return {k: v if k in keep else v.to(cdt) for k, v in tree.items()}


def cast_params(params: dict, cfg: ModelConfig, *, mlp_too: bool = True):
    """A copy of ``params`` whose attention weights and biases (and, with
    ``mlp_too``, the float FFN weights) are in the compute dtype: the
    values every call would otherwise get from a per-use cast, made once.
    For an ssm model: every Mamba leaf but ``A_log``, which stays float32
    (A = -exp(A_log) is computed from the float32 parameter, as in JAX).
    For a moe model: the expert weights; the router stays as it is (the
    routing reads it in float32). A hybrid model: each of those in its
    super-blocks. An encdec model: the attention, cross-attention and FFN
    weights of both stacks, and the embedding in float32, the dtype its
    tied unembedding reads it in (the token lookup gives the same values
    from it). The other families' embedding (read in float32 by
    :func:`unembed`), the norms and any quantized tree are kept as they
    are."""
    cdt = _cdt(cfg)
    if cfg.family == "encdec":
        return dict(params, embed=params["embed"].to(torch.float32), **{
            stack: dict(params[stack], **{
                k: _cast(params[stack][k], cdt)
                for k in ("attn", "xattn", "mlp") if k in params[stack]})
            for stack in ("enc_layers", "dec_layers")})
    key = "blocks" if cfg.family == "hybrid" else "layers"
    layers = dict(params[key])
    if "mamba" in layers:
        layers["mamba"] = _cast(layers["mamba"], cdt, keep=("A_log",))
    if "attn" in layers:
        layers["attn"] = _cast(layers["attn"], cdt)
    if mlp_too and "mlp" in layers:
        layers["mlp"] = _cast(layers["mlp"], cdt)
    if "moe" in layers:
        layers["moe"] = _cast(layers["moe"], cdt, keep=("router",))
    return dict(params, **{key: layers})


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


def _unstack(tree, n: int) -> list:
    """The ``n`` layers of a stacked tree, each leaf taken apart with one
    ``unbind(0)``: views whose gradients autograd stacks once."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    return tree.unbind(0)


def _layers(params: dict, cfg: ModelConfig):
    return [_take(params["layers"], l) for l in range(cfg.n_layers)]


def _blocks(params: dict, cfg: ModelConfig):
    return [_take(params["blocks"], b)
            for b in range(_hybrid_counts(cfg)[0])]


def _hybrid_layout(cfg: ModelConfig) -> list:
    """Per sublayer of a super-block: ``((mixer, index), (ffn, index))``,
    mixer ``"attn"`` or ``"mamba"``, ffn ``"moe"`` or ``"mlp"``, each
    index the sublayer's place in its stack of the block."""
    seen = {"attn": 0, "mamba": 0, "moe": 0, "mlp": 0}
    out = []
    for i in range(cfg.attn_period):
        kinds = ("attn" if i == cfg.attn_offset else "mamba",
                 "moe" if i % cfg.moe.every_n_layers == 1 else "mlp")
        out.append(tuple((k, seen[k]) for k in kinds))
        for k in kinds:
            seen[k] += 1
    return out


# ==================================================================== layers

def _q(lp, x, cfg: ModelConfig, cdt, positions, rows=None):
    """The queries of ``x`` (B, S, d), rotated at ``positions`` (the
    projection :func:`~repro_torch.models.blocks.row_mm` in blocks of
    ``rows``), as many heads as ``wq`` holds columns for."""
    b, s, _ = x.shape
    q = row_mm(x, lp["wq"].to(cdt), rows)
    if cfg.qkv_bias:
        q = q + lp["bq"].to(cdt)
    q = constrain(q, "batch", "seq", "heads")
    return rope(q.reshape(b, s, -1, cfg.head_dim), positions,
                cfg.rope_theta)


def _kv(lp, x, cfg: ModelConfig, cdt, positions, rows=None):
    """The keys (rotated at ``positions``) and values of ``x``."""
    b, s, _ = x.shape
    k = row_mm(x, lp["wk"].to(cdt), rows)
    v = row_mm(x, lp["wv"].to(cdt), rows)
    if cfg.qkv_bias:
        k = k + lp["bk"].to(cdt)
        v = v + lp["bv"].to(cdt)
    k = constrain(k, "batch", "seq", "kv_heads")
    v = constrain(v, "batch", "seq", "kv_heads")
    shape = (b, s, -1, cfg.head_dim)
    return rope(k.reshape(shape), positions, cfg.rope_theta), v.reshape(shape)


def _qkv(lp, x, cfg: ModelConfig, cdt, positions, rows=None):
    return (_q(lp, x, cfg, cdt, positions, rows),
            *_kv(lp, x, cfg, cdt, positions, rows))


def attn_forward(lp, x, cfg: ModelConfig, cdt, *, impl: str, q_offset=0,
                 block_k: int = 256, rows=None):
    """Causal self-attention of ``x`` (B, S, d). With ``rows`` (which must
    divide S) every GEMM has one shape whatever S is: the projections
    :func:`~repro_torch.models.blocks.row_mm` in blocks of ``rows``, and
    the attention :func:`~repro_torch.models.attention.
    prefix_chunk_attention` in query chunks of ``rows`` (``impl`` and
    ``block_k`` are then not used)."""
    b, s, _ = x.shape
    positions = q_offset + torch.arange(s, device=x.device)[None, :]
    q, k, v = _qkv(lp, x, cfg, cdt, positions, rows)
    heads = split_axes("heads")
    ka, va = _own_groups(k, q.shape[2], cfg, heads), \
        _own_groups(v, q.shape[2], cfg, heads)
    if rows is None:
        o = A.attention(q, ka, va, causal=True, impl=impl, block_k=block_k)
    else:
        o = A.prefix_chunk_attention(q, ka, va, rows)
    o = constrain(o.reshape(b, s, -1), "batch", "seq", "heads")
    out = row_mm(o, lp["wo"].to(cdt), rows)
    if heads:
        out = psum(out, heads)
    return constrain(out, "batch", "seq", None), (k, v)


def _own_groups(kv, hq: int, cfg: ModelConfig, heads: tuple):
    """``kv`` (B, S, Hkv, D) cut to the key/value heads of this rank's
    ``hq`` query heads where the rules split the query heads over
    ``heads`` but not the key/value heads (``make_rules`` then leaves the
    rank part of a GQA group): one key/value head per query head, each
    its group's. Anything else as it is."""
    if not heads or split_axes("kv_heads") or hq == cfg.n_heads:
        return kv
    first = axis_index(heads) * hq
    ids = torch.arange(first, first + hq, device=kv.device) \
        // (cfg.n_heads // cfg.n_kv_heads)
    return kv.index_select(2, ids)


def attn_decode(lp, x, cfg: ModelConfig, cdt, k_cache, v_cache, cache_len,
                kv_scales=None, lockstep: bool = False, sp_axis=None):
    """One decode step against one layer's cache, (B,S,Hkv,D) each.

    ``cache_len`` is a (B,) vector: row i writes its new K/V at position
    ``cache_len[i]`` (in place) and attends its own prefix. A row whose
    length is past the end of the cache writes nothing; with ``lockstep``
    (a scalar length, the static scheduler's) it writes at the last
    position instead, as JAX's clamped ``dynamic_update_slice`` does.
    ``kv_scales=(k_scale, v_scale)``, each (B,S,Hkv) float32, marks an
    int8 cache: the new K/V row is quantized on write at its own position
    (its scale beside it) and the cache is dequantized on read.

    ``sp_axis`` names the mesh axis of a sequence-parallel decode
    (lockstep only, float caches only, as in JAX): each rank's caches hold
    its S positions of the axis's S * size, the rank that owns position
    ``cache_len`` writes the new K/V there, and the ranks combine their
    attention (:func:`_sp_decode`). Outside a mesh, or on an axis of size
    1, it changes nothing."""
    if sp_axis is not None:
        if kv_scales is not None:
            raise NotImplementedError("int8 KV decode: sequence-parallel "
                                      "path is float-only")
        if not lockstep:
            raise ValueError("attn_decode: the sequence-parallel path takes "
                             "a scalar cache_len (lockstep decode)")
    b = x.shape[0]
    s = k_cache.shape[1]
    q, k, v = _qkv(lp, x, cfg, cdt, cache_len[:, None])
    rows = torch.arange(b, device=x.device)
    pos = torch.clamp(cache_len, max=s - 1)
    live = (cache_len < s)[:, None]
    sp = sp_axis is not None and current_mesh() is not None \
        and axis_size(sp_axis) > 1
    if sp:          # the owner of the (clamped) global position writes
        n = axis_size(sp_axis)
        local = torch.clamp(cache_len, max=s * n - 1) - axis_index(sp_axis) * s
        pos = torch.clamp(local, 0, s - 1)
        live = ((local >= 0) & (local < s))[:, None]
        lockstep = False
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
    elif sp:
        o = _sp_decode(q, k_cache, v_cache, cache_len[0] + 1, sp_axis)
    else:
        o = A.decode_attention(q, k_cache, v_cache, cache_len + 1)
    return o.reshape(b, 1, cfg.n_heads * cfg.head_dim) @ lp["wo"].to(cdt)


def _sp_decode(q, k_cache, v_cache, n_valid, axis: str):
    """Sequence-parallel decode attention (JAX's ``_sp_decode``): this
    rank's caches hold positions [i * S_loc, (i + 1) * S_loc) of the
    sequence, i its index on ``axis``; the valid ones (global position
    below the scalar ``n_valid``) give this shard's flash statistics,
    which :func:`~repro_torch.models.attention.sp_combine` merges across
    the axis. Outside a mesh, or on an axis of size 1, plain
    :func:`~repro_torch.models.attention.decode_attention`."""
    b = q.shape[0]
    if current_mesh() is None or axis_size(axis) == 1:
        return A.decode_attention(q, k_cache, v_cache, n_valid.expand(b))
    kv_seq = active_rules().kv_seq
    if axis not in ((kv_seq,) if isinstance(kv_seq, str) else kv_seq or ()):
        raise ValueError(f"sequence-parallel decode over {axis!r}: the "
                         f"active rules shard the cache's kv_seq over "
                         f"{kv_seq!r}")
    s_loc = k_cache.shape[1]
    pos = axis_index(axis) * s_loc + torch.arange(s_loc, device=q.device)
    m, l, o = A.decode_attention_partial(q, k_cache, v_cache, pos < n_valid)
    o = A.sp_combine(m, l, o, axis)                    # (B,Hkv,G,1,D)
    return o.movedim(3, 1).reshape(b, 1, -1, q.shape[-1]).to(q.dtype)


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


def ffn_forward(lp, x, cfg: ModelConfig, cdt, precision: str = "float",
                rows=None):
    """The float FFN (a moe layer's experts, plus the dense FFN where
    ``dense_residual`` is set; a dense FFN's matmuls in blocks of
    ``rows``), or with an integer ``precision`` the quantized one
    (:func:`~repro_torch.models.blocks.qmlp`, integer GEMMs whose rows are
    exact; the layer must carry a ``"qmlp"`` tree)."""
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
    if cfg.moe is not None and "moe" in lp:
        y = moe_ffn(x, lp["moe"], cfg.moe, cfg.act, cdt)
        if cfg.moe.dense_residual:
            y = y + mlp(x, lp["mlp"], cfg.act, cdt)
        return y
    return mlp(x, lp["mlp"], cfg.act, cdt, rows)


def _hybrid_ffn(x, bp, kind: str, j: int, cfg: ModelConfig, cdt):
    """Sublayer FFN ``j`` of its kind (``"moe"`` or ``"mlp"``) of the
    super-block ``bp``."""
    if kind == "moe":
        return moe_ffn(x, _take(bp["moe"], j), cfg.moe, cfg.act, cdt)
    return mlp(x, _take(bp["mlp"], j), cfg.act, cdt)


def embed_tokens(params, tokens, cfg: ModelConfig, cdt):
    """The token embeddings in the compute dtype. Where the rules split
    ``vocab``, ``params["embed"]`` holds this rank's rows of the table:
    a token outside them looks up zeros, and the ranks' lookups are
    summed (one rank holds each token, so the sum is its row exactly)."""
    ax = split_axes("vocab")
    if not ax:
        return params["embed"][tokens].to(cdt)
    table = params["embed"]
    vl = table.shape[0]
    loc = tokens - axis_index(ax) * vl
    mine = ((loc >= 0) & (loc < vl))[..., None]
    rows = table[loc.clamp(0, vl - 1)]
    return psum(torch.where(mine, rows, torch.zeros_like(rows)),
                ax).to(cdt)


def unembed(params, h, cfg: ModelConfig):
    w = params["embed"].t() if cfg.tied_embeddings else params["unembed"]
    return constrain(h.to(torch.float32) @ w.to(torch.float32),
                     "batch", None, "vocab")


# ================================================================== training

def dense_layer(h, lp, cfg: ModelConfig, cdt, *, impl: str):
    """One attention + FFN layer over a whole sequence, no cache."""
    a, _ = attn_forward(lp["attn"], rmsnorm(h, lp["ln1"], cfg.norm_eps),
                        cfg, cdt, impl=impl)
    h = h + a
    f = ffn_forward(lp, rmsnorm(h, lp["ln2"], cfg.norm_eps), cfg, cdt)
    return constrain(h + f, "batch", "seq", "d_model_act")


def ssm_layer(h, lp, cfg: ModelConfig, cdt, conv_method: str = "cuda"):
    """One Mamba layer over a whole sequence, no state: the conv stage
    through ``causal_conv1d`` (``"cuda"``: the kernel; ``"torch"``: its
    plain version)."""
    y = mamba_forward(lp["mamba"], rmsnorm(h, lp["ln"], cfg.norm_eps),
                      cfg.mamba, cdt, conv_method=conv_method)
    return constrain(h + y, "batch", "seq", "d_model_act")


def hybrid_block(h, bp, cfg: ModelConfig, cdt, *, impl: str):
    """One super-block over a whole sequence, no state (its serve twin:
    :func:`_hybrid_block_with_state`), the sublayer stacks of ``bp`` taken
    apart with :func:`_unstack`."""
    _, nm, n_moe, n_dense = _hybrid_counts(cfg)
    ln_mix, ln_ffn = bp["ln_mix"].unbind(0), bp["ln_ffn"].unbind(0)
    subs = {"mamba": _unstack(bp["mamba"], nm),
            "moe": _unstack(bp["moe"], n_moe),
            "mlp": _unstack(bp["mlp"], n_dense)}
    for i, ((mix, j), (ffn, jf)) in enumerate(_hybrid_layout(cfg)):
        x = rmsnorm(h, ln_mix[i], cfg.norm_eps)
        if mix == "attn":
            h = h + attn_forward(bp["attn"], x, cfg, cdt, impl=impl)[0]
        else:
            h = h + mamba_forward(subs["mamba"][j], x, cfg.mamba, cdt)
        f_in = rmsnorm(h, ln_ffn[i], cfg.norm_eps)
        if ffn == "moe":
            h = h + moe_ffn(f_in, subs["moe"][jf], cfg.moe, cfg.act, cdt)
        else:
            h = h + mlp(f_in, subs["mlp"][jf], cfg.act, cdt)
    return constrain(h, "batch", None, "d_model_act")


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, mode: str):
    """``fn`` under activation checkpointing (JAX's ``_remat``):
    ``"full"`` keeps only its inputs and recomputes the rest in the
    backward; ``"dots"`` keeps the outputs of the unbatched matrix
    products (``aten.mm`` / ``addmm``) and recomputes everything else,
    batched products included (JAX's ``checkpoint_dots_with_no_batch_dims``);
    ``"none"`` keeps every residual. The checkpoint is the non-reentrant
    one: the reentrant one loses the gradients of the parameters ``fn``
    reads without taking them as inputs. Outside autograd ``fn`` runs
    as it is."""
    if mode == "none":
        return fn
    if mode not in ("full", "dots"):
        raise ValueError(f"unknown remat mode {mode!r}; expected 'full', "
                         "'dots' or 'none'")
    kw = {} if mode == "full" else {
        "context_fn": lambda: create_selective_checkpoint_contexts(
            _save_dots)}

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw)
    return wrapped


def _layer_specs(cfg: ModelConfig) -> dict:
    """The logical axis names of one layer's leaves (a super-block's for
    a hybrid model): :func:`lm_param_specs`' stack without its leading
    layer axis."""
    specs = lm_param_specs(cfg)["blocks" if cfg.family == "hybrid"
                                else "layers"]

    def strip(t):
        if isinstance(t, dict):
            return {k: strip(v) for k, v in t.items()}
        return t[1:]
    return strip(specs)


#: the top-level leaves whose ``embed_table`` dim FSDP splits
_TABLES = ("embed", "unembed")


def gather_tables(params, cfg: ModelConfig) -> dict:
    """``params`` with the embedding (and unembedding) table's
    ``embed_table`` dim gathered where the rules split it (FSDP), once a
    step, ahead of :func:`forward_hidden`; ``params`` itself elsewhere."""
    specs = lm_param_specs(cfg)
    keys = [k for k in _TABLES if k in params]
    got = gather_dims({k: params[k] for k in keys},
                      {k: specs[k] for k in keys}, ("embed_table",))
    return dict(params, **got)


def check_splits(cfg: ModelConfig, what: str):
    """A hybrid or encdec model's layers compute every dim whole: raise
    where the active rules split one beyond the batch, the cache and the
    experts."""
    dims = split_dims() if cfg.family in ("hybrid", "encdec") else ()
    if dims:
        raise NotImplementedError(
            f"{what}: the {cfg.family} family does not train under rules "
            f"that split {', '.join(dims)} (ROADMAP A8.1c); its sharded "
            "step splits the batch only")


def forward_hidden(params, tokens, cfg: ModelConfig, *, embeds=None,
                   attn_impl: str = "full", remat: str = "full"):
    """Final hidden states (after the final norm) of ``tokens`` (B, S), a
    vlm model's ``embeds`` (B, P, d_model) ahead of them, each layer (or
    super-block) under ``_remat(.., remat)``. Under FSDP rules each
    layer's weights are gathered inside its checkpointed function, and
    the tables must come gathered (:func:`gather_tables`)."""
    _check_decoder(cfg, "forward_hidden")
    check_splits(cfg, "forward_hidden")
    cdt = _cdt(cfg)
    specs = _layer_specs(cfg)

    def whole(lp):
        return gather_dims(lp, specs, ("embed",))
    h = embed_tokens(params, tokens, cfg, cdt)
    if embeds is not None:
        h = torch.cat([embeds.to(cdt), h], dim=1)
    h = constrain(h, "batch", "seq", None)
    if cfg.family == "hybrid":
        body = _remat(lambda hh, bp: hybrid_block(hh, bp, cfg, cdt,
                                                  impl=attn_impl), remat)
        stack = _unstack(params["blocks"], _hybrid_counts(cfg)[0])
    elif cfg.family == "ssm":
        body = _remat(lambda hh, lp: ssm_layer(hh, whole(lp), cfg, cdt),
                      remat)
        stack = _unstack(params["layers"], cfg.n_layers)
    else:
        body = _remat(lambda hh, lp: dense_layer(hh, whole(lp), cfg, cdt,
                                                 impl=attn_impl), remat)
        stack = _unstack(params["layers"], cfg.n_layers)
    for lp in stack:
        h = body(h, lp)
    return rmsnorm(h, params["final_norm"], cfg.norm_eps)


def forward(params, tokens, cfg: ModelConfig, *, embeds=None,
            attn_impl: str = "full", remat: str = "full"):
    """Float32 logits (B, P + S, V) of :func:`forward_hidden` (this
    rank's block of V where the rules split ``vocab``)."""
    params = gather_tables(params, cfg)
    h = forward_hidden(params, tokens, cfg, embeds=embeds,
                       attn_impl=attn_impl, remat=remat)
    return unembed(params, h, cfg)


def lm_loss(params, batch, cfg: ModelConfig, *, attn_impl: str = "full",
            remat: str = "full", z_loss: float = 1e-4, loss_chunk: int = 512):
    """Next-token loss of ``batch["tokens"]`` (B, S + 1):
    :func:`~repro_torch.models.blocks.chunked_softmax_ce` of the hidden
    states of tokens[:, :-1] against tokens[:, 1:]; a vlm model's
    ``batch["embeds"]`` go ahead of the tokens and their positions are
    left out of the loss."""
    tokens = batch["tokens"]
    embeds = batch.get("embeds")
    params = gather_tables(params, cfg)
    h = forward_hidden(params, tokens[:, :-1], cfg, embeds=embeds,
                       attn_impl=attn_impl, remat=remat)
    n_img = 0 if embeds is None else embeds.shape[1]
    w = params["embed"].t() if cfg.tied_embeddings else params["unembed"]
    return chunked_softmax_ce(h[:, n_img:], w, tokens[:, 1:],
                              chunk=loss_chunk, z_loss=z_loss)


# ==================================================================== decode

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda"):
    _check_decoder(cfg, "init_cache")
    if cfg.family == "hybrid":
        nb, nm, _, _ = _hybrid_counts(cfg)
        st = mamba_init_state(cfg.d_model, cfg.mamba, batch, dtype, device)
        kv = (nb, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(kv, dtype=dtype, device=device),
                "v": torch.zeros(kv, dtype=dtype, device=device),
                "conv": torch.zeros((nb, nm) + st["conv"].shape,
                                    dtype=dtype, device=device),
                "ssm": torch.zeros((nb, nm) + st["ssm"].shape,
                                   dtype=torch.float32, device=device),
                "len": torch.zeros((), dtype=torch.int32, device=device)}
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


def cache_specs(cfg: ModelConfig):
    """The logical axis names of :func:`init_cache`'s leaves (JAX's
    ``cache_specs``: the sequence-parallel rules shard ``kv_seq``)."""
    if cfg.family == "ssm":
        return {"conv": (None, "batch", None, "d_inner"),
                "ssm": (None, "batch", "d_inner", None), "len": ()}
    kv = (None, "batch", "kv_seq", "kv_heads", None)
    if cfg.family == "hybrid":
        return {"k": kv, "v": kv,
                "conv": (None, None, "batch", None, "d_inner"),
                "ssm": (None, None, "batch", "d_inner", None), "len": ()}
    return {"k": kv, "v": kv, "len": ()}


def _check_cache(cfg: ModelConfig, cache):
    if "block_table" in cache and cfg.family in NOT_DENSE_KV:
        raise NotImplementedError(
            "paged KV decode only covers attention-family dense caches")
    if "k_scale" in cache and cfg.family in NOT_DENSE_KV:
        raise NotImplementedError(
            "int8 KV decode only covers attention-family dense caches")


def decode_step(params, token, cache, cfg: ModelConfig, *, sp_axis=None,
                precision: str = "float"):
    """One-token serve step. token: (B, 1) int. Returns ``(logits (B,1,V)
    float32, cache)`` with the cache's K/V (an int8 cache: codes and
    scales; a paged cache: its pools' page slots; an ssm model: its conv
    and ssm states; a hybrid model: both) written in place and ``"len"`` a
    new tensor, advanced by one. ``sp_axis``: the attention layers'
    sequence-parallel decode over that mesh axis (:func:`attn_decode`; a
    contiguous float cache with a scalar length), inside a mesh whose
    rules shard the cache's ``kv_seq``; every tensor is this rank's block
    (``parallel.sharding.shard_tree`` of ``cache_specs``)."""
    _check_decoder(cfg, "decode_step")
    check_ssm_precision(cfg, precision, "decode")
    _check_cache(cfg, cache)
    if sp_axis is not None and "block_table" in cache:
        raise NotImplementedError("paged KV decode: sequence-parallel "
                                  "path is contiguous-only")
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
    if cfg.family == "hybrid":
        h = _hybrid_decode_blocks(params, h, cfg, cdt, cache, cl, lockstep,
                                  sp_axis)
        h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
        return unembed(params, h, cfg), dict(cache, len=clen + 1)
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
                            lockstep=lockstep, sp_axis=sp_axis)
        h = h + a
        h = h + ffn_forward(lp, rmsnorm(h, lp["ln2"], cfg.norm_eps), cfg,
                            cdt, precision=precision)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return unembed(params, h, cfg), dict(cache, len=clen + 1)


def _hybrid_decode_blocks(params, h, cfg: ModelConfig, cdt, cache, cl,
                          lockstep: bool, sp_axis=None):
    """One token through the super-blocks: each attention sublayer writes
    its K/V into the block's cache row, each Mamba sublayer overwrites its
    conv and ssm state, in place."""
    for b, bp in enumerate(_blocks(params, cfg)):
        for i, ((mix, j), (ffn, jf)) in enumerate(_hybrid_layout(cfg)):
            x = rmsnorm(h, bp["ln_mix"][i], cfg.norm_eps)
            if mix == "attn":
                h = h + attn_decode(bp["attn"], x, cfg, cdt, cache["k"][b],
                                    cache["v"][b], cl, lockstep=lockstep,
                                    sp_axis=sp_axis)
            else:
                conv, ssm = cache["conv"][b, j], cache["ssm"][b, j]
                y, st = mamba_decode_step(_take(bp["mamba"], j), x,
                                          {"conv": conv, "ssm": ssm},
                                          cfg.mamba, cdt)
                conv.copy_(st["conv"])
                ssm.copy_(st["ssm"])
                h = h + y
            h = h + _hybrid_ffn(rmsnorm(h, bp["ln_ffn"][i], cfg.norm_eps),
                                bp, ffn, jf, cfg, cdt)
    return h


def prefill(params, tokens, cfg: ModelConfig, max_len: int, *, embeds=None,
            attn_impl: str = "flash", prompt_lens=None,
            precision: str = "float", attn_block_k: int = 256):
    """Run the prompt, build the cache, return ``(last_logits, cache)``.

    ``embeds`` (B, P, d_model), a vlm model's patch embeddings, go ahead of
    the tokens' embeddings: the prompt is P + S positions, and its length
    (``cache["len"]`` without ``prompt_lens``; a caller's ``prompt_lens``)
    counts them.

    With ``prompt_lens`` (a (B,) int vector) the batch is RIGHT-padded: row
    i's real tokens occupy positions [0, prompt_lens[i]); causality keeps
    them from attending the trailing pads, pad K/V land at positions the
    per-slot decode mask never reads, logits are taken at each row's last
    real position, and ``cache["len"]`` is the length vector. Right-padding
    is exact for the attention families only: an ssm or hybrid recurrence
    folds every position into its state, so its callers pass exact lengths
    (``prompt_lens[i] == S``), as the serving engine does."""
    return _prefill(params, tokens, cfg, max_len, embeds, attn_impl,
                    prompt_lens, precision, attn_block_k, None)


def shared_prefill(params, tokens, cfg: ModelConfig, max_len: int, *,
                   embeds=None, attn_impl: str = "flash", prompt_lens=None,
                   precision: str = "float", attn_block_k: int = 256):
    """:func:`prefill` whose rows get the same bits under every prefill
    bucket, for a serving engine whose prefix cache shares a prompt's
    pages with prompts of other buckets. cuBLAS picks a GEMM's kernel, and
    so the order of its sums, by the row count, so :func:`prefill` gives a
    prompt's K/V rows other bits under another bucket. Here, on a card, a
    dense or vlm prefill runs its positions in blocks of
    :data:`PREFILL_ROWS` (the prompt zero-padded after its end to a
    multiple of it; the pad rows' K/V are not written): every projection
    and FFN GEMM in one shape (``blocks.row_mm``) and the attention in
    query chunks of that many rows (:func:`attn_forward`), whatever
    ``attn_impl`` and ``attn_block_k`` say. A moe model's routing depends
    on every row of the call (capacity), so it runs as :func:`prefill`;
    so does the host, whose rows do not depend on the row count."""
    return _prefill(params, tokens, cfg, max_len, embeds, attn_impl,
                    prompt_lens, precision, attn_block_k, PREFILL_ROWS)


def _prefill(params, tokens, cfg: ModelConfig, max_len: int, embeds,
             attn_impl, prompt_lens, precision, attn_block_k, row_block):
    _check_decoder(cfg, "prefill")
    check_ssm_precision(cfg, precision, "prefill")
    cdt = _cdt(cfg)
    b = tokens.shape[0]
    cache = init_cache(cfg, b, max_len, device=tokens.device)
    h = embed_tokens(params, tokens, cfg, cdt)
    if embeds is not None:
        h = torch.cat([embeds.to(cdt), h], dim=1)
    if cfg.family == "ssm":
        h = _ssm_prefill_layers(params, h, cfg, cdt, cache)
    elif cfg.family == "hybrid":
        for blk, bp in enumerate(_blocks(params, cfg)):
            h, st = _hybrid_block_with_state(h, bp, cfg, cdt, attn_impl,
                                             max_len)
            for key in ("k", "v", "conv", "ssm"):
                cache[key][blk] = st[key].to(cache[key].dtype)
    else:
        rows = (row_block if row_block and h.is_cuda and cfg.moe is None
                else None)
        h = _dense_prefill_layers(params, h, cfg, cdt, cache, attn_impl,
                                  precision, attn_block_k, rows)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    if prompt_lens is None:
        cache["len"] = torch.tensor(h.shape[1], dtype=torch.int32,
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


def _pad_seq(x, max_len: int):
    """(B, S, H, D) zero-padded along S to ``max_len``."""
    return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, max_len - x.shape[1]))


def _hybrid_block_with_state(h, bp, cfg: ModelConfig, cdt, attn_impl,
                             max_len: int):
    """One super-block over the prompt (JAX's ``_hybrid_block_with_state``):
    returns ``(h, {"k", "v", "conv", "ssm"})``, the attention sublayer's
    K/V zero-padded to ``max_len`` and the Mamba sublayers' final conv and
    ssm states stacked, (period - 1, B, ...)."""
    convs, ssms, kv = [], [], None
    for i, ((mix, j), (ffn, jf)) in enumerate(_hybrid_layout(cfg)):
        x = rmsnorm(h, bp["ln_mix"][i], cfg.norm_eps)
        if mix == "attn":
            a, (k, v) = attn_forward(bp["attn"], x, cfg, cdt, impl=attn_impl)
            h = h + a
            kv = (_pad_seq(k, max_len), _pad_seq(v, max_len))
        else:
            y, st = mamba_forward_with_state(_take(bp["mamba"], j), x,
                                             cfg.mamba, cdt)
            h = h + y
            convs.append(st["conv"])
            ssms.append(st["ssm"])
        h = h + _hybrid_ffn(rmsnorm(h, bp["ln_ffn"][i], cfg.norm_eps), bp,
                            ffn, jf, cfg, cdt)
    return h, {"k": kv[0], "v": kv[1], "conv": torch.stack(convs),
               "ssm": torch.stack(ssms)}


def _dense_prefill_layers(params, h, cfg: ModelConfig, cdt, cache, attn_impl,
                          precision, attn_block_k, rows=None):
    """The attention stack over the prompt; each layer's K/V go into
    ``cache``. With ``rows``: in row blocks (:func:`prefill`), the prompt
    zero-padded to a multiple of ``rows`` and cut back at the end."""
    s = h.shape[1]
    if rows is not None:
        h = torch.nn.functional.pad(h, (0, 0, 0, -s % rows))
    for l, lp in enumerate(_layers(params, cfg)):
        x = rmsnorm(h, lp["ln1"], cfg.norm_eps)
        a, (k, v) = attn_forward(lp["attn"], x, cfg, cdt, impl=attn_impl,
                                 block_k=attn_block_k, rows=rows)
        h = h + a
        f = ffn_forward(lp, rmsnorm(h, lp["ln2"], cfg.norm_eps), cfg, cdt,
                        precision=precision, rows=rows)
        cache["k"][l, :, :s] = k[:, :s].to(cache["k"].dtype)
        cache["v"][l, :, :s] = v[:, :s].to(cache["v"].dtype)
        h = h + f
    return h[:, :s]


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
    the compute dtype, for the caller to scatter into its pages. Attention
    layer stacks only (dense, vlm, moe)."""
    check_family(cfg, "prefill_suffix")
    if cfg.family in NOT_DENSE_KV:
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
        o = constrain(o.reshape(b, s, cfg.n_heads * cfg.head_dim),
                      "batch", "seq", "heads")
        h = h + constrain(o @ lp["attn"]["wo"].to(cdt), "batch", "seq", None)
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
