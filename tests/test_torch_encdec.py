"""The port's encoder-decoder family against the JAX package on the CPU:
seamless-m4t-large-v2 cut to ``tests/test_arch_smoke.py``'s ``reduce_cfg``
sizes (2 encoder and 2 decoder layers, d_model 64, 4 heads of which 2 KV,
d_ff 128, vocab 256), float32 compute. Both sides compute from the same
seeded numpy weights, the port's converted by
``weights.lm_params_from_numpy``; the frames (the speech frontend's stub
embeddings) and prompts are seeded numpy arrays fed to both sides.
Covered: the parameter tree, ``encode``, ``_decoder_layer``,
``encdec_prefill`` (logits and all four cache leaves), four chained
``encdec_decode_step``s, ``cast_params`` and the gates: the integer-FFN
refusal of ``prefill_fn`` / ``decode_fn`` and of ``Engine``, and encdec
under each scheduler (JAX's continuous-scheduler refusal; under the static
one JAX's engine retires every request with ``KeyError('frames')``, the
port's refuses at construction).

Tolerances, each with its reason:

* parameter trees, cache lengths, error messages: exact;
* the encoder output, a decoder layer's hidden state and its K/V in
  float32: the two frameworks sum the matmuls in another order, atol and
  rtol 1e-5, as ``tests/test_torch_moe.py``'s float32 FFN;
* prefill and decode logits: atol 1e-4, rtol 1e-3, as
  ``tests/test_torch_lm.py``; the bf16 cache leaves: atol and rtol 1e-2,
  as ``tests/test_torch_families.py`` (the two sides can round an element
  to neighbouring bf16 values);
* the decode step over ``cast_params``' weights against the step over the
  uncast ones: exact (the cast is the value each use would cast to).

Run here with ``PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q
tests/test_torch_encdec.py``."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.base import get_config as j_get_config  # noqa: E402
from repro.models import api as j_api  # noqa: E402
from repro.models import encdec as JE  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import encdec as E  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import Engine, ServeConfig  # noqa: E402
from repro_torch.serve.engine import ENCDEC_STATIC_MESSAGE  # noqa: E402
from repro_torch.weights import lm_params_from_numpy  # noqa: E402

ARCH = "seamless-m4t-large-v2"
#: tests/test_arch_smoke.py's reduce_cfg for encdec, float32 compute
REDUCED = dict(n_layers=2, n_encoder_layers=2, d_model=64, n_heads=4,
               n_kv_heads=2, d_ff=128, vocab=256, compute_dtype="float32")
F32_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-3)
CACHE_TOL = dict(atol=1e-2, rtol=1e-2)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def numpy_params(jcfg, seed: int) -> dict:
    """Seeded numpy weights in the layout of JAX's ``init_params`` (traced
    for its shapes, not run), at its scales: normal embedding * 0.02,
    normal matrices * fan_in^-1/2, unit norms, zero biases."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: j_api.init_params(
        jcfg, jax.random.PRNGKey(0)))

    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        if name.startswith("ln") or name.endswith("_norm"):
            return np.ones(shape, np.float32)
        std = 0.02 if name == "embed" else shape[-2] ** -0.5
        return (rng.standard_normal(shape) * std).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=None)
def reduced():
    """(JAX config, JAX params, port config, port params): the same numpy
    weights on both sides."""
    jcfg = dataclasses.replace(j_get_config(ARCH), **REDUCED)
    cfg = dataclasses.replace(get_config(ARCH), **REDUCED)
    weights = numpy_params(jcfg, 0)
    return (jcfg, jax.tree_util.tree_map(jnp.asarray, weights), cfg,
            lm_params_from_numpy(weights, device="cpu"))


def _inputs(seed=0, b=2, s_enc=12, s=9):
    """Seeded frames (B, S_enc, d_model) bf16 and prompt tokens (B, S)."""
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((b, s_enc, REDUCED["d_model"])) \
        .astype(np.float32)
    toks = rng.integers(0, REDUCED["vocab"], (b, s)).astype(np.int32)
    return ((jnp.asarray(frames, jnp.bfloat16), jnp.asarray(toks)),
            (torch.from_numpy(frames).to(torch.bfloat16),
             torch.from_numpy(toks).long()))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


# ------------------------------------------------------------ parameters --

def test_config_is_jax_and_init_keeps_its_layout():
    jcfg, jparams, cfg, params = reduced()
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(j_get_config(ARCH))
    mine = api.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    shapes = jax.tree_util.tree_map(lambda v: tuple(v.shape), jparams)
    assert jax.tree_util.tree_map(lambda v: tuple(v.shape), mine) == shapes
    leaves = jax.tree_util.tree_leaves(mine)
    assert all(v.is_contiguous() and v.dtype == torch.float32
               for v in leaves)
    # the analytic count leaves out the two final norms, and counts an
    # untied unembedding (the config's tied_embeddings is False) where the
    # model ties its output projection to the embedding, in both packages
    assert not cfg.tied_embeddings
    assert sum(v.numel() for v in leaves) == \
        cfg.param_count() - cfg.vocab * 64 + 2 * 64
    assert float(mine["embed"].std()) == pytest.approx(0.02, rel=0.1)
    wq = mine["dec_layers"]["xattn"]["wq"]
    assert float(wq.std()) == pytest.approx(64 ** -0.5, rel=0.1)
    # the converter carries JAX's tree leaf by leaf, dtypes kept
    assert jax.tree_util.tree_map(lambda v: tuple(v.shape), params) == shapes
    for got, want in zip(jax.tree_util.tree_leaves(params),
                         jax.tree_util.tree_leaves(jparams)):
        assert np.array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------- layers --

@pytest.mark.parametrize("impl", ["full", "flash"])
def test_encode_matches_jax(impl):
    jcfg, jparams, cfg, params = reduced()
    (jf, _), (tf, _) = _inputs(1)
    want = jax.jit(JE.encode, static_argnums=2,
                   static_argnames=("attn_impl",))(jparams, jf, jcfg,
                                                   attn_impl=impl)
    got = E.encode(params, tf, cfg, attn_impl=impl)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("impl", ["full", "flash"])
def test_decoder_layer_matches_jax(impl):
    """One decoder layer: hidden state, self K/V and cross K/V (the keys
    rotated at encoder positions, as the reference does)."""
    jcfg, jparams, cfg, params = reduced()
    (jf, jt), (tf, tt) = _inputs(2)
    jenc = JE.encode(jparams, jf, jcfg)
    enc = E.encode(params, tf, cfg)
    jlp = jax.tree_util.tree_map(lambda v: v[1], jparams["dec_layers"])
    lp = T._take(params["dec_layers"], 1)
    jh = jparams["embed"][jt].astype(jnp.float32)
    h = params["embed"][tt]
    want_h, ((wk, wv), (wkx, wvx)) = jax.jit(
        JE._decoder_layer, static_argnums=(3, 4, 5))(
            jh, jlp, jenc, jcfg, jnp.float32, impl)
    got_h, ((k, v), (kx, vx)) = E._decoder_layer(
        h, lp, torch.from_numpy(np.array(jenc)), cfg, torch.float32, impl)
    for got, want in ((got_h, want_h), (k, wk), (v, wv), (kx, wkx),
                      (vx, wvx)):
        assert tuple(got.shape) == tuple(want.shape)
        _close(got, want, F32_TOL)
    _close(enc, jenc, F32_TOL)


# ----------------------------------------------------------------- model --

@pytest.mark.parametrize("impl", ["flash", "full"])
def test_prefill_and_four_decode_steps_track_jax(impl):
    """``prefill_fn`` (logits, ``k``, ``v``, ``xk``, ``xv``, ``len``), then
    four chained ``decode_fn`` steps fed JAX's greedy tokens."""
    jcfg, jparams, cfg, params = reduced()
    (jf, jt), (tf, tt) = _inputs(3)
    max_len = 16
    jl, jc = j_api.prefill_fn(jcfg, max_len, attn_impl=impl)(
        jparams, {"frames": jf, "tokens": jt})
    tl, tc = api.prefill_fn(cfg, max_len, attn_impl=impl)(
        params, {"frames": tf, "tokens": tt})
    assert tuple(tl.shape) == (2, 1, cfg.vocab) and tl.dtype == torch.float32
    _close(tl, jl, LOGIT_TOL)
    assert set(tc) == set(jc) == {"k", "v", "xk", "xv", "len"}
    for key in ("k", "v", "xk", "xv"):
        assert tc[key].dtype == torch.bfloat16
        assert tuple(tc[key].shape) == tuple(jc[key].shape), key
        _close(tc[key], jc[key], CACHE_TOL)
    assert not tc["k"][:, :, 9:].any()            # zeros past the prompt
    assert int(tc["len"]) == int(jc["len"]) == 9
    jdec, tdec = j_api.decode_fn(jcfg), api.decode_fn(cfg)
    for step in range(4):
        cur = np.argmax(np.asarray(jl)[:, -1], -1)[:, None].astype(np.int32)
        k_before = tc["k"]
        jl, jc = jdec(jparams, jnp.asarray(cur), jc)
        tl, tc = tdec(params, torch.from_numpy(cur).long(), tc)
        _close(tl, jl, LOGIT_TOL)
        assert tc["k"] is k_before                  # written in place
        assert int(tc["len"]) == int(jc["len"]) == 10 + step
    _close(tc["k"], jc["k"], CACHE_TOL)
    _close(tc["v"], jc["v"], CACHE_TOL)


def test_cast_params_gives_the_uncast_step_bitwise():
    """In bfloat16 compute: the weights ``cast_params`` casts once give the
    values every use would cast to, so the step is bitwise the same; the
    embedding and the norms are kept."""
    _, _, cfg, params = reduced()
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    cast = T.cast_params(params, cfg)
    for stack in ("enc_layers", "dec_layers"):
        assert cast[stack]["attn"]["wq"].dtype == torch.bfloat16
        assert cast[stack]["mlp"]["w_up"].dtype == torch.bfloat16
        assert cast[stack]["ln1"] is params[stack]["ln1"]
    assert cast["dec_layers"]["xattn"]["wo"].dtype == torch.bfloat16
    assert cast["embed"] is params["embed"]
    _, (tf, tt) = _inputs(4)
    outs = []
    for p in (params, cast):
        logits, cache = api.prefill_fn(cfg, 16)(p, {"frames": tf,
                                                    "tokens": tt})
        step, _ = api.decode_fn(cfg)(p, logits.argmax(-1), cache)
        outs.append((logits, step))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_cast_params_makes_the_float32_embedding_once():
    """bfloat16 weights: ``cast_params`` makes the float32 embedding the
    tied unembedding reads, once; the token lookup gives the same values
    from it, so the prefill and the decode step are bitwise the ones over
    the bfloat16 embedding, which each call would copy to float32."""
    _, _, cfg, params = reduced()
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16",
                              param_dtype="bfloat16")
    params = jax.tree_util.tree_map(lambda v: v.to(torch.bfloat16), params)
    cast = T.cast_params(params, cfg)
    assert cast["embed"].dtype == torch.float32
    assert torch.equal(cast["embed"], params["embed"].float())
    assert T.cast_params(cast, cfg)["embed"] is cast["embed"]
    _, (tf, tt) = _inputs(5)
    outs = []
    for p in (params, cast):
        logits, cache = api.prefill_fn(cfg, 16)(p, {"frames": tf,
                                                    "tokens": tt})
        step, _ = api.decode_fn(cfg)(p, logits.argmax(-1), cache)
        outs.append((logits, step))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


# ----------------------------------------------------------------- gates --

@pytest.mark.parametrize("which", ["prefill_fn", "decode_fn"])
def test_integer_ffn_refused_with_jax_message(which):
    jcfg, _, cfg, _ = reduced()
    args = (16,) if which == "prefill_fn" else ()
    with pytest.raises(NotImplementedError) as want:
        getattr(j_api, which)(jcfg, *args, precision="int8")
    for prec in ("int8", "w4a8-torch"):
        with pytest.raises(NotImplementedError) as got:
            getattr(api, which)(cfg, *args, precision=prec)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    dict(), dict(precision="int8"), dict(kv_cache="int8"),
    dict(kv_layout="paged"), dict(scheduler="static", precision="int8"),
    dict(scheduler="static", kv_cache="int8")],
    ids=["continuous", "continuous-int8", "continuous-kv8",
         "continuous-paged", "static-int8", "static-kv8"])
def test_engine_gates_raise_jax_messages(kw):
    jcfg, jparams, cfg, params = reduced()
    with pytest.raises(NotImplementedError) as want:
        JEngine(jcfg, jparams, JServeConfig(**kw))
    with pytest.raises(NotImplementedError) as got:
        Engine(cfg, params, ServeConfig(**kw))
    assert str(got.value) == str(want.value)


def test_static_engine_jax_retires_keyerror_port_refuses():
    """JAX's static engine builds, then its prefill reads ``frames`` that
    no request carries: every request retires ``error``, no tokens. The
    port refuses at construction instead, naming ROADMAP.md's C."""
    jcfg, jparams, cfg, params = reduced()
    jeng = JEngine(jcfg, jparams, JServeConfig(scheduler="static",
                                               max_batch=2, max_len=32))
    rng = np.random.default_rng(5)
    for i in range(3):
        jeng.submit(JRequest(uid=i, prompt=rng.integers(0, 256, (5,))
                             .astype(np.int32), max_new_tokens=4))
    done = jeng.run_until_drained()
    assert [r.status for r in done] == ["error"] * 3
    assert {r.error for r in done} == {"KeyError('frames')"}
    assert all(r.out_tokens == [] for r in done)
    with pytest.raises(NotImplementedError) as got:
        Engine(cfg, params, ServeConfig(scheduler="static", max_batch=2,
                                        max_len=32))
    assert str(got.value) == ENCDEC_STATIC_MESSAGE
    assert "ROADMAP.md, C" in ENCDEC_STATIC_MESSAGE


def test_decoder_only_entry_points_and_slots_refuse_encdec():
    _, _, cfg, params = reduced()
    with pytest.raises(NotImplementedError, match="models/encdec.py"):
        T.init_lm(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="models/encdec.py"):
        T.prefill(params, torch.zeros((1, 4), dtype=torch.long), cfg, 8)
    with pytest.raises(NotImplementedError) as want:
        j_api.slot_batch_axes(reduced()[0])
    with pytest.raises(NotImplementedError) as got:
        api.slot_batch_axes(cfg)
    assert str(got.value) == str(want.value)
    cache = E.init_encdec_cache(cfg, 3, 16, 12, device="cpu")
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        "k": (2, 3, 16, 2, 16), "v": (2, 3, 16, 2, 16),
        "xk": (2, 3, 12, 2, 16), "xv": (2, 3, 12, 2, 16), "len": ()}
