"""The configs the port registers and the vlm family and dense configs
beyond Qwen2-0.5B, against the JAX package on the CPU: every registered
config's fields and ``param_count`` (and ``param_count`` of every JAX
architecture id), the stacked draws of ``init_lm``, internvl2-1b with its
``embeds`` prefix through ``prefill_fn`` / ``decode_fn`` and served
text-only by ``Engine``, and granite-3-2b, granite-34b (gelu, one KV head)
and qwen1.5-32b (40 KV heads, qkv bias) at ``tests/test_arch_smoke.py``'s
``reduce_cfg`` sizes (2 layers, d_model 64, d_ff 128, vocab 256; the
number of KV heads kept where it is the point), float32 compute. JAX's
parameters cross over by ``weights.lm_params_from_numpy``.

Tolerances, each with its reason:

* config fields, parameter counts, the prefill with ``embeds`` of a token
  prefix against the prefill of those tokens (the port against itself)
  and greedy token streams: exact;
* prefill and decode logits: the two frameworks sum in another order
  (float32 rounding): atol 1e-4, rtol 1e-3, as ``tests/test_torch_lm.py``;
  the prefilled K/V: atol 1e-2, rtol 1e-2 (the bf16 cache can round an
  element of the two sides to neighbouring bf16 values).

Run here with ``PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q
tests/test_torch_families.py``."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.base import ARCH_IDS  # noqa: E402
from repro.configs.base import get_config as j_get_config  # noqa: E402
from repro.models import api as j_api  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402

from repro_torch.configs import (MambaConfig, ModelConfig,  # noqa: E402
                                 MoEConfig, get_config, registered)
from repro_torch.models import api  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.blocks import stacked_normal  # noqa: E402
from repro_torch.serve import Engine, Request, ServeConfig  # noqa: E402
from repro_torch.weights import lm_params_from_numpy  # noqa: E402

#: the JAX architecture ids the port registers; jamba-v0.1-52b (hybrid)
#: and seamless-m4t-large-v2 (encdec) come with their families
PORTED = sorted(set(ARCH_IDS) - {"jamba-v0.1-52b", "seamless-m4t-large-v2"})
REDUCED = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
               vocab=256, compute_dtype="float32")


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def port_config(jcfg) -> ModelConfig:
    """The port's ModelConfig of a JAX ModelConfig, field for field."""
    kw = dataclasses.asdict(jcfg)
    if jcfg.moe is not None:
        kw["moe"] = MoEConfig(**kw["moe"])
    if jcfg.mamba is not None:
        kw["mamba"] = MambaConfig(**kw["mamba"])
    return ModelConfig(**kw)


@functools.lru_cache(maxsize=None)
def reduced(arch, **kw):
    """(JAX config, JAX params, port config, port params) of ``arch`` at
    reduce_cfg's sizes (vlm: 4 patch positions), with ``kw`` on top."""
    jcfg = j_get_config(arch)
    over = dict(REDUCED, **kw)
    if jcfg.family == "vlm":
        over["frontend_positions"] = 4
    jcfg = dataclasses.replace(jcfg, **over)
    jparams = jax.jit(j_api.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    return (jcfg, jparams, port_config(jcfg),
            lm_params_from_numpy(_np(jparams), device="cpu"))


# -------------------------------------------------------------- configs --

def test_registry_holds_the_ported_configs():
    assert registered() == PORTED


@pytest.mark.parametrize("arch", PORTED)
def test_registered_config_equals_jax(arch):
    jcfg, cfg = j_get_config(arch), get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg == port_config(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.head_dim == jcfg.head_dim


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_count_equals_jax_for_every_arch(arch):
    """The analytic count of all ten architectures, the hybrid and encdec
    ones included (their configs are built from JAX's fields)."""
    jcfg = j_get_config(arch)
    assert port_config(jcfg).param_count() == jcfg.param_count()


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "seamless-m4t-large-v2"])
def test_unregistered_config_is_a_key_error(arch):
    with pytest.raises(KeyError, match="granite-moe-1b-a400m"):
        get_config(arch)


def test_hybrid_and_encdec_raise_naming_roadmap():
    for arch in ("jamba-v0.1-52b", "seamless-m4t-large-v2"):
        cfg = port_config(j_get_config(arch))
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            T.init_lm(cfg, torch.Generator().manual_seed(0))
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            api.prefill_fn(cfg, 16)


def test_stacked_draws_equal_single_layer_draws():
    """``init_lm``'s stacked FFN and expert leaves are allocated once and
    filled layer by layer with the draws that one call per layer makes."""
    shapes = {"w_up": ((8, 12), 0.5), "w_down": ((12, 8), 0.25)}
    stacked = stacked_normal(torch.Generator().manual_seed(3), shapes,
                             torch.float32, n_layers=3)
    g = torch.Generator().manual_seed(3)
    layers = [stacked_normal(g, shapes, torch.float32) for _ in range(3)]
    for k in shapes:
        assert stacked[k].is_contiguous()
        assert torch.equal(stacked[k], torch.stack([lp[k] for lp in layers]))
    _, jparams, cfg, _ = reduced("granite-3-2b")
    mine = T.init_lm(cfg, torch.Generator().manual_seed(0))
    assert jax.tree_util.tree_map(lambda v: tuple(v.shape), mine) \
        == jax.tree_util.tree_map(lambda v: tuple(v.shape), jparams)


# ------------------------------------------------------------------ vlm --

def test_vlm_prefill_with_embeds_and_decode_track_jax():
    """internvl2-1b: 4 patch embeddings ahead of right-padded tokens;
    ``prompt_lens`` and ``len`` count the patches."""
    jcfg, jparams, cfg, params = reduced("internvl2-1b")
    rng = np.random.default_rng(31)
    p, lens, max_len = cfg.frontend_positions, [4 + 5, 4 + 10], 24
    toks = rng.integers(0, cfg.vocab, (2, 10)).astype(np.int32)
    embeds = rng.standard_normal((2, p, cfg.d_model)).astype(np.float32)
    jl, jc = j_api.prefill_fn(jcfg, max_len)(jparams, {
        "tokens": jnp.asarray(toks), "embeds": jnp.asarray(embeds),
        "prompt_lens": jnp.asarray(lens, jnp.int32)})
    tl, tc = api.prefill_fn(cfg, max_len)(params, {
        "tokens": torch.from_numpy(toks).long(),
        "embeds": torch.from_numpy(embeds),
        "prompt_lens": torch.tensor(lens, dtype=torch.int32)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-3,
                               atol=1e-4)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].float().numpy(),
                                   np.asarray(jc[k], np.float32),
                                   rtol=1e-2, atol=1e-2)
    jdec, tdec = j_api.decode_fn(jcfg), api.decode_fn(cfg)
    for _ in range(3):
        cur = np.argmax(np.asarray(jl)[:, -1], axis=-1)[:, None] \
            .astype(np.int32)
        jl, jc = jdec(jparams, jnp.asarray(cur), jc)
        tl, tc = tdec(params, torch.from_numpy(cur).long(), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-3,
                                   atol=1e-4)
    assert tc["len"].tolist() == [n + 3 for n in lens]
    # without prompt_lens the length is the patches plus the tokens
    _, plain = api.prefill_fn(cfg, max_len)(params, {
        "tokens": torch.from_numpy(toks).long(),
        "embeds": torch.from_numpy(embeds)})
    assert int(plain["len"]) == p + toks.shape[1]


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_embeds_of_tokens_equal_the_tokens_prefill(compute):
    """A prefill whose ``embeds`` are the embeddings of ``tokens_a``,
    followed by ``tokens_b``, gives the logits and cache of the prefill of
    ``tokens_a ++ tokens_b``, bit for bit."""
    _, _, cfg, params = reduced("internvl2-1b")
    cfg = dataclasses.replace(cfg, compute_dtype=compute)
    rng = np.random.default_rng(32)
    a = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 4))).long()
    b = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 7))).long()
    lens = torch.tensor([9, 11], dtype=torch.int32)
    pre = api.prefill_fn(cfg, 16)
    got_l, got_c = pre(params, {"tokens": b, "embeds": params["embed"][a],
                                "prompt_lens": lens})
    want_l, want_c = pre(params, {"tokens": torch.cat([a, b], dim=1),
                                  "prompt_lens": lens})
    assert torch.equal(got_l, want_l)
    for k in ("k", "v", "len"):
        assert torch.equal(got_c[k], want_c[k])


def _requests(cls, vocab, specs):
    rng = np.random.default_rng(33)
    return [cls(uid=i, prompt=rng.integers(0, vocab, (plen,)).astype(
        np.int32), max_new_tokens=new) for i, (plen, new) in enumerate(specs)]


SPECS = [(5, 6), (9, 3), (17, 5), (4, 1), (7, 7)]


def _streams_equal(arch, port_prec="float", jax_prec="float", **kw):
    jcfg, jparams, cfg, params = reduced(arch, **kw)
    scfg = dict(max_batch=2, max_len=32)
    jeng = JEngine(jcfg, jparams, JServeConfig(precision=jax_prec, **scfg))
    eng = Engine(cfg, params, ServeConfig(precision=port_prec, **scfg))
    streams = []
    for e, cls in ((jeng, JRequest), (eng, Request)):
        for r in _requests(cls, cfg.vocab, SPECS):
            e.submit(r)
        done = sorted(e.run_until_drained(), key=lambda r: r.uid)
        assert [r.status for r in done] == ["ok"] * len(SPECS)
        streams.append([r.out_tokens for r in done])
    assert streams[1] == streams[0]
    assert [len(s) for s in streams[1]] == [n for _, n in SPECS]


@pytest.mark.parametrize("port,ref", [("float", "float"),
                                      ("int8-torch", "int8-xla")])
def test_vlm_engine_serves_text_only_as_jax(port, ref):
    _streams_equal("internvl2-1b", port, ref)


# ---------------------------------------------------------- dense configs --

#: the dense configs beyond Qwen2-0.5B, each with what its reduction keeps
DENSE = {"granite-3-2b": {}, "granite-34b": dict(n_kv_heads=1),
         "qwen1.5-32b": dict(n_kv_heads=4)}


@pytest.mark.parametrize("arch", sorted(DENSE))
def test_dense_prefill_and_decode_track_jax(arch):
    jcfg, jparams, cfg, params = reduced(arch, **DENSE[arch])
    assert cfg.act == j_get_config(arch).act
    rng = np.random.default_rng(34)
    lens, max_len = [6, 12], 24
    toks = rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    jl, jc = j_api.prefill_fn(jcfg, max_len)(
        jparams, {"tokens": jnp.asarray(toks),
                  "prompt_lens": jnp.asarray(lens, jnp.int32)})
    tl, tc = api.prefill_fn(cfg, max_len)(
        params, {"tokens": torch.from_numpy(toks).long(),
                 "prompt_lens": torch.tensor(lens, dtype=torch.int32)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-3,
                               atol=1e-4)
    assert tc["k"].shape[3] == cfg.n_kv_heads
    jdec, tdec = j_api.decode_fn(jcfg), api.decode_fn(cfg)
    for _ in range(3):
        cur = np.argmax(np.asarray(jl)[:, -1], axis=-1)[:, None] \
            .astype(np.int32)
        jl, jc = jdec(jparams, jnp.asarray(cur), jc)
        tl, tc = tdec(params, torch.from_numpy(cur).long(), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-3,
                                   atol=1e-4)


def test_granite_34b_engine_streams_equal_jax():
    """gelu FFN, one KV head, untied unembedding."""
    _streams_equal("granite-34b", **DENSE["granite-34b"])
