"""The port's hybrid (Jamba) family against the JAX package on the CPU:
jamba-v0.1-52b cut to ``tests/test_arch_smoke.py``'s ``reduce_cfg`` sizes
(8 layers, one super-block of 7 Mamba sublayers and 1 attention sublayer
at offset 4, d_model 64, 4 heads of which 2 KV, d_ff 128, vocab 256, 4
experts top-2 with expert d_ff 64 on every other sublayer), and at 16
layers (two super-blocks, so the block stacking is exercised), float32
compute, the experts at Jamba's own capacity factor 1.25 (a decode step
drops pairs, so a slot's output depends on the other slots). Both sides
compute from the same seeded numpy weights, the port's converted by
``weights.lm_params_from_numpy``.
Covered: the parameter tree, ``_hybrid_block_with_state`` (hidden state,
k, v, conv, ssm), ``prefill`` (logits and cache) and four chained
``decode_step``s, ``causal_conv1d`` once per Mamba sublayer a prefill,
the slot writes, ``cast_params``, the ``Engine``'s greedy streams against
JAX's continuous and static engines and the engine's gates.

Tolerances, each with its reason:

* parameter trees, launch counts, error messages and greedy token
  streams: exact;
* a super-block's hidden state, K/V and states in float32: the two
  frameworks sum the matmuls, the experts and the scan in another order
  (``lax.associative_scan`` against a doubling scan): atol and rtol 1e-5,
  as ``tests/test_torch_mamba.py``'s float32 Mamba block and
  ``tests/test_torch_moe.py``'s float32 FFN;
* prefill and decode logits: atol 1e-4, rtol 1e-3, as
  ``tests/test_torch_lm.py``; the bf16 cache leaves (K/V, conv state):
  atol and rtol 1e-2, as ``tests/test_torch_families.py``; the float32
  ssm state after the prefill: rtol 1e-4, atol 1e-5, and after the decode
  steps rtol 1e-3, atol 1e-4, as ``tests/test_torch_mamba.py``;
* the step over ``cast_params``' weights against the step over the
  uncast ones: exact.

Run here with ``PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q
tests/test_torch_hybrid.py``."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.check.config import kv_cache_bytes as j_kv_cache_bytes  # noqa: E402
from repro.configs.base import get_config as j_get_config  # noqa: E402
from repro.models import api as j_api  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402

from repro_torch.check.config import kv_cache_bytes  # noqa: E402
from repro_torch.configs import MoEConfig, get_config  # noqa: E402
from repro_torch.models import api, mamba  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import Engine, Request, ServeConfig  # noqa: E402
from repro_torch.weights import lm_params_from_numpy  # noqa: E402

ARCH = "jamba-v0.1-52b"
#: tests/test_arch_smoke.py's reduce_cfg for hybrid, float32 compute
REDUCED = dict(n_layers=8, attn_period=8, attn_offset=4, d_model=64,
               n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
               compute_dtype="float32")
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
    normal matrices * fan_in^-1/2, unit norms and ``D``, zero biases,
    ``A_log`` = log(1..N), ``dt_bias`` the inverse softplus of a step in
    [0.001, 0.1]."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: j_api.init_params(
        jcfg, jax.random.PRNGKey(0)))

    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        if name.startswith("ln") or name.endswith("_norm") or name == "D":
            return np.ones(shape, np.float32)
        if name in ("conv_b", "bq", "bk", "bv"):
            return np.zeros(shape, np.float32)
        if name == "A_log":
            a = np.log(np.arange(1, shape[-1] + 1, dtype=np.float32))
            return np.broadcast_to(a, shape).copy()
        if name == "dt_bias":
            dt = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), shape))
            return np.log(np.expm1(dt)).astype(np.float32)
        std = 0.02 if name == "embed" else shape[-2] ** -0.5
        return (rng.standard_normal(shape) * std).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=None)
def reduced(n_layers=8):
    """(JAX config, JAX params, port config, port params) at reduce_cfg's
    sizes with ``n_layers``, the experts at Jamba's own capacity factor
    1.25; the same numpy weights on both sides."""
    jcfg = j_get_config(ARCH)
    moe = dataclasses.replace(jcfg.moe, num_experts=4, top_k=2, d_ff=64)
    kw = dict(REDUCED, n_layers=n_layers)
    jcfg = dataclasses.replace(jcfg, moe=moe, **kw)
    cfg = dataclasses.replace(get_config(ARCH), **kw, moe=MoEConfig(
        **dataclasses.asdict(moe)))
    weights = numpy_params(jcfg, n_layers)
    return (jcfg, jax.tree_util.tree_map(jnp.asarray, weights), cfg,
            lm_params_from_numpy(weights, device="cpu"))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


# ------------------------------------------------------------ parameters --

@pytest.mark.parametrize("n_layers", [8, 16])
def test_init_keeps_jax_layout_and_count(n_layers):
    jcfg, jparams, cfg, params = reduced(n_layers)
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(j_get_config(ARCH))
    mine = T.init_lm(cfg, torch.Generator().manual_seed(0))
    shapes = jax.tree_util.tree_map(lambda v: tuple(v.shape), jparams)
    assert jax.tree_util.tree_map(lambda v: tuple(v.shape), mine) == shapes
    nb = n_layers // 8
    assert tuple(mine["blocks"]["mamba"]["in_proj"].shape) == \
        (nb, 7, 64, 256)
    assert tuple(mine["blocks"]["moe"]["w_up"].shape) == (nb, 4, 4, 64, 64)
    assert tuple(mine["blocks"]["mlp"]["w_down"].shape) == (nb, 4, 128, 64)
    leaves = jax.tree_util.tree_leaves(mine)
    assert all(v.is_contiguous() for v in leaves)
    # the analytic count leaves out the final norm, in both packages
    assert sum(v.numel() for v in leaves) == cfg.param_count() + 64
    assert cfg.param_count() == jcfg.param_count()
    assert jax.tree_util.tree_map(lambda v: tuple(v.shape), params) == shapes
    for got, want in zip(jax.tree_util.tree_leaves(params),
                         jax.tree_util.tree_leaves(jparams)):
        assert np.array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------- block --

def test_hybrid_block_with_state_matches_jax():
    """Block 1 of the two-block model over a 9-token prompt (flash
    attention, the serving default): hidden state,
    the attention sublayer's K/V padded to max_len, the 7 Mamba
    sublayers' conv and ssm states."""
    jcfg, jparams, cfg, params = reduced(16)
    rng = np.random.default_rng(7)
    h = (rng.standard_normal((2, 9, 64)) * 0.5).astype(np.float32)
    jbp = jax.tree_util.tree_map(lambda v: v[1], jparams["blocks"])
    want_h, want = jax.jit(JT._hybrid_block_with_state,
                           static_argnums=(2, 3, 4, 5))(
        jnp.asarray(h), jbp, jcfg, jnp.float32, "flash", 16)
    got_h, got = T._hybrid_block_with_state(
        torch.from_numpy(h), T._take(params["blocks"], 1), cfg,
        torch.float32, "flash", 16)
    _close(got_h, want_h, F32_TOL)
    assert set(got) == set(want) == {"k", "v", "conv", "ssm"}
    for key in got:
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        _close(got[key], want[key], F32_TOL)
    assert tuple(got["conv"].shape) == (7, 2, 3, 128)
    assert not got["k"][:, 9:].any()


# ----------------------------------------------------------------- model --

def _port_cache(jcache, like):
    """JAX's cache as the port's tensors, in the dtypes of ``like``."""
    return {k: torch.from_numpy(np.array(jnp.asarray(v, jnp.float32)))
            .to(like[k].dtype) for k, v in jcache.items()}


@pytest.mark.parametrize("n_layers,with_lens", [(8, False), (8, True),
                                               (16, False)])
def test_prefill_and_four_decode_steps_track_jax(n_layers, with_lens):
    """The prefill's logits and cache, then four chained decode steps. Each
    step's logits and state are held against JAX's step over the same
    cache (JAX's, copied in): the two sides' bf16 caches differ in a few
    elements that round to neighbouring bf16 values (3 of 5,376 conv
    elements after this prefill at 8 layers), and seven Mamba sublayers a
    block carry such a difference on into the logits. Along the port's own
    chained cache the greedy tokens equal JAX's."""
    jcfg, jparams, cfg, params = reduced(n_layers)
    rng = np.random.default_rng(n_layers)
    toks = rng.integers(0, 256, (2, 9)).astype(np.int32)
    batch_j, batch_t = ({"tokens": jnp.asarray(toks)},
                        {"tokens": torch.from_numpy(toks).long()})
    if with_lens:               # exact lengths, as the engine passes them
        batch_j["prompt_lens"] = jnp.asarray([9, 9], jnp.int32)
        batch_t["prompt_lens"] = torch.tensor([9, 9], dtype=torch.int32)
    jl, jc = jax.jit(j_api.prefill_fn(jcfg, 16))(jparams, batch_j)
    tl, tc = api.prefill_fn(cfg, 16)(params, batch_t)
    _close(tl, jl, LOGIT_TOL)
    assert set(tc) == set(jc) == {"k", "v", "conv", "ssm", "len"}
    for key in ("k", "v", "conv"):
        assert tc[key].dtype == torch.bfloat16
        assert tuple(tc[key].shape) == tuple(jc[key].shape), key
        _close(tc[key], jc[key], CACHE_TOL)
    assert tc["ssm"].dtype == torch.float32
    _close(tc["ssm"], jc["ssm"], dict(rtol=1e-4, atol=1e-5))
    jdec, tdec = jax.jit(j_api.decode_fn(jcfg)), api.decode_fn(cfg)
    for _ in range(4):
        cur = np.argmax(np.asarray(jl)[:, -1], -1)[:, None].astype(np.int32)
        same = _port_cache(jc, tc)
        k_before, conv_before = tc["k"], tc["conv"]
        jl, jc = jdec(jparams, jnp.asarray(cur), jc)
        sl, sc = tdec(params, torch.from_numpy(cur).long(), same)
        _close(sl, jl, LOGIT_TOL)
        _close(sc["ssm"], jc["ssm"], dict(rtol=1e-3, atol=1e-4))
        _close(sc["conv"], jc["conv"], CACHE_TOL)
        _close(sc["k"], jc["k"], CACHE_TOL)
        tl, tc = tdec(params, torch.from_numpy(cur).long(), tc)
        assert tc["k"] is k_before and tc["conv"] is conv_before
        np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                      np.argmax(np.asarray(jl), -1))
    assert np.asarray(tc["len"]).tolist() == np.asarray(jc["len"]).tolist()


@pytest.mark.parametrize("n_layers", [8, 16])
def test_prefill_runs_causal_conv1d_once_per_mamba_sublayer(n_layers,
                                                            monkeypatch):
    """7 calls per super-block a prefill (the CUDA kernel on a card), none
    a decode step."""
    _, _, cfg, params = reduced(n_layers)
    calls = []
    real = mamba.K.causal_conv1d

    def spy(x, w, **kw):
        calls.append(tuple(x.shape))
        return real(x, w, **kw)
    monkeypatch.setattr(mamba.K, "causal_conv1d", spy)
    logits, cache = T.prefill(params, torch.zeros((1, 5), dtype=torch.long),
                              cfg, 8)
    assert calls == [(1, 5, 128)] * (7 * n_layers // 8)
    T.decode_step(params, logits.argmax(-1), cache, cfg)
    assert len(calls) == 7 * n_layers // 8


def test_slot_cache_write_and_free():
    """K/V at the slot axis 1, conv and ssm at axis 2 (JAX's
    ``slot_batch_axes``), written in place."""
    jcfg, _, cfg, params = reduced(16)
    assert api.slot_batch_axes(cfg) == j_api.slot_batch_axes(jcfg) == \
        {"k": 1, "v": 1, "conv": 2, "ssm": 2}
    live = api.init_slot_cache(cfg, 3, 16, device="cpu")
    shapes = {k: tuple(v.shape) for k, v in live.items()}
    jshapes = {k: tuple(v.shape) for k, v in
               j_api.init_slot_cache(jcfg, 3, 16).items()}
    assert shapes == jshapes == {
        "k": (2, 3, 16, 2, 16), "v": (2, 3, 16, 2, 16),
        "conv": (2, 7, 3, 3, 128), "ssm": (2, 7, 3, 128, 16), "len": (3,)}
    before = dict(live)
    _, fresh = T.prefill(params, torch.tensor([[4, 5, 6, 7]]), cfg, 16,
                         prompt_lens=[4])
    api.cache_write_slot(cfg, live, fresh, 1)
    assert all(live[k] is before[k] for k in live)
    assert live["len"].tolist() == [0, 4, 0]
    assert torch.equal(live["k"][:, 1], fresh["k"][:, 0])
    assert torch.equal(live["conv"][:, :, 1], fresh["conv"][:, :, 0])
    assert torch.equal(live["ssm"][:, :, 1], fresh["ssm"][:, :, 0])
    assert not live["ssm"][:, :, 0].any() and not live["ssm"][:, :, 2].any()
    api.cache_free_slot(live, 1)
    assert live["len"].tolist() == [0, 0, 0]


def test_cast_params_gives_the_uncast_step_bitwise():
    """bfloat16 compute: the cast weights give the values each use would
    cast to; ``A_log`` and the router stay float32, the norms and the
    embedding as they are."""
    _, _, cfg, params = reduced(16)
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    cast = T.cast_params(params, cfg)
    bp = cast["blocks"]
    assert bp["mamba"]["in_proj"].dtype == torch.bfloat16
    assert bp["mamba"]["A_log"] is params["blocks"]["mamba"]["A_log"]
    assert bp["moe"]["router"] is params["blocks"]["moe"]["router"]
    assert bp["moe"]["w_up"].dtype == torch.bfloat16
    assert bp["attn"]["wq"].dtype == bp["mlp"]["w_gate"].dtype \
        == torch.bfloat16
    assert bp["ln_mix"] is params["blocks"]["ln_mix"]
    toks = torch.tensor([[3, 1, 4, 1, 5, 9]])
    outs = []
    for p in (params, cast):
        logits, cache = T.prefill(p, toks, cfg, 12)
        step, _ = T.decode_step(p, logits.argmax(-1), cache, cfg)
        outs.append((logits, step))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


# ---------------------------------------------------------------- engine --

#: more requests than slots, three prompt lengths (each one prefill graph
#: for JAX), one as long as the conv window's K-1 = 3 positions (JAX's
#: Pallas conv reads a short halo below that, ROADMAP.md C), refills
#: mid-decode
SPECS = [(5, 6), (3, 3), (9, 5), (3, 4), (5, 1), (9, 7)]


def _requests(cls, specs):
    rng = np.random.default_rng(31)
    return [cls(uid=i, prompt=rng.integers(0, 256, (plen,)).astype(np.int32),
                max_new_tokens=new) for i, (plen, new) in enumerate(specs)]


def _drain(engine, reqs):
    for r in reqs:
        engine.submit(r)
    return sorted(engine.run_until_drained(), key=lambda r: r.uid)


@pytest.mark.parametrize("scheduler", ["continuous", "static"])
def test_engine_streams_equal_jax(scheduler):
    """The port's engine serves the streams of JAX's engine under the same
    scheduler: continuous (each prompt prefilled at its exact length) and
    static (prompts left-padded to the batch's longest)."""
    jcfg, jparams, cfg, params = reduced(8)
    scfg = dict(max_batch=3, max_len=32, scheduler=scheduler)
    jeng = JEngine(jcfg, jparams, JServeConfig(**scfg))
    jdone = _drain(jeng, _requests(JRequest, SPECS))
    eng = Engine(cfg, params, ServeConfig(**scfg))
    done = _drain(eng, _requests(Request, SPECS))
    assert [r.status for r in done] == ["ok"] * len(SPECS)
    assert [r.out_tokens for r in done] == [r.out_tokens for r in jdone]
    assert [len(r.out_tokens) for r in done] == [n for _, n in SPECS]
    assert eng.stats["prefills"] == jeng.stats["prefills"]
    assert eng.stats["decode_steps"] == jeng.stats["decode_steps"]


def test_static_left_pads_change_short_prompts_streams():
    """The static scheduler's left pads run through the recurrence, so a
    prompt shorter than its batch's longest gets another stream than under
    the continuous scheduler (each scheduler's streams equal JAX's:
    :func:`test_engine_streams_equal_jax`); the longest prompt of each
    batch keeps its stream. At capacity factor 8, where no pair is
    dropped and so no slot's output depends on another's."""
    _, _, cfg, params = reduced(8)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
    streams = {}
    for sched in ("continuous", "static"):
        done = _drain(Engine(cfg, params, ServeConfig(
            max_batch=3, max_len=32, scheduler=sched)),
            _requests(Request, SPECS))
        streams[sched] = [r.out_tokens for r in done]
    # batches (0, 1, 2) and (3, 4, 5): 9 tokens is each batch's longest
    for i in (2, 5):
        assert streams["static"][i] == streams["continuous"][i]
    assert all(streams["static"][i] != streams["continuous"][i]
               for i in (0, 1, 3))


@pytest.mark.parametrize("kw", [
    dict(precision="int8"), dict(precision="w4a8-torch"),
    dict(kv_cache="int8"), dict(kv_layout="paged"),
    dict(scheduler="static", kv_cache="int8"),
    dict(scheduler="static", kv_layout="paged")],
    ids=["int8", "w4a8-torch", "kv8", "paged", "static-kv8", "static-paged"])
def test_engine_gates_raise_jax_messages(kw):
    jcfg, jparams, cfg, params = reduced(8)
    jkw = dict(kw, precision="int8") if "precision" in kw else kw
    with pytest.raises(NotImplementedError) as want:
        JEngine(jcfg, jparams, JServeConfig(**jkw))
    with pytest.raises(NotImplementedError) as got:
        Engine(cfg, params, ServeConfig(**kw))
    assert str(got.value) == str(want.value)


def test_model_entry_points_refuse_the_integer_ffn_and_int8_kv():
    _, _, cfg, params = reduced(8)
    for fn in (lambda: api.prefill_fn(cfg, 16, precision="int8"),
               lambda: api.decode_fn(cfg, precision="w4a8")):
        with pytest.raises(NotImplementedError, match="integer-FFN"):
            fn()
    with pytest.raises(NotImplementedError, match="int8 KV slot cache"):
        api.init_slot_cache(cfg, 2, 16, kv="int8", device="cpu")
    with pytest.raises(NotImplementedError, match="paged KV cache"):
        api.init_paged_cache(cfg, 2, 8, 8, 16, device="cpu")


def test_kv_cache_bytes_mirrors_jax_overcount():
    """JAX's ``kv_cache_bytes`` counts every layer of a hybrid model as an
    attention layer (attn_period times its nb attention sublayers' K/V,
    and no Mamba state); the port's mirrors it."""
    jcfg, cfg = j_get_config(ARCH), get_config(ARCH)
    kw = dict(max_batch=8, max_len=256)
    got = kv_cache_bytes(cfg, ServeConfig(**kw))
    assert got == j_kv_cache_bytes(jcfg, JServeConfig(**kw))
    nb = cfg.n_layers // cfg.attn_period
    attn_kv = nb * 2 * 8 * 256 * cfg.n_kv_heads * cfg.head_dim * 2
    assert got == cfg.attn_period * attn_kv
