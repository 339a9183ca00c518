"""The port's mixture-of-experts FFN and the moe family against the JAX
package on the CPU: ``_capacity``, ``_route``, ``_dispatch_combine`` (with
dropped pairs), ``moe_ffn_local``, the ``dense_residual`` branch, and
granite-moe-1b-a400m cut to ``tests/test_arch_smoke.py``'s ``reduce_cfg``
sizes (2 layers, d_model 64, 4 experts, top-2, expert d_ff 64) with JAX's
own capacity factor 1.25 as well as reduce_cfg's 8.0: prefill and decode
logits, and ``Engine`` streams over the contiguous, paged and int8 KV
caches. JAX's parameters cross over by ``weights.lm_params_from_numpy``.

Tolerances, each with its reason:

* ``_capacity``, the routed expert ids, ``_dispatch_combine`` given the
  same probabilities, ids and expert function (bf16 and float32: both
  sides sum a token's k contributions in index order in the compute
  dtype; JAX op by op, since under jit XLA fuses the weighting into the
  scatter-add) and greedy token streams: exact;
* router probabilities: the two softmaxes sum in another order, rtol 1e-6;
* ``moe_ffn_local`` and ``ffn_forward`` in float32: the expert matmuls sum
  in another order, atol 1e-5, rtol 1e-5; in bf16 the two sides round
  other intermediates to bf16 (each rounding 2^-8 of a value; XLA keeps
  some of the expert FFN's elementwise chain in float32), so most entries
  differ in their last bits: atol 2^-5, rtol 2^-6;
* prefill and decode logits (float32 compute): atol 1e-4, rtol 1e-3, as
  ``tests/test_torch_lm.py``.

Run here with ``PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q
tests/test_torch_moe.py``."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.configs.base import get_config as j_get_config  # noqa: E402
from repro.models import api as j_api  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402

from repro_torch.configs import MoEConfig, get_config  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import Engine, Request, ServeConfig  # noqa: E402
from repro_torch.weights import lm_params_from_numpy  # noqa: E402

#: tests/test_arch_smoke.py's reduce_cfg, float32 compute
REDUCED = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
               vocab=256, compute_dtype="float32")
DT = {"f32": (torch.float32, jnp.float32),
      "bf16": (torch.bfloat16, jnp.bfloat16)}


def j_init(cfg, seed):
    """JAX's parameters, one compiled call (op by op, JAX's init compiles
    each primitive on its own)."""
    return jax.jit(j_api.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(seed))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _reduce(arch, capacity_factor):
    """(JAX config, port config) of ``arch`` at reduce_cfg's sizes, with
    ``capacity_factor``."""
    jcfg = j_get_config(arch)
    kw = dict(REDUCED, moe=dataclasses.replace(
        jcfg.moe, num_experts=4, top_k=min(jcfg.moe.top_k, 2), d_ff=64,
        capacity_factor=capacity_factor))
    jcfg = dataclasses.replace(jcfg, **kw)
    cfg = dataclasses.replace(get_config(arch), **dict(
        kw, moe=MoEConfig(**dataclasses.asdict(kw["moe"]))))
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def granite(capacity_factor=1.25):
    """Reduced granite-moe-1b-a400m: JAX's parameters and the port's copy
    of them."""
    jcfg, cfg = _reduce("granite-moe-1b-a400m", capacity_factor)
    jparams = j_init(jcfg, 0)
    return jcfg, jparams, cfg, lm_params_from_numpy(_np(jparams),
                                                    device="cpu")


def _expert_params(rng, d, e, ff, act="silu"):
    p = {"router": rng.standard_normal((d, e)) * d ** -0.5,
         "w_up": rng.standard_normal((e, d, ff)) * d ** -0.5,
         "w_down": rng.standard_normal((e, ff, d)) * ff ** -0.5}
    if act == "silu":
        p["w_gate"] = rng.standard_normal((e, d, ff)) * d ** -0.5
    return {k: v.astype(np.float32) for k, v in p.items()}


# --------------------------------------------------------------- pieces --

@pytest.mark.parametrize("tokens,moe", [
    (8, (32, 8, 1.25)), (128, (32, 8, 1.25)), (8, (128, 2, 1.25)),
    (1, (4, 2, 1.25)), (16, (4, 2, 8.0)), (3, (16, 2, 1.25))])
def test_capacity_equals_jax(tokens, moe):
    e, k, cf = moe
    got = M._capacity(tokens, MoEConfig(e, k, 8, capacity_factor=cf))
    assert got == JM._capacity(tokens, JMoEConfig(e, k, 8,
                                                  capacity_factor=cf))
    assert got >= 1


@pytest.mark.parametrize("t,d,e,k", [(8, 64, 32, 8), (40, 64, 4, 2),
                                     (5, 16, 128, 2)])
def test_route_equals_jax(t, d, e, k):
    rng = np.random.default_rng(t * e)
    x = rng.standard_normal((t, d)).astype(np.float32)
    router = _expert_params(rng, d, e, 8)["router"]
    # ties: two tokens see experts 0, 1 and 2 at one logit, and one sees
    # every expert at the same logit (the lower index wins, as lax.top_k)
    router[:, 1] = router[:, 0]
    router[:, 2] = router[:, 0]
    x[-1] = 0.0
    jp, jids = JM._route(jnp.asarray(x, jnp.bfloat16), jnp.asarray(router),
                         k)
    p, ids = M._route(torch.from_numpy(x).to(torch.bfloat16),
                      torch.from_numpy(router), k)
    assert p.dtype == torch.float32 and tuple(ids.shape) == (t, k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(ids[-1].numpy(), np.arange(k))
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("t,e,k,cap", [(8, 32, 8, 2), (40, 4, 2, 3),
                                       (6, 8, 2, 1)])
def test_dispatch_combine_bitwise_with_drops(dtype, t, e, k, cap):
    tdt, jdt = DT[dtype]
    rng = np.random.default_rng(t + e + cap)
    x = rng.standard_normal((t, 16)).astype(np.float32)
    router = _expert_params(rng, 16, e, 8)["router"]
    jx = jnp.asarray(x, jdt)
    jp, jids = JM._route(jx, jnp.asarray(router), k)
    # a per-expert affine map, so a pair routed to the wrong row shows
    scale = np.linspace(0.5, 2.0, e).astype(np.float32)[:, None, None]
    # op by op: under jit XLA fuses the weighting into the scatter-add,
    # and float32 sums then differ in their last bits
    want = JM._dispatch_combine(jx, jp, jids,
                                lambda b: b * jnp.asarray(scale, jdt) + 1,
                                e, cap)
    got = M._dispatch_combine(
        torch.from_numpy(x).to(tdt), torch.from_numpy(np.asarray(jp)),
        torch.from_numpy(np.asarray(jids)).long(),
        lambda b: b * torch.from_numpy(scale).to(tdt) + 1, e, cap)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    # every case drops pairs: some expert is routed more than cap pairs
    counts = np.bincount(np.asarray(jids).reshape(-1), minlength=e)
    assert (counts > cap).any()


def _close_in_bf16(got, want):
    """bf16 outputs (module docstring): atol 2^-5, rtol 2^-6."""
    np.testing.assert_allclose(got, want, atol=2 ** -5, rtol=2 ** -6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("act,e,k,cf", [("silu", 8, 2, 1.25),
                                        ("gelu", 4, 2, 8.0),
                                        ("silu", 32, 8, 1.25)])
def test_moe_ffn_local_matches_jax(dtype, act, e, k, cf):
    tdt, jdt = DT[dtype]
    rng = np.random.default_rng(e * k)
    p = _expert_params(rng, 64, e, 32, act)
    x = rng.standard_normal((2, 12, 64)).astype(np.float32)
    want = jax.jit(JM.moe_ffn_local, static_argnums=(2, 3, 4))(
        jnp.asarray(x, jdt), {n: jnp.asarray(v) for n, v in p.items()},
        JMoEConfig(e, k, 32, capacity_factor=cf), act, jdt)
    got = M.moe_ffn_local(
        torch.from_numpy(x).to(tdt), {n: torch.from_numpy(v)
                                      for n, v in p.items()},
        MoEConfig(e, k, 32, capacity_factor=cf), act, tdt)
    assert got.dtype == tdt and tuple(got.shape) == x.shape
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        _close_in_bf16(got, want)
    assert M.moe_ffn(torch.from_numpy(x).to(tdt), {
        n: torch.from_numpy(v) for n, v in p.items()}, MoEConfig(
            e, k, 32, capacity_factor=cf), act, tdt).float().numpy() \
        .tolist() == got.tolist()


def test_moe_ffn_sharded_waits_for_roadmap():
    """``moe_ffn_sharded`` no longer refuses: outside a mesh it is
    ``moe_ffn_local`` bitwise, drops included (its mesh path:
    ``tests/test_torch_sharded.py``)."""
    gen = torch.Generator().manual_seed(0)
    moe = MoEConfig(4, 2, 8, capacity_factor=1.0)
    p = {"router": torch.randn(16, 4, generator=gen),
         "w_up": torch.randn(4, 16, 8, generator=gen),
         "w_gate": torch.randn(4, 16, 8, generator=gen),
         "w_down": torch.randn(4, 8, 16, generator=gen)}
    x = torch.randn(2, 6, 16, generator=gen)
    assert torch.equal(M.moe_ffn_sharded(x, p, moe, "silu", torch.float32),
                       M.moe_ffn_local(x, p, moe, "silu", torch.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dense_residual_ffn_forward_matches_jax(dtype):
    """arctic-480b's layer (reduced): the MoE FFN plus the dense FFN
    beside it, through ``ffn_forward`` on JAX's layer parameters."""
    tdt, jdt = DT[dtype]
    jcfg, cfg = _reduce("arctic-480b", 1.25)
    assert cfg.moe.dense_residual
    jparams = j_init(jcfg, 3)
    params = lm_params_from_numpy(_np(jparams), device="cpu")
    assert set(params["layers"]) == {"ln1", "ln2", "attn", "moe", "mlp"}
    x = np.random.default_rng(4).standard_normal((2, 8, 64)).astype(
        np.float32)
    jlp = jax.tree_util.tree_map(lambda v: v[1], jparams["layers"])
    want = jax.jit(JT.ffn_forward, static_argnums=(2, 3))(
        jlp, jnp.asarray(x, jdt), jcfg, jdt)
    got = T.ffn_forward(T._take(params["layers"], 1),
                        torch.from_numpy(x).to(tdt), cfg, tdt)
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        _close_in_bf16(got, want)
    assert cfg.param_count() == jcfg.param_count()


def test_init_and_cast_keep_jax_layout():
    """``init_lm`` draws JAX's tree (shapes, no ``mlp`` without
    ``dense_residual``), each stacked expert leaf contiguous;
    ``cast_params`` casts the experts and keeps the router; the JAX tree
    carried across keeps its (L, E, ., .) expert stacks."""
    jcfg, jparams, cfg, params = granite()
    mine = T.init_lm(cfg, torch.Generator().manual_seed(0))
    shapes = jax.tree_util.tree_map(lambda v: tuple(v.shape), jparams)
    assert jax.tree_util.tree_map(lambda v: tuple(v.shape), mine) == shapes
    assert all(v.is_contiguous() for v in mine["layers"]["moe"].values())
    n = sum(v.numel() for v in jax.tree_util.tree_leaves(mine))
    assert n == cfg.param_count() + cfg.d_model
    e, d, ff = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff
    assert params["layers"]["moe"]["w_gate"].shape == (2, e, d, ff)
    assert params["layers"]["moe"]["w_down"].shape == (2, e, ff, d)
    bf = dataclasses.replace(cfg, compute_dtype="bfloat16")
    cast = T.cast_params(params, bf)["layers"]["moe"]
    assert cast["w_up"].dtype == torch.bfloat16
    assert cast["router"] is params["layers"]["moe"]["router"]
    assert params["layers"]["moe"]["w_up"].dtype == torch.float32


# ------------------------------------------------------------- the model --

@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_prefill_and_decode_logits_track_jax(cf):
    """Right-padded prefill (the pads route and take capacity on both
    sides) and four decode steps."""
    jcfg, jparams, cfg, params = granite(cf)
    rng = np.random.default_rng(21)
    lens, max_len = [5, 11], 24
    toks = rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    jl, jc = j_api.prefill_fn(jcfg, max_len)(
        jparams, {"tokens": jnp.asarray(toks),
                  "prompt_lens": jnp.asarray(lens, jnp.int32)})
    tl, tc = api.prefill_fn(cfg, max_len)(
        params, {"tokens": torch.from_numpy(toks).long(),
                 "prompt_lens": torch.tensor(lens, dtype=torch.int32)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-3,
                               atol=1e-4)
    jdec, tdec = j_api.decode_fn(jcfg), api.decode_fn(cfg)
    for _ in range(4):
        cur = np.argmax(np.asarray(jl)[:, -1], axis=-1)[:, None] \
            .astype(np.int32)
        jl, jc = jdec(jparams, jnp.asarray(cur), jc)
        tl, tc = tdec(params, torch.from_numpy(cur).long(), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-3,
                                   atol=1e-4)
    assert tc["len"].tolist() == [n + 4 for n in lens]


def _requests(cls, vocab, specs):
    rng = np.random.default_rng(22)
    return [cls(uid=i, prompt=rng.integers(0, vocab, (plen,)).astype(
        np.int32), max_new_tokens=new) for i, (plen, new) in enumerate(specs)]


#: more requests than slots, a prompt past the first bucket, refills
SPECS = [(5, 6), (9, 3), (17, 5), (4, 1), (7, 7)]


def _drain(engine, reqs):
    for r in reqs:
        engine.submit(r)
    return sorted(engine.run_until_drained(), key=lambda r: r.uid)


@pytest.mark.parametrize("cf,kw", [
    (1.25, {}), (1.25, dict(kv_layout="paged", kv_block_size=8)),
    (1.25, dict(kv_cache="int8")), (8.0, {})],
    ids=["contiguous", "paged", "kv8", "contiguous-cf8"])
def test_engine_streams_equal_jax(cf, kw):
    """The float engine's greedy streams equal JAX's float engine's over
    each KV backing; a decode step routes the free slots too, so a slot's
    stream depends on the others' (capacity drops at factor 1.25)."""
    jcfg, jparams, cfg, params = granite(cf)
    scfg = dict(max_batch=3, max_len=32, **kw)
    jdone = _drain(JEngine(jcfg, jparams, JServeConfig(**scfg)),
                   _requests(JRequest, cfg.vocab, SPECS))
    eng = Engine(cfg, params, ServeConfig(**scfg))
    done = _drain(eng, _requests(Request, cfg.vocab, SPECS))
    assert [r.status for r in done] == ["ok"] * len(SPECS)
    assert [r.out_tokens for r in done] == [r.out_tokens for r in jdone]
    assert [len(r.out_tokens) for r in done] == [n for _, n in SPECS]
    if eng.pool is not None:
        assert eng.pool.audit(expect_drained=True) == []


def test_engine_refuses_integer_precision_with_jax_message():
    jcfg, jparams, cfg, params = granite()
    with pytest.raises(NotImplementedError) as want:
        JEngine(jcfg, jparams, JServeConfig(precision="int8"))
    for prec in ("int8", "w4a8-torch"):
        with pytest.raises(NotImplementedError) as got:
            Engine(cfg, params, ServeConfig(precision=prec))
        assert str(got.value) == str(want.value)
