"""The port's paged KV cache against the JAX package on the CPU: the
config checks (``paged_num_blocks``, ``kv_cache_bytes``, the paged and
``hbm_budget`` checks), the paged attention and cache helpers, the paged
``decode_step``, ``prefill_suffix``, ``flash_attention_tri``, the
``BlockPool``, and ``Engine(kv_layout="paged")`` with its prefix cache,
backpressure, preemption and fault seams, on the same seeded numpy inputs
and JAX's own parameters carried across.

The behaviours are those ``tests/test_paged.py`` encodes for the JAX
engine. Two tiny Qwen2 stacks serve them: float32 compute, where the
port's streams, gauges and pool audits are held against JAX's engine on
the same parameters, and the config's bfloat16 compute (``test_paged.py``'s
``tiny_cfg``), where the two frameworks' bf16 matmuls may round apart, so
the port's paged streams are held against its own contiguous ones and
``prefill_suffix`` against its own full prefill.

Tolerances, each with its reason:

* streams, gauges, page ids, refcounts, digests, audits, int8 codes and
  scales, and every page the helpers write are compared exactly;
* the paged decode's and ``prefill_suffix``'s logits against the port's
  contiguous decode and full prefill: bitwise (the same products on the
  same values);
* ``flash_attention_tri`` against JAX's and against the port's
  ``flash_attention``: atol 2e-6, rtol 1e-5 in float32 (a chunk's
  online softmax sums its KV blocks in another order than one scan).

Run here with ``PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q
tests/test_torch_paged.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.check import config as j_check  # noqa: E402
from repro.configs.base import get_config as j_get_config  # noqa: E402
from repro.faults.inject import FaultPlan as JFaultPlan  # noqa: E402
from repro.faults.inject import FaultSpec as JFaultSpec  # noqa: E402
from repro.models import api as j_api  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.serve.engine import BlockPool as JBlockPool  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402

from repro_torch.check import config as check  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.faults import FaultPlan, FaultSpec  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.serve import Engine, Request, ServeConfig  # noqa: E402
from repro_torch.serve.engine import BlockPool  # noqa: E402
from repro_torch.weights import lm_params_from_numpy  # noqa: E402

TINY = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
            vocab=64)
COMPUTE = {"f32": dict(compute_dtype="float32"), "bf16": {}}
#: the port's precision and JAX's engine precision that computes the same
PRECISION = {"float": "float", "int8": "int8-xla", "w4a8": "w4a8"}


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _lm(compute):
    kw = dict(TINY, **COMPUTE[compute])
    jcfg = dataclasses.replace(j_get_config("qwen2-0.5b"), **kw)
    jparams = j_api.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), **kw)
    return jcfg, jparams, cfg, lm_params_from_numpy(_np(jparams),
                                                    device="cpu")


@pytest.fixture(scope="module")
def f32():
    """JAX's tiny Qwen2 and the port's copy, float32 compute."""
    return _lm("f32")


@pytest.fixture(scope="module")
def bf16():
    """The same in the config's bfloat16 compute (test_paged.py's)."""
    return _lm("bf16")


def make_req(cls, uid, plen=5, max_new=6, seed=None, **kw):
    rng = np.random.default_rng(uid if seed is None else seed)
    return cls(uid=uid, prompt=rng.integers(0, 64, (plen,)).astype(np.int32),
               max_new_tokens=max_new, **kw)


def make_prefixed(cls, uid, shared, suffix_len, max_new=6, **kw):
    rng = np.random.default_rng(1000 + uid)
    sfx = rng.integers(0, 64, (suffix_len,)).astype(np.int32)
    return cls(uid=uid, prompt=np.concatenate([shared, sfx]),
               max_new_tokens=max_new, **kw)


def drain(setup, make, port=True, engine_kw=None, **scfg_kw):
    """Serve the requests ``make(cls)`` on the port's engine (or JAX's,
    ``port=False``); returns the engine and the requests by uid."""
    jcfg, jparams, cfg, params = setup
    if port:
        eng = Engine(cfg, params, ServeConfig(**scfg_kw),
                     **(engine_kw or {}))
        reqs = make(Request)
    else:
        eng = JEngine(jcfg, jparams, JServeConfig(**scfg_kw))
        reqs = make(JRequest)
    for r in reqs:
        eng.submit(r)
    return eng, sorted(eng.run_until_drained(), key=lambda r: r.uid)


def streams(done):
    return {r.uid: list(r.out_tokens) for r in done}


def pool_state(pool):
    """Everything a BlockPool holds, comparable across the packages."""
    return (list(pool._free), sorted(pool._allocated), dict(pool._ref),
            dict(pool._digest), list(pool._evictable), pool.lookups,
            pool.hits, pool.audit(), pool.audit(expect_drained=True))


def assert_same_as_jax(setup, make, **scfg_kw):
    """The port's paged engine against JAX's on the same requests:
    streams, statuses, the stats' counters and gauges, and the pool's
    state and drained audit. Returns the port's engine."""
    jeng, jdone = drain(setup, make, port=False, **scfg_kw)
    eng, done = drain(setup, make, **scfg_kw)
    assert streams(done) == streams(jdone)
    assert [r.status for r in done] == [r.status for r in jdone]
    keys = ("prefills", "decode_steps", "tokens_out", "requests_done",
            "blocks_in_use", "blocks_free", "prefix_hit_rate", "retries",
            "errors", "arena_rebuilds")
    assert {k: eng.stats[k] for k in keys} == \
        {k: jeng.stats[k] for k in keys}
    assert pool_state(eng.pool) == pool_state(jeng.pool)
    assert eng.pool.audit(expect_drained=True) == []
    return eng


# ------------------------------------------------- paged-contiguous parity


MID_DECODE = [(5, 9), (13, 2), (8, 7), (16, 4), (3, 11), (9, 1)]


def mid_decode(cls):
    return [make_req(cls, i, plen=p, max_new=m)
            for i, (p, m) in enumerate(MID_DECODE)]


@pytest.mark.parametrize("precision", sorted(PRECISION))
def test_paged_parity_mid_decode_refill(f32, bf16, precision):
    """Streams equal the contiguous layout's through mid-decode retirements
    and refills, prompts crossing page boundaries, and JAX's paged engine
    in every precision."""
    kw = dict(max_batch=2, max_len=32, precision=precision)
    _, ref = drain(bf16, mid_decode, **kw)
    _, got = drain(bf16, mid_decode, kv_layout="paged", kv_block_size=8,
                   **kw)
    assert streams(got) == streams(ref) and all(r.done for r in got)
    kw["precision"] = PRECISION[precision]
    jeng, jdone = drain(f32, mid_decode, port=False, kv_layout="paged",
                        kv_block_size=8, **kw)
    kw["precision"] = precision
    eng, done = drain(f32, mid_decode, kv_layout="paged", kv_block_size=8,
                      **kw)
    assert streams(done) == streams(jdone)
    assert eng.pool.audit(expect_drained=True) == []


def test_paged_parity_int8_kv(f32, bf16):
    def make(cls):
        return [make_req(cls, i, plen=p, max_new=m) for i, (p, m) in
                enumerate([(6, 8), (11, 3), (15, 6), (4, 10)])]
    kw = dict(max_batch=2, max_len=32, kv_cache="int8")
    _, ref = drain(bf16, make, **kw)
    _, got = drain(bf16, make, kv_layout="paged", kv_block_size=8, **kw)
    assert streams(got) == streams(ref)
    assert_same_as_jax(f32, make, kv_layout="paged", kv_block_size=8, **kw)


def test_paged_growth_at_page_boundary(f32, bf16):
    """A prompt ending on a page boundary needs a fresh page before its
    first decode write; generation crosses further boundaries."""
    def make(cls):
        return [make_req(cls, 0, plen=8, max_new=20),
                make_req(cls, 1, plen=16, max_new=12)]
    _, ref = drain(bf16, make, max_batch=2, max_len=64)
    eng, got = drain(bf16, make, max_batch=2, max_len=64,
                     kv_layout="paged", kv_block_size=8)
    assert streams(got) == streams(ref)
    assert eng.stats["blocks_in_use"] == 0
    assert_same_as_jax(f32, make, max_batch=2, max_len=64,
                       kv_layout="paged", kv_block_size=8)


def test_paged_single_request_vs_contiguous(bf16):
    def make(cls):
        return [make_req(cls, 0, plen=7, max_new=12)]
    _, ref = drain(bf16, make, max_batch=4, max_len=32)
    _, got = drain(bf16, make, max_batch=4, max_len=32, kv_layout="paged",
                   kv_block_size=16)
    assert streams(got) == streams(ref)


# ------------------------------------------------------------ prefix reuse


def _shared(seed, n=17):
    return np.random.default_rng(seed).integers(0, 64, (n,)).astype(np.int32)


def test_prefix_sharing_hits_and_parity(f32, bf16):
    """Requests sharing a prompt prefix hit the donor's published pages,
    share their storage and recompute their prompt; streams equal the
    contiguous layout's, and the hit rate, gauges and pool JAX's."""
    shared = _shared(7)

    def make(cls):
        return [make_prefixed(cls, i, shared, s, max_new=m) for i, (s, m)
                in enumerate([(3, 6), (5, 4), (1, 8), (9, 2)])]
    _, ref = drain(bf16, make, max_batch=2, max_len=64)
    eng, got = drain(bf16, make, max_batch=2, max_len=64,
                     kv_layout="paged", kv_block_size=8)
    assert streams(got) == streams(ref)
    st = eng.stats
    assert st["prefix_hit_rate"] > 0.0 and st["prefills"] == 4
    assert st["blocks_in_use"] == 0 and st["blocks_free"] > 0
    assert eng.pool.audit(expect_drained=True) == []
    eng = assert_same_as_jax(f32, make, max_batch=2, max_len=64,
                             kv_layout="paged", kv_block_size=8)
    assert eng.stats["prefix_hit_rate"] > 0.0


def test_prefix_salt_keeps_hits_within_a_bucket(bf16):
    """No salt any more: page digests are JAX's on every device, so a
    prompt hits pages published by a prefill of another bucket (on a card
    a paged engine with the prefix cache prefills through
    ``transformer.shared_prefill``, in row blocks of one shape): the
    bucket-64 request hits the bucket-32 donor's
    shared pages. Streams equal the contiguous layout's and JAX's pool
    counts the same hits."""
    shared = _shared(11)

    def make(cls):       # buckets 32, 64, 32, 64; the shared run 2 pages
        return [make_prefixed(cls, i, shared, s, max_new=4)
                for i, s in enumerate([3, 20, 5, 25])]
    _, ref = drain(bf16, make, max_batch=1, max_len=64)
    jcfg, jparams, cfg, params = bf16
    eng = Engine(cfg, params, ServeConfig(
        max_batch=1, max_len=64, kv_layout="paged", kv_block_size=8))
    assert not hasattr(eng, "salt_prefix")
    for r in make(Request):
        eng.submit(r)
    got = sorted(eng.run_until_drained(), key=lambda r: r.uid)
    assert streams(got) == streams(ref)
    assert eng.stats["prefills"] == 4
    assert eng.pool.audit(expect_drained=True) == []
    # keys per prompt: 2, 4, 2, 5; every request after the first hits the
    # 2 shared pages, the second across buckets 32 -> 64
    assert (eng.pool.hits, eng.pool.lookups) == (6, 13)
    jeng = JEngine(jcfg, jparams, JServeConfig(
        max_batch=1, max_len=64, kv_layout="paged", kv_block_size=8))
    for r in make(JRequest):
        jeng.submit(r)
    jeng.run_until_drained()
    assert (jeng.pool.hits, jeng.pool.lookups) == (6, 13)


def test_prefix_refcount_survives_retire_orders(bf16):
    """Sharers retiring donor-first and donor-last leave the pool drained,
    and their streams equal the contiguous layout's both ways."""
    shared = _shared(8)
    for maxnews in ([2, 9], [9, 2]):
        def make(cls):
            return [make_prefixed(cls, i, shared, 3 + i, max_new=m)
                    for i, m in enumerate(maxnews)]
        _, ref = drain(bf16, make, max_batch=2, max_len=64)
        eng, got = drain(bf16, make, max_batch=2, max_len=64,
                         kv_layout="paged", kv_block_size=8)
        assert streams(got) == streams(ref)
        assert eng.stats["blocks_in_use"] == 0
        assert eng.pool.audit(expect_drained=True) == []


def test_prefix_sharing_int8_storage_only(f32, bf16):
    """An int8-KV hit shares page storage and recomputes its prompt:
    streams equal the contiguous int8 cache's, the hit rate is above 0."""
    shared = _shared(9)

    def make(cls):
        return [make_prefixed(cls, i, shared, 2 + i, max_new=5)
                for i in range(3)]
    kw = dict(max_batch=2, max_len=64, kv_cache="int8")
    _, ref = drain(bf16, make, **kw)
    eng, got = drain(bf16, make, kv_layout="paged", kv_block_size=8, **kw)
    assert streams(got) == streams(ref)
    assert eng.stats["prefix_hit_rate"] > 0.0
    assert_same_as_jax(f32, make, kv_layout="paged", kv_block_size=8, **kw)


def test_prefix_cache_disabled(f32, bf16):
    shared = _shared(10)

    def make(cls):
        return [make_prefixed(cls, i, shared, 2, max_new=4)
                for i in range(3)]
    _, ref = drain(bf16, make, max_batch=2, max_len=64)
    eng, got = drain(bf16, make, max_batch=2, max_len=64,
                     kv_layout="paged", kv_block_size=8, prefix_cache=False)
    assert streams(got) == streams(ref)
    assert eng.stats["prefix_hit_rate"] == 0.0
    assert_same_as_jax(f32, make, max_batch=2, max_len=64,
                       kv_layout="paged", kv_block_size=8,
                       prefix_cache=False)


# -------------------------------------------- backpressure and preemption


def test_pool_exhaustion_admission_backpressure(f32, bf16):
    """A pool too small for max_batch requests parks admissions in the
    holdback; every request completes with the contiguous stream."""
    def make(cls):
        return [make_req(cls, i, plen=12, max_new=10) for i in range(5)]
    _, ref = drain(bf16, make, max_batch=4, max_len=32)
    eng, got = drain(bf16, make, max_batch=4, max_len=32,
                     kv_layout="paged", kv_block_size=8, kv_num_blocks=6)
    assert streams(got) == streams(ref)
    assert eng.stats["requests_done"] == 5
    assert eng.stats["blocks_in_use"] == 0
    assert_same_as_jax(f32, make, max_batch=4, max_len=32,
                       kv_layout="paged", kv_block_size=8, kv_num_blocks=6)


def test_preemption_replays_identical_stream(f32, bf16):
    """The least legal pool forces mid-decode preemption; the preempted
    request replays from its prompt (an ``engine.block_free`` span with
    ``preempt=True``) and every stream equals the contiguous one."""
    def make(cls):
        return [make_req(cls, i, plen=9, max_new=16) for i in range(3)]
    _, ref = drain(bf16, make, max_batch=2, max_len=32)
    trace.clear()
    trace.enable()
    try:
        eng, got = drain(bf16, make, max_batch=2, max_len=32,
                         kv_layout="paged", kv_block_size=8,
                         kv_num_blocks=5)
        events = trace.TRACER.events()
    finally:
        trace.disable()
        trace.clear()
    assert streams(got) == streams(ref) and all(r.done for r in got)
    frees = [e for e in events
             if e["name"] == "engine.block_free" and e["ph"] == "B"]
    assert any(e["args"].get("preempt") for e in frees)
    names = {e["name"] for e in events}
    assert {"engine.prefix_lookup", "engine.block_alloc"} <= names
    assert_same_as_jax(f32, make, max_batch=2, max_len=32,
                       kv_layout="paged", kv_block_size=8, kv_num_blocks=5)


# ---------------------------------------------------- faults and the pool


def _faulted(setup, specs, jspecs, make, **scfg_kw):
    """The port's and JAX's paged engines under the same fault schedule,
    each held against its own fault-free run: the survivors' streams, the
    statuses and the drained audit; returns the port's engine."""
    _, clean = drain(setup, make, **scfg_kw)
    with FaultPlan(specs) as plan:
        eng, done = drain(setup, make, **scfg_kw)
    assert plan.log, "the fault plan never fired"
    with JFaultPlan(jspecs):
        jeng, jdone = drain(setup, make, port=False, **scfg_kw)
    assert [r.status for r in done] == [r.status for r in jdone]
    assert streams(done) == streams(jdone)
    ok = {r.uid for r in done if r.status == "ok"}
    assert {u: s for u, s in streams(done).items() if u in ok} == \
        {u: s for u, s in streams(clean).items() if u in ok}
    assert eng.pool.audit(expect_drained=True) == []
    assert eng.stats["arena_rebuilds"] == jeng.stats["arena_rebuilds"]
    return eng


def _chaos_reqs(cls, n=5, plen=5, max_new=8):
    return [cls(uid=uid, prompt=np.random.default_rng(uid).integers(
        0, 64, (plen,)).astype(np.int32), max_new_tokens=max_new)
        for uid in range(n)]


PAGED_FAULTED = dict(max_batch=2, max_len=32, kv_layout="paged",
                     kv_block_size=4, prefill_bucket=8)


def test_paged_pool_fault_backpressures_not_leaks(f32):
    """A ``blockpool.alloc`` fault is a transient shortage: every request
    still ends ok with its fault-free stream, and no page leaks."""
    eng = _faulted(
        f32, [FaultSpec(site="blockpool.alloc", kind="raise", nth=2,
                        times=2)],
        [JFaultSpec(site="blockpool.alloc", kind="raise", nth=2, times=2)],
        _chaos_reqs, **PAGED_FAULTED)
    assert eng.stats["errors"] == 0 and eng.stats["retries"] >= 1


def test_paged_decode_error_rebuilds_pool_clean(f32):
    """A decode round that fails past its retries retires the active set,
    clears the arena and starts a fresh pool; the rest is served and the
    new pool audits clean."""
    eng = _faulted(
        f32, [FaultSpec(site="engine.decode_round", kind="raise", nth=3,
                        times=3)],
        [JFaultSpec(site="engine.decode_round", kind="raise", nth=3,
                    times=3)],
        _chaos_reqs, **PAGED_FAULTED)
    assert eng.stats["arena_rebuilds"] == 1 and eng.stats["errors"] >= 1


# ------------------------------------------------------------- rejections


def test_paged_rejects_bad_configs(f32):
    """The JAX engine's gates and checks, with its messages."""
    jcfg, jparams, cfg, params = f32
    for kw, exc in ((dict(kv_layout="chunked"), ValueError),
                    (dict(kv_layout="paged", scheduler="static"),
                     NotImplementedError),
                    (dict(kv_layout="paged", max_len=40, kv_block_size=16),
                     ValueError),
                    (dict(kv_layout="paged", max_len=64, kv_block_size=16,
                          kv_num_blocks=3), ValueError)):
        with pytest.raises(exc) as got:
            Engine(cfg, params, ServeConfig(**kw))
        with pytest.raises(exc) as want:
            JEngine(jcfg, jparams, JServeConfig(**kw))
        if exc is NotImplementedError:
            assert str(got.value) == str(want.value)
        else:       # the port lists its enums' values, JAX the same words
            for m in ("kv_layout", "divide", "usable"):
                assert (m in str(got.value)) == (m in str(want.value))


def test_paged_rejects_recurrent_families(f32):
    kw = dict(n_layers=2, d_model=32, d_ff=64, vocab=64)
    ssm = dataclasses.replace(get_config("falcon-mamba-7b"), **kw)
    jssm = dataclasses.replace(j_get_config("falcon-mamba-7b"), **kw)
    with pytest.raises(NotImplementedError) as got:
        Engine(ssm, f32[3], ServeConfig(kv_layout="paged"))
    with pytest.raises(NotImplementedError) as want:    # gates come first
        JEngine(jssm, {}, JServeConfig(kv_layout="paged"))
    assert str(got.value) == str(want.value)
    assert "attention-family" in str(got.value)
    with pytest.raises(NotImplementedError, match="attention-family dense"):
        api.init_paged_cache(ssm, 2, 4, 8, 16, device="cpu")


def test_unified_prompt_length_message(f32):
    """Submit-time and admit-time rejections of an oversized prompt share
    one message, the paged engine's too."""
    _, _, cfg, params = f32
    eng = Engine(cfg, params, ServeConfig(max_batch=2, max_len=16,
                                          kv_layout="paged",
                                          kv_block_size=8))
    big = make_req(Request, 7, plen=17)
    msg = r"request 7: prompt length 17 exceeds max_len=16"
    with pytest.raises(ValueError, match=msg):
        eng.submit(big)
    eng.queue.put(big)
    with pytest.raises(ValueError, match=msg):
        eng.run_until_drained()


# ---------------------------------------------------------- the BlockPool


def test_blockpool_alloc_free_lru():
    pool = BlockPool(num_blocks=6, block_size=8)
    assert pool.usable == 5 and pool.free_pages == 5
    a = pool.alloc(3)
    assert a == [1, 2, 3] and pool.in_use == 3
    assert pool.alloc(3) is None            # only 2 left: backpressure
    pool.free(a)
    assert pool.free_pages == 5 and pool.in_use == 0
    assert pool.alloc(6) is None            # beyond usable, ever
    with pytest.raises(ValueError, match="not allocated"):
        pool.free(a)                        # double free


def test_blockpool_prefix_publish_refcount_evict():
    pool = BlockPool(num_blocks=4, block_size=4)
    prompt = np.arange(9, dtype=np.int32)   # 2 full blocks hashable
    keys = pool.prefix_keys(prompt)
    assert keys == JBlockPool(4, 4).prefix_keys(prompt)
    assert len(keys) == 2 and pool.lookup(keys) == []
    ids = pool.alloc(2)
    pool.publish(keys, ids)                 # the donor's live reference
    assert pool.lookup(keys) == ids
    pool.acquire(ids)                       # a sharer
    pool.release(ids)
    pool.free(ids, hashed=len(ids))         # the donor retires
    assert pool.in_use == 0 and pool.free_pages == 3
    assert pool.lookup(keys) == ids         # retained: still hits
    got = pool.alloc(3)                     # pressure evicts LRU pages
    assert set(ids) <= set(got)
    assert pool.lookup(keys) == []
    with pytest.raises(ValueError, match="evicted"):
        pool.acquire(ids)


def test_blockpool_chained_keys_diverge():
    pool = BlockPool(num_blocks=8, block_size=4)
    a = pool.prefix_keys(np.arange(12, dtype=np.int32))
    b = pool.prefix_keys(np.concatenate(
        [np.arange(4, dtype=np.int32), np.arange(100, 108, dtype=np.int32)]))
    assert a[0] == b[0] and a[1] != b[1]


def test_blockpool_prefix_keys_salt():
    """The digests are JAX's, unsalted, for every prompt length around a
    page edge (the salt by prefill bucket is gone from the engine)."""
    pool = BlockPool(num_blocks=8, block_size=4)
    for n in (4, 5, 12, 13):
        prompt = np.arange(n, dtype=np.int32)
        assert pool.prefix_keys(prompt) == JBlockPool(8, 4).prefix_keys(
            prompt)
        assert len(pool.prefix_keys(prompt)) == (n - 1) // 4


def test_blockpool_no_prefix_cache():
    pool = BlockPool(num_blocks=4, block_size=4, prefix_cache=False)
    assert pool.prefix_keys(np.arange(12, dtype=np.int32)) == []


def _pool_ops(pool, rng, n_ops=300):
    """A seeded random sequence of the engine's pool operations (lookup +
    acquire + alloc + publish, free, allocation under pressure); yields
    the pool's state after each op. Prompts come from a few shared
    prefixes, so hits, evictions and refcounts above 1 all occur."""
    bases = [rng.integers(0, 8, (24,)).astype(np.int32) for _ in range(3)]
    live = []
    for _ in range(n_ops):
        if live and (rng.random() < 0.45 or pool.free_pages < 3):
            ids, hashed = live.pop(int(rng.integers(len(live))))
            pool.free(ids, hashed=hashed)
        else:
            base = bases[int(rng.integers(len(bases)))]
            cut = int(rng.integers(5, 24))
            prompt = np.concatenate([base[:cut], rng.integers(
                0, 8, (int(rng.integers(0, 6)),)).astype(np.int32)])
            keys = pool.prefix_keys(prompt)
            hit = pool.lookup(keys)
            pool.acquire(hit)
            fresh = pool.alloc(-(-len(prompt) // pool.block_size) - len(hit))
            if fresh is None:
                pool.release(hit)
            else:
                ids = hit + fresh
                pool.publish(keys[len(hit):], ids[len(hit):len(keys)])
                live.append((ids, len(keys)))
        yield pool_state(pool)
    for ids, hashed in live:
        pool.free(ids, hashed=hashed)
    yield pool_state(pool)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_blockpool_random_ops_equal_jax(seed):
    """The port's and JAX's pools, driven by the same seeded operations,
    hold equal free lists, allocations, refcounts, digests, LRU orders,
    hit counts and audits after every one, up to the first op after which
    JAX's pool audits a broken digest bijection (an evicted chain head
    whose later block stays published; see ``BlockPool.publish``). The
    port's pool audits clean after every op and ends drained."""
    for prefix_cache in (True, False):
        port = _pool_ops(BlockPool(12, 4, prefix_cache),
                         np.random.default_rng(seed))
        ref = _pool_ops(JBlockPool(12, 4, prefix_cache),
                        np.random.default_rng(seed))
        compared = 0
        for got, want in zip(port, ref):
            if want[-2]:                # JAX's pool broke: stop comparing
                break
            assert got == want
            compared += 1
        assert compared >= 50
        for got in port:
            assert got[-2] == []
        assert got[-2] == got[-1] == []


def test_blockpool_republish_after_chain_head_evicted():
    """The chain head's page is evicted before its successor's (LRU): a
    new request with the same prefix misses at the head, recomputes and
    publishes both blocks. The port's pool frees the stale successor page
    and stays a bijection through later evictions; JAX's pool audits a
    broken bijection and fails its eviction of that page."""
    prompt = np.arange(9, dtype=np.int32)            # 2 hashable blocks
    pools = [BlockPool(num_blocks=5, block_size=4),
             JBlockPool(num_blocks=5, block_size=4)]
    for pool in pools:
        keys = pool.prefix_keys(prompt)
        ids = pool.alloc(3)
        pool.publish(keys, ids[:2])
        pool.free(ids, hashed=2)                     # both parked, LRU
        other = pool.alloc(3)                        # evicts the head only
        assert pool.lookup(keys) == []               # the run stops there
        pool.free(other)
        fresh = pool.alloc(3)                        # the recomputing
        pool.publish(keys, fresh[:2])                # admission
        pool.free(fresh, hashed=2)
    port, ref = pools
    assert port.audit(expect_drained=True) == []
    assert any("bijection" in m for m in ref.audit())
    assert len(port.alloc(port.usable)) == port.usable   # evicts all
    assert port.audit() == []
    with pytest.raises(KeyError):
        ref.alloc(ref.usable)


# ------------------------------------------------------- config/budgeting


def test_check_config_paged(f32):
    """``paged_num_blocks``, ``kv_cache_bytes`` and the paged and
    ``hbm_budget`` checks equal JAX's."""
    jcfg, _, cfg, _ = f32
    cases = [dict(kv_layout="paged", max_len=64, kv_block_size=16),
             dict(max_len=64), dict(max_len=64, kv_cache="int8"),
             dict(kv_layout="paged", max_len=64, kv_block_size=16,
                  kv_cache="int8", kv_num_blocks=9),
             dict(kv_layout="nope"),
             dict(kv_layout="paged", max_len=40, kv_block_size=16),
             dict(kv_layout="paged", max_len=64, kv_block_size=16,
                  kv_num_blocks=4),
             dict(kv_layout="paged", max_batch=8, max_len=64,
                  kv_block_size=16, kv_num_blocks=5),
             dict(kv_layout="paged", kv_num_blocks=1),
             dict(kv_layout="paged", scheduler="static")]
    for kw in cases:
        s, js = ServeConfig(**kw), JServeConfig(**kw)
        if kw.get("kv_layout") != "nope" and kw.get("kv_block_size") != 0:
            assert check.kv_cache_bytes(cfg, s) == \
                j_check.kv_cache_bytes(jcfg, js)
            assert check.paged_num_blocks(s) == j_check.paged_num_blocks(js)
        for strict in (True, False):
            for budget in (None, 2 ** 10, 2 ** 30):
                got = check.check_serve_config(s, cfg, hbm_budget=budget,
                                               strict=strict)
                want = j_check.check_serve_config(js, jcfg,
                                                  hbm_budget=budget,
                                                  strict=strict)
                assert len(got) == len(want), (kw, got, want)
                assert [m for m in got if "kv_layout" not in m] == \
                    [m for m in want if "kv_layout" not in m]
    ok = ServeConfig(kv_layout="paged", max_len=64, kv_block_size=16)
    assert check.check_serve_config(ok, cfg) == []
    assert check.paged_num_blocks(ok) == 4 * 4 + 1
    per_page = cfg.n_layers * 2 * 16 * cfg.n_kv_heads * cfg.head_dim * 4
    assert check.kv_cache_bytes(cfg, ok) == \
        check.kv_cache_bytes(cfg, ServeConfig(max_len=64)) + per_page \
        + 4 * ok.max_batch * 4
    assert any("MiB budget" in m for m in check.check_serve_config(
        ok, cfg, hbm_budget=1024))


# ------------------------------------------------ cache and attention level


def test_init_paged_cache_and_clear(f32):
    jcfg, _, cfg, _ = f32
    for kv in ("float", "int8"):
        got = api.init_paged_cache(cfg, 3, 5, 8, 32, kv=kv, device="cpu")
        want = j_api.init_paged_cache(jcfg, 3, 5, 8, 32, kv=kv)
        assert sorted(got) == sorted(want)
        for k in got:
            assert tuple(got[k].shape) == tuple(want[k].shape)
            np.testing.assert_array_equal(got[k].float().numpy(),
                                          np.asarray(want[k], np.float32))
        for t in got.values():
            t.fill_(7)
        api.cache_clear(got)            # the arena back to its init state
        for k in got:
            np.testing.assert_array_equal(got[k].float().numpy(),
                                          np.asarray(want[k], np.float32))
    with pytest.raises(ValueError, match="divide"):
        api.init_paged_cache(cfg, 2, 4, 12, 32, device="cpu")
    with pytest.raises(ValueError, match="garbage"):
        api.init_paged_cache(cfg, 2, 1, 8, 32, device="cpu")


@pytest.mark.parametrize("kv", ["float", "int8"])
def test_paged_writes_and_gather_equal_jax(f32, kv):
    """``paged_write_prompt`` (with skipped shared pages),
    ``paged_write_kv`` (padded and cut to the pages' span) and
    ``paged_gather_prefix`` write and read the pages JAX's do, int8 codes
    and scales bitwise; the pools are updated in place."""
    jcfg, jparams, cfg, params = f32
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 64, (1, 32)).astype(np.int32)
    _, jfresh = j_api.prefill_fn(jcfg, 32)(
        jparams, {"tokens": jnp.asarray(toks),
                  "prompt_lens": jnp.asarray([21], jnp.int32)})
    fresh = {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.bfloat16) if k != "len" else torch.from_numpy(np.array(v))
        for k, v in jfresh.items()}
    live = api.init_paged_cache(cfg, 2, 9, 8, 32, kv=kv, device="cpu")
    jlive = j_api.init_paged_cache(jcfg, 2, 9, 8, 32, kv=kv)
    k_pool = live["k"]
    api.paged_write_prompt(cfg, live, fresh, [5, 2], skip_blocks=1)
    jlive = j_api.paged_write_prompt(jcfg, jlive, jfresh, [5, 2],
                                     skip_blocks=1)
    suffix = rng.standard_normal((2, 2, 1, 13, 2, 8)).astype(np.float32)
    api.paged_write_kv(live, torch.from_numpy(suffix[0]),
                       torch.from_numpy(suffix[1]), [7, 1])
    jlive = j_api.paged_write_kv(jlive, jnp.asarray(suffix[0]),
                                 jnp.asarray(suffix[1]), [7, 1])
    long = rng.standard_normal((2, 2, 1, 20, 2, 8)).astype(np.float32)
    api.paged_write_kv(live, torch.from_numpy(long[0]),
                       torch.from_numpy(long[1]), [3])
    jlive = j_api.paged_write_kv(jlive, jnp.asarray(long[0]),
                                 jnp.asarray(long[1]), [3])
    assert live["k"] is k_pool                       # in place
    for k in live:
        np.testing.assert_array_equal(live[k].float().numpy(),
                                      np.asarray(jlive[k], np.float32))
    if kv == "int8":
        with pytest.raises(NotImplementedError, match="storage only"):
            api.paged_gather_prefix(live, [5, 2])
        return
    pk, pv = api.paged_gather_prefix(live, [5, 2, 7])
    jpk, jpv = j_api.paged_gather_prefix(jlive, jnp.asarray([5, 2, 7]))
    assert tuple(pk.shape) == (2, 1, 24, 2, 8)
    np.testing.assert_array_equal(pk.float().numpy(),
                                  np.asarray(jpk, np.float32))
    np.testing.assert_array_equal(pv.float().numpy(),
                                  np.asarray(jpv, np.float32))


@pytest.mark.parametrize("int8", [False, True])
def test_gather_and_paged_decode_attention(int8):
    """The gathered view equals JAX's ``gather_kv_blocks``; paged decode
    attention equals the contiguous one on that view, bitwise, with other
    values at masked positions; and JAX's at the decode tolerance."""
    rng = np.random.default_rng(4)
    nb, bs, hkv, d, b = 7, 4, 2, 16, 3
    table = np.array([[3, 1, 0, 0], [2, 5, 6, 4], [0, 0, 0, 0]], np.int32)
    lens = np.array([6, 15, 0], np.int32)
    q = rng.standard_normal((b, 1, 4, d)).astype(np.float32)
    if int8:
        pools = [rng.integers(-127, 128, (nb, bs, hkv, d)).astype(np.int8)
                 for _ in range(2)]
        scales = [(rng.random((nb, bs, hkv)) * 0.05).astype(np.float32)
                  for _ in range(2)]
    else:
        pools = [rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
                 for _ in range(2)]
    tp = [torch.from_numpy(p) for p in pools]
    g = A.gather_kv_blocks(tp[0], torch.from_numpy(table))
    np.testing.assert_array_equal(g.numpy(), np.asarray(
        JA.gather_kv_blocks(jnp.asarray(pools[0]), jnp.asarray(table))))
    tq, tl = torch.from_numpy(q), torch.from_numpy(lens)
    if int8:
        ts = [torch.from_numpy(s) for s in scales]
        got = A.decode_attention_paged_q8(tq, *tp, *ts,
                                          torch.from_numpy(table), tl)
        gath = [A.gather_kv_blocks(t, torch.from_numpy(table))
                for t in tp + ts]
        contig = A.decode_attention_q8(tq, *gath, tl)
        want = JA.decode_attention_paged_q8(
            jnp.asarray(q), *map(jnp.asarray, pools + scales),
            jnp.asarray(table), jnp.asarray(lens))
    else:
        got = A.decode_attention_paged(tq, *tp, torch.from_numpy(table), tl)
        gath = [A.gather_kv_blocks(t, torch.from_numpy(table)) for t in tp]
        # other values past each length: no effect on the output
        noisy = [t.clone() for t in gath]
        for t in noisy:
            for i, n in enumerate(lens):
                t[i, n:] = 1e3
        contig = A.decode_attention(tq, *noisy, tl)
        want = JA.decode_attention_paged(
            jnp.asarray(q), *map(jnp.asarray, pools), jnp.asarray(table),
            jnp.asarray(lens))
    assert torch.equal(got[:2], contig[:2])
    np.testing.assert_allclose(got.numpy()[:2], np.asarray(want)[:2],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kv", ["float", "int8"])
def test_paged_decode_step_equals_contiguous(bf16, kv):
    """``decode_step`` over a paged arena gives the contiguous arena's
    logits bitwise, and writes each live row's K/V into its page slot;
    a retired row writes only into page 0."""
    _, _, cfg, params = bf16
    params = T.cast_params(params, cfg)
    rng = np.random.default_rng(5)
    plens = [5, 16, 0]
    contig = api.init_slot_cache(cfg, 3, 32, kv=kv, device="cpu")
    paged = api.init_paged_cache(cfg, 3, 16, 8, 32, kv=kv, device="cpu")
    tables = [[3, 9, 0, 0], [2, 4, 7, 0], [0, 0, 0, 0]]
    for i, n in enumerate(plens[:2]):
        toks = torch.zeros((1, 16), dtype=torch.long)
        toks[0, :n] = torch.from_numpy(rng.integers(0, 64, n))
        _, fresh = T.prefill(params, toks, cfg, 32, prompt_lens=[n])
        api.cache_write_slot(cfg, contig, fresh, i)
        api.paged_write_prompt(cfg, paged, fresh, tables[i][:2])
    paged["block_table"].copy_(torch.tensor(tables, dtype=torch.int32))
    paged["len"].copy_(torch.tensor(plens, dtype=torch.int32))
    contig["len"].copy_(torch.tensor(plens, dtype=torch.int32))
    tok = torch.from_numpy(rng.integers(0, 64, (3, 1)))
    for step in range(3):
        lc, _ = T.decode_step(params, tok, contig, cfg)
        lp, out = T.decode_step(params, tok, paged, cfg)
        assert torch.equal(lc[:2], lp[:2])
        assert out["k"] is paged["k"]
        contig["len"][:2] += 1
        paged["len"][:2] += 1
        tok = lc.argmax(-1)
    view = A.gather_kv_blocks(paged["k"][0], paged["block_table"])
    for i, n in enumerate(plens[:2]):
        assert torch.equal(view[i, :n + 3], contig["k"][0, i, :n + 3])
    untouched = [p for p in range(1, 16)
                 if p not in (3, 9, 2, 4, 7)]
    assert not paged["k"][:, untouched].any()


def test_prefill_suffix_bitwise_exact(bf16):
    """The prefix-hit path's foundation: the suffix prefilled against the
    prefix K/V of a prefill at another (shorter) bucket gives the bits of
    a prefill of the whole prompt, logits and suffix K/V alike."""
    _, _, cfg, params = bf16
    params = T.cast_params(params, cfg)
    rng = np.random.default_rng(11)
    plen, pfx, max_len = 21, 16, 32
    prompt = torch.from_numpy(rng.integers(0, 64, (plen,)))
    full = api.prefill_fn(cfg, max_len)
    toks = torch.zeros((1, max_len), dtype=torch.long)
    toks[0, :plen] = prompt
    logits_ref, cache = full(params, {
        "tokens": toks, "prompt_lens": torch.tensor([plen],
                                                    dtype=torch.int32)})
    _, donor = api.prefill_fn(cfg, pfx)(params, {
        "tokens": prompt[None, :pfx],
        "prompt_lens": torch.tensor([pfx], dtype=torch.int32)})
    assert torch.equal(cache["k"][:, :, :pfx], donor["k"])
    s_sfx = plen - pfx
    stoks = torch.zeros((1, 8), dtype=torch.long)   # bucketed past it
    stoks[0, :s_sfx] = prompt[pfx:]
    logits, ks, vs = api.prefill_suffix_fn(cfg)(params, {
        "tokens": stoks, "prefix_k": donor["k"], "prefix_v": donor["v"],
        "suffix_lens": torch.tensor([s_sfx], dtype=torch.int32)})
    assert torch.equal(logits, logits_ref)
    assert torch.equal(ks[:, :, :s_sfx].to(cache["k"].dtype),
                       cache["k"][:, :, pfx:pfx + s_sfx])
    assert torch.equal(vs[:, :, :s_sfx].to(cache["v"].dtype),
                       cache["v"][:, :, pfx:pfx + s_sfx])


@pytest.mark.parametrize("sq,block_k,n_chunks", [(64, 16, 8), (30, 8, 4),
                                                  (7, 4, 8)])
def test_flash_attention_tri_tracks_jax(sq, block_k, n_chunks):
    rng = np.random.default_rng(sq)
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, sq, 2, 16)).astype(np.float32)
            for _ in range(2))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = A.flash_attention_tri(tq, tk, tv, block_k=block_k,
                                n_chunks=n_chunks)
    want = JA.flash_attention_tri(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), block_k=block_k,
                                  n_chunks=n_chunks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=2e-6)
    flash = A.flash_attention(tq, tk, tv, causal=True, block_k=block_k)
    np.testing.assert_allclose(got.numpy(), flash.numpy(), rtol=1e-5,
                               atol=2e-6)
    via = A.attention(tq, tk, tv, causal=True, impl="flash_tri",
                      block_k=block_k)
    assert torch.equal(via, A.flash_attention_tri(tq, tk, tv,
                                                  block_k=block_k))
    # not self-attention: the plain flash scan, as JAX dispatches
    off = A.attention(tq[:, -3:], tk, tv, causal=True, impl="flash_tri",
                      q_offset=sq - 3, block_k=block_k)
    assert torch.equal(off, A.flash_attention(
        tq[:, -3:], tk, tv, causal=True, q_offset=sq - 3, block_k=block_k))
