"""The LM side of the port's chaos harness (``repro_torch.faults.chaos``)
against the JAX package's ``repro.faults.chaos`` on the CPU.

Every LM schedule of ``tests/test_faults.py`` but the deadline one runs
through both packages' harnesses on the same tiny Qwen2 (that file's
``tiny_cfg``: 2 layers, d_model 32) with the same seeded numpy weights
(JAX's ``init_params`` traced for its layout, not run: running it
compiles each small op), carried across by
``weights.lm_params_from_numpy``, the same requests and the same seed. It
computes in float32, as the port's other stream-parity tests do
(tests/test_torch_lm.py, tests/test_torch_paged.py): in bfloat16 the two
frameworks' matmuls round apart, and on these weights that flips greedy
tokens of the clean run already. The two reports must both be ``ok`` and have
equal statuses, survivors, poisoned sets, fires, fault logs and stats
counters, and the faulted survivors' streams must equal JAX's. The
``REPRO_FAULTS`` activation runs end to end through both engines.

JAX's engine compiles its prefill and decode per instance, so each JAX
engine is made once per serve config and reused (``reset_stats``
between drains; it keeps no other state across drains); the port's
engines are made fresh per drain, as the harness asks.

The port's own schedules: the deadline (a 0.2 s stall of every decode
round against a 0.05 s deadline, contiguous and paged; only what holds
however long a round takes is asserted), and the ``kernels.dispatch``
seam inside an ``"int8"`` engine's prefills and decode rounds, contiguous
and paged, once and persistently (the JAX package's Pallas guard would
retry and degrade inside the dispatch; the port's engine retries or
retires, and its pool audits clean).

Run here with ``PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q
tests/test_torch_chaos.py``."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.faults import chaos as j_chaos  # noqa: E402
from repro.faults import inject as j_inject  # noqa: E402
from repro.models import api as j_api  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.faults import chaos, inject  # noqa: E402
from repro_torch.serve import Engine, Request, ServeConfig  # noqa: E402
from repro_torch.weights import lm_params_from_numpy  # noqa: E402

#: test_faults.tiny_cfg's sizes, float32 compute
TINY = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
            vocab=64, compute_dtype="float32")
SEED = 0
LM_COUNTERS = ("prefills", "decode_steps", "tokens_out", "requests_done",
               "occupancy", "blocks_in_use", "blocks_free",
               "prefix_hit_rate", "timeouts", "errors", "shed", "retries",
               "arena_rebuilds")
PAGED = dict(kv_layout="paged", kv_block_size=4, prefill_bucket=8)


@pytest.fixture(autouse=True)
def no_plan_leaks():
    inject.deactivate()
    j_inject.deactivate()
    yield
    inject.deactivate()
    j_inject.deactivate()


def numpy_lm_params(jcfg, seed=0):
    """Seeded numpy weights in the layout of JAX's ``init_params`` (traced
    for its shapes, not run) at its scales: normal embedding * 0.02, normal
    matrices * fan_in^-1/2, unit norms, zero biases."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: j_api.init_params(
        jcfg, jax.random.PRNGKey(0)))

    def leaf(path, s):
        name = path[-1].key
        if name.startswith("ln") or name.endswith("_norm"):
            return np.ones(s.shape, np.float32)
        if name in ("bq", "bk", "bv"):
            return np.zeros(s.shape, np.float32)
        std = 0.02 if name == "embed" else s.shape[-2] ** -0.5
        return (rng.standard_normal(s.shape) * std).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=None)
def tiny_lm():
    """(JAX config, JAX params, port config, port params)."""
    from repro.configs.base import get_config as j_get_config
    jcfg = dataclasses.replace(j_get_config("qwen2-0.5b"), **TINY)
    jparams = numpy_lm_params(jcfg)
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), **TINY)
    return jcfg, jparams, cfg, lm_params_from_numpy(jparams, device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_engine(items):
    jcfg, jparams, _, _ = tiny_lm()
    return JEngine(jcfg, jparams, JServeConfig(**dict(items)))


def jax_engine(**scfg):
    """JAX's engine of this serve config, made once, stats reset."""
    eng = _jax_engine(tuple(sorted(scfg.items())))
    eng.reset_stats()
    return eng


def make_reqs(cls, n=4, plen=5, max_new=6, **kw):
    """test_faults.make_reqs for either package's ``Request``."""
    def factory():
        return [cls(uid=uid, prompt=np.random.default_rng(uid).integers(
            0, 64, (plen,)).astype(np.int32), max_new_tokens=max_new, **kw)
            for uid in range(n)]
    return factory


class Made:
    """A request factory keeping every list it made (the last is the
    faulted run's)."""

    def __init__(self, make):
        self.make, self.lists = make, []

    def __call__(self):
        self.lists.append(self.make())
        return self.lists[-1]


def lm_pair(specs, scfg_kw=None, req_kw=None, seed=SEED, **harness_kw):
    """One schedule through both harnesses (test_faults.lm_chaos's serve
    config); returns (report, plan, requests) for the port and for JAX."""
    scfg = dict(max_batch=2, max_len=32, **(scfg_kw or {}))
    _, _, cfg, params = tiny_lm()
    plan = inject.FaultPlan([inject.FaultSpec(**s) for s in specs], seed)
    jplan = j_inject.FaultPlan([j_inject.FaultSpec(**s) for s in specs],
                               seed)
    made = Made(make_reqs(Request, **(req_kw or {})))
    jmade = Made(make_reqs(JRequest, **(req_kw or {})))
    rep = chaos.run_lm_chaos(
        lambda: Engine(cfg, params, ServeConfig(**scfg)), made, plan,
        **harness_kw)
    jrep = j_chaos.run_lm_chaos(lambda: jax_engine(**scfg), jmade, jplan,
                                **harness_kw)
    return (rep, plan, made.lists[-1]), (jrep, jplan, jmade.lists[-1])


def assert_same(port, jax_side):
    (rep, plan, reqs), (jrep, jplan, jreqs) = port, jax_side
    assert rep.ok, rep.summary()
    assert jrep.ok, jrep.summary()
    assert rep.statuses == jrep.statuses
    assert rep.survivors == jrep.survivors
    assert rep.poisoned == jrep.poisoned
    assert rep.fired == jrep.fired
    assert rep.pool_violations == jrep.pool_violations == []
    assert [(f.site, f.kind, f.hit) for f in plan.log] == \
        [(f.site, f.kind, f.hit) for f in jplan.log]
    assert {k: rep.stats[k] for k in LM_COUNTERS} == \
        {k: jrep.stats[k] for k in LM_COUNTERS}
    streams = {r.uid: list(r.out_tokens) for r in reqs}
    jstreams = {r.uid: list(r.out_tokens) for r in jreqs}
    assert {u: streams[u] for u in rep.survivors} == \
        {u: jstreams[u] for u in rep.survivors}
    return rep


# test_faults.py's LM schedules, by its test names:
# (specs, serve config, requests, harness keywords)
SCHEDULES = {
    "prefill_fault_absorbed_by_retry": (
        [dict(site="engine.prefill", kind="raise", nth=2, times=1)],
        None, None, {}),
    "prefill_fault_exhausts_retries_to_error": (
        [dict(site="engine.prefill", kind="raise", nth=1, times=3)],
        None, None, {}),
    "decode_fault_retires_active_set_and_rebuilds": (
        [dict(site="engine.decode_round", kind="raise", nth=2, times=3)],
        None, dict(n=5), {}),
    "corrupt_round_is_contained": (
        [dict(site="engine.decode_round", kind="corrupt", nth=2)],
        None, dict(n=5), {}),
    "shedding_reject": (
        [], dict(max_queue=3, shed_policy="reject"), dict(n=6),
        dict(expect_fired=False)),
    "shedding_drop": (
        [], dict(max_queue=3, shed_policy="drop"), dict(n=6),
        dict(expect_fired=False)),
    "paged_pool_fault_backpressures_not_leaks": (
        [dict(site="blockpool.alloc", kind="raise", nth=2, times=2)],
        PAGED, dict(n=5, max_new=8), {}),
    "paged_decode_error_rebuilds_pool_clean": (
        [dict(site="engine.decode_round", kind="raise", nth=3, times=3)],
        PAGED, dict(n=5, max_new=8), {}),
    "static_prefill_raise": (
        [dict(site="engine.prefill", kind="raise", nth=1, times=1)],
        dict(scheduler="static"), None, {}),
    "static_decode_raise": (
        [dict(site="engine.decode_round", kind="raise", nth=1, times=3)],
        dict(scheduler="static"), None, {}),
    "static_decode_corrupt": (
        [dict(site="engine.decode_round", kind="corrupt", nth=2)],
        dict(scheduler="static"), None, {}),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_lm_chaos_equals_jax(name):
    specs, scfg_kw, req_kw, harness_kw = SCHEDULES[name]
    rep = assert_same(*lm_pair(specs, scfg_kw, req_kw, **harness_kw))
    st, by = rep.stats, sorted(rep.statuses.values())
    # test_faults.py's own assertions, on the port's report
    if name == "prefill_fault_absorbed_by_retry":
        assert by == ["ok"] * 4 and rep.fired == 1 and st["retries"] >= 1
    elif name == "prefill_fault_exhausts_retries_to_error":
        assert by == ["error", "ok", "ok", "ok"] and st["errors"] == 1
    elif name == "decode_fault_retires_active_set_and_rebuilds":
        assert by.count("error") == 2 and by.count("ok") == 3
        assert st["arena_rebuilds"] == 1 and st["requests_done"] == 5
    elif name == "corrupt_round_is_contained":
        assert by == ["ok"] * 5 and rep.poisoned and rep.survivors
        assert set(rep.survivors).isdisjoint(rep.poisoned)
    elif name.startswith("shedding"):
        assert by == ["ok", "ok", "ok", "shed", "shed", "shed"]
        if name.endswith("drop"):
            assert st["shed"] == 3
    elif name == "paged_pool_fault_backpressures_not_leaks":
        assert by == ["ok"] * 5
    elif name == "paged_decode_error_rebuilds_pool_clean":
        assert "error" in by and st["arena_rebuilds"] == 1
    else:
        assert set(by) <= {"ok", "error"}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_lm_seeded_probability_matrix_equals_jax(seed):
    rep = assert_same(*lm_pair(
        [dict(site="engine.decode_round", kind="raise", probability=0.2,
              times=2),
         dict(site="engine.prefill", kind="raise", probability=0.2,
              times=2)], req_kw=dict(n=6), seed=seed, expect_fired=False))
    assert set(rep.statuses.values()) <= {"ok", "error"}


def test_env_activation_end_to_end_equals_jax(monkeypatch):
    """``REPRO_FAULTS`` installed through ``install_from_env`` in both
    packages: the schedule fires once and is absorbed, the same way."""
    _, _, cfg, params = tiny_lm()
    monkeypatch.setenv("REPRO_FAULTS", "engine.decode_round:raise:nth=2:"
                       f"times=1;seed={SEED}")
    out = []
    for mod, make in ((inject, lambda: Engine(cfg, params, ServeConfig(
            max_batch=2, max_len=32))), (j_inject, lambda: jax_engine(
                max_batch=2, max_len=32))):
        mod.install_from_env(force=True)
        try:
            plan = mod.active_plan()
            assert plan is not None and plan.seed == SEED
            eng = make()
            cls = Request if mod is inject else JRequest
            for r in make_reqs(cls)():
                eng.submit(r)
            done = eng.run_until_drained()
            out.append(([r.status for r in done],
                        [list(r.out_tokens) for r in done],
                        [(f.site, f.hit) for f in plan.log],
                        eng.stats["retries"]))
        finally:
            mod.deactivate()
    assert out[0] == out[1]
    assert out[0][0] == ["ok"] * 4 and len(out[0][2]) == 1
    assert out[0][3] >= 1


# ------------------------------------------------------- the port's own --

@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_lm_deadline_cancels_at_round_boundary(layout):
    """Every decode round stalls 0.2 s against a 0.05 s deadline: requests
    get their first token, then cancel at a round boundary or at
    admission. Asserted only what holds however long a round takes."""
    _, _, cfg, params = tiny_lm()
    scfg = ServeConfig(max_batch=2, max_len=32, deadline_s=0.05,
                       **(PAGED if layout == "paged" else {}))
    rep = chaos.run_lm_chaos(
        lambda: Engine(cfg, params, scfg), make_reqs(Request),
        inject.FaultPlan([inject.FaultSpec(
            site="engine.decode_round", kind="delay", nth=1, times=10**6,
            delay_s=0.2)], SEED))
    assert set(rep.statuses.values()) <= {"ok", "timeout"}
    assert rep.stats["timeouts"] >= 1
    assert not rep.pool_violations and rep.ok, rep.summary()


def _dispatch_report(specs, layout, **req_kw):
    _, _, cfg, params = tiny_lm()
    scfg = ServeConfig(max_batch=2, max_len=32, precision="int8",
                       **(PAGED if layout == "paged" else {}))
    return chaos.run_lm_chaos(
        lambda: Engine(cfg, params, scfg), make_reqs(Request, **req_kw),
        inject.FaultPlan([inject.FaultSpec(**s) for s in specs], SEED))


#: the kernels.dispatch hits of the int8 engine: 3 FFN matmuls a layer, 2
#: layers, per prefill and per decode step; with 2 slots the first two
#: prefills take hits 1-12 and the first decode round 13-18
PER_CALL = 3 * TINY["n_layers"]


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("where,nth", [("prefill", 4),
                                       ("decode", 2 * PER_CALL + 3)])
def test_lm_dispatch_fault_once_is_retried(layout, where, nth):
    """One ``kernels.dispatch`` raise in the middle of a prefill (after
    its pages were taken) or of a decode round: the engine retries it,
    every stream equals the clean run's, the pool audits clean."""
    rep = _dispatch_report([dict(site="kernels.dispatch", kind="raise",
                                 nth=nth)], layout)
    assert rep.ok, rep.summary()
    assert set(rep.statuses.values()) == {"ok"}
    assert rep.fired == 1 and rep.stats["retries"] == 1
    assert rep.survivors == [0, 1, 2, 3] and rep.pool_violations == []


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_lm_dispatch_fault_persistent_errors(layout):
    """A persistent ``kernels.dispatch`` raise: every admission outlives
    its retries and retires ``error``; nothing runs as a plain version,
    no page leaks."""
    rep = _dispatch_report([dict(site="kernels.dispatch", kind="raise",
                                 nth=1, times=10**6)], layout)
    assert rep.ok, rep.summary()
    assert rep.statuses == dict.fromkeys(range(4), "error")
    assert rep.stats["errors"] == 4 and rep.stats["prefills"] == 0
    assert rep.fired == 12 and rep.pool_violations == []
