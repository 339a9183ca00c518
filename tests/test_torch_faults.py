"""The port's fault-injection core (``repro_torch.faults.inject``), its
``kernels.dispatch`` seam and the CNN side of the chaos harness against
the JAX package's ``repro.faults`` on the CPU.

* The fault plan: for a grid of plans (``nth`` / ``times``,
  ``probability`` at several seeds, ``delay``, several specs at one site)
  ``plan.log`` equals JAX's over one sequence of site hits; ``parse_env``
  on the same strings gives equal specs and bad ones the same
  ``ValueError``; ``FaultSpec``'s checks raise JAX's messages;
  ``Fired.apply`` gives equal float and integer arrays; ``reset``,
  nesting, ``install`` / ``deactivate`` and ``REPRO_FAULTS`` read at
  import behave the same.
* The ``kernels.dispatch`` seam: every ``"cuda"`` entry point hits it
  once per call, after its argument checks; ``"torch"`` never does; a
  raise propagates. In the port's ``CNNEngine`` a one-shot raise is
  retried and every request ends ``ok``; a persistent one ends the rounds
  in ``error`` with ``degraded`` 0. JAX's Pallas guard instead retries
  inside the dispatch and degrades the kernel to XLA, so JAX's engine
  serves every request ``ok`` and counts no retry: the port answers a
  kernel fault with no fallback, on purpose (ROADMAP C).
* CNN chaos: every CNN schedule of ``tests/test_faults.py`` through both
  packages' engines on the same plan (``cnn_setup``'s config lowered by
  JAX, carried across by ``weights.plan_from_numpy``), the same images
  and seed: equal
  statuses, survivors, poisoned sets, fires, logs and stats counters, the
  survivors' logits bitwise the port's clean run and within atol 1e-5 of
  JAX's (the float head sums in another order; tests/test_torch_graph.py).
  The one schedule whose outcome differs is the one that exhausts a
  round's retries: JAX's engine degrades the plan to XLA and serves, the
  port's retires the round as ``error`` (no plan degrades in the port).

Run here with ``PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q
tests/test_torch_faults.py``."""
import dataclasses
import json
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.faults import chaos as j_chaos  # noqa: E402
from repro.faults import inject as j_inject  # noqa: E402

from repro_torch import faults  # noqa: E402
from repro_torch.faults import chaos, inject  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402
from test_torch_chaos import Made  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SITES = sorted(inject.SITES)


@pytest.fixture(autouse=True)
def no_plan_leaks():
    """Every test starts and ends with no plan active in either package."""
    inject.deactivate()
    j_inject.deactivate()
    yield
    inject.deactivate()
    j_inject.deactivate()


# ---------------------------------------------------------------- the API --

@pytest.mark.parametrize("pair", [(j_inject, inject), (j_chaos, chaos)],
                         ids=["inject", "chaos"])
def test_public_names_exist_in_the_port(pair):
    jmod, mod = pair
    missing = {n for n in dir(jmod) if not n.startswith("_")
               and not hasattr(mod, n)}
    assert not missing, f"{mod.__name__} lacks {sorted(missing)}"


def test_package_exports_and_constants_equal_jax():
    import repro.faults as jfaults
    assert faults.__all__ == jfaults.__all__
    assert inject.SITES == j_inject.SITES
    assert inject.KINDS == j_inject.KINDS
    assert inject.CORRUPT_SITES == j_inject.CORRUPT_SITES
    assert inject.ENV_VAR == j_inject.ENV_VAR == "REPRO_FAULTS"
    assert chaos.TERMINAL == j_chaos.TERMINAL


BAD_SPECS = [
    dict(site="engine.nope", kind="raise"),
    dict(site="engine.prefill", kind="explode"),
    dict(site="blockpool.alloc", kind="corrupt"),
    dict(site="kernels.dispatch", kind="corrupt"),
    dict(site="engine.prefill", kind="raise", nth=1, probability=0.5),
    dict(site="engine.prefill", kind="raise", nth=0),
    dict(site="engine.prefill", kind="raise", probability=1.5),
    dict(site="engine.prefill", kind="raise", probability=0.0),
    dict(site="engine.prefill", kind="raise", times=0),
    dict(site="engine.prefill", kind="delay", delay_s=-1),
]


@pytest.mark.parametrize("kw", BAD_SPECS, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_spec_checks_raise_jax_messages(kw):
    with pytest.raises(ValueError) as got:
        inject.FaultSpec(**kw)
    with pytest.raises(ValueError) as want:
        j_inject.FaultSpec(**kw)
    assert str(got.value) == str(want.value)


def test_spec_defaults_equal_jax():
    for kw in (dict(site="engine.prefill", kind="raise"),
               dict(site="kernels.dispatch", kind="delay", probability=0.3),
               dict(site="cnn.batch_round", kind="corrupt", nth=4, times=2)):
        assert dataclasses.asdict(inject.FaultSpec(**kw)) == \
            dataclasses.asdict(j_inject.FaultSpec(**kw))


# ------------------------------------------------------ firing and the log --

#: plans as (specs, seed); delays are 0 s so the grid runs in no time
PLANS = [
    ([dict(site="engine.prefill", kind="raise", nth=3, times=2)], 0),
    ([dict(site="engine.decode_round", kind="corrupt", nth=1, times=5)], 7),
    *[([dict(site="engine.decode_round", kind="raise", probability=0.4,
             times=100)], seed) for seed in (0, 1, 2, 41)],
    *[([dict(site="kernels.dispatch", kind="raise", probability=0.05,
             times=3),
        dict(site="cnn.batch_round", kind="delay", probability=0.3,
             times=4, delay_s=0.0)], seed) for seed in (0, 5)],
    ([dict(site="engine.prefill", kind="raise", nth=2, times=2),
      dict(site="engine.prefill", kind="corrupt", nth=3, times=3),
      dict(site="engine.prefill", kind="delay", probability=0.5, times=3,
           delay_s=0.0)], 3),
    ([dict(site="blockpool.alloc", kind="raise", probability=1.0, times=2),
      dict(site="tune.cache_load", kind="delay", nth=2, delay_s=0.0),
      dict(site="engine.decode_round", kind="corrupt", probability=0.2,
           times=10**6)], 11),
]


def _drive(mod, plan, hits):
    """Hit ``plan`` (a ``mod.FaultPlan``) at each site of ``hits`` in
    order; returns the outcome of each hit and the log as tuples."""
    out = []
    for site in hits:
        try:
            got = plan.hit(site)
        except mod.InjectedFault as e:
            out.append(("raise", str(e)))
            continue
        out.append(None if got is None else ("directive", got.hit))
    return out, [(f.site, f.kind, f.hit, f.seed) for f in plan.log]


@pytest.mark.parametrize("case", range(len(PLANS)))
def test_plan_log_equals_jax_over_one_hit_sequence(case):
    specs, seed = PLANS[case]
    hits = list(np.random.default_rng(case).choice(SITES, 300))
    plan = inject.FaultPlan([inject.FaultSpec(**s) for s in specs], seed)
    jplan = j_inject.FaultPlan([j_inject.FaultSpec(**s) for s in specs],
                               seed)
    got = _drive(inject, plan, hits)
    assert got == _drive(j_inject, jplan, hits)
    assert got[1], "the plan never fired on this hit sequence"
    # reset: the same plan over the same hits fires identically again
    plan.reset()
    assert plan.log == []
    assert _drive(inject, plan, hits) == got


def test_probability_counts_fires_and_nth_counts_a_window():
    plan = inject.FaultPlan([inject.FaultSpec(
        site="engine.decode_round", kind="raise", probability=1.0, times=3)])
    assert _drive(inject, plan, ["engine.decode_round"] * 6)[1] == \
        [("engine.decode_round", "raise", h, 0) for h in (1, 2, 3)]
    plan = inject.FaultPlan([inject.FaultSpec(
        site="engine.prefill", kind="raise", nth=3, times=2)])
    assert [f.hit for f in plan.log] == []
    _drive(inject, plan, ["engine.prefill"] * 7 + ["engine.decode_round"])
    assert [f.hit for f in plan.log] == [3, 4]


def test_fired_counter_and_delay():
    before = metrics.counter("faults.fired.engine.prefill").value
    plan = inject.FaultPlan([inject.FaultSpec(
        site="engine.prefill", kind="delay", nth=1, delay_s=0.05)])
    with plan:
        t0 = time.perf_counter()
        assert inject.check("engine.prefill") is None
        assert time.perf_counter() - t0 >= 0.04
    assert len(plan.log) == 1
    assert metrics.counter("faults.fired.engine.prefill").value == before + 1


@pytest.mark.parametrize("dtype", ["float32", "float64", "int8", "int32",
                                   "uint8", "int64"])
@pytest.mark.parametrize("hit,seed", [(1, 0), (3, 7), (4, 2**40 + 5)])
def test_fired_apply_equals_jax(dtype, hit, seed):
    x = (np.linspace(-1.0, 1.0, 64).reshape(4, 16) * 50).astype(dtype)
    f = inject.Fired(site="engine.decode_round", kind="corrupt", hit=hit,
                     seed=seed)
    jf = j_inject.Fired(site="engine.decode_round", kind="corrupt", hit=hit,
                        seed=seed)
    got = f.apply(x)
    np.testing.assert_array_equal(got, jf.apply(x))
    assert got.dtype == x.dtype and not np.array_equal(got, x)
    if np.issubdtype(x.dtype, np.integer):
        assert got.max() == np.iinfo(x.dtype).max
    assert f.apply(np.zeros((0,), dtype)).size == 0


def test_nesting_install_and_deactivate():
    outer = inject.FaultPlan([inject.FaultSpec(
        site="engine.prefill", kind="raise", nth=10**9)])
    inner = inject.FaultPlan([])
    assert inject.active_plan() is None
    assert inject.check("engine.prefill") is None
    with outer:
        assert inject.active_plan() is outer
        with inner:
            assert inject.active_plan() is inner
        assert inject.active_plan() is outer
    assert inject.active_plan() is None
    inject.install(outer)
    assert inject.active_plan() is outer
    inject.check("engine.prefill")
    assert outer._hits == {"engine.prefill": 1}
    inject.deactivate()
    assert inject.active_plan() is None


# ------------------------------------------------------------ REPRO_FAULTS --

ENV_STRINGS = [
    "engine.decode_round:raise:nth=2:times=3;"
    "kernels.dispatch:delay:p=0.25:delay=0.01; seed=41",
    "engine.decode_round:raise:nth=2:times=1;seed=7",
    "kernels.dispatch:raise:p=0.05:times=3",
    " ; cnn.batch_round:corrupt ;; blockpool.alloc:raise:nth=4 ",
    "",
]
BAD_ENV = [
    "engine.decode_round",
    "engine.decode_round:raise:nth",
    "engine.decode_round:raise:bogus=1",
    "engine.bogus:raise",
    "kernels.dispatch:corrupt",
    "engine.prefill:raise:nth=1:p=0.5",
    "engine.prefill:raise:nth=x",
    "seed=x",
]


def _plan_dict(plan):
    return {"seed": plan.seed,
            "specs": [dataclasses.asdict(s) for s in plan.specs]}


@pytest.mark.parametrize("s", ENV_STRINGS)
def test_parse_env_equals_jax(s):
    assert _plan_dict(inject.parse_env(s)) == \
        _plan_dict(j_inject.parse_env(s))


@pytest.mark.parametrize("s", BAD_ENV)
def test_parse_env_errors_equal_jax(s):
    with pytest.raises(ValueError) as got:
        inject.parse_env(s)
    with pytest.raises(ValueError) as want:
        j_inject.parse_env(s)
    assert str(got.value) == str(want.value)


def test_install_from_env(monkeypatch):
    s = "engine.decode_round:raise:nth=2:times=1;seed=9"
    monkeypatch.setenv("REPRO_FAULTS", s)
    held = inject.FaultPlan([])
    inject.install(held)
    inject.install_from_env()              # a plan is active: kept
    assert inject.active_plan() is held
    inject.install_from_env(force=True)
    j_inject.install_from_env(force=True)
    assert _plan_dict(inject.active_plan()) == \
        _plan_dict(j_inject.active_plan())
    monkeypatch.setenv("REPRO_FAULTS", "")
    inject.deactivate()
    inject.install_from_env(force=True)
    assert inject.active_plan() is None


def test_repro_faults_is_read_at_import():
    """A fresh interpreter with ``REPRO_FAULTS`` set has the plan active as
    soon as the port's faults package is imported, which pulls in neither
    the chaos harness nor the serve stack."""
    s = "kernels.dispatch:raise:p=0.05:times=3;engine.prefill:delay;seed=3"
    code = ("import json, dataclasses, sys\n"
            "from repro_torch.faults import active_plan\n"
            "assert not {'repro_torch.faults.chaos', 'repro_torch.serve'}"
            " & set(sys.modules)\n"
            "p = active_plan()\n"
            "print(json.dumps({'seed': p.seed, 'specs': "
            "[dataclasses.asdict(x) for x in p.specs]}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_FAULTS=s)
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout) == _plan_dict(j_inject.parse_env(s))


# ------------------------------------------------ the kernels.dispatch seam --

def _calls():
    """One small call of every entry point, as (label, fn(method))."""
    rng = np.random.default_rng(0)

    def i8(*shape):
        return torch.from_numpy(rng.integers(-60, 60, shape).astype(np.int8))

    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x8, xf = i8(1, 6, 6, 4), f(1, 6, 6, 4)
    w8, wf, dw8, pw8 = i8(3, 3, 4, 5), f(3, 3, 4, 5), i8(3, 3, 4), i8(4, 5)
    a8, b8, af, bf = i8(2, 3, 8), i8(8, 5), f(3, 8), f(8, 5)
    xc, wc = f(1, 7, 4), f(3, 4)
    shifts = torch.from_numpy(rng.integers(-1, 2, (4, 2)).astype(np.int32))
    return [
        ("conv2d_q8", lambda m: ops.conv2d(x8, w8, method=m,
                                           requant_shift=7)),
        ("conv2d_f", lambda m: ops.conv2d(xf, wf, method=m)),
        ("depthwise2d_q8", lambda m: ops.depthwise2d(
            x8, dw8, method=m, requant_shift=5)),
        ("shift_conv2d_q8", lambda m: ops.shift_conv2d(
            x8, shifts, pw8, method=m, requant_shift=6, max_shift=1)),
        ("add_conv2d_q8", lambda m: ops.add_conv2d(
            x8, w8, method=m, requant_shift=6)),
        ("maxpool2d_s8", lambda m: ops.maxpool2d(x8, method=m)),
        ("matmul_q8", lambda m: ops.matmul(a8, b8, method=m,
                                           requant_shift=4)),
        ("matmul_f", lambda m: ops.matmul(af, bf, method=m)),
        ("causal_conv1d", lambda m: ops.causal_conv1d(xc, wc, method=m)),
    ]


@pytest.mark.parametrize("i", range(9), ids=[c[0] for c in _calls()])
def test_dispatch_seam_hit_by_cuda_not_by_torch(i):
    label, call = _calls()[i]
    plan = inject.FaultPlan([inject.FaultSpec(
        site="kernels.dispatch", kind="raise", nth=10**9)])
    with plan:
        want = call("torch")
        assert plan._hits.get("kernels.dispatch", 0) == 0
        got = call("cuda")
        assert plan._hits["kernels.dispatch"] == 1
    assert torch.equal(got, want) or torch.allclose(got, want, atol=1e-5)
    with inject.FaultPlan([inject.FaultSpec(
            site="kernels.dispatch", kind="raise", nth=1)]) as plan:
        with pytest.raises(inject.InjectedFault, match="kernels.dispatch"):
            call("cuda")
        call("torch")                       # never hits the seam
    assert [f.hit for f in plan.log] == [1]


def test_dispatch_seam_after_the_argument_checks():
    x = torch.zeros((1, 4, 4, 2), dtype=torch.int8)
    w = torch.zeros((3, 3, 1, 3), dtype=torch.int8)
    plan = inject.FaultPlan([inject.FaultSpec(
        site="kernels.dispatch", kind="raise", nth=1, times=10**6)])
    with plan:
        with pytest.raises(ValueError, match="W4 weights need"):
            ops.conv2d(x, w, w_shifts=torch.zeros(2, dtype=torch.int8))
        with pytest.raises(ValueError, match="unknown method"):
            ops.conv2d(x, w, method="pallas")
        with pytest.raises(ValueError, match="bias without requant_shift"):
            ops.shift_conv2d(x.float(), torch.zeros((2, 2), dtype=torch.int32),
                             torch.zeros((2, 3)), torch.zeros(3))
        with ops.force_method("torch"):     # forced plain: no seam
            ops.maxpool2d(x, method="cuda")
    assert plan.log == [] and plan._hits == {}


def test_dispatch_counters_count_the_faulted_call():
    x = torch.zeros((1, 4, 4, 2), dtype=torch.int8)
    c = metrics.counter("kernels.dispatch.maxpool2d.cuda")
    before = c.value
    with inject.FaultPlan([inject.FaultSpec(site="kernels.dispatch",
                                            kind="raise")]):
        with pytest.raises(inject.InjectedFault):
            ops.maxpool2d(x)
    assert c.value == before + 1


def test_dispatch_delay_runs_the_kernel_after_it():
    x = torch.from_numpy(np.arange(32, dtype=np.int8).reshape(1, 4, 4, 2))
    with inject.FaultPlan([inject.FaultSpec(
            site="kernels.dispatch", kind="delay", nth=1, delay_s=0.02)]):
        t0 = time.perf_counter()
        got = ops.maxpool2d(x)
        assert time.perf_counter() - t0 >= 0.015
    assert torch.equal(got, ops.maxpool2d(x, method="torch"))


# ------------------------------------------------------------- CNN chaos --

def jax_cnn_plan():
    """(JAX plan, the port's copy): ``tests/test_faults.py``'s
    ``cnn_setup`` config (standard, widths (8, 12), 16x16 images) lowered
    by JAX on a 4-image calibration batch, with seeded numpy weights in the
    layout of JAX's ``init_cnn`` (traced for its shapes, not run: running
    it compiles each small op, about 13 s on a CPU host) at its scales:
    normal weights * fan_in^-1/2, zero biases, unit BN."""
    from repro.graph import build_cnn_graph as j_build
    from repro.graph import lower as j_lower
    from repro.models.convnet import CNNConfig as JCNNConfig
    from repro.models.convnet import init_cnn as j_init_cnn
    from repro_torch.weights import plan_from_numpy
    from test_torch_graph import plan_to_numpy
    jcfg = JCNNConfig(primitive="standard", widths=(8, 12), image_size=16)
    rng = np.random.default_rng(1)

    def leaf(path, s):
        name = path[-1].key if hasattr(path[-1], "key") else "head"
        if name in ("gamma", "var"):
            return np.ones(s.shape, np.float32)
        if name in ("beta", "mean", "b"):
            return np.zeros(s.shape, np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.standard_normal(s.shape) * fan_in ** -0.5) \
            .astype(np.float32)
    shapes = jax.eval_shape(lambda: j_init_cnn(jcfg, jax.random.PRNGKey(1)))
    jparams = jax.tree_util.tree_map_with_path(leaf, shapes)
    calib = (rng.standard_normal((4, 16, 16, 3)) * 0.5).astype(np.float32)
    jplan = j_lower(j_build(jcfg), jparams, calib)
    return jplan, plan_from_numpy(plan_to_numpy(jplan), jplan.in_fb,
                                  device="cpu")


@pytest.fixture(scope="module")
def cnn():
    """JAX's plan and the port's copy (:func:`jax_cnn_plan`); JAX's xla
    CompiledPlan made once (each one's jit compiles)."""
    from repro.graph import CompiledPlan as JCompiledPlan
    jplan, plan = jax_cnn_plan()
    return dict(jplan=jplan, plan=plan,
                jxla=JCompiledPlan(jplan, method="xla"))


def _images(cls, n=6):
    rng = np.random.default_rng(0)                 # test_faults.make_images
    return [cls(uid, rng.normal(size=(16, 16, 3)).astype(np.float32) * 0.5)
            for uid in range(n)]


CNN_COUNTERS = ("batch_rounds", "images_done", "timeouts", "errors", "shed",
                "retries", "degraded")


def _cnn_pair(cnn, specs, method="torch", jplan=None, expect_fired=True,
              **scfg):
    """One schedule through both harnesses; returns the port's report and
    requests, and JAX's. JAX's engines serve ``jplan()`` (a fresh plan
    per engine where a schedule needs one: JAX's ``kernels.dispatch`` seam
    fires per jit trace), by default the shared xla plan."""
    from repro.serve import CNNEngine as JCNNEngine
    from repro.serve import CNNServeConfig as JCNNServeConfig
    from repro.serve import ImageRequest as JImageRequest
    from repro_torch.graph import CompiledPlan
    from repro_torch.serve import CNNEngine, CNNServeConfig, ImageRequest
    scfg = dict(dict(max_batch=4), **scfg)
    made, jmade = (Made(lambda: _images(ImageRequest)),
                   Made(lambda: _images(JImageRequest)))
    rep = chaos.run_cnn_chaos(
        lambda: CNNEngine(CompiledPlan(cnn["plan"], method=method,
                                       device="cpu"), CNNServeConfig(**scfg)),
        made, inject.FaultPlan([inject.FaultSpec(**s) for s in specs]),
        expect_fired=expect_fired)
    jplan = jplan or (lambda: cnn["jxla"])
    jrep = j_chaos.run_cnn_chaos(
        lambda: JCNNEngine(jplan(), JCNNServeConfig(**scfg)), jmade,
        j_inject.FaultPlan([j_inject.FaultSpec(**s) for s in specs]),
        expect_fired=expect_fired)
    return rep, made.lists[-1], jrep, jmade.lists[-1]


def _assert_same_report(rep, jrep, counters=CNN_COUNTERS):
    assert rep.ok and jrep.ok, (rep.summary(), jrep.summary())
    assert rep.statuses == jrep.statuses
    assert rep.survivors == jrep.survivors
    assert rep.poisoned == jrep.poisoned
    assert rep.fired == jrep.fired
    assert {k: rep.stats[k] for k in counters} == \
        {k: jrep.stats[k] for k in counters}


def _assert_logits_near_jax(reqs, jreqs):
    for r, jr in zip(reqs, jreqs):
        if r.status == "ok":
            np.testing.assert_allclose(r.logits, np.asarray(jr.logits),
                                       rtol=0, atol=1e-5)


CNN_SCHEDULES = {
    "round_fault_absorbed": [dict(site="cnn.batch_round", kind="raise",
                                  nth=1, times=2)],
    "corrupt_round_contained": [dict(site="cnn.batch_round",
                                     kind="corrupt", nth=1)],
    "probability": [dict(site="cnn.batch_round", kind="raise",
                         probability=0.5, times=2)],
}


@pytest.mark.parametrize("name", list(CNN_SCHEDULES))
def test_cnn_chaos_equals_jax(cnn, name):
    rep, reqs, jrep, jreqs = _cnn_pair(cnn, CNN_SCHEDULES[name],
                                       expect_fired=name != "probability")
    _assert_same_report(rep, jrep)
    _assert_logits_near_jax(reqs, jreqs)
    if name == "round_fault_absorbed":
        assert set(rep.statuses.values()) == {"ok"}
        assert rep.stats["retries"] >= 2
    if name == "corrupt_round_contained":
        assert len(rep.poisoned) == 4 and len(rep.survivors) == 2


def test_cnn_exhausted_retries_error_where_jax_degrades(cnn):
    """The documented difference: three raises on one round exhaust its
    retries. JAX's engine degrades the plan to XLA and serves the round;
    the port's retires it with ``error`` and serves the next round."""
    from repro.graph import CompiledPlan as JCompiledPlan
    spec = [dict(site="cnn.batch_round", kind="raise", nth=1, times=3)]
    jex = JCompiledPlan(cnn["jplan"], method="xla")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        rep, reqs, jrep, jreqs = _cnn_pair(cnn, spec, jplan=lambda: jex)
    assert rep.ok and jrep.ok, (rep.summary(), jrep.summary())
    assert rep.fired == jrep.fired == 3
    assert jrep.statuses == dict.fromkeys(range(6), "ok")
    assert jrep.stats["degraded"] == 1
    assert rep.statuses == {0: "error", 1: "error", 2: "error", 3: "error",
                            4: "ok", 5: "ok"}
    assert rep.stats["degraded"] == 0 and rep.stats["errors"] == 4
    assert rep.survivors == [4, 5]
    _assert_logits_near_jax(reqs, jreqs)


def test_cnn_persistent_round_fault_errors_as_jax(cnn):
    """Round faults that outlast every retry end every round in ``error``
    in both engines; JAX's degrades its plan once on the way (``degraded``
    1), the port's never (``degraded`` 0)."""
    from repro.graph import CompiledPlan as JCompiledPlan
    from repro.serve import CNNEngine as JCNNEngine
    from repro.serve import CNNServeConfig as JCNNServeConfig
    from repro.serve import ImageRequest as JImageRequest
    from repro_torch.graph import CompiledPlan
    from repro_torch.serve import CNNEngine, CNNServeConfig, ImageRequest
    spec = dict(site="cnn.batch_round", kind="raise", nth=1, times=10**6)
    runs = []
    for mod, eng, cls in (
            (inject, CNNEngine(CompiledPlan(cnn["plan"], method="torch",
                                            device="cpu"),
                               CNNServeConfig(max_batch=4)), ImageRequest),
            (j_inject, JCNNEngine(JCompiledPlan(cnn["jplan"], method="xla"),
                                  JCNNServeConfig(max_batch=4)),
             JImageRequest)):
        with mod.FaultPlan([mod.FaultSpec(**spec)]), \
                warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            for r in _images(cls, 3):
                eng.submit(r)
            done = eng.run_until_drained()
        runs.append(([r.status for r in done],
                     {k: eng.stats[k] for k in CNN_COUNTERS}))
    assert runs[0][0] == runs[1][0] == ["error"] * 3
    assert runs[0][1]["degraded"] == 0 and runs[1][1]["degraded"] == 1
    for st in (runs[0][1], runs[1][1]):
        del st["degraded"]
    assert runs[0][1] == runs[1][1] and runs[0][1]["errors"] == 3


def test_cnn_deadline_and_shedding_equal_jax(cnn):
    from repro.serve import CNNEngine as JCNNEngine
    from repro.serve import CNNServeConfig as JCNNServeConfig
    from repro.serve import ImageRequest as JImageRequest
    from repro.serve import QueueFullError as JQueueFullError
    from repro_torch.graph import CompiledPlan
    from repro_torch.serve import (CNNEngine, CNNServeConfig, ImageRequest,
                                   QueueFullError)
    ex = CompiledPlan(cnn["plan"], method="torch", device="cpu")
    out = []
    for eng_cls, scfg_cls, cls, full, plan in (
            (CNNEngine, CNNServeConfig, ImageRequest, QueueFullError, ex),
            (JCNNEngine, JCNNServeConfig, JImageRequest, JQueueFullError,
             cnn["jxla"])):
        eng = eng_cls(plan, scfg_cls(max_batch=2, max_queue=3,
                                     shed_policy="reject"))
        shed = 0
        for r in _images(cls, 5):
            try:
                eng.submit(r)
            except full:
                shed += 1
        done = eng.run_until_drained()
        eng2 = eng_cls(plan, scfg_cls(max_batch=2, deadline_s=1e-9))
        for r in _images(cls, 2):
            eng2.submit(r)
        done2 = eng2.run_until_drained()
        out.append((shed, [r.status for r in done], [r.status for r in done2],
                    {k: eng.stats[k] for k in CNN_COUNTERS},
                    {k: eng2.stats[k] for k in CNN_COUNTERS}))
    assert out[0] == out[1]
    assert out[0][0] == 2 and out[0][2] == ["timeout"] * 2


def _port_cnn_chaos(cnn, specs):
    """One schedule through the port's harness on a ``"cuda"`` plan (its
    plain versions here, behind the ``kernels.dispatch`` seam); returns
    the report and the faulted run's requests."""
    from repro_torch.graph import CompiledPlan
    from repro_torch.serve import CNNEngine, CNNServeConfig, ImageRequest
    made = Made(lambda: _images(ImageRequest))
    rep = chaos.run_cnn_chaos(
        lambda: CNNEngine(CompiledPlan(cnn["plan"], method="cuda",
                                       device="cpu"),
                          CNNServeConfig(max_batch=4)),
        made, inject.FaultPlan([inject.FaultSpec(**s) for s in specs]))
    return rep, made.lists[-1]


def _jax_served(cnn):
    """JAX's images through its xla plan, as requests (the reference the
    port's logits are held to)."""
    from repro.serve import CNNEngine as JCNNEngine
    from repro.serve import CNNServeConfig as JCNNServeConfig
    from repro.serve import ImageRequest as JImageRequest
    eng = JCNNEngine(cnn["jxla"], JCNNServeConfig(max_batch=4))
    reqs = _images(JImageRequest)
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return reqs


def test_cnn_dispatch_fault_once_is_retried(cnn):
    """A one-shot ``kernels.dispatch`` raise in a ``"cuda"`` plan's forward
    is retried by the engine; every request ends ``ok`` with the clean
    run's logits (and JAX's within 1e-5), and nothing degrades."""
    rep, reqs = _port_cnn_chaos(
        cnn, [dict(site="kernels.dispatch", kind="raise", nth=1)])
    assert rep.ok, rep.summary()
    assert rep.statuses == dict.fromkeys(range(6), "ok")
    assert rep.fired == 1 and rep.survivors == list(range(6))
    assert rep.stats["retries"] == 1 and rep.stats["degraded"] == 0
    _assert_logits_near_jax(reqs, _jax_served(cnn))


def test_cnn_dispatch_fault_persistent_errors_where_jax_degrades(cnn):
    """A persistent ``kernels.dispatch`` raise: every round of the port's
    engine ends ``error`` with ``degraded`` 0, and no kernel ran as its
    plain version. JAX's Pallas guard retries inside the dispatch and
    degrades each kernel to XLA, so JAX's engine serves every request
    ``ok`` with no engine-level retry: the documented difference."""
    from repro.graph import CompiledPlan as JCompiledPlan
    from repro.kernels import ops as j_ops
    from repro.serve import CNNEngine as JCNNEngine
    from repro.serve import CNNServeConfig as JCNNServeConfig
    from repro.serve import ImageRequest as JImageRequest
    spec = dict(site="kernels.dispatch", kind="raise", nth=1, times=10**6)
    torch_calls = metrics.counter("kernels.dispatch.conv2d.torch")
    before = torch_calls.value
    rep, _ = _port_cnn_chaos(cnn, [spec])
    assert rep.ok, rep.summary()
    assert rep.statuses == dict.fromkeys(range(6), "error")
    assert rep.stats["errors"] == 6 and rep.stats["degraded"] == 0
    assert rep.stats["retries"] == 4 and rep.fired == 6
    assert rep.survivors == [] and torch_calls.value == before
    j_ops.reset_degraded()
    try:
        eng = JCNNEngine(JCompiledPlan(cnn["jplan"], method="pallas"),
                         JCNNServeConfig(max_batch=4))
        with j_inject.FaultPlan([j_inject.FaultSpec(**spec)]), \
                warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            for r in _images(JImageRequest):
                eng.submit(r)
            done = eng.run_until_drained()
        assert set(j_ops.degraded()) == {"conv2d", "maxpool2d"}
    finally:
        j_ops.reset_degraded()
    assert [r.status for r in done] == ["ok"] * 6
    assert eng.stats["retries"] == eng.stats["degraded"] == 0
