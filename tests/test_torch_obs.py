"""The port's tracer and metrics registry (``repro_torch.obs``) against the
JAX package's ``repro.obs`` on the CPU.

* The tracer: the same call sequence on both packages' ``Tracer`` gives
  equal events once ``ts``, ``pid`` and a thread ``tid`` are dropped (the
  same names, ``ph``, ``cat``, ``args`` and order); ``to_chrome`` has the
  same keys; an exported file loads as JSON; ``traced``, the
  ``REPRO_TRACE`` gating and the disabled no-ops behave the same; lanes
  from ``next_lane`` are unique. The span categories of the executor's
  profile (``graph.profile``) and the tuner's candidates (``tune``) are
  the events' own ``cat``.
* The metrics: after the same observations, ``snapshot()`` and
  ``to_json()`` equal JAX's.
* The request lanes: a traced drain of the LM ``Engine`` and of the
  ``CNNEngine`` gives the same lanes, span names and args as JAX's, times
  left out (and ``submit_wall_t``, a wall-clock stamp).
* Every public name of JAX's ``obs.trace`` and ``obs.metrics`` exists in
  the port.

Run here with ``PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q
tests/test_torch_obs.py``."""
import json
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.obs import metrics as j_metrics  # noqa: E402
from repro.obs import trace as j_trace  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402
from repro_torch.obs import trace  # noqa: E402

LANE_BASE = 1 << 20


@pytest.mark.parametrize("pair", [(j_trace, trace), (j_metrics, metrics)],
                         ids=["trace", "metrics"])
def test_public_names_exist_in_the_port(pair):
    jmod, mod = pair
    missing = {n for n in dir(jmod) if not n.startswith("_")
               and not hasattr(mod, n)}
    assert not missing, f"{mod.__name__} lacks {sorted(missing)}"


def test_obs_package_exports():
    import repro.obs as jobs
    assert set(jobs.__all__) <= set(obs.__all__)
    assert obs.traced is trace.traced


# ------------------------------------------------------------- the tracer --

def _sequence(tm, tr):
    """One call sequence over the tracer API of module ``tm``: spans with
    attributes and ``set``, nesting, explicit lanes and categories, stamped
    begin / end / complete; ``tr`` is a ``tm.Tracer``."""
    with tr.span("outer", a=1, cat="graph.profile") as sp:
        with tr.span("inner", tid=7):
            pass
        sp.set(us=3.5)
    tr.begin("req", ts=1.0, tid=LANE_BASE + 5, uid=3, cat="serve")
    tr.complete("queue_wait", 1.0, 1.5, tid=LANE_BASE + 5)
    tr.complete("gen", 1.5, 2.0, tid=LANE_BASE + 5, tokens=4)
    tr.end("req", ts=2.0, tid=LANE_BASE + 5)
    tr.begin("open", x="y")
    tr.end("open", done=True)
    with tr.span("tune.candidate", cat="tune", config={"bp": 64}):
        pass


def _norm(events, thread):
    """Events with ``ts`` and ``pid`` dropped and the calling thread's id
    written as "thread" (the lanes and explicit tids kept)."""
    out = []
    for ev in events:
        ev = dict(ev)
        ev.pop("ts")
        ev.pop("pid")
        if ev["tid"] == thread:
            ev["tid"] = "thread"
        out.append(ev)
    return out


def test_events_equal_jax_without_times():
    jt, pt = j_trace.Tracer(enabled=True), trace.Tracer(enabled=True)
    _sequence(j_trace, jt)
    _sequence(trace, pt)
    me = threading.get_ident()
    assert _norm(pt.events(), me) == _norm(jt.events(), me)
    assert [e["cat"] for e in pt.events()][:2] == ["graph.profile", "repro"]
    # recorded stamps are rebased onto the tracer's clock, in microseconds
    ev = {(e["name"], e["ph"]): e for e in pt.events()}
    assert ev[("gen", "E")]["ts"] - ev[("req", "B")]["ts"] == \
        pytest.approx(1e6)


def test_to_chrome_and_export(tmp_path):
    jt, pt = j_trace.Tracer(enabled=True), trace.Tracer(enabled=True)
    _sequence(j_trace, jt)
    _sequence(trace, pt)
    jc, pc = jt.to_chrome(), pt.to_chrome()
    assert set(pc) == set(jc)
    assert set(pc["otherData"]) == set(jc["otherData"])
    assert pc["otherData"]["source"] == "repro_torch.obs.trace"
    assert pc["displayTimeUnit"] == jc["displayTimeUnit"] == "ms"
    path = pt.export(str(tmp_path / "sub" / "trace.json"))
    loaded = json.loads(Path(path).read_text())
    assert loaded["traceEvents"] == pt.events()
    for ev in loaded["traceEvents"]:
        assert {"ph", "name", "cat", "ts", "pid", "tid"} <= set(ev)


def test_disabled_tracer_is_a_noop():
    for tm in (j_trace, trace):
        tr = tm.Tracer(enabled=False)
        sp = tr.span("x", a=1)
        assert sp is tm._NULL_SPAN
        with sp as s:
            s.set(b=2)
        tr.begin("x")
        tr.end("x")
        tr.complete("x", 0.0, 1.0)
        assert tr.events() == []
        assert tr.to_chrome()["traceEvents"] == []


@pytest.mark.parametrize("value,on", [("", False), ("0", False), ("1", True),
                                      ("yes", True)])
def test_env_gating(monkeypatch, value, on):
    monkeypatch.setenv("REPRO_TRACE", value)
    assert trace.Tracer().enabled is j_trace.Tracer().enabled is on
    assert trace.Tracer(enabled=not on).enabled is (not on)


def _traced_events(tm):
    """``traced`` with and without a label on the process tracer of
    ``tm``, disabled then enabled; returns (results, events)."""
    @tm.traced()
    def plain(x):
        return x + 1

    @tm.traced("labelled", cat="tune")
    def named(x):
        return x * 2

    was = tm.enabled()
    tm.disable()
    before = len(tm.TRACER.events())
    try:
        res = [plain(1), named(2)]
        tm.enable()
        assert tm.enabled()
        res += [plain(3), named(4)]
    finally:
        if not was:
            tm.disable()
    return res, tm.TRACER.events()[before:]


def test_traced_decorator_equals_jax():
    jres, jev = _traced_events(j_trace)
    res, ev = _traced_events(trace)
    assert res == jres == [2, 4, 4, 8]
    me = threading.get_ident()
    names = [(e["ph"], e["name"].rsplit(".", 1)[-1], e["cat"])
             for e in _norm(ev, me)]
    assert names == [(e["ph"], e["name"].rsplit(".", 1)[-1], e["cat"])
                     for e in _norm(jev, me)]
    assert names == [("B", "plain", "repro"), ("E", "plain", "repro"),
                     ("B", "labelled", "tune"), ("E", "labelled", "tune")]


def test_module_level_functions(tmp_path):
    was = trace.enabled()
    trace.enable()
    try:
        trace.clear()
        with trace.span("m", tid=9, cat="c", k=1):
            pass
        evs = trace.TRACER.events()
        assert [(e["ph"], e["tid"], e["cat"]) for e in evs] == \
            [("B", 9, "c"), ("E", 9, "c")]
        path = trace.export(str(tmp_path / "t.json"))
        assert len(json.loads(Path(path).read_text())["traceEvents"]) == 2
        trace.clear()
        assert trace.TRACER.events() == []
    finally:
        if not was:
            trace.disable()


def test_next_lane_unique_across_threads():
    lanes = []

    def take():
        lanes.extend(trace.next_lane() for _ in range(200))
    ts = [threading.Thread(target=take) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert len(set(lanes)) == 800 and min(lanes) > LANE_BASE


def test_profile_and_tuner_spans_carry_their_category():
    """The executor's per-layer profile spans and the tuner's candidate
    spans carry ``graph.profile`` and ``tune`` as the event's category,
    not in its args."""
    from repro_torch.graph import CompiledPlan, build_cnn_graph, lower
    from repro_torch.models import CNNConfig, init_cnn
    from repro_torch import tune
    cfg = CNNConfig(primitive="dws", widths=(8,), image_size=8)
    params = init_cnn(cfg, torch.Generator().manual_seed(0), device="cpu")
    x = (np.random.default_rng(0).standard_normal((2, 8, 8, 3)) * 0.5) \
        .astype(np.float32)
    plan = CompiledPlan(lower(build_cnn_graph(cfg), params,
                              torch.from_numpy(x)),
                        method="torch", device="cpu")
    was = trace.enabled()
    trace.enable()
    before = len(trace.TRACER.events())
    try:
        plan.profile(x, reps=1)
        x8 = torch.zeros((1, 8, 8, 8), dtype=torch.int8)
        tune.autotune("maxpool2d", tune.sig_maxpool2d(1, 8, 8, 8, 2, 2),
                      (x8,), dtype="int8", reps=1, warmup=0,
                      max_candidates=1)
    finally:
        if not was:
            trace.disable()
    evs = trace.TRACER.events()[before:]
    layers = [e for e in evs if e["name"].startswith("layer.")]
    cands = [e for e in evs if e["name"] == "tune.candidate"]
    assert layers and cands
    assert {e["cat"] for e in layers} == {"graph.profile"}
    assert {e["cat"] for e in cands} == {"tune"}
    assert all("cat" not in e.get("args", {}) for e in layers + cands)


# ------------------------------------------------------------ the metrics --

def _observe(mm):
    """The same observations into a fresh ``mm.Registry``."""
    reg = mm.Registry()
    c = reg.counter("a.count")
    c.inc()
    c.inc(2.5)
    reg.gauge("b.gauge").set(7)
    reg.gauge("b.gauge").set(-3.25)
    h = reg.histogram("c.lat_s")
    rng = np.random.default_rng(0)
    for v in np.concatenate([rng.exponential(0.003, 200), [0.0, 1e-7, 99.0]]):
        h.observe(float(v))
    h2 = reg.histogram("d.custom", buckets=(5, 1, 10))
    for v in (0.5, 1, 3, 7, 10, 11, 50):
        h2.observe(v)
    reg.histogram("e.empty")
    reg.counter("f.zero")
    return reg


def test_snapshot_and_json_equal_jax():
    jreg, reg = _observe(j_metrics), _observe(metrics)
    assert reg.names() == jreg.names()
    assert reg.snapshot() == jreg.snapshot()
    assert reg.to_json() == jreg.to_json()
    assert reg.to_json(indent=2) == jreg.to_json(indent=2)
    snap = reg.snapshot()
    assert snap["e.empty"] == {"type": "histogram", "count": 0, "sum": 0.0,
                               "mean": 0.0, "min": 0.0, "max": 0.0,
                               "p50": 0.0, "p95": 0.0, "p99": 0.0}
    h, jh = reg.histogram("d.custom"), jreg.histogram("d.custom")
    assert (h.count, h.sum, h.min, h.max) == (jh.count, jh.sum, jh.min,
                                              jh.max) == (7, 82.5, 0.5, 50.0)
    for p in (0, 10, 50, 90, 99, 100):
        assert h.percentile(p) == jh.percentile(p)
    reg.reset()
    jreg.reset()
    assert reg.to_json() == jreg.to_json()


def test_registry_type_clash_message_equals_jax():
    msgs = []
    for mm in (j_metrics, metrics):
        reg = mm.Registry()
        reg.counter("x")
        with pytest.raises(TypeError) as e:
            reg.gauge("x")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_module_level_metrics_use_the_process_registry():
    g = metrics.gauge("test_torch_obs.gauge")
    assert g is metrics.REGISTRY.gauge("test_torch_obs.gauge")
    g.set(4)
    h = metrics.histogram("test_torch_obs.hist", buckets=(1.0, 2.0))
    h.observe(1.5)
    snap = metrics.snapshot()
    assert snap["test_torch_obs.gauge"] == {"type": "gauge", "value": 4.0}
    assert snap["test_torch_obs.hist"]["count"] == 1
    assert json.loads(metrics.to_json())["test_torch_obs.gauge"]["value"] \
        == 4.0
    assert metrics.to_json(indent=1) == metrics.REGISTRY.to_json(indent=1)


# -------------------------------------------------------- the request lanes --

def _traced_drain(run):
    """The events of ``run()`` with the port's and JAX's process tracers
    both on (each engine emits to its own package's tracer)."""
    was = (trace.enabled(), j_trace.enabled())
    trace.enable()
    j_trace.enable()
    b0, b1 = len(trace.TRACER.events()), len(j_trace.TRACER.events())
    try:
        run()
    finally:
        if not was[0]:
            trace.disable()
        if not was[1]:
            j_trace.disable()
    return trace.TRACER.events()[b0:], j_trace.TRACER.events()[b1:]


def _by_lane(events, skip=()):
    """(lanes, the rest): each synthetic lane's events in order, lanes in
    order of appearance; the events of this thread; both with times, pid,
    tid and wall-clock stamps left out."""
    lanes, rest = {}, []
    for ev in events:
        if ev["name"] in skip:
            continue
        args = {k: v for k, v in ev.get("args", {}).items()
                if k != "submit_wall_t"}
        item = (ev["ph"], ev["name"], ev["cat"], args)
        if ev["tid"] != threading.get_ident():
            lanes.setdefault(ev["tid"], []).append(item)
        else:
            rest.append(item)
    return list(lanes.values()), rest


def test_lm_engine_lanes_equal_jax():
    from repro.serve import Request as JRequest
    from repro_torch.serve import Engine, Request, ServeConfig
    from test_torch_chaos import jax_engine, tiny_lm
    _, _, cfg, params = tiny_lm()

    def reqs(cls):
        return [cls(uid=u, prompt=np.random.default_rng(u).integers(
            0, 64, (3 + 2 * u,)).astype(np.int32), max_new_tokens=2 + u)
            for u in range(4)]
    eng = Engine(cfg, params, ServeConfig(max_batch=2, max_len=32))
    jeng = jax_engine(max_batch=2, max_len=32)

    def run():
        for e, cls in ((eng, Request), (jeng, JRequest)):
            for r in reqs(cls):
                e.submit(r)
            e.run_until_drained()
    ev, jev = _traced_drain(run)
    lanes, rest = _by_lane(ev)
    jlanes, jrest = _by_lane(jev)
    assert len(lanes) == 4 and lanes == jlanes
    assert [lane[0][3]["uid"] for lane in lanes] == [0, 1, 2, 3]
    first = lanes[0]
    assert [(ph, n) for ph, n, _, _ in first] == [
        ("B", "request"), ("B", "queue_wait"), ("E", "queue_wait"),
        ("B", "prefill"), ("E", "prefill"), ("B", "generate"),
        ("E", "generate"), ("E", "request")]
    assert rest == jrest
    # each lane nests in time: request encloses its three phases in order
    for tid in {e["tid"] for e in ev} - {threading.get_ident()}:
        ts = [e["ts"] for e in ev if e["tid"] == tid]
        assert ts == sorted(ts)


def test_cnn_engine_lanes_equal_jax():
    from repro.graph import CompiledPlan as JCompiledPlan
    from repro.serve import CNNEngine as JCNNEngine
    from repro.serve import CNNServeConfig as JCNNServeConfig
    from repro.serve import ImageRequest as JImageRequest
    from repro_torch.graph import CompiledPlan
    from repro_torch.serve import CNNEngine, CNNServeConfig, ImageRequest
    from test_torch_faults import jax_cnn_plan
    jplan, plan = jax_cnn_plan()
    rng = np.random.default_rng(2)
    imgs = (rng.standard_normal((6, 16, 16, 3)) * 0.5).astype(np.float32)
    eng = CNNEngine(CompiledPlan(plan, method="torch", device="cpu"),
                    CNNServeConfig(max_batch=4))
    jeng = JCNNEngine(JCompiledPlan(jplan, method="xla"),
                      JCNNServeConfig(max_batch=4))

    def run():
        for e, cls in ((eng, ImageRequest), (jeng, JImageRequest)):
            for i, im in enumerate(imgs):
                e.submit(cls(i, im))
            e.run_until_drained()
    ev, jev = _traced_drain(run)
    # a jit trace is JAX's own event; the port captures only on a card
    lanes, rest = _by_lane(ev, skip=("plan.trace",))
    jlanes, jrest = _by_lane(jev, skip=("plan.trace",))
    assert len(lanes) == 6 and lanes == jlanes
    assert [(ph, n) for ph, n, _, _ in lanes[5]] == [
        ("B", "image_request"), ("B", "queue_wait"), ("E", "queue_wait"),
        ("B", "execute"), ("E", "execute"), ("E", "image_request")]
    assert lanes[5][0][3] == {"uid": 5, "round": 1}
    assert rest == jrest
