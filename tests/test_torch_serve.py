"""The port's CNNEngine on the CPU: logits equal the plan's forward_batch,
stats keys, deadlines, load shedding, an injected round fault absorbed by a
retry, a corrupt fault contained to its round (the port's own
``repro_torch.faults``), a real plan failure retired as ``error`` without
switching the plan to another method, and the round spans and request
lanes on the tracer."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.faults import FaultPlan, FaultSpec  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.models import CNNConfig, init_cnn, quantize_cnn  # noqa: E402
from repro_torch.serve import (CNNEngine, CNNServeConfig,  # noqa: E402
                               ImageRequest, QueueFullError)

STATS_KEYS = {
    "batch_rounds", "images_done", "occupancy", "latency_avg_s",
    "images_per_s", "latency_p50_s", "latency_p95_s", "latency_p99_s",
    "queue_wait_avg_s", "queue_wait_p99_s", "timeouts", "errors", "shed",
    "retries", "degraded"}


@pytest.fixture(scope="module")
def plan():
    cfg = CNNConfig(primitive="dws", widths=(8, 12), image_size=16)
    params = init_cnn(cfg, torch.Generator().manual_seed(1), device="cpu")
    rng = np.random.default_rng(2)
    calib = (rng.standard_normal((8, 16, 16, 3)) * 0.5).astype(np.float32)
    return quantize_cnn(params, cfg, calib, method="torch", device="cpu")


def _images(n, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 16, 16, 3)) * 0.5).astype(np.float32)


def test_logits_equal_forward_batch_and_stats_keys(plan):
    imgs = _images(11)
    eng = CNNEngine(plan, CNNServeConfig(max_batch=4))
    for i, im in enumerate(imgs):
        eng.submit(ImageRequest(uid=i, image=im))
    done = eng.run_until_drained()
    assert [r.status for r in done] == ["ok"] * 11
    assert set(eng.stats) == STATS_KEYS
    st = eng.stats
    assert st["batch_rounds"] == 3 and st["images_done"] == 11
    assert st["errors"] == st["retries"] == st["degraded"] == 0
    by_uid = {r.uid: r for r in done}
    for start in range(0, 11, 4):          # the engine's rounds, in order
        want = plan.forward_batch(imgs[start:start + 4]).numpy()
        for j in range(want.shape[0]):
            got = by_uid[start + j]
            assert got.batch_round == start // 4
            np.testing.assert_array_equal(got.logits, want[j])


def test_deadline_times_out_at_admission(plan):
    eng = CNNEngine(plan, CNNServeConfig(max_batch=4, deadline_s=1e-9))
    for i, im in enumerate(_images(3)):
        eng.submit(ImageRequest(uid=i, image=im))
    done = eng.run_until_drained()
    assert [r.status for r in done] == ["timeout"] * 3
    assert eng.stats["timeouts"] == 3 and eng.stats["batch_rounds"] == 0


def test_per_request_deadline_overrides_config(plan):
    eng = CNNEngine(plan, CNNServeConfig(max_batch=4))
    imgs = _images(2)
    eng.submit(ImageRequest(uid=0, image=imgs[0], deadline_s=1e-9))
    eng.submit(ImageRequest(uid=1, image=imgs[1]))
    status = {r.uid: r.status for r in eng.run_until_drained()}
    assert status == {0: "timeout", 1: "ok"}


@pytest.mark.parametrize("policy", ["reject", "drop"])
def test_max_queue_sheds(plan, policy):
    eng = CNNEngine(plan, CNNServeConfig(max_batch=2, max_queue=2,
                                         shed_policy=policy))
    imgs = _images(3)
    eng.submit(ImageRequest(uid=0, image=imgs[0]))
    eng.submit(ImageRequest(uid=1, image=imgs[1]))
    third = ImageRequest(uid=2, image=imgs[2])
    if policy == "reject":
        with pytest.raises(QueueFullError):
            eng.submit(third)
    else:
        eng.submit(third)
        assert third.done and third.status == "shed"
    assert eng.stats["shed"] == 1
    assert [r.status for r in eng.run_until_drained()] == ["ok", "ok"]


def test_injected_round_fault_absorbed_by_retry(plan):
    imgs = _images(4)
    eng = CNNEngine(plan, CNNServeConfig(max_batch=4, max_retries=2))
    for i, im in enumerate(imgs):
        eng.submit(ImageRequest(uid=i, image=im))
    with FaultPlan([FaultSpec(site="cnn.batch_round", kind="raise", nth=1,
                              times=1)], seed=7) as fp:
        done = eng.run_until_drained()
    assert len(fp.log) == 1
    assert [r.status for r in done] == ["ok"] * 4
    st = eng.stats
    assert st["retries"] == 1 and st["errors"] == 0 and st["degraded"] == 0
    want = plan.forward_batch(imgs).numpy()
    np.testing.assert_array_equal(np.stack([r.logits for r in done]), want)


def test_invalid_config_rejected(plan):
    with pytest.raises(ValueError, match="max_queue"):
        CNNEngine(plan, CNNServeConfig(max_batch=4, max_queue=2))
    with pytest.raises(ValueError, match="shed_policy"):
        CNNEngine(plan, CNNServeConfig(shed_policy="maybe"))


def test_corrupt_fault_poisons_only_its_round(plan):
    imgs = _images(8)
    eng = CNNEngine(plan, CNNServeConfig(max_batch=4))
    for i, im in enumerate(imgs):
        eng.submit(ImageRequest(uid=i, image=im))
    with FaultPlan([FaultSpec(site="cnn.batch_round", kind="corrupt",
                              nth=2)], seed=5) as fp:
        done = eng.run_until_drained()
    assert [f.hit for f in fp.log] == [2]
    assert [r.status for r in done] == ["ok"] * 8
    assert eng.poisoned_uids == {4, 5, 6, 7}
    clean = plan.forward_batch(imgs[:4]).numpy()
    np.testing.assert_array_equal(np.stack([r.logits for r in done[:4]]),
                                  clean)
    bad = np.stack([r.logits for r in done[4:]])
    assert not np.array_equal(bad, plan.forward_batch(imgs[4:]).numpy())


def test_real_plan_failure_retires_round_as_error(plan, monkeypatch):
    """A plan exception that is not an injected fault (a kernel that fails
    to build or launch) is not retried and does not switch the plan to the
    plain versions: the round retires with status "error"."""
    calls = []

    def broken(x):
        calls.append(x.shape[0])
        raise RuntimeError("conv2d_q8: CUDA launch failed with error 700")
    monkeypatch.setattr(plan, "forward_batch", broken)
    method = plan.method
    eng = CNNEngine(plan, CNNServeConfig(max_batch=4, max_retries=2))
    for i, im in enumerate(_images(6)):
        eng.submit(ImageRequest(uid=i, image=im))
    done = eng.run_until_drained()
    assert calls == [4, 2]                  # one attempt per round
    assert [r.status for r in done] == ["error"] * 6
    assert all("error 700" in r.error for r in done)
    assert plan.method == method
    st = eng.stats
    assert (st["errors"], st["retries"], st["degraded"]) == (6, 0, 0)
    assert st["batch_rounds"] == 0 and st["images_done"] == 0


def test_round_and_forward_spans_on_the_tracer(plan):
    eng = CNNEngine(plan, CNNServeConfig(max_batch=4))
    for i, im in enumerate(_images(5)):
        eng.submit(ImageRequest(uid=i, image=im))
    trace.clear()
    trace.enable()
    try:
        eng.run_until_drained()
        events = trace.TRACER.events()
    finally:
        trace.disable()
        trace.clear()
    # each served request's lifecycle is replayed on a lane of its own
    me = threading.get_ident()
    lanes = [e for e in events if e["tid"] != me]
    events = [e for e in events if e["tid"] == me]
    assert len({e["tid"] for e in lanes}) == 5
    assert sorted(e["args"]["uid"] for e in lanes
                  if e["name"] == "image_request" and e["ph"] == "B") == \
        list(range(5))
    pairs = [(e["ph"], e["name"]) for e in events]
    assert pairs == [("B", "cnn.batch_round"), ("B", "plan.forward_batch"),
                     ("E", "plan.forward_batch"), ("E", "cnn.batch_round")] * 2
    begins = [e for e in events if e["ph"] == "B"]
    assert [e["args"] for e in begins] == [
        {"round": 0, "batch": 4}, {"n": 4, "bucket": 4},
        {"round": 1, "batch": 1}, {"n": 1, "bucket": 1}]
    assert all(b["ts"] <= a["ts"] for b, a in zip(events, events[1:]))
    with trace.span("off") as sp:           # disabled: the shared no-op
        assert sp is trace._NULL_SPAN
    assert trace.TRACER.events() == []


@pytest.mark.parametrize("prim", ["shift", "add"])
def test_shift_and_add_plans_serve(prim):
    """Plans of the two primitives the dws fixture does not run (the add
    plan with its integer BN nodes) served over a ragged last round: every
    request ok, logits equal to the plan's forward_batch."""
    cfg = CNNConfig(primitive=prim, widths=(8, 12), image_size=16)
    params = init_cnn(cfg, torch.Generator().manual_seed(4), device="cpu")
    calib = _images(8, seed=5)
    plan = quantize_cnn(params, cfg, calib, method="torch", device="cpu")
    ops = [n.op for n in plan.plan.nodes]
    assert ops.count("qbn") == (2 if prim == "add" else 0)
    imgs = _images(7, seed=6)
    eng = CNNEngine(plan, CNNServeConfig(max_batch=4))
    for i, im in enumerate(imgs):
        eng.submit(ImageRequest(uid=i, image=im))
    done = eng.run_until_drained()
    assert [r.status for r in done] == ["ok"] * 7
    assert eng.stats["batch_rounds"] == 2
    for start in (0, 4):
        want = plan.forward_batch(imgs[start:start + 4]).numpy()
        np.testing.assert_array_equal(
            np.stack([r.logits for r in done[start:start + 4]]), want)
