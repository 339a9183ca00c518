"""The port's static scheduler (``ServeConfig(scheduler="static")``)
against the JAX package's static engine on the CPU: drain batches of up to
``max_batch`` requests, prompts left-padded to the batch's longest and
prefilled once at that length, a lockstep scalar ``len``, and the batch
decoded to completion; for the dense family in ``float``, ``int8`` and
``w4a8`` and for the ssm family (Falcon-Mamba cut to 2 layers, whose
recurrence folds the pad tokens into its state, so its streams are held
against JAX's static engine, not against the continuous one), with the
fault seams and deadlines of the failure model.

Greedy token streams, statuses and the stats' counters are compared
exactly; the tiny stacks compute in float32, where the two frameworks'
streams agree (``tests/test_torch_lm.py``).

Run here with ``PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q
tests/test_torch_static.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs.base import get_config as j_get_config  # noqa: E402
from repro.faults.inject import FaultPlan as JFaultPlan  # noqa: E402
from repro.faults.inject import FaultSpec as JFaultSpec  # noqa: E402
from repro.models import api as j_api  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.faults import FaultPlan, FaultSpec  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import Engine, Request, ServeConfig  # noqa: E402
from repro_torch.weights import lm_params_from_numpy  # noqa: E402

F32 = dict(compute_dtype="float32")
DENSE = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
             vocab=64, **F32)
SSM = dict(n_layers=2, d_model=32, vocab=64, **F32)
#: the port's precision and JAX's engine precision that computes the same
PRECISION = {"float": "float", "int8": "int8-xla", "w4a8": "w4a8"}
#: 5 requests over batches of 2: skewed prompt and output lengths, one
#: request done at its prefill token, one prompt past 16 tokens
SPECS = [(5, 6), (9, 3), (17, 5), (4, 1), (7, 7)]
COUNTERS = ("prefills", "decode_steps", "tokens_out", "requests_done",
            "occupancy", "timeouts", "errors", "retries")


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _setup(arch, kw, seed):
    jcfg = dataclasses.replace(j_get_config(arch), **kw)
    jparams = j_api.init_params(jcfg, jax.random.PRNGKey(seed))
    cfg = dataclasses.replace(get_config(arch), **kw)
    return jcfg, jparams, cfg, lm_params_from_numpy(_np(jparams),
                                                    device="cpu")


@pytest.fixture(scope="module")
def dense():
    """JAX's tiny Qwen2 and the port's copy."""
    return _setup("qwen2-0.5b", DENSE, 0)


@pytest.fixture(scope="module")
def ssm():
    """JAX's Falcon-Mamba cut to 2 layers, d_model 32, and the port's
    copy."""
    return _setup("falcon-mamba-7b", SSM, 1)


def _requests(cls, specs, **kw):
    rng = np.random.default_rng(14)
    return [cls(uid=i, prompt=rng.integers(0, 64, (plen,)).astype(np.int32),
                max_new_tokens=new, **kw)
            for i, (plen, new) in enumerate(specs)]


def _serve(setup, specs, port=True, plan=None, req_kw=None, **scfg_kw):
    jcfg, jparams, cfg, params = setup
    scfg_kw = dict(dict(max_batch=2, max_len=32, scheduler="static"),
                   **scfg_kw)
    if port:
        eng = Engine(cfg, params, ServeConfig(**scfg_kw))
        reqs = _requests(Request, specs, **(req_kw or {}))
    else:
        scfg_kw["precision"] = PRECISION[scfg_kw.get("precision", "float")]
        eng = JEngine(jcfg, jparams, JServeConfig(**scfg_kw))
        reqs = _requests(JRequest, specs, **(req_kw or {}))
    for r in reqs:
        eng.submit(r)
    if plan is None:
        done = eng.run_until_drained()
    else:
        with plan:
            done = eng.run_until_drained()
    return eng, sorted(done, key=lambda r: r.uid)


def _assert_same(a, b):
    (eng, done), (jeng, jdone) = a, b
    assert [r.out_tokens for r in done] == [r.out_tokens for r in jdone]
    assert [r.status for r in done] == [r.status for r in jdone]
    assert {k: eng.stats[k] for k in COUNTERS} == \
        {k: jeng.stats[k] for k in COUNTERS}
    assert eng.poisoned_uids == jeng.poisoned_uids


@pytest.mark.parametrize("precision", sorted(PRECISION))
def test_static_dense_streams_equal_jax(dense, precision):
    got = _serve(dense, SPECS, precision=precision)
    _assert_same(got, _serve(dense, SPECS, port=False, precision=precision))
    eng, done = got
    assert [r.status for r in done] == ["ok"] * len(SPECS)
    assert [len(r.out_tokens) for r in done] == [n for _, n in SPECS]
    assert eng.stats["prefills"] == 3          # batches of 2, 2 and 1
    assert eng.pool is None and eng._arena is None


def test_static_ssm_streams_equal_jax(ssm):
    """Left-padded Mamba prompts fold their pads into the state, so the
    streams are held against JAX's static engine (the continuous engine,
    which prefills exact lengths, need not agree)."""
    got = _serve(ssm, SPECS)
    _assert_same(got, _serve(ssm, SPECS, port=False))
    assert [r.status for r in got[1]] == ["ok"] * len(SPECS)


def test_static_lockstep_length_past_max_len(dense):
    """The lockstep length may pass max_len (the static scheduler does not
    retire at the KV cap): each step writes at the last position and
    attends every position, as JAX's clamped update does."""
    specs = [(10, 30), (3, 28)]
    eng, done = _serve(dense, specs, max_len=16)
    _assert_same((eng, done), _serve(dense, specs, port=False, max_len=16))
    assert [len(r.out_tokens) for r in done] == [30, 28]


def test_static_batches_equal_their_requests_alone(dense):
    """Padded batches: a prompt of the longest length decodes the tokens
    it decodes alone (its row has no pads), and a single request's static
    stream equals its continuous (right-padded, bucketed) one."""
    eng, done = _serve(dense, [(9, 6), (9, 6)], max_batch=2)
    alone = _serve(dense, [(9, 6)], max_batch=1)[1]
    assert done[0].out_tokens == alone[0].out_tokens
    cont = _serve(dense, [(9, 6)], max_batch=4, scheduler="continuous")[1]
    assert cont[0].out_tokens == alone[0].out_tokens


def test_static_take_batch_nonblocking(dense):
    _, _, cfg, params = dense
    eng = Engine(cfg, params, ServeConfig(max_batch=4, scheduler="static"))
    for r in _requests(Request, [(5, 2)] * 5):
        eng.submit(r)
    assert [r.uid for r in eng._take_batch()] == [0, 1, 2, 3]
    assert [r.uid for r in eng._take_batch()] == [4]
    assert eng._take_batch() == []


FAULTS = {
    "prefill_raise": ("engine.prefill", "raise", 1, 1),
    "prefill_exhausts": ("engine.prefill", "raise", 2, 3),
    "decode_raise": ("engine.decode_round", "raise", 1, 3),
    "decode_retried": ("engine.decode_round", "raise", 2, 2),
    "decode_corrupt": ("engine.decode_round", "corrupt", 2, 1),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_static_faults_equal_jax(dense, fault):
    """The static scheduler under a fault schedule: a prefill fault
    absorbed by a retry or retiring its batch as "error", a decode fault
    retiring the batch's live requests or absorbed, a corrupt round
    poisoning its batch; statuses, streams, counters and poisoned uids
    equal JAX's, and the survivors' streams the fault-free ones."""
    site, kind, nth, times = FAULTS[fault]
    got = _serve(dense, SPECS, plan=FaultPlan(
        [FaultSpec(site=site, kind=kind, nth=nth, times=times)]))
    _assert_same(got, _serve(dense, SPECS, port=False, plan=JFaultPlan(
        [JFaultSpec(site=site, kind=kind, nth=nth, times=times)])))
    eng, done = got
    clean = _serve(dense, SPECS)[1]
    statuses = {r.status for r in done}
    assert statuses <= {"ok", "error"}
    for r, c in zip(done, clean):
        if r.status == "ok" and r.uid not in eng.poisoned_uids:
            assert r.out_tokens == c.out_tokens
    if kind == "corrupt":
        assert eng.poisoned_uids and statuses == {"ok"}
    elif times > 2:
        assert "error" in statuses and eng.stats["errors"] > 0
    else:
        assert statuses == {"ok"} and eng.stats["retries"] == times


def test_static_deadline_cancels_at_round_boundary(dense):
    got = _serve(dense, SPECS, deadline_s=1e-9)
    _assert_same(got, _serve(dense, SPECS, port=False, deadline_s=1e-9))
    eng, done = got
    # cancelled after the prefill token, but the request done at it
    assert [r.status for r in done] == [
        "ok" if n == 1 else "timeout" for _, n in SPECS]
    assert all(len(r.out_tokens) == 1 for r in done)


def test_static_gates_keep_jax_messages(dense, ssm):
    """The int8 KV cache and the paged layout need the continuous
    scheduler; an ssm model serves static in "float" only."""
    for setup, kw in ((dense, dict(kv_cache="int8")),
                      (dense, dict(kv_layout="paged")),
                      (ssm, dict(precision="int8"))):
        jcfg, jparams, cfg, params = setup
        with pytest.raises(NotImplementedError) as got:
            Engine(cfg, params, ServeConfig(scheduler="static", **kw))
        jkw = dict(kw, precision="int8") if "precision" in kw else kw
        with pytest.raises(NotImplementedError) as want:
            JEngine(jcfg, jparams, JServeConfig(scheduler="static", **jkw))
        assert str(got.value) == str(want.value)


def test_decode_step_lockstep_writes_clamp(dense):
    """A scalar ``len`` at or past the cache's end writes the last position
    (a per-slot length there writes nothing)."""
    _, _, cfg, params = dense
    params = T.cast_params(params, cfg)
    cache = T.init_cache(cfg, 2, 4, device="cpu")
    tok = torch.tensor([[3], [5]])
    cache["len"] = torch.tensor(4, dtype=torch.int32)
    T.decode_step(params, tok, cache, cfg)
    assert cache["k"][:, :, 3].any() and not cache["k"][:, :, :3].any()
    vec = T.init_cache(cfg, 2, 4, device="cpu")
    vec["len"] = torch.tensor([4, 4], dtype=torch.int32)
    T.decode_step(params, tok, vec, cfg)
    assert not vec["k"].any()
