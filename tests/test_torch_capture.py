"""The capture helper's bookkeeping (``repro_torch.graph.capture``) and the
LM engine's ``jit`` on the host, on the CPU.

A capture's wrapper calls execute nothing on the card, so the helper takes
the change they make to each kernel wrapper's ``launches`` back out and
keeps it as the record of one replay, which every replay adds back. Here a
fake wrapper stands in for a kernel and a fake graph for the CUDA graph.
On the host there is nothing to capture: ``Engine(jit=True)`` is
``jit=False`` there, token for token, with no trace. The capture itself
is tested on the card (``tests/test_torch_cuda.py``, marker ``cuda``).

Run here with ``PYTHONPATH=src python -m pytest -q
tests/test_torch_capture.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.graph.capture import (CapturedFn,  # noqa: E402
                                       launches_taken_out)
from repro_torch.models import api  # noqa: E402
from repro_torch.serve import Engine, Request, ServeConfig  # noqa: E402


def _fake_wrapper():
    def wrapper():
        wrapper.launches += 1
    wrapper.launches = 0
    return wrapper


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_launch_record_restore_and_replays():
    a, b, idle = _fake_wrapper(), _fake_wrapper(), _fake_wrapper()
    a.launches, b.launches = 7, 2
    with launches_taken_out((a, b, idle)) as record:
        for _ in range(3):
            a()
        b()
        assert (a.launches, b.launches) == (10, 3)   # counted as usual
    assert (a.launches, b.launches, idle.launches) == (7, 2, 0)
    assert record == {a: 3, b: 1}                    # idle left out
    graph = _FakeGraph()
    out = torch.zeros(2)
    cap = CapturedFn(graph, (torch.zeros(1),), out, record, 0.0)
    for n in range(1, 4):
        assert cap.replay() is out
        assert graph.replays == n
        assert (a.launches, b.launches) == (7 + 3 * n, 2 + n)
    assert idle.launches == 0


def test_launch_record_restored_when_the_capture_fails():
    a = _fake_wrapper()
    with pytest.raises(RuntimeError, match="capture"):
        with launches_taken_out((a,)) as record:
            a()
            a()
            raise RuntimeError("capture invalidated")
    assert a.launches == 0 and record == {a: 2}


def _tiny(family):
    if family == "ssm":
        return dataclasses.replace(get_config("falcon-mamba-7b"), n_layers=2,
                                   d_model=32, vocab=64)
    return dataclasses.replace(get_config("qwen2-0.5b"), n_layers=2,
                               d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                               vocab=64)


@pytest.mark.parametrize("family,kw", [
    ("dense", dict()), ("dense", dict(precision="int8", kv_cache="int8")),
    ("ssm", dict())], ids=["dense", "dense-int8-kv8", "ssm"])
def test_engine_jit_on_the_host_is_jit_false(family, kw):
    """On the host jit has no effect: the same streams as jit=False, over
    a workload with mid-decode refill and two drains, no trace, and the
    arena kept (cleared in place) from one drain to the next."""
    cfg = _tiny(family)
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    rng = np.random.default_rng(3)
    specs = [(5, 6), (17, 3), (9, 5), (3, 4)]
    prompts = [rng.integers(0, 64, (n,)).astype(np.int32)
               for n, _ in specs]
    streams = {}
    for jit in (True, False):
        eng = Engine(cfg, params, ServeConfig(max_batch=2, max_len=32, **kw),
                     jit=jit)
        assert eng.jit is jit
        runs = []
        for _ in range(2):
            for i, (p, (_, new)) in enumerate(zip(prompts, specs)):
                eng.submit(Request(uid=i, prompt=p, max_new_tokens=new))
            done = sorted(eng.run_until_drained(), key=lambda r: r.uid)
            assert [r.status for r in done] == ["ok"] * len(specs)
            assert any(r.admit_round > 0 for r in done)
            runs.append([r.out_tokens for r in done])
            arena = eng._arena
        assert runs[0] == runs[1] and eng._arena is arena
        assert eng.traces == 0 and not eng._graphs
        streams[jit] = runs[0]
    assert streams[True] == streams[False]
