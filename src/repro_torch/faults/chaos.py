"""Chaos harness: paired fault-free / faulted runs + invariant checks.

Port of ``repro/faults/chaos.py``, with its signatures and invariants, run
against the port's engines. A fault schedule is only useful if the
*hardened* engine provably keeps its promises under it. This module runs
the same workload twice on fresh engines — once clean, once under a
:class:`~repro_torch.faults.inject.FaultPlan` — and checks the degradation
contract:

1. **Terminal statuses** — every submitted request ends ``done`` with a
   terminal ``status`` in {ok, timeout, error, shed}; nothing hangs and no
   injected fault escapes ``run_until_drained`` as an exception.
2. **Survivor bit-identity** — requests the faulted run completed with
   ``status="ok"`` whose uid is NOT in ``engine.poisoned_uids`` must carry
   byte-for-byte the stream (LM) or the logits (CNN) the clean run
   produced: a retried or retired neighbour must not perturb survivors.
   On a card this leans on the engines keeping every GEMM's row count
   fixed: the decode step always runs ``max_batch`` slots, a prefill one
   request at its bucket, a CNN round its own images at its bucket.
3. **Pool conservation** — after a paged drain, ``BlockPool.audit``
   (free + allocated == usable, non-negative refcounts, no leaked pages)
   returns no violations.
4. **Balanced spans** — every ``obs.trace`` B event emitted during the
   faulted run has its E: the error paths unwind through the same span
   context managers as the happy path.

No plan of the port degrades to another numeric path (the JAX engine's
``degrade_to_xla`` and Pallas-guard fallbacks are not ported on purpose),
so every CNN schedule, ``kernels.dispatch`` ones included, is held
bitwise; ``logits_exact=False`` keeps the JAX harness's relaxed compare
for callers that ask for it.

Import discipline: ``repro_torch.faults.__init__`` must NOT import this
module (it pulls in the serving stack, which itself imports
``faults.inject`` at its seams). Use it as
``from repro_torch.faults import chaos``.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, List, Sequence

import numpy as np

from repro_torch.faults import inject
from repro_torch.obs import trace as obs_trace

TERMINAL = ("ok", "timeout", "error", "shed")


@dataclasses.dataclass
class ChaosReport:
    """Outcome of one paired run. ``violations`` empty == every invariant
    held; each entry is one human-readable broken invariant (full-list
    style, same as ``repro_torch.check``)."""
    violations: List[str]
    statuses: Dict[int, str]            # uid -> terminal status (faulted)
    survivors: List[int]                # uids compared bit-identically
    poisoned: set                       # uids a corrupt fault touched
    fired: int                          # faults the plan actually fired
    pool_violations: List[str]          # BlockPool.audit output (LM paged)
    stats: dict                         # faulted engine's stats snapshot

    @property
    def ok(self) -> bool:
        return not self.violations

    def summary(self) -> str:
        by = collections.Counter(self.statuses.values())
        head = (f"fired={self.fired} statuses="
                + ",".join(f"{k}:{v}" for k, v in sorted(by.items()))
                + f" survivors={len(self.survivors)}"
                  f" poisoned={len(self.poisoned)}")
        if self.ok:
            return head + " [all invariants held]"
        return head + "\n" + "\n".join(f"  - {v}" for v in self.violations)


def _submit_all(engine, reqs) -> List:
    """Submit tolerating shed rejections; returns every request (shed-
    rejected ones carry no terminal status — they never entered)."""
    from repro_torch.serve.engine import QueueFullError
    entered = []
    for r in reqs:
        try:
            engine.submit(r)
        except QueueFullError:
            r.status = "shed"
            r.done = True
            continue
        entered.append(r)
    return entered


def _check_terminal(reqs, violations: List[str]):
    for r in reqs:
        if not r.done:
            violations.append(f"request {r.uid} not done after drain")
        if r.status not in TERMINAL:
            violations.append(f"request {r.uid} has non-terminal "
                              f"status {r.status!r}")


def _check_spans(events: Sequence[dict], violations: List[str]):
    open_spans = collections.Counter()
    for ev in events:
        if ev["ph"] == "B":
            open_spans[ev["name"]] += 1
        elif ev["ph"] == "E":
            open_spans[ev["name"]] -= 1
    for name, n in sorted(open_spans.items()):
        if n:
            violations.append(
                f"unbalanced span {name!r}: {n:+d} (an error path returned "
                "without unwinding its trace context manager)")


def _capture_spans(fn):
    """Run ``fn()`` with the process tracer force-enabled; returns
    (fn result, the events emitted during the call)."""
    tr = obs_trace.TRACER
    was = tr.enabled
    before = len(tr.events())
    tr.enable()
    try:
        out = fn()
    finally:
        if not was:
            tr.disable()
    return out, tr.events()[before:]


def _drain_faulted(engine, reqs, fault_plan: inject.FaultPlan):
    fault_plan.reset()
    with fault_plan:
        entered = _submit_all(engine, reqs)
        done = engine.run_until_drained()
    return entered, done


def _drain_clean(make_engine, make_requests) -> list:
    """The fault-free reference drain, with no plan active (an installed
    one is put back after)."""
    eng = make_engine()
    reqs = make_requests()
    prev = inject.active_plan()
    inject.deactivate()
    try:
        _submit_all(eng, reqs)
        eng.run_until_drained()
    finally:
        inject.install(prev)
    return reqs


def _drain_checked(make_engine, make_requests, fault_plan, check_spans,
                   expect_fired):
    """The faulted drain on a fresh engine and its terminal-status check;
    returns (engine, requests, violations, survivors, span events)."""
    eng = make_engine()
    reqs = make_requests()
    if check_spans:
        _, events = _capture_spans(
            lambda: _drain_faulted(eng, reqs, fault_plan))
    else:
        _drain_faulted(eng, reqs, fault_plan)
        events = []
    violations: List[str] = []
    _check_terminal(reqs, violations)
    if expect_fired and not fault_plan.log:
        violations.append("fault plan never fired — the schedule does not "
                          "intersect this workload's site hits")
    survivors = [r.uid for r in reqs
                 if r.status == "ok" and r.uid not in eng.poisoned_uids]
    return eng, reqs, violations, survivors, events


def _report(eng, reqs, violations, survivors, fault_plan,
            pool_violations) -> ChaosReport:
    return ChaosReport(
        violations=violations,
        statuses={r.uid: r.status for r in reqs},
        survivors=survivors,
        poisoned=set(eng.poisoned_uids),
        fired=len(fault_plan.log),
        pool_violations=pool_violations,
        stats=eng.stats,
    )


# ---------------------------------------------------------------------- LM


def run_lm_chaos(make_engine: Callable[[], object],
                 make_requests: Callable[[], List[object]],
                 fault_plan: inject.FaultPlan,
                 *, check_spans: bool = True,
                 expect_fired: bool = True) -> ChaosReport:
    """Paired LM run: ``make_engine``/``make_requests`` must build a fresh
    engine / identical request list per call (requests are consumed).
    The workload should be greedy — survivor bit-identity leans on greedy
    streams being independent of batch composition."""
    baseline = {r.uid: list(r.out_tokens)
                for r in _drain_clean(make_engine, make_requests)
                if r.status == "ok"}
    eng, reqs, violations, survivors, events = _drain_checked(
        make_engine, make_requests, fault_plan, check_spans, expect_fired)
    for r in reqs:
        if r.uid not in survivors:
            continue
        if r.uid not in baseline:
            violations.append(f"survivor {r.uid} has no clean-run "
                              "reference (baseline did not finish it ok)")
        elif list(r.out_tokens) != baseline[r.uid]:
            violations.append(
                f"survivor {r.uid} diverged from the fault-free stream: "
                f"{baseline[r.uid]} -> {list(r.out_tokens)}")
    pool_violations: List[str] = []
    if getattr(eng, "pool", None) is not None:
        pool_violations = eng.pool.audit(expect_drained=True)
        violations += [f"pool: {v}" for v in pool_violations]
    _check_spans(events, violations)
    return _report(eng, reqs, violations, survivors, fault_plan,
                   pool_violations)


# --------------------------------------------------------------------- CNN


def run_cnn_chaos(make_engine: Callable[[], object],
                  make_requests: Callable[[], List[object]],
                  fault_plan: inject.FaultPlan,
                  *, check_spans: bool = True,
                  expect_fired: bool = True,
                  logits_exact: bool = True) -> ChaosReport:
    """Paired CNN run. Survivor identity compares logits bitwise by
    default; ``logits_exact=False`` relaxes to tight allclose + identical
    argmax (the JAX harness's option for plans that degrade mid-run; no
    plan of the port does)."""
    baseline = {r.uid: np.asarray(r.logits)
                for r in _drain_clean(make_engine, make_requests)
                if r.status == "ok"}
    eng, reqs, violations, survivors, events = _drain_checked(
        make_engine, make_requests, fault_plan, check_spans, expect_fired)
    for r in reqs:
        if r.uid not in survivors:
            continue
        if r.uid not in baseline:
            violations.append(f"survivor {r.uid} has no clean-run "
                              "reference (baseline did not finish it ok)")
            continue
        got, want = np.asarray(r.logits), baseline[r.uid]
        if logits_exact:
            same = np.array_equal(got, want)
        else:
            same = (np.allclose(got, want, rtol=1e-5, atol=1e-6)
                    and np.argmax(got) == np.argmax(want))
        if not same:
            violations.append(f"survivor {r.uid} logits diverged from the "
                              "fault-free run")
    _check_spans(events, violations)
    return _report(eng, reqs, violations, survivors, fault_plan, [])
