"""Deterministic fault injection core.

The port's own copy of the JAX package's stdlib-only
``repro/faults/inject.py`` (the port imports nothing of that package): the
same sites, kinds, firing rule, log, environment grammar and messages, so
the same plan over the same sequence of site hits fires identically in
both packages.

Fault *sites* are named seams in the hot paths — the instrumented code
calls :func:`check(site)` at each seam. With no plan active that call is
one module-global read and a ``None`` compare (the same near-zero-cost
discipline as ``repro_torch.obs.trace``'s ``_NullSpan``), so the seams ride
in production paths permanently. With a plan active, the per-site hit
counter advances and any matching :class:`FaultSpec` fires:

* ``kind="raise"``  — raises :class:`InjectedFault` out of the seam (the
  hardened caller must absorb it: retry or retire).
* ``kind="delay"``  — sleeps ``delay_s`` inside the seam (simulates a
  stuck round; per-request deadlines catch it at the next boundary).
* ``kind="corrupt"`` — returns a :class:`Fired` directive whose
  :meth:`Fired.apply` deterministically corrupts a host array (poisoned
  logits — silent data corruption the engine *cannot* detect, only
  contain). Allowed only at sites whose consumers hold host values
  (``CORRUPT_SITES``).

The ``kernels.dispatch`` seam sits in every ``repro_torch.kernels.ops``
entry point that resolves to ``method="cuda"``, after the argument checks
and before the tensor's device picks the kernel or its plain version; a
captured graph hits it while it is captured, never on replay. Unlike the
JAX package's Pallas guard, the port answers a raise there with no
fallback: the fault propagates to the engine, whose bounded retries absorb
it or retire the round with ``status="error"``.

Firing is fully deterministic: ``nth`` entries fire on hits
``[nth, nth + times)`` of their site (a *consecutive* window, sized to
defeat — or be absorbed by — bounded retries, which re-hit the seam);
``probability`` entries draw from the plan's own seeded ``random.Random``
in hit order, so the same plan over the same workload fires identically
every run. Every fire is appended to ``FaultPlan.log`` and counted into
the process metrics registry as ``faults.fired.<site>``.

Activation: ``with FaultPlan([...], seed=7): ...`` (nestable; restores
the previous plan on exit), :func:`install` / :func:`deactivate` for
non-scoped use, or the ``REPRO_FAULTS`` environment variable parsed at
import — ``;``-separated entries of ``site:kind[:k=v...]`` plus an
optional ``seed=N`` entry, e.g.::

    REPRO_FAULTS="engine.decode_round:raise:nth=2:times=1;seed=7"
    REPRO_FAULTS="kernels.dispatch:raise:p=0.05:times=3"

Recognized per-entry keys: ``nth`` (1-indexed hit), ``p`` (per-hit
probability), ``times`` (window length / max fires, default 1),
``delay`` (seconds, delay kind).
"""
from __future__ import annotations

import dataclasses
import os
import random
import threading
import time
import zlib
from typing import Dict, List, Optional

from repro_torch.obs import metrics as _obs_metrics

ENV_VAR = "REPRO_FAULTS"

#: The registered fault sites — the hot seams of the serving stack. A
#: FaultSpec naming any other site is a construction-time ValueError, so
#: schedules can't silently rot when a seam is renamed.
SITES = frozenset({
    "kernels.dispatch",      # repro_torch.kernels.ops "cuda" entry points
    "engine.prefill",        # LM Engine admission prefill (per attempt)
    "engine.decode_round",   # LM Engine decode round (per attempt)
    "blockpool.alloc",       # paged-KV BlockPool.alloc (per call)
    "tune.cache_load",       # persistent tune-cache load (per file read)
    "cnn.batch_round",       # CNNEngine batch round (per attempt)
})

KINDS = ("raise", "delay", "corrupt")

#: Sites whose instrumented consumer holds a *host* value a corrupt
#: directive can be applied to. The kernel seam is excluded: its consumer
#: holds device tensors mid-forward.
CORRUPT_SITES = frozenset({
    "engine.prefill", "engine.decode_round", "cnn.batch_round",
})


class InjectedFault(RuntimeError):
    """The exception an active ``kind="raise"`` fault throws at its seam."""


@dataclasses.dataclass
class FaultSpec:
    """One scheduled fault: fire ``kind`` at ``site`` on the ``nth`` hit
    (for ``times`` consecutive hits), or with ``probability`` per hit (up
    to ``times`` total fires)."""
    site: str
    kind: str
    nth: Optional[int] = None
    probability: Optional[float] = None
    times: int = 1
    delay_s: float = 0.05

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"registered sites: {sorted(SITES)}")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"choose from {KINDS}")
        if self.kind == "corrupt" and self.site not in CORRUPT_SITES:
            raise ValueError(
                f"kind='corrupt' is not applicable at site {self.site!r} "
                f"(no host value to corrupt); allowed: "
                f"{sorted(CORRUPT_SITES)}")
        if (self.nth is None) == (self.probability is None):
            if self.nth is None:
                self.nth = 1            # default: fire on the first hit
            else:
                raise ValueError("give exactly one of nth= or probability=")
        if self.nth is not None and self.nth < 1:
            raise ValueError(f"nth must be >= 1 (1-indexed), got {self.nth}")
        if self.probability is not None \
                and not 0.0 < self.probability <= 1.0:
            raise ValueError(f"probability must be in (0, 1], "
                             f"got {self.probability}")
        if self.times < 1:
            raise ValueError(f"times must be >= 1, got {self.times}")
        if self.delay_s < 0:
            raise ValueError(f"delay_s must be >= 0, got {self.delay_s}")


@dataclasses.dataclass
class Fired:
    """One fired fault (also the corrupt directive handed to the seam's
    caller). ``apply`` is deterministic in (plan seed, site, hit)."""
    site: str
    kind: str
    hit: int                    # the site hit index (1-based) that fired
    seed: int

    def apply(self, arr):
        """Deterministically corrupt a host array: overwrite a few seeded
        positions with out-of-band large values (moves float argmaxes, so
        poisoned logits visibly derail a greedy stream; integer arrays take
        their dtype's max)."""
        import numpy as np
        a = np.array(arr, copy=True)
        if a.size == 0:
            return a
        rng = np.random.default_rng(
            [self.seed & 0x7FFFFFFF, self.hit,
             zlib.crc32(self.site.encode())])
        flat = a.reshape(-1)
        k = min(8, flat.size)
        idx = rng.choice(flat.size, size=k, replace=False)
        if np.issubdtype(a.dtype, np.floating):
            flat[idx] = float(flat.max()) + 1e3 + rng.standard_normal(k)
        elif np.issubdtype(a.dtype, np.integer):
            flat[idx] = np.iinfo(a.dtype).max
        return a


class FaultPlan:
    """A seeded, deterministic schedule of :class:`FaultSpec` entries.

    Context manager (nestable — restores the previously active plan), or
    install process-wide via :func:`install`. One plan instance carries
    its own per-site hit counters and rng; reuse across runs accumulates
    hits, so paired baseline/faulted comparisons should construct a fresh
    plan (or call :meth:`reset`) per run.
    """

    def __init__(self, specs: List[FaultSpec], seed: int = 0):
        self.specs = list(specs)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._by_site: Dict[str, List[FaultSpec]] = {}
        for s in self.specs:
            self._by_site.setdefault(s.site, []).append(s)
        self.reset()

    def reset(self):
        """Zero the hit counters, fire counts, rng, and log."""
        with self._lock:
            self._hits: Dict[str, int] = {}
            self._fires: Dict[int, int] = {id(s): 0 for s in self.specs}
            self._rng = random.Random(self.seed)
            self.log: List[Fired] = []

    # ------------------------------------------------------------ firing --

    def hit(self, site: str) -> Optional[Fired]:
        """Advance ``site``'s hit counter; raise/sleep/return-directive per
        the first matching spec. Returns None when nothing fires."""
        with self._lock:
            h = self._hits.get(site, 0) + 1
            self._hits[site] = h
            fired: Optional[Fired] = None
            spec: Optional[FaultSpec] = None
            for s in self._by_site.get(site, ()):
                if self._fires[id(s)] >= s.times:
                    continue
                if s.nth is not None:
                    fire = s.nth <= h < s.nth + s.times
                else:
                    fire = self._rng.random() < s.probability
                if fire:
                    self._fires[id(s)] += 1
                    fired = Fired(site=site, kind=s.kind, hit=h,
                                  seed=self.seed)
                    spec = s
                    self.log.append(fired)
                    break
        if fired is None:
            return None
        _obs_metrics.counter(f"faults.fired.{site}").inc()
        if fired.kind == "raise":
            raise InjectedFault(
                f"injected fault at {site} (hit {fired.hit})")
        if fired.kind == "delay":
            time.sleep(spec.delay_s)
            return None
        return fired                    # corrupt: the caller applies it

    # -------------------------------------------------------- activation --

    def __enter__(self) -> "FaultPlan":
        global _ACTIVE
        self._prev = _ACTIVE
        _ACTIVE = self
        return self

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = self._prev
        return False


# The active plan. None -> every check() is a global read + None compare.
_ACTIVE: Optional[FaultPlan] = None


def check(site: str) -> Optional[Fired]:
    """THE seam entry point. No-op (None) when no plan is active; else may
    raise :class:`InjectedFault`, sleep, or return a corrupt directive."""
    plan = _ACTIVE
    if plan is None:
        return None
    return plan.hit(site)


def active_plan() -> Optional[FaultPlan]:
    return _ACTIVE


def install(plan: Optional[FaultPlan]):
    """Activate ``plan`` process-wide (None deactivates)."""
    global _ACTIVE
    _ACTIVE = plan


def deactivate():
    install(None)


# ------------------------------------------------------------- env parsing

def parse_env(s: str) -> FaultPlan:
    """``REPRO_FAULTS`` grammar -> FaultPlan (see module docstring)."""
    specs: List[FaultSpec] = []
    seed = 0
    for part in s.split(";"):
        part = part.strip()
        if not part:
            continue
        if part.startswith("seed="):
            seed = int(part[len("seed="):])
            continue
        fields = part.split(":")
        if len(fields) < 2:
            raise ValueError(
                f"REPRO_FAULTS entry {part!r}: expected site:kind[:k=v...]")
        kw: dict = {}
        for f in fields[2:]:
            k, sep, v = f.partition("=")
            if not sep:
                raise ValueError(f"REPRO_FAULTS entry {part!r}: "
                                 f"malformed field {f!r} (expected k=v)")
            if k == "nth":
                kw["nth"] = int(v)
            elif k == "p":
                kw["probability"] = float(v)
            elif k == "times":
                kw["times"] = int(v)
            elif k == "delay":
                kw["delay_s"] = float(v)
            else:
                raise ValueError(f"REPRO_FAULTS entry {part!r}: unknown "
                                 f"field {k!r} (nth/p/times/delay)")
        specs.append(FaultSpec(site=fields[0], kind=fields[1], **kw))
    return FaultPlan(specs, seed=seed)


def install_from_env(force: bool = False):
    """Install a plan from ``REPRO_FAULTS`` if set (import-time hook).
    ``force=True`` re-reads the env even when a plan is already active."""
    if _ACTIVE is not None and not force:
        return
    val = os.environ.get(ENV_VAR, "")
    if val:
        install(parse_env(val))


install_from_env()
