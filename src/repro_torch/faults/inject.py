"""Deterministic fault injection core.

The port's own copy of the JAX package's stdlib-only
``repro/faults/inject.py``, cut to what the port's serving layer uses: its
seams (``cnn.batch_round``, ``engine.prefill``, ``engine.decode_round``,
``tune.cache_load``),
the ``raise`` and ``corrupt`` kinds, and firing on a window of hit
numbers.

Fault *sites* are named seams in the hot paths — the instrumented code
calls :func:`check(site)` at each seam. With no plan active that call is
one module-global read and a ``None`` compare, so the seams ride in
production paths permanently. With a plan active, the per-site hit
counter advances and any matching :class:`FaultSpec` fires:

* ``kind="raise"``  — raises :class:`InjectedFault` out of the seam (the
  hardened caller must absorb it: retry or retire).
* ``kind="corrupt"`` — returns a :class:`Fired` directive whose
  :meth:`Fired.apply` deterministically corrupts a host array (poisoned
  logits — silent data corruption the engine *cannot* detect, only
  contain).

Firing is fully deterministic: an entry fires on hits ``[nth, nth +
times)`` of its site (a *consecutive* window, sized to defeat — or be
absorbed by — bounded retries, which re-hit the seam). Every fire is
appended to ``FaultPlan.log`` and counted into the process metrics
registry as ``faults.fired.<site>``.

Activation: ``with FaultPlan([...], seed=7): ...`` (nestable; restores the
previous plan on exit).
"""
from __future__ import annotations

import dataclasses
import threading
import zlib
from typing import Dict, List, Optional

from repro_torch.obs import metrics as _obs_metrics

#: The registered fault sites. A FaultSpec naming any other site is a
#: construction-time ValueError, so schedules can't silently rot when a
#: seam is renamed.
SITES = frozenset({
    "engine.prefill",        # LM Engine admission prefill (per attempt)
    "engine.decode_round",   # LM Engine decode round (per attempt)
    "cnn.batch_round",       # CNNEngine batch round (per attempt)
    "tune.cache_load",       # tuner cache file read (repro_torch.tune)
})

KINDS = ("raise", "corrupt")


class InjectedFault(RuntimeError):
    """The exception an active ``kind="raise"`` fault throws at its seam."""


@dataclasses.dataclass
class FaultSpec:
    """One scheduled fault: fire ``kind`` at ``site`` on the ``nth`` hit,
    and on the ``times - 1`` consecutive hits after it."""
    site: str
    kind: str
    nth: int = 1
    times: int = 1

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"registered sites: {sorted(SITES)}")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"choose from {KINDS}")
        if self.nth < 1:
            raise ValueError(f"nth must be >= 1 (1-indexed), got {self.nth}")
        if self.times < 1:
            raise ValueError(f"times must be >= 1, got {self.times}")


@dataclasses.dataclass
class Fired:
    """One fired fault (also the corrupt directive handed to the seam's
    caller). ``apply`` is deterministic in (plan seed, site, hit)."""
    site: str
    kind: str
    hit: int                    # the site hit index (1-based) that fired
    seed: int

    def apply(self, arr):
        """Deterministically corrupt a host float array (the round's
        logits): overwrite a few seeded positions with out-of-band large
        values, which moves argmaxes."""
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
        flat[idx] = float(flat.max()) + 1e3 + rng.standard_normal(k)
        return a


class FaultPlan:
    """A seeded, deterministic schedule of :class:`FaultSpec` entries, used
    as a context manager (nestable — restores the previously active plan).
    One plan instance carries its own per-site hit counters; reuse across
    runs accumulates hits, so construct a fresh plan per run."""

    def __init__(self, specs: List[FaultSpec], seed: int = 0):
        self.specs = list(specs)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._by_site: Dict[str, List[FaultSpec]] = {}
        for s in self.specs:
            self._by_site.setdefault(s.site, []).append(s)
        self._hits: Dict[str, int] = {}
        self.log: List[Fired] = []

    def hit(self, site: str) -> Optional[Fired]:
        """Advance ``site``'s hit counter; raise or return a directive per
        the first matching spec. Returns None when nothing fires."""
        with self._lock:
            h = self._hits.get(site, 0) + 1
            self._hits[site] = h
            fired: Optional[Fired] = None
            for s in self._by_site.get(site, ()):
                if s.nth <= h < s.nth + s.times:
                    fired = Fired(site=site, kind=s.kind, hit=h,
                                  seed=self.seed)
                    self.log.append(fired)
                    break
        if fired is None:
            return None
        _obs_metrics.counter(f"faults.fired.{site}").inc()
        if fired.kind == "raise":
            raise InjectedFault(
                f"injected fault at {site} (hit {fired.hit})")
        return fired                    # corrupt: the caller applies it

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
    raise :class:`InjectedFault` or return a corrupt directive."""
    plan = _ACTIVE
    if plan is None:
        return None
    return plan.hit(site)
