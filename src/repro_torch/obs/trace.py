"""Span tracer with Chrome trace-event export (Perfetto / chrome://tracing).

The port's own copy of the JAX package's stdlib-only ``repro/obs/trace.py``
(the port imports nothing of that package). One process-wide
:data:`TRACER` collects duration events ("B"/"E" pairs) from every
instrumented layer — the serve engines' request lifecycles, admissions and
rounds, the executor's forwards and captures, the tuner's candidates — and
exports them as Chrome trace-event JSON, which loads as-is in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing``.

Enabling: tracing is OFF by default and gated by the ``REPRO_TRACE`` env
var (any value other than ``""``/``"0"``), read once when the tracer is
constructed; :func:`enable`/:func:`disable` toggle it programmatically.
When disabled every entry point is a near-zero-cost no-op — ``span()``
returns a shared null context manager after one attribute check, and
``begin``/``end``/``complete`` return immediately — so instrumented hot
paths (the serve engines' per-round loops) carry no measurable overhead
with tracing off.

Clocks: event timestamps come from ``time.perf_counter()`` (monotonic, so
intervals can never go negative under wall-clock adjustment), rebased to
the tracer's construction instant and expressed in microseconds as the
trace format requires. The wall-clock time of that instant is recorded in
the export's ``otherData`` so absolute times are recoverable.

Lanes: ``tid`` defaults to the real thread id, but callers may pass a
synthetic lane id — the serve engines replay each retired request's
lifecycle (queue-wait -> prefill -> generate, or queue-wait -> execute)
onto its own fresh lane, so overlapping requests render as parallel tracks
and B/E pairs still nest properly per lane.
"""
from __future__ import annotations

import functools
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

ENV_VAR = "REPRO_TRACE"

# Synthetic-lane allocator: lanes are process-unique so replayed request
# lifecycles from any engine never interleave on one track.
_LANE_BASE = 1 << 20
_lane_counter = itertools.count(1)


def _env_enabled() -> bool:
    return os.environ.get(ENV_VAR, "") not in ("", "0")


def next_lane() -> int:
    """A fresh synthetic tid for one replayed span stack (see module doc)."""
    return _LANE_BASE + next(_lane_counter)


class _NullSpan:
    """Shared do-nothing context manager returned when tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NULL_SPAN = _NullSpan()


class _Span:
    """Context manager emitting one balanced B/E pair on the owning tracer.

    Attributes passed at construction ride on the "B" event; attributes
    added via :meth:`set` during the span ride on the "E" event (Perfetto
    merges both into the slice's args).
    """
    __slots__ = ("_tr", "_name", "_tid", "_cat", "_attrs", "_exit_attrs")

    def __init__(self, tr: "Tracer", name: str, tid, cat: str, attrs: dict):
        self._tr = tr
        self._name = name
        self._tid = tid
        self._cat = cat
        self._attrs = attrs
        self._exit_attrs: Dict[str, Any] = {}

    def set(self, **attrs):
        """Attach attributes discovered mid-span (e.g. a measured time)."""
        self._exit_attrs.update(attrs)
        return self

    def __enter__(self):
        self._tr.begin(self._name, tid=self._tid, cat=self._cat,
                       **self._attrs)
        return self

    def __exit__(self, *exc):
        self._tr.end(self._name, tid=self._tid, cat=self._cat,
                     **self._exit_attrs)
        return False


class Tracer:
    """Thread-safe collector of Chrome trace duration events."""

    def __init__(self, enabled: Optional[bool] = None):
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._enabled = _env_enabled() if enabled is None else enabled
        self._t0 = time.perf_counter()
        self._wall_t0 = time.time()
        self._pid = os.getpid()

    # ------------------------------------------------------------- gating --

    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self):
        self._enabled = True

    def disable(self):
        self._enabled = False

    def clear(self):
        with self._lock:
            self._events = []

    # ------------------------------------------------------------ emitting --

    def _ts_us(self, t: Optional[float]) -> float:
        """perf_counter seconds (or now) -> trace-relative microseconds."""
        t = time.perf_counter() if t is None else t
        return (t - self._t0) * 1e6

    def _emit(self, ph: str, name: str, ts: Optional[float], tid, cat: str,
              attrs: dict):
        ev = {"ph": ph, "name": name, "cat": cat, "ts": self._ts_us(ts),
              "pid": self._pid,
              "tid": threading.get_ident() if tid is None else tid}
        if attrs:
            ev["args"] = dict(attrs)
        with self._lock:
            self._events.append(ev)

    def begin(self, name: str, *, ts: Optional[float] = None, tid=None,
              cat: str = "repro", **attrs):
        """Open a span. ``ts`` is an optional recorded perf_counter stamp."""
        if self._enabled:
            self._emit("B", name, ts, tid, cat, attrs)

    def end(self, name: str, *, ts: Optional[float] = None, tid=None,
            cat: str = "repro", **attrs):
        if self._enabled:
            self._emit("E", name, ts, tid, cat, attrs)

    def complete(self, name: str, t_start: float, t_end: float, *, tid=None,
                 cat: str = "repro", **attrs):
        """One balanced B/E pair from two recorded perf_counter stamps —
        how engines replay a request lifecycle at retirement."""
        if self._enabled:
            self._emit("B", name, t_start, tid, cat, attrs)
            self._emit("E", name, t_end, tid, cat, {})

    def span(self, name: str, *, tid=None, cat: str = "repro", **attrs):
        """Context manager measuring the enclosed block as one span."""
        if not self._enabled:
            return _NULL_SPAN
        return _Span(self, name, tid, cat, attrs)

    # ------------------------------------------------------------- export --

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def to_chrome(self) -> dict:
        """The Chrome trace-event JSON object (load in Perfetto as-is)."""
        return {
            "traceEvents": self.events(),
            "displayTimeUnit": "ms",
            "otherData": {
                "wall_clock_t0": self._wall_t0,
                "pid": self._pid,
                "source": "repro_torch.obs.trace",
            },
        }

    def export(self, path: str) -> str:
        """Write the trace JSON to ``path``; returns the path."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path


# Process-wide tracer: the instance every instrumented layer emits to.
TRACER = Tracer()


def enabled() -> bool:
    return TRACER.enabled


def enable():
    TRACER.enable()


def disable():
    TRACER.disable()


def clear():
    TRACER.clear()


def span(name: str, *, tid=None, cat: str = "repro", **attrs):
    """Module-level span on the process tracer (the common call site)."""
    return TRACER.span(name, tid=tid, cat=cat, **attrs)


def export(path: str) -> str:
    return TRACER.export(path)


def traced(name: Optional[str] = None, *, cat: str = "repro"):
    """Decorator form: trace every call of ``fn`` as one span.

    ``@traced()`` uses the function's qualname; ``@traced("label")`` names
    the span explicitly. Disabled-mode cost is one attribute check.
    """
    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not TRACER.enabled:
                return fn(*args, **kwargs)
            with TRACER.span(label, cat=cat):
                return fn(*args, **kwargs)
        return wrapper
    return deco
