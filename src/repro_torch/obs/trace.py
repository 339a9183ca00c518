"""Span tracer.

The port's own copy of the JAX package's stdlib-only ``repro/obs/trace.py``,
cut to what the port uses: :func:`span` around the executor's forwards,
the serving engine's rounds and the tuner's candidates (``set`` adds
attributes to a span's "E" event). Events are Chrome trace-event duration pairs
("B"/"E"), read back with :meth:`Tracer.events`.

Enabling: tracing is OFF by default and gated by the ``REPRO_TRACE`` env
var (any value other than ``""``/``"0"``), read once when the tracer is
constructed; :func:`enable`/:func:`disable` toggle it programmatically.
When disabled, ``span()`` returns a shared null context manager after one
attribute check, so instrumented hot paths carry no measurable overhead.

Clocks: event timestamps come from ``time.perf_counter()`` (monotonic),
rebased to the tracer's construction instant, in microseconds.
"""
from __future__ import annotations

import os
import threading
import time
from typing import List

ENV_VAR = "REPRO_TRACE"


def _env_enabled() -> bool:
    return os.environ.get(ENV_VAR, "") not in ("", "0")


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
    """Context manager emitting one balanced B/E pair on the owning tracer;
    the constructor's attributes ride on the "B" event, those given to
    :meth:`set` on the "E" event."""
    __slots__ = ("_tr", "_name", "_attrs", "_end")

    def __init__(self, tr: "Tracer", name: str, attrs: dict):
        self._tr = tr
        self._name = name
        self._attrs = attrs
        self._end = {}

    def __enter__(self):
        self._tr._emit("B", self._name, self._attrs)
        return self

    def set(self, **attrs):
        """Attributes known only at the end (a measured time)."""
        self._end.update(attrs)
        return self

    def __exit__(self, *exc):
        self._tr._emit("E", self._name, self._end)
        return False


class Tracer:
    """Thread-safe collector of Chrome trace duration events."""

    def __init__(self):
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._enabled = _env_enabled()
        self._t0 = time.perf_counter()
        self._pid = os.getpid()

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

    def _emit(self, ph: str, name: str, attrs: dict):
        ev = {"ph": ph, "name": name, "cat": "repro",
              "ts": (time.perf_counter() - self._t0) * 1e6,
              "pid": self._pid, "tid": threading.get_ident()}
        if attrs:
            ev["args"] = dict(attrs)
        with self._lock:
            self._events.append(ev)

    def span(self, name: str, **attrs):
        """Context manager measuring the enclosed block as one span."""
        if not self._enabled:
            return _NULL_SPAN
        return _Span(self, name, attrs)

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)


# Process-wide tracer: the instance every instrumented layer emits to.
TRACER = Tracer()


def enable():
    TRACER.enable()


def disable():
    TRACER.disable()


def clear():
    TRACER.clear()


def span(name: str, **attrs):
    """Module-level span on the process tracer (the common call site)."""
    return TRACER.span(name, **attrs)
