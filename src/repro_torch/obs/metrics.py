"""Metrics registry: counters, gauges, fixed-bucket histograms.

The port's own copy of the JAX package's stdlib-only ``repro/obs/metrics.py``
(the port imports nothing of that package). A :class:`Registry` is a
thread-safe, name-keyed collection of instruments with
``snapshot()``/``to_json()`` for machine-readable export (the same dict and
the same JSON string as the JAX package's for the same observations).
:data:`REGISTRY` is the process-wide default that the kernel dispatch layer
and the fault seams count into; each ``CNNEngine`` and LM ``Engine`` owns a
private ``Registry`` so its ``stats`` stay isolated across engine instances
(``reset`` zeroes values in place, so handles held by an engine stay live).

Histograms use fixed bucket boundaries (default: 1-2-5 log-spaced seconds
covering 1us..50s) and report percentiles by linear interpolation inside the
containing bucket, clamped to the observed min/max; ``sum``/``count`` are
tracked exactly, so ``mean`` is exact even though percentiles are
bucket-resolution approximations.
"""
from __future__ import annotations

import bisect
import json
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

# 1-2-5 per decade, 1µs .. 50s: latency-shaped default for seconds values.
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(
    m * 10.0 ** e for e in range(-6, 2) for m in (1.0, 2.0, 5.0))


class Counter:
    """Monotonically increasing value (float increments allowed, so time
    accumulators like ``batch_time_s`` are counters too)."""
    __slots__ = ("name", "_lock", "_v")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._v = 0.0

    def inc(self, n: Union[int, float] = 1):
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        return self._v

    def reset(self):
        with self._lock:
            self._v = 0.0

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self._v}


class Gauge:
    """Last-write-wins value (e.g. the LM engine's block-pool gauges)."""
    __slots__ = ("name", "_lock", "_v")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._v = 0.0

    def set(self, v: Union[int, float]):
        with self._lock:
            self._v = float(v)

    @property
    def value(self) -> float:
        return self._v

    def reset(self):
        with self._lock:
            self._v = 0.0

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self._v}


class Histogram:
    """Fixed-bucket histogram with exact sum/count and interpolated
    percentiles.

    ``buckets`` are the inclusive upper bounds of each bin (ascending); an
    implicit overflow bin catches values above the last bound. Percentiles
    interpolate linearly inside the containing bucket and are clamped to
    the observed [min, max], so they are exact to bucket resolution.
    """
    __slots__ = ("name", "buckets", "_lock", "_counts", "_sum", "_count",
                 "_min", "_max")

    def __init__(self, name: str,
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        bs = tuple(sorted(buckets if buckets is not None else DEFAULT_BUCKETS))
        if not bs:
            raise ValueError(f"histogram {name}: empty bucket list")
        self.buckets = bs
        self._lock = threading.Lock()
        self._counts = [0] * (len(bs) + 1)     # +1: overflow bin
        self._sum = 0.0
        self._count = 0
        self._min = float("inf")
        self._max = float("-inf")

    def observe(self, v: Union[int, float]):
        v = float(v)
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    @property
    def min(self) -> float:
        return self._min if self._count else 0.0

    @property
    def max(self) -> float:
        return self._max if self._count else 0.0

    def percentile(self, p: float) -> float:
        """p in [0, 100] -> interpolated value at that rank."""
        if not 0.0 <= p <= 100.0:
            raise ValueError(f"percentile {p} outside [0, 100]")
        with self._lock:
            count = self._count
            counts = list(self._counts)
            lo, hi = self._min, self._max
        if count == 0:
            return 0.0
        target = (p / 100.0) * count
        cum = 0.0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= target:
                b_lo = self.buckets[i - 1] if i > 0 else min(lo, self.buckets[0])
                b_hi = self.buckets[i] if i < len(self.buckets) else hi
                frac = (target - cum) / c
                v = b_lo + frac * (b_hi - b_lo)
                return min(max(v, lo), hi)
            cum += c
        return hi

    def reset(self):
        with self._lock:
            self._counts = [0] * (len(self.buckets) + 1)
            self._sum = 0.0
            self._count = 0
            self._min = float("inf")
            self._max = float("-inf")

    def snapshot(self) -> dict:
        with self._lock:
            count, s = self._count, self._sum
        return {"type": "histogram", "count": count, "sum": s,
                "mean": s / count if count else 0.0,
                "min": self.min, "max": self.max,
                "p50": self.percentile(50.0),
                "p95": self.percentile(95.0),
                "p99": self.percentile(99.0)}


class Registry:
    """Name-keyed get-or-create store of metric instruments."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get_or_create(self, name: str, cls, *args):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, *args)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge)

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create(name, Histogram, buckets)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def reset(self):
        """Zero every instrument IN PLACE (handles stay valid — the serve
        engines hold references across ``reset_stats`` calls)."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m.reset()

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            metrics = sorted(self._metrics.items())
        return {name: m.snapshot() for name, m in metrics}

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)


# Process-wide default registry (kernel dispatch, fault seams, captures).
REGISTRY = Registry()


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str,
              buckets: Optional[Sequence[float]] = None) -> Histogram:
    return REGISTRY.histogram(name, buckets)


def snapshot() -> Dict[str, dict]:
    return REGISTRY.snapshot()


def to_json(indent: Optional[int] = None) -> str:
    return REGISTRY.to_json(indent)
