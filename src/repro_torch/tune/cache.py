"""Persistent autotuning config cache (port of ``repro/tune/cache.py``).

JSON on disk, keyed by ``(kernel, shape, dtype, backend)``, with a schema
version so a cache written over another search space is ignored rather
than misapplied. An in-process memo sits in front of the file so the
dispatch hot path never re-reads or re-parses JSON.

Resolution order used by the kernel dispatch layer (``runner.get_config``):

  1. the in-process memo (analytic-fallback results included);
  2. the entries of the loaded cache: the file ``REPRO_TORCH_TUNE_CACHE``
     names, if it is set (there is no other default location);
  3. the analytic cost model (``runner.analytic_config``), memoized.

The port never reads or writes the JAX package's cache
(``artifacts/tune_cache.json``): its configs are Pallas block sizes, and
the port's backend tags name a CUDA card or the host, so no key could
match anyway.
"""
from __future__ import annotations

import json
import os
import threading
import warnings
from typing import Dict, Optional

from repro_torch.faults import inject as faults
from repro_torch.obs import metrics as _obs_metrics

#: v1: threads / bm / splits spaces of the port's CUDA kernels; v2: the
#: integer conv2d's tile (bp, q) in place of threads, the float matmul's
#: tile (bm, bn, tm, tn) in place of bm; v3: shift_conv2d's tile (bp, q) in
#: place of threads, in every mode; v4: the float conv2d's and the float
#: add_conv2d's tile (bp, q) in place of threads; v5: depthwise2d's tile
#: (pt, rows) and the integer add_conv2d's tile (bp, q) in place of threads;
#: v6: the integer matmul's tile (bn, bm) and cluster in place of bm /
#: splits; v7: causal_conv1d's run and block size (run, threads) in place
#: of threads alone, and the pools' vector paths
SCHEMA_VERSION = 7
#: the environment variable naming the default cache file
ENV_VAR = "REPRO_TORCH_TUNE_CACHE"


def cache_key(kernel: str, shape_key: str, dtype: str, backend: str) -> str:
    return "|".join((kernel, shape_key, dtype, backend))


class TuneCache:
    """One JSON cache file: ``{schema_version, entries: {key: entry}}``.

    An *entry* is ``{"config": {...}, "us": float|None, "source":
    "measured"|"analytic", ...}``. Unknown extra fields round-trip
    untouched.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.entries: Dict[str, dict] = {}
        self.stale = False          # True if an on-disk file was not used
        self._lock = threading.Lock()
        if path:
            self._load(path)

    def _load(self, path: str):
        """A corrupt, truncated or wrongly typed file never raises: it warns,
        counts ``tune.cache.load_failed``, marks the cache ``stale`` (empty),
        and lookups fall back to the analytic model. A file of another
        schema is ignored the same way, without the warning. ``save()`` is
        atomic, so a file only ends up corrupt from outside."""
        if not os.path.exists(path):
            return
        try:
            faults.check("tune.cache_load")
            with open(path) as f:
                blob = json.load(f)
            if not isinstance(blob, dict):
                raise ValueError(f"expected a JSON object at top level, "
                                 f"got {type(blob).__name__}")
        except (OSError, ValueError, faults.InjectedFault) as e:
            warnings.warn(
                f"tune cache {path!r} is unreadable ({e!r}); kernels run "
                f"analytic schedules until it is re-tuned",
                RuntimeWarning, stacklevel=3)
            _obs_metrics.counter("tune.cache.load_failed").inc()
            self.stale = True
            return
        entries = blob.get("entries", {})
        if (blob.get("schema_version") != SCHEMA_VERSION
                or not isinstance(entries, dict)):
            # another schema: never misapply a config searched over a
            # different space; save() rewrites the file at this version
            self.stale = True
            return
        self.entries = entries

    def get(self, key: str) -> Optional[dict]:
        return self.entries.get(key)

    def put(self, key: str, config: dict, *, us: Optional[float] = None,
            source: str = "measured", **meta):
        with self._lock:
            self.entries[key] = dict(config=dict(config), us=us,
                                     source=source, **meta)

    def save(self, path: Optional[str] = None):
        path = path or self.path
        if not path:
            raise ValueError("TuneCache.save: no path given or bound")
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        blob = {"schema_version": SCHEMA_VERSION, "entries": self.entries}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(blob, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        self.path = path

    def __len__(self):
        return len(self.entries)


# --------------------------------------------------------------------------
# Process-wide default cache + memo (the dispatch hot path)
# --------------------------------------------------------------------------

_default_cache: Optional[TuneCache] = None
_memo: Dict[tuple, dict] = {}
_memo_lock = threading.Lock()
# counter handles stay valid across Registry.reset (it zeroes in place)
_MEMO_HIT = _obs_metrics.counter("tune.memo.hit")
_MEMO_MISS = _obs_metrics.counter("tune.memo.miss")


def default_cache_path() -> Optional[str]:
    """The file ``REPRO_TORCH_TUNE_CACHE`` names, or None."""
    return os.environ.get(ENV_VAR) or None


def get_default_cache() -> TuneCache:
    global _default_cache
    if _default_cache is None:
        _default_cache = TuneCache(default_cache_path())
    return _default_cache


def set_default_cache(cache: Optional[TuneCache]):
    """Install a cache for the dispatch layer (tests, scripts); clears the
    memo. ``None`` re-reads the environment at the next lookup."""
    global _default_cache
    with _memo_lock:
        _default_cache = cache
        _memo.clear()


def reset():
    """Drop the default cache and the memo."""
    set_default_cache(None)


def memo_get(key) -> Optional[dict]:
    entry = _memo.get(key)
    (_MEMO_HIT if entry is not None else _MEMO_MISS).inc()
    return entry


def memo_put(key, entry: dict):
    with _memo_lock:
        _memo[key] = entry
