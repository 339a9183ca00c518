"""One function captured as a CUDA graph: the port's counterpart of a
``jax.jit`` trace, shared by ``CompiledPlan`` (one graph per batch size)
and the LM ``Engine`` (its decode step and its dense prefill buckets).

:func:`capture` runs the function once eagerly on a side stream (it
launches, and counts, like any call; it resolves launch configs and builds
the kernel library at a process's first launch), then captures it over
the same static inputs. The function must hold no host sync (``.cpu()``,
``.item()``, ``float(t)``): a sync breaks the capture, and a failed
capture raises. Inputs and outputs are static: a caller writes the next
call's inputs into ``inputs`` in place and reads ``outputs`` after a
replay, until the next replay overwrites them. Tensors the function reads
from outside (weights, a live cache) are read by address, so a caller
must update them in place, never rebind them.

Launch counts: the wrapper calls made while capturing execute nothing, so
the change they make to each kernel wrapper's ``launches`` is taken back
out and kept as :attr:`CapturedFn.launches`, the launches one replay
makes; :meth:`CapturedFn.replay` adds it back. Each capture counts into the
process metrics as ``graph.compiles`` and ``graph.compiles.<key>``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, Iterable, Tuple

import torch

from repro_torch.kernels import KERNELS
from repro_torch.obs import metrics as obs_metrics
from repro_torch.tree import leaves


@dataclasses.dataclass(eq=False)
class CapturedFn:
    """A captured graph, its static inputs and outputs, the kernel launches
    one replay makes, and the wall seconds of its first call (the eager
    pass and the capture)."""
    graph: "torch.cuda.CUDAGraph"
    inputs: tuple
    outputs: object
    launches: Dict[object, int]
    seconds: float

    def replay(self):
        """Run the graph on what ``inputs`` hold now; returns
        ``outputs``."""
        self.graph.replay()
        for k, n in self.launches.items():
            k.launches += n
        return self.outputs


@contextlib.contextmanager
def launches_taken_out(kernels: Iterable = KERNELS):
    """Within the block, kernel wrappers count their launches as usual; on
    leaving it (also by an exception) each wrapper's count is restored and
    the yielded dict holds the change, wrapper -> launches, for the
    wrappers whose count changed."""
    before = {k: k.launches for k in kernels}
    record: Dict[object, int] = {}
    try:
        yield record
    finally:
        record.update((k, k.launches - n) for k, n in before.items()
                      if k.launches != n)
        for k, n in before.items():
            k.launches = n


def capture(fn: Callable, inputs: tuple, *, key: str,
            pool=None) -> Tuple[CapturedFn, object]:
    """Capture ``fn(*inputs)`` on the inputs' card. Returns the captured
    function and the outputs of the eager pass, which are this call's
    result: the capture itself computes nothing. ``pool`` is a
    ``torch.cuda.graph_pool_handle()`` that graphs replayed one at a time
    may share."""
    dev = inputs[0].device
    t0 = time.perf_counter()
    with torch.cuda.device(dev):
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            eager = fn(*inputs)
        cur.wait_stream(side)
        for t in leaves(eager):
            if isinstance(t, torch.Tensor):
                t.record_stream(cur)
        graph = torch.cuda.CUDAGraph()
        with launches_taken_out() as launches, \
                torch.cuda.graph(graph, pool=pool):
            outputs = fn(*inputs)
    obs_metrics.counter("graph.compiles").inc()
    obs_metrics.counter(f"graph.compiles.{key}").inc()
    return (CapturedFn(graph, tuple(inputs), outputs, launches,
                       time.perf_counter() - t0), eager)
