"""Run a function on every rank of a real ``torch.distributed`` world.

    world = run_world(fn, 8, device_type="cpu")     # 8 gloo processes
    world = run_world(fn, 2)                        # 2 threads, one card

JAX runs a sharded step over the devices of one process; the port runs it
SPMD, one rank per mesh device, every rank calling ``fn(rank, *args)``
with its process group initialised (the sharded step inside makes its
``DeviceMesh``: ``launch.mesh.make_mesh``). Two worlds:

* ``device_type="cpu"``: ``n`` processes (``spawn``) over the ``gloo``
  backend, meeting through a ``FileStore`` under a new temporary
  directory, so no port is fixed and worlds of parallel test workers never
  meet. Each process runs one intra-op thread (``torch.set_num_threads
  (1)``: the ranks share the host's cores). ``fn`` and ``args`` must
  pickle; each rank's result comes back pickled.
* ``device_type="cuda"``: ``n`` threads of this process over torch's
  threaded process group, sharing the one card (NCCL refuses two ranks on
  one device, and gloo has no ``all_to_all`` on CUDA tensors). Every
  thread issues its work to the device's default stream, so the stream
  runs it in issue order; a collective runs once every rank has joined it
  (the lowest rank copies the data, the others wait for it), so no rank
  reads a collective's output before the copy is queued, and nothing
  races across threads. The ranks take turns on the host
  (``parallel.sharding.taking_turns``): one runs until it waits in a
  collective (or makes a group or a mesh, ``launch.mesh.make_mesh``),
  then the next; a rank that waits on the others anywhere else holds
  its turn and stops the world. While the threads run, the interpreter's
  thread switch interval is ``THREAD_SWITCH_S`` (the default is 5 ms): a
  rank woken from a collective waits for the GIL until the rank that
  holds it lets go, and with the default that wait dominated a step of
  120 collectives.

A rank that raises, or a world that outlives ``timeout`` seconds, raises
here (the other ranks are terminated or released): nothing retries on
fewer ranks. Returns a :class:`World`: the backend, the rank count and
each rank's result in rank order.
"""
from __future__ import annotations

import dataclasses
import os
import queue as queue_mod
import shutil
import sys
import tempfile
import threading
import traceback
from datetime import timedelta


#: the thread switch interval while a threaded world runs (seconds)
THREAD_SWITCH_S = 1e-4


@dataclasses.dataclass
class World:
    backend: str
    ranks: int
    results: list


class WorldError(RuntimeError):
    """A rank of a world raised, or the world did not end in time."""


def run_world(fn, n: int, *args, device_type: str = "cuda",
              timeout: float = 300.0) -> World:
    """``fn(rank, *args)`` on each of ``n`` ranks (module docstring)."""
    if n < 1:
        raise ValueError(f"run_world: n must be >= 1, got {n}")
    if device_type == "cpu":
        return _process_world(fn, n, args, timeout)
    if device_type == "cuda":
        return _thread_world(fn, n, args, timeout, device_type)
    raise ValueError(f"run_world: device_type must be 'cpu' or 'cuda', got "
                     f"{device_type!r}")


def _gloo_rank(rank, n, store_path, timeout, fn, args, out):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        store = dist.FileStore(store_path, n)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=n,
                                timeout=timedelta(seconds=timeout))
        try:
            out.put((rank, True, fn(rank, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        out.put((rank, False, traceback.format_exc()))


def _process_world(fn, n, args, timeout) -> World:
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_world_")
    out = ctx.Queue()
    procs = [ctx.Process(target=_gloo_rank, daemon=True, args=(
        r, n, os.path.join(tmp, "store"), timeout, fn, args, out))
        for r in range(n)]
    try:
        for p in procs:
            p.start()
        results = _collect(out, n, timeout, "gloo")
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
    return World("gloo", n, results)


def _collect(out, n, timeout, backend) -> list:
    """Each rank's result from ``out``, in rank order; the first error or
    a timeout raises."""
    import time
    results = [None] * n
    deadline = time.monotonic() + timeout
    for _ in range(n):
        try:
            rank, ok, value = out.get(
                timeout=max(0.0, deadline - time.monotonic()))
        except queue_mod.Empty:
            raise WorldError(f"{backend} world of {n} ranks: no result "
                             f"within {timeout} s") from None
        if not ok:
            raise WorldError(f"{backend} world: rank {rank} raised\n{value}")
        results[rank] = value
    return results


def _thread_world(fn, n, args, timeout, device_type) -> World:
    """The card's world: ``n`` threads over the threaded process group
    (``device_type="cpu"`` runs the same world on host tensors)."""
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed import multi_threaded_pg as tpg
    isolate = getattr(torch._C._distributed_c10d,
                      "_set_thread_isolation_mode", None)
    if isolate is not None:
        isolate(True)
    tpg._install_threaded_pg()
    from repro_torch.parallel.sharding import taking_turns
    store = dist.HashStore()
    turn = threading.Lock()
    out = queue_mod.Queue()
    device = torch.cuda.current_device() if device_type == "cuda" else None

    def rank_main(rank):
        # the thread's groups live in its thread-local world, dropped with
        # the world below (destroy_process_group reads attributes that
        # some torch versions' threaded world lacks)
        try:
            if device is not None:
                torch.cuda.set_device(device)
            dist.init_process_group("threaded", rank=rank, world_size=n,
                                    store=store)
            with taking_turns(turn):
                result = fn(rank, *args)
            out.put((rank, True, result))
        except BaseException as e:
            out.put((rank, False, traceback.format_exc()))
            tpg.ProcessLocalGroup.exception_handle(e)   # release the others

    ts = [threading.Thread(target=rank_main, args=(r,), daemon=True)
          for r in range(n)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(THREAD_SWITCH_S)
    try:
        for t in ts:
            t.start()
        results = _collect(out, n, timeout, "threaded")
        for t in ts:
            t.join(timeout=30)
    except BaseException as e:
        tpg.ProcessLocalGroup.exception_handle(e)
        for t in ts:
            t.join(timeout=30)
        raise
    finally:
        sys.setswitchinterval(switch)
        tpg.ProcessLocalGroup.reset()
        tpg._uninstall_threaded_pg()
        if isolate is not None:
            isolate(False)
    return World("threaded", n, results)
