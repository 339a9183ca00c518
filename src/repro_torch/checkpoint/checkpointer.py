"""Atomic, async, keep-N, elastic checkpoints of trees of tensors (port of
``repro/checkpoint/checkpointer.py``).

Layout per step, the JAX package's::

    <dir>/step_000000123/
        manifest.json     the step and each leaf's key, shape and dtype
        shard_0.npz       the leaves, keyed by path ("blocks/0/conv/w")
        _COMMITTED        the commit marker, written last

so a checkpoint written by either package restores in the other.

* Atomic: a step is written under ``step_....tmp`` and renamed into place
  after its marker; readers trust only directories with the marker.
* Async: the leaves are copied to host memory before ``save`` returns,
  and written on a background thread (one save in flight at a time).
* Keep-N: after each write, all but the newest ``keep`` steps go.

* Sharded: inside a mesh (``parallel.sharding``) ``save`` takes the
  leaves' ``shardings`` (a tree of ``NamedSharding`` s, ``None`` for a
  leaf or subtree held whole) and gathers each leaf to its global array
  on the caller's thread before it returns (a collective: every rank
  calls it); the mesh's first rank alone writes, JAX's layout of global
  arrays, and at the next ``wait`` (or at once with ``block``) every rank
  waits for the commit.
* Elastic: ``restore(..., shardings=)`` returns each rank's block of the
  stored global arrays (``local_shard``) under any mesh, whatever mesh
  wrote them.

npz holds no bfloat16: such a leaf is stored as its 16-bit pattern
(uint16) and the manifest's dtype, which is authoritative, restores it.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.parallel import sharding as S
from repro_torch.tree import map_with_paths, paths


def _to_host(v) -> tuple:
    """(numpy array as stored, dtype name) of one leaf, a copy: a host
    tensor's ``.cpu()`` is the tensor itself, which a trainer updating in
    place would change under a save in flight."""
    if isinstance(v, torch.Tensor):
        v = v.detach().to("cpu", copy=True)
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        v = v.numpy()
    v = np.asarray(v)
    return v, str(v.dtype)


def _at(shardings, path: str):
    """The sharding of the leaf at ``path`` (keys joined by "/") in a tree
    of shardings whose ``None`` or ``NamedSharding`` may stand for a whole
    subtree."""
    for key in path.split("/"):
        if shardings is None or isinstance(shardings, S.NamedSharding):
            break
        shardings = shardings[key]
    return shardings


@torch.no_grad()
def _global(t, sharding):
    """The global array of this rank's block ``t`` under ``sharding``: each
    split dim gathered over its mesh axes (inside ``sharding``'s mesh)."""
    if sharding is None:
        return t
    with S.use_mesh(sharding.mesh):
        for dim, entry in enumerate(sharding.spec):
            if entry is not None and S.axis_size(entry) > 1:
                t = S.all_gather(t, entry, dim)
    return t


def _barrier(mesh):
    """Every rank of ``mesh`` meets here."""
    with S.use_mesh(mesh):
        S.psum(torch.zeros(1, device=mesh.device_type),
               tuple(mesh.mesh_dim_names))


def _from_host(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, dtype=np.dtype(dtype_name)))


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._mesh = None        # the mesh of a sharded save not yet met
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save --
    def save(self, step: int, tree: Any, *, block: bool = False,
             shardings: Any = None):
        """Write ``tree`` as step ``step``; inside a mesh, with the
        leaves' ``shardings`` (module docstring), on every rank."""
        self.wait()                      # one in-flight save at a time
        mesh = S.current_mesh()
        # fetched to host now, so the caller may overwrite its tensors
        if mesh is None:
            items = [(k, *_to_host(v)) for k, v in paths(tree)]
        else:               # a leaf at a time: one global leaf on a card
            leader = not any(mesh.get_coordinate())
            items = []
            for k, v in paths(tree):
                whole = _global(v, _at(shardings, k))
                if leader:
                    items.append((k, *_to_host(whole)))
                del whole
            self._mesh = mesh
            if not leader:
                if block or not self.async_save:
                    self.wait()
                return

        def _write():
            path = os.path.join(self.dir, f"step_{step:09d}")
            tmp = path + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            manifest = {
                "step": step,
                "leaves": [{"key": k, "shape": list(v.shape), "dtype": dt}
                           for k, v, dt in items],
            }
            np.savez(os.path.join(tmp, "shard_0.npz"),
                     **{k: v for k, v, _ in items})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            with open(os.path.join(tmp, "_COMMITTED"), "w") as f:
                f.write(str(time.time()))
            if os.path.exists(path):
                shutil.rmtree(path)
            os.rename(tmp, path)
            self._gc()

        if self.async_save and not block:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()
            if self._mesh is not None:
                self.wait()

    def wait(self):
        """Until the save in flight has committed; after a sharded save,
        every rank of its mesh waits for the commit (a collective)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._mesh is not None:
            mesh, self._mesh = self._mesh, None
            _barrier(mesh)

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore --
    def all_steps(self) -> list:
        out = []
        for name in sorted(os.listdir(self.dir)):
            if name.startswith("step_") and not name.endswith(".tmp") and \
                    os.path.exists(os.path.join(self.dir, name, "_COMMITTED")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like: Any, step: Optional[int] = None,
                shardings: Any = None):
        """``(tree, step)``: the checkpoint of ``step`` (the latest committed
        one by default) in the structure of ``tree_like``, each leaf cast
        to its ``tree_like`` leaf's dtype and put on its device. With
        ``shardings`` (a tree like ``save``'s), each leaf is this rank's
        block of the stored global array under its sharding (a tensor of
        its own), the elastic path: the stored arrays know no mesh."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(path, "manifest.json")) as f:
            stored = {leaf["key"]: leaf["dtype"]
                      for leaf in json.load(f)["leaves"]}
        with np.load(os.path.join(path, "shard_0.npz")) as data:
            def load(key, want):
                t = _from_host(data[key], stored[key])
                sharding = _at(shardings, key)
                if sharding is not None:
                    t = S.local_shard(t, sharding).clone(
                        memory_format=torch.contiguous_format)
                if isinstance(want, torch.Tensor):
                    t = t.to(device=want.device, dtype=want.dtype)
                return t
            return map_with_paths(load, tree_like), step
