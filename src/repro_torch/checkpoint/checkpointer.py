"""Atomic, async, keep-N checkpoints of trees of tensors (port of
``repro/checkpoint/checkpointer.py``, one host).

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
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save --
    def save(self, step: int, tree: Any, *, block: bool = False):
        self.wait()                      # one in-flight save at a time
        # fetched to host now, so the caller may overwrite its tensors
        items = [(k, *_to_host(v)) for k, v in paths(tree)]

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

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

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

    def restore(self, tree_like: Any, step: Optional[int] = None):
        """``(tree, step)``: the checkpoint of ``step`` (the latest committed
        one by default) in the structure of ``tree_like``, each leaf cast
        to its ``tree_like`` leaf's dtype and put on its device."""
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
                if isinstance(want, torch.Tensor):
                    t = t.to(device=want.device, dtype=want.dtype)
                return t
            return map_with_paths(load, tree_like), step
