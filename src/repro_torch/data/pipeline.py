"""Deterministic, shardable, resumable synthetic data (port of
``repro/data/pipeline.py``, numpy only).

The pipeline is index-based: batch ``i`` is a pure function of (seed, i,
host), so a resume needs only the step counter from the checkpoint, every
host computes exactly its own shard, and skip-ahead is O(1). The numpy
generator is the JAX package's, so every batch is bitwise equal to its
batch for every ``kind`` (lm, vlm, encdec, image).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    kind: str = "lm"              # lm | vlm | encdec | image
    vocab: int = 32000
    seq_len: int = 1024
    global_batch: int = 8
    seed: int = 0
    # image (paper-side CNN)
    image_size: int = 32
    channels: int = 3
    num_classes: int = 10
    d_model: int = 0              # vlm/encdec stub embedding dim
    frontend_positions: int = 0


class IndexedDataset:
    """batch(i) -> this host's shard of global batch i (numpy arrays)."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, num_hosts: int = 1):
        if cfg.global_batch % num_hosts:
            raise ValueError(f"global_batch={cfg.global_batch} does not "
                             f"split over {num_hosts} hosts")
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.local_batch = cfg.global_batch // num_hosts

    def _rng(self, step: int) -> np.random.Generator:
        # counter-based: independent of call order, O(1) skip-ahead
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, self.host_id]))

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = self._rng(step)
        if cfg.kind == "lm":
            # n-gram-ish repeats, so a model can reduce the loss
            toks = rng.integers(0, cfg.vocab,
                                (self.local_batch, cfg.seq_len + 1),
                                dtype=np.int32)
            period = 3 + (step % 5)
            toks[:, period:] = np.where(
                rng.random((self.local_batch, cfg.seq_len + 1 - period))
                < 0.7, toks[:, :-period], toks[:, period:])
            return {"tokens": toks}
        if cfg.kind == "vlm":
            toks = rng.integers(0, cfg.vocab,
                                (self.local_batch,
                                 cfg.seq_len - cfg.frontend_positions + 1),
                                dtype=np.int32)
            emb = rng.standard_normal(
                (self.local_batch, cfg.frontend_positions, cfg.d_model),
                dtype=np.float32)
            return {"tokens": toks, "embeds": emb}
        if cfg.kind == "encdec":
            toks = rng.integers(0, cfg.vocab,
                                (self.local_batch, cfg.seq_len + 1),
                                dtype=np.int32)
            frames = rng.standard_normal(
                (self.local_batch, cfg.seq_len, cfg.d_model),
                dtype=np.float32)
            return {"frames": frames, "tokens": toks}
        if cfg.kind == "image":
            # class-conditional gaussian blobs: a learnable classification
            y = rng.integers(0, cfg.num_classes, (self.local_batch,),
                             dtype=np.int32)
            means = np.linspace(-1.5, 1.5, cfg.num_classes)[y]
            x = rng.standard_normal(
                (self.local_batch, cfg.image_size, cfg.image_size,
                 cfg.channels)).astype(np.float32) * 0.5 \
                + means[:, None, None, None]
            # a class-dependent spatial pattern, so convs matter
            xs = np.linspace(0, np.pi * 2, cfg.image_size)
            pat = np.sin(xs[None, :, None] * (1 + y[:, None, None] % 4))
            x += pat[..., None].astype(np.float32)
            return {"images": x, "labels": y}
        raise ValueError(f"unknown data kind {cfg.kind!r}")

    def iterate(self, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1


def _to32(a: np.ndarray) -> np.ndarray:
    return a.astype({"f": np.float32, "i": np.int32}[a.dtype.kind]) \
        if a.dtype.itemsize == 8 and a.dtype.kind in "fi" else a


class PrefetchLoader:
    """Batches moved to ``device`` ``depth`` steps ahead of the one handed
    out (on a card the copies are enqueued behind the running step)."""

    def __init__(self, ds: IndexedDataset, start_step: int = 0,
                 depth: int = 2, device="cuda"):
        self.ds = ds
        self.step = start_step
        self.depth = depth
        self.device = resolve_device(device)
        self.buf: list = []

    def _put(self, batch: dict) -> dict:
        # 64-bit arrays arrive in 32 bits, as JAX puts them with x64 off
        return {k: torch.as_tensor(_to32(v)).to(self.device,
                                                non_blocking=True)
                for k, v in batch.items()}

    def __next__(self) -> dict:
        while len(self.buf) < self.depth:
            self.buf.append(self._put(self.ds.batch(self.step
                                                    + len(self.buf))))
        out = self.buf.pop(0)
        self.step += 1
        return out

    def __iter__(self):
        return self
