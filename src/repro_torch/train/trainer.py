"""Fault-tolerant training loop (port of ``repro/train/trainer.py``).

* Checkpoint / restart: checkpoints every ``ckpt_every`` steps (written
  on a background thread); a restore resumes from the latest committed
  step, and the index-based data pipeline replays the exact batch
  sequence, so an interrupted run and an uninterrupted one give the same
  losses.
* Preemption: SIGTERM (after :meth:`Trainer.install_preemption_handler`)
  makes the loop save a blocking checkpoint after the step in flight and
  return.
* Non-finite steps: a step whose loss or gradient norm is not finite is
  counted in ``skipped`` and left out of the history. Its update is kept,
  as the JAX package's code keeps it (its docstring says the params and
  optimizer state are kept from before the step; its code keeps the
  donated, updated buffers); if any parameter is then non-finite, the
  last checkpoint is restored.
* Stragglers: each step's wall time goes to a :class:`HeartbeatMonitor`,
  which counts steps slower than ``straggler_factor`` x the trailing
  median.

The step (:func:`~repro_torch.train.train_step.make_train_step`)
updates params and optimizer state in place.

Sharded, as JAX's: every rank of a ``launch.world.run_world`` world runs
the trainer inside ``parallel.sharding.use_mesh`` and the train rules
(``use_rules(make_rules(mesh, cfg, "train", fsdp=True))``) with
``param_shardings`` (``tree_shardings(api.param_specs(cfg))``) and
``batch_shardings``. The initial params are made whole from the seeded
generator and cut to the rank's blocks; a restore is elastic (the
checkpoint's global arrays cut under the given shardings, the moments
under the params', whatever mesh wrote them); a checkpoint gathers the
blocks, its mesh's first rank writes it. Every decision that would part
the ranks is agreed: the preemption flag is the world's ``pmax`` before
each save decision (a SIGTERM seen by one rank alone would leave the
others waiting in the next collective), and so is a rank's finding that
its params went non-finite.
"""
from __future__ import annotations

import dataclasses
import math
import signal
import statistics
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.data.pipeline import IndexedDataset, PrefetchLoader
from repro_torch.device import resolve_device
from repro_torch.optim import init_opt_state
from repro_torch.parallel import sharding as S
from repro_torch.tree import leaves

from .train_step import TrainConfig, make_train_step, trainable


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    # no default: a Trainer resumes from any checkpoint it finds there
    ckpt_dir: str = dataclasses.field(kw_only=True)
    keep: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0


class HeartbeatMonitor:
    """Tracks step wall times; flags stragglers against the trailing
    median."""

    def __init__(self, factor: float = 3.0, window: int = 32):
        self.factor = factor
        self.window = window
        self.times: list[float] = []
        self.stragglers = 0

    def beat(self, dt: float) -> bool:
        flagged = False
        if len(self.times) >= 8:
            med = statistics.median(self.times[-self.window:])
            flagged = dt > self.factor * med
            self.stragglers += int(flagged)
        self.times.append(dt)
        return flagged


def _all_finite(params) -> bool:
    return all(bool(torch.isfinite(p).all()) for p in leaves(params)
               if p.is_floating_point())


def _anywhere(flag: bool, device) -> bool:
    """``flag`` on any rank of the current mesh (its ``pmax``), or
    ``flag`` outside one."""
    mesh = S.current_mesh()
    if mesh is None:
        return flag
    got = S.pmax(torch.tensor([float(flag)], device=device),
                 tuple(mesh.mesh_dim_names))
    return bool(got.item())


class Trainer:
    """``init_params_fn(generator)`` makes the initial parameters from a
    ``torch.Generator`` on ``device`` seeded with the run's seed (whole,
    on every rank of a sharded run; module docstring)."""

    def __init__(self, cfg, tcfg: TrainConfig, loop: LoopConfig,
                 dataset: IndexedDataset, init_params_fn: Callable,
                 param_shardings=None, batch_shardings=None, *,
                 device="cuda"):
        self.cfg = cfg
        self.tcfg = tcfg
        self.loop = loop
        self.ds = dataset
        self.device = resolve_device(device)
        self.ckpt = Checkpointer(loop.ckpt_dir, keep=loop.keep)
        self.monitor = HeartbeatMonitor(loop.straggler_factor)
        self.step_fn = make_train_step(cfg, tcfg)
        self._preempted = False
        self._init_params_fn = init_params_fn
        self.param_shardings = param_shardings
        self.batch_shardings = batch_shardings
        self.skipped = 0

    def _shardings(self):
        """The checkpoint tree's shardings (JAX's: the moments take the
        params'), or ``None``."""
        psh = self.param_shardings
        if psh is None:
            return None
        return {"params": psh, "opt": {"m": psh, "v": psh, "step": None}}

    # -------------------------------------------------------- lifecycle --
    def install_preemption_handler(self):
        def _handler(signum, frame):
            self._preempted = True
        signal.signal(signal.SIGTERM, _handler)

    def _restore(self, params, opt_state, step=None):
        # a save in flight commits first: every rank then reads the same
        # latest step (in a sharded run the wait is a collective)
        self.ckpt.wait()
        tree, got = self.ckpt.restore({"params": params, "opt": opt_state},
                                      step, shardings=self._shardings())
        return trainable(tree["params"]), tree["opt"], got

    def init_or_restore(self, seed: int = 0):
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = self._init_params_fn(gen)
        if self.param_shardings is not None:
            params = S.local_tree(params, self.param_shardings, copy=True)
        params = trainable(params)
        opt_state = init_opt_state(params, self.tcfg.opt)
        start = 0
        if self.ckpt.latest_step() is not None:
            params, opt_state, start = self._restore(params, opt_state)
        return params, opt_state, start

    # -------------------------------------------------------------- run --
    def run(self, params=None, opt_state=None,
            start_step: Optional[int] = None, seed: int = 0):
        if params is None:
            params, opt_state, start_step = self.init_or_restore(seed)
        start_step = start_step or 0
        loader = PrefetchLoader(self.ds, start_step, device=self.device,
                                sharding=self.batch_shardings)
        history = []
        step = start_step
        while step < self.loop.total_steps:
            batch = next(loader)
            t0 = time.perf_counter()
            params, opt_state, metrics = self.step_fn(params, opt_state,
                                                      batch)
            loss = float(metrics["loss"])
            gnorm = float(metrics["grad_norm"])
            dt = time.perf_counter() - t0
            self.monitor.beat(dt)
            if not (math.isfinite(loss) and math.isfinite(gnorm)):
                # the update is kept (module docstring); a state that
                # itself went bad is replaced by the last checkpoint
                self.skipped += 1
                if _anywhere(not _all_finite(params), self.device):
                    params, opt_state, _ = self._restore(params, opt_state)
            else:
                history.append(dict(step=step, loss=loss, grad_norm=gnorm,
                                    sec=dt))
            step += 1
            preempted = _anywhere(self._preempted, self.device)
            if step % self.loop.ckpt_every == 0 or preempted:
                self.ckpt.save(step, {"params": params, "opt": opt_state},
                               block=preempted, shardings=self._shardings())
                if preempted:
                    return params, opt_state, step, history
            if self.loop.log_every and step % self.loop.log_every == 0:
                print(f"step {step} loss {loss:.4f} gnorm {gnorm:.3f} "
                      f"{dt * 1e3:.0f}ms", flush=True)
        self.ckpt.save(self.loop.total_steps,
                       {"params": params, "opt": opt_state}, block=True,
                       shardings=self._shardings())
        self.ckpt.wait()
        return params, opt_state, step, history
