"""CNN microbatch serving: queued image requests through one CompiledPlan.

Port of ``repro/serve/cnn.py``. Requests queue up, and between *batch
rounds* the scheduler admits up to ``max_batch`` queued images into the
round's batch slots. Each round runs ONE batched forward through
``CompiledPlan.forward_batch``, padded to a pow2 batch bucket, and scatters
the logits back onto the originating requests.

Observability: ``CNNEngine.stats`` is backed by a private metrics registry
(``repro_torch.obs``; the same keys as the JAX engine), the round timer
stops only after ``torch.cuda.synchronize(device)`` so ``images_per_s``
measures device time, request timestamps are monotonic ``perf_counter``
values (with one wall-clock field for trace export), and with
``REPRO_TRACE=1`` each round lands on the process tracer as a
``cnn.batch_round`` span and each served request's lifecycle
(``image_request`` over ``queue_wait`` and ``execute``) on a lane of its
own.

Failure model: every request ends in a terminal ``status`` (ok | timeout |
error | shed). The ``cnn.batch_round`` fault seam (``repro_torch.faults``)
fires once per round attempt; an injected raise there, or at the
``kernels.dispatch`` seam inside the plan's forward (a ``"cuda"`` plan:
per kernel call, or per capture when the plan is captured), is absorbed
by ``max_retries`` bounded retries, and a round that still fails retires
its batch with ``status="error"``. A real exception from the plan (a kernel
that fails to build or launch) is not retried: the round retires at once.
Unlike the JAX engine, a failing plan is never switched to the plain
PyTorch versions, so a broken kernel shows as errors, not as a slower
engine; ``stats["degraded"]`` stays in the key set and is always 0. A
``corrupt`` fault poisons the round's host logits; the affected uids are
recorded in ``CNNEngine.poisoned_uids``. Deadlines cancel at round
admission; a full queue sheds at ``submit``
(``CNNServeConfig(max_queue=, shed_policy=)``).
"""
from __future__ import annotations

import dataclasses
import queue
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.faults import inject as faults
from repro_torch.graph.executor import CompiledPlan
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.engine import QueueFullError


@dataclasses.dataclass
class ImageRequest:
    """One classification request plus engine-filled result/metric fields."""
    uid: int
    image: np.ndarray               # (H, W, C) float
    logits: Optional[np.ndarray] = None
    done: bool = False
    status: str = "pending"         # terminal: ok | timeout | error | shed
    error: Optional[str] = None     # the absorbed exception, status="error"
    deadline_s: Optional[float] = None  # overrides CNNServeConfig.deadline_s
    # engine-filled metrics — monotonic perf_counter stamps (negative-proof
    # intervals); submit_wall_t is the wall-clock field for trace export
    submit_t: float = 0.0
    submit_wall_t: float = 0.0
    admit_t: float = 0.0            # perf_counter when its round started
    finish_t: float = 0.0
    batch_round: int = -1           # round the request was served in

    @property
    def latency_s(self) -> float:
        return max(self.finish_t - self.submit_t, 0.0)

    @property
    def queue_wait_s(self) -> float:
        return max(self.admit_t - self.submit_t, 0.0)


@dataclasses.dataclass
class CNNServeConfig:
    """max_batch: batch slots per round (forward_batch pads a ragged final
    round to its pow2 bucket, so partial rounds reuse a compiled shape).
    deadline_s / max_queue / shed_policy / max_retries / retry_backoff_s
    carry the JAX engine's failure-model semantics (deadlines checked at round admission; "reject" raises
    :class:`QueueFullError`, "drop" marks ``status="shed"``)."""
    max_batch: int = 8
    deadline_s: Optional[float] = None
    max_queue: Optional[int] = None
    shed_policy: str = "reject"
    max_retries: int = 2
    retry_backoff_s: float = 0.0


class CNNEngine:
    """Microbatching frontend over one :class:`CompiledPlan`."""

    def __init__(self, plan: CompiledPlan,
                 scfg: Optional[CNNServeConfig] = None):
        scfg = scfg or CNNServeConfig()
        from repro_torch.check.config import check_cnn_serve_config
        bad = check_cnn_serve_config(scfg)
        if bad:
            raise ValueError("invalid CNNServeConfig:\n"
                             + "\n".join(f"  - {m}" for m in bad))
        self.plan = plan
        self.scfg = scfg
        self.queue: "queue.Queue[ImageRequest]" = queue.Queue()
        # private registry: per-engine stats isolation, in-place reset
        self.metrics = obs_metrics.Registry()
        self._m = {
            "batch_rounds": self.metrics.counter("serve.cnn.batch_rounds"),
            "images_done": self.metrics.counter("serve.cnn.images_done"),
            "batch_time": self.metrics.counter("serve.cnn.batch_time_s"),
            "latency": self.metrics.histogram("serve.cnn.latency_s"),
            "queue_wait": self.metrics.histogram("serve.cnn.queue_wait_s"),
            # resilience counters
            "timeouts": self.metrics.counter("serve.cnn.timeouts"),
            "errors": self.metrics.counter("serve.cnn.errors"),
            "shed": self.metrics.counter("serve.cnn.shed"),
            "retries": self.metrics.counter("serve.cnn.retries"),
        }
        self.reset_stats()

    # ------------------------------------------------------------- metrics --

    def reset_stats(self):
        self.metrics.reset()
        # uids whose logits an injected "corrupt" fault poisoned (contained,
        # not detected — the chaos harness excludes them from bit-identity)
        self.poisoned_uids: set = set()

    @property
    def stats(self) -> dict:
        """Counters + derived scheduler metrics (computed on access from the
        engine's registry); occupancy is served images over offered batch
        slots. Key-compatible with the pre-registry dict plus quantiles."""
        m = self._m
        rounds = int(m["batch_rounds"].value)
        c = dict(batch_rounds=rounds, images_done=int(m["images_done"].value))
        c["occupancy"] = (c["images_done"] / (rounds * self.scfg.max_batch)
                          if rounds else 0.0)
        c["latency_avg_s"] = m["latency"].mean
        batch_time = m["batch_time"].value
        c["images_per_s"] = (c["images_done"] / batch_time
                             if batch_time > 0 else 0.0)
        c["latency_p50_s"] = m["latency"].percentile(50)
        c["latency_p95_s"] = m["latency"].percentile(95)
        c["latency_p99_s"] = m["latency"].percentile(99)
        c["queue_wait_avg_s"] = m["queue_wait"].mean
        c["queue_wait_p99_s"] = m["queue_wait"].percentile(99)
        c["timeouts"] = int(m["timeouts"].value)
        c["errors"] = int(m["errors"].value)
        c["shed"] = int(m["shed"].value)
        c["retries"] = int(m["retries"].value)
        c["degraded"] = 0               # key kept; the port never degrades
        return c

    def _observe_served(self, req: ImageRequest):
        self._m["latency"].observe(req.latency_s)
        self._m["queue_wait"].observe(req.queue_wait_s)
        tr = obs_trace.TRACER
        if tr.enabled:
            lane = obs_trace.next_lane()
            tr.begin("image_request", ts=req.submit_t, tid=lane, uid=req.uid,
                     round=req.batch_round, submit_wall_t=req.submit_wall_t)
            tr.complete("queue_wait", req.submit_t, req.admit_t, tid=lane)
            tr.complete("execute", req.admit_t, req.finish_t, tid=lane)
            tr.end("image_request", ts=req.finish_t, tid=lane)

    # ----------------------------------------------------------- frontend --

    def submit(self, req: ImageRequest):
        req.submit_t = time.perf_counter()
        req.submit_wall_t = time.time()
        # load shedding at the door (single-threaded, so qsize is exact)
        mq = self.scfg.max_queue
        if mq is not None and self.queue.qsize() >= mq:
            self._m["shed"].inc()
            if self.scfg.shed_policy == "reject":
                raise QueueFullError(
                    f"image request {req.uid}: queue holds max_queue={mq} "
                    f"requests (shed_policy='reject')")
            req.done = True             # "drop": terminal without enqueue
            req.status = "shed"
            req.finish_t = time.perf_counter()
            return
        self.queue.put(req)

    def _expired(self, req: ImageRequest, now: float) -> bool:
        d = (req.deadline_s if req.deadline_s is not None
             else self.scfg.deadline_s)
        return d is not None and (now - req.submit_t) > d

    def _take_round(self) -> List[ImageRequest]:
        # get_nowait, not .empty(): .empty() is only a racy hint once a
        # producer thread feeds the queue (same contract as the LM engine)
        out: List[ImageRequest] = []
        while len(out) < self.scfg.max_batch:
            try:
                out.append(self.queue.get_nowait())
            except queue.Empty:
                break
        return out

    def run_until_drained(self) -> List[ImageRequest]:
        """Admit queued requests into batch rounds until the queue is empty;
        returns the finished requests in completion order (every one with a
        terminal status — a failed round retires its batch, it never kills
        the drain)."""
        finished: List[ImageRequest] = []
        while True:
            batch = self._take_round()
            if not batch:
                break
            # deadline check at round admission: an expired request never
            # gets a forward spent on it
            now = time.perf_counter()
            live: List[ImageRequest] = []
            for r in batch:
                if self._expired(r, now):
                    r.done = True
                    r.status = "timeout"
                    if r.admit_t == 0.0:
                        r.admit_t = now
                    r.finish_t = now
                    self._m["timeouts"].inc()
                    finished.append(r)
                else:
                    live.append(r)
            if not live:
                continue
            batch = live
            x = np.stack([r.image for r in batch])
            rnd = int(self._m["batch_rounds"].value)
            t0 = time.perf_counter()
            for r in batch:
                r.admit_t = t0

            def attempt_round():
                fired = faults.check("cnn.batch_round")
                with obs_trace.span("cnn.batch_round", round=rnd,
                                    batch=len(batch)):
                    logits = self.plan.forward_batch(x)
                    # sync before stopping the timer: images_per_s must
                    # measure device time, not async-launch enqueue time
                    if logits.device.type == "cuda":
                        torch.cuda.synchronize(logits.device)
                return logits.cpu().numpy(), fired

            got = None
            last_err: Optional[BaseException] = None
            for att in range(self.scfg.max_retries + 1):
                if att:
                    self._m["retries"].inc()
                    if self.scfg.retry_backoff_s > 0:
                        time.sleep(self.scfg.retry_backoff_s
                                   * (2 ** (att - 1)))
                try:
                    got = attempt_round()
                    break
                except faults.InjectedFault as e:
                    # the round seam, or a kernels.dispatch fault inside
                    # the forward (a failed capture caches no graph): the
                    # round's inputs are untouched, so retry is safe
                    last_err = e
                except Exception as e:
                    last_err = e        # real plan failure: no retry, the
                    break               # round retires with "error"
            if got is None:
                for r in batch:         # one shared forward — the whole
                    r.done = True       # round retires together
                    r.status = "error"
                    r.error = repr(last_err)
                    r.finish_t = time.perf_counter()
                    self._m["errors"].inc()
                finished.extend(batch)
                continue
            self._m["batch_time"].inc(time.perf_counter() - t0)
            logits, fired = got
            if fired is not None:       # corrupt directive: poison the
                logits = fired.apply(logits)   # round's host logits
                self.poisoned_uids.update(r.uid for r in batch)
            now = time.perf_counter()
            for i, r in enumerate(batch):
                r.logits = logits[i]
                r.done = True
                r.status = "ok"
                r.finish_t = now
                r.batch_round = rnd
                self._observe_served(r)
            self._m["batch_rounds"].inc()
            self._m["images_done"].inc(len(batch))
            finished.extend(batch)
        return finished
