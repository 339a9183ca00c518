"""Continuous-batching LM serve engine over a fixed (max_batch, max_len)
budget.

Port of the continuous scheduler of ``repro/serve/engine.py`` with the
contiguous KV layout, for the dense and ssm families. Each admitted
request is prefilled on its own, right-padded to a power-of-two length
bucket (``prefill_bucket`` is the floor; an ssm model's recurrence is
position-exact, so its prompts are prefilled at their exact length), and
its K/V (or conv and ssm state) and length are written into a free slot of
the ONE live batched cache (``models/api.cache_write_slot``). Decode then
advances every occupied slot one token per round with per-slot lengths. A
sequence retires the round it finishes — per-request EOS, per-request
``max_new_tokens``, or the ``max_len`` KV cap — and its freed slot is
refilled from the queue between decode rounds.

Sampling is greedy argmax by default; a positive temperature (per
``ServeConfig`` with ``greedy=False``, or per-``Request`` override) switches
that request to softmax sampling with the engine's seeded host rng.

``ServeConfig.precision`` picks the FFN arithmetic: ``"float"``, or the
paper's integer FFN (Eq. 4 / Algorithm 1) with weights PTQ'd once at init —
``"int8"`` and ``"w4a8"`` (nibble-packed weights) through the ``matmul_q8``
and ``matmul_w4`` CUDA kernels, ``"int8-torch"`` and ``"w4a8-torch"``
through their plain PyTorch versions (the JAX package's ``"int8-xla"``);
a kernel and its plain version give the same token streams. An ssm model
serves in ``"float"`` only, as in the JAX package. ``ServeConfig.kv_cache``
picks the resident cache: ``"float"`` (the compute dtype) or ``"int8"``
(int8 codes with per-(position, head) float32 scales; a prefilled row is
quantized as it is written into its slot, and each decode step quantizes
its new K/V at the slot's own position), dense models only. At init the
engine also
casts the float32 attention (and, for ``"float"``, FFN) weights, or an ssm
model's Mamba weights but ``A_log``, to the compute dtype once — the values
JAX's per-use casts give.

``Engine.stats`` has the JAX engine's keys: prefill/decode-round/token
counters, slot occupancy, TTFT/TPOT/queue-wait quantiles, decode
throughput, and the block-pool gauges, which are registered and always 0
under the contiguous layout. A decode round's timer stops after
``torch.cuda.synchronize``, so ``decode_tok_s`` measures device time, not
the enqueue. With ``REPRO_TRACE=1`` each admission prefill and each decode
round is an ``engine.prefill`` / ``engine.decode_round`` span on the
process tracer (the JAX engine's per-request trace lanes are not ported).

Failure model: every request reaches exactly one terminal ``status`` —
``ok``, ``timeout`` (its ``deadline_s`` elapsed; cancelled at a round
boundary with partial ``out_tokens``), ``error`` (a prefill or decode
failure outlived ``max_retries``; an unrecoverable decode round retires the
whole active set and rebuilds the KV arena), or ``shed`` (the queue held
``max_queue`` requests at ``submit``; ``shed_policy="reject"`` raises
:class:`QueueFullError` instead). The ``engine.prefill`` and
``engine.decode_round`` fault seams (``repro_torch.faults``) fire once per
attempt, before any device work; an injected raise is retried, a real
exception (a kernel that fails to build or launch) is not. A ``corrupt``
fault poisons the sampled host logits; the affected uids are recorded in
``Engine.poisoned_uids``.

``Engine(..., jit=True)`` (the default) is the counterpart of the JAX
engine's ``jax.jit`` of prefill and decode: on a card the decode step is
captured once per engine as a CUDA graph (``graph/capture.py``; the decode
batch is always ``max_batch``) at the first decode round, after one eager
pass, which is that round's result, and every later round replays it. Its
static input is a (max_batch, 1) token tensor, which each round fills
from a pinned host buffer; its static output the (max_batch, 1, V) float32
logits; its cache is the live arena's own tensors (K/V, or conv and ssm
state, the int8 scales and ``"len"``), which the engine therefore only
ever updates in place: slot writes and frees, the per-slot lengths
rewritten after every round from a pinned host mirror, and the arena
zeroed in place at each drain and after an unrecoverable round. A dense
model's prefill is captured once per power-of-two bucket at batch 1
(static tokens and prompt length; static logits and fresh cache, copied
into the arena by the eager ``cache_write_slot``), in one memory pool with
the decode graph. An ssm model's prefill stays eager: its prompts run at
their exact length, so capture would take one graph per length, and the
prefill is device-bound anyway. ``traces`` counts captures (also in the
process counter ``graph.compiles``). A capture or replay that fails
raises, and the round fails by the failure model below; nothing falls
back to the eager path. On the host ``jit`` has no effect;
``jit=False`` runs every op from Python.

Not ported yet, and raising ``NotImplementedError`` (ROADMAP.md, queue A):
``scheduler="static"``, ``kv_layout="paged"`` with its block pool and
prefix cache, ``attn_impl="flash_tri"``, and the moe, hybrid and encdec
families. An ssm model with a non-float precision, ``kv_cache="int8"`` or
``kv_layout="paged"`` raises the JAX engine's ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import queue
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.check.config import PRECISIONS
from repro_torch.configs.base import ModelConfig
from repro_torch.faults import inject as faults
from repro_torch.graph.capture import CapturedFn, capture
from repro_torch.models import api
from repro_torch.models import transformer as T
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


class QueueFullError(RuntimeError):
    """Raised by ``submit`` under ``shed_policy="reject"`` when the queue
    already holds ``max_queue`` requests."""


@dataclasses.dataclass
class Request:
    """One generation request plus the engine-filled result/metric fields."""
    uid: int
    prompt: np.ndarray              # (S,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None    # overrides ServeConfig.eos_id when set
    temperature: Optional[float] = None  # overrides the engine default
    deadline_s: Optional[float] = None   # overrides ServeConfig.deadline_s
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    status: str = "pending"         # terminal: ok | timeout | error | shed
    error: Optional[str] = None     # the absorbed exception, status="error"
    # monotonic perf_counter stamps (intervals never go negative);
    # submit_wall_t is the one wall-clock field
    submit_t: float = 0.0
    submit_wall_t: float = 0.0
    admit_t: float = 0.0
    first_token_t: float = 0.0
    finish_t: float = 0.0
    admit_round: int = -1           # global decode-round counter at admission
    finish_round: int = -1          # round the request retired on

    @property
    def ttft_s(self) -> float:
        return max(self.first_token_t - self.submit_t, 0.0)

    @property
    def queue_wait_s(self) -> float:
        return max(self.admit_t - self.submit_t, 0.0)


@dataclasses.dataclass
class ServeConfig:
    """Engine knobs, with the JAX package's fields and defaults (see
    ``repro/serve/engine.py`` for each). The port serves
    ``scheduler="continuous"`` and ``kv_layout="contiguous"``, with
    ``kv_cache`` ``"float"`` or ``"int8"``; ``precision`` is one of
    ``"float"``, ``"int8"``, ``"int8-torch"``, ``"w4a8"`` and
    ``"w4a8-torch"``. The paged-layout
    knobs (``kv_block_size``, ``kv_num_blocks``, ``prefix_cache``) are kept
    for a config's round trip and unused."""
    max_batch: int = 4
    max_len: int = 256
    eos_id: int = -1                # -1: never
    greedy: bool = True
    temperature: float = 0.0
    scheduler: str = "continuous"
    prefill_bucket: int = 16
    attn_impl: str = "flash"
    seed: int = 0
    precision: str = "float"
    kv_cache: str = "float"
    kv_layout: str = "contiguous"
    kv_block_size: int = 16
    kv_num_blocks: Optional[int] = None
    prefix_cache: bool = True
    deadline_s: Optional[float] = None
    max_queue: Optional[int] = None
    shed_policy: str = "reject"
    max_retries: int = 2
    retry_backoff_s: float = 0.0


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md, "
                              "queue A); the port serves the continuous "
                              "scheduler over a contiguous KV cache")


def _check_family_gates(cfg: ModelConfig, scfg: ServeConfig):
    """The JAX engine's gates for the ssm family, with its messages: no
    int8 KV cache, no paged layout, no integer FFN."""
    if cfg.family != "ssm":
        return
    if scfg.kv_cache == "int8":
        raise NotImplementedError(
            "kv_cache='int8' covers attention-family dense KV caches "
            "only (no ssm / hybrid / encdec)")
    if scfg.kv_layout == "paged":
        raise NotImplementedError(
            "kv_layout='paged' covers attention-family dense KV "
            "caches only (no ssm / hybrid / encdec)")
    if scfg.precision in PRECISIONS and scfg.precision != "float":
        raise NotImplementedError(
            "ServeConfig.precision='int8' quantizes dense FFN "
            "matmuls; moe/ssm/hybrid/encdec configs are unsupported")


class Engine:
    """The continuous-batching LM engine (module docstring); ``jit``
    captures its decode step and dense prefill buckets on a card."""

    def __init__(self, cfg: ModelConfig, params, scfg: ServeConfig, *,
                 jit: bool = True):
        from repro_torch.check.config import check_serve_config
        T.check_family(cfg, "Engine")
        _check_family_gates(cfg, scfg)
        bad = check_serve_config(scfg, cfg, strict=False)
        if bad:
            raise ValueError("invalid ServeConfig:\n"
                             + "\n".join(f"  - {m}" for m in bad))
        if scfg.scheduler == "static":
            _not_ported("scheduler='static'")
        if scfg.kv_layout == "paged":
            _not_ported("kv_layout='paged'")
        if scfg.attn_impl == "flash_tri":
            _not_ported("attn_impl='flash_tri'")
        if scfg.precision != "float":
            # PTQ the FFN stack once; the quantized tree rides along in
            # params["layers"]; the caller's tree is not touched
            from repro_torch.models.blocks import quantize_mlp_params
            layers = dict(params["layers"])
            layers["qmlp"] = quantize_mlp_params(
                layers["mlp"],
                bits=4 if scfg.precision.startswith("w4a8") else 8)
            params = dict(params, layers=layers)
        self.cfg = cfg
        self.scfg = scfg
        self.device = params["embed"].device
        self.params = T.cast_params(params, cfg,
                                    mlp_too=scfg.precision == "float")
        self.prefill = api.prefill_fn(cfg, scfg.max_len,
                                      attn_impl=scfg.attn_impl,
                                      precision=scfg.precision)
        self.decode = api.decode_fn(cfg, precision=scfg.precision)
        self.jit = jit
        #: CUDA graph captures made (the decode step, each prefill bucket)
        self.traces = 0
        self._graphs: Dict[tuple, CapturedFn] = {}
        self._pool = None
        # the live cache, made at the first drain, and the host buffers
        # the decode step's tokens and the per-slot lengths come from
        self._arena: Optional[dict] = None
        pinned = self.device.type == "cuda"
        self._host_tok = torch.zeros((scfg.max_batch, 1), dtype=torch.int64,
                                     pin_memory=pinned)
        self._host_len = torch.zeros((scfg.max_batch,), dtype=torch.int32,
                                     pin_memory=pinned)
        self.queue: "queue.Queue[Request]" = queue.Queue()
        self._rng = np.random.default_rng(scfg.seed)
        # private registry: per-engine stats isolation; handles stay valid
        # across reset_stats (Registry.reset zeroes in place)
        self.metrics = obs_metrics.Registry()
        self._m = {
            "prefills": self.metrics.counter("serve.prefills"),
            "decode_steps": self.metrics.counter("serve.decode_steps"),
            "tokens_out": self.metrics.counter("serve.tokens_out"),
            "requests_done": self.metrics.counter("serve.requests_done"),
            "occupied": self.metrics.counter("serve.occupied_slot_rounds"),
            "decode_time": self.metrics.counter("serve.decode_time_s"),
            "ttft": self.metrics.histogram("serve.ttft_s"),
            "tpot": self.metrics.histogram("serve.tpot_s"),
            "queue_wait": self.metrics.histogram("serve.queue_wait_s"),
            # block-pool gauges: registered for key parity with the JAX
            # engine, always 0 under the contiguous layout
            "blocks_in_use": self.metrics.gauge("serve.blocks_in_use"),
            "blocks_free": self.metrics.gauge("serve.blocks_free"),
            "prefix_hit_rate": self.metrics.gauge("serve.prefix_hit_rate"),
            "timeouts": self.metrics.counter("serve.timeouts"),
            "errors": self.metrics.counter("serve.errors"),
            "shed": self.metrics.counter("serve.shed"),
            "retries": self.metrics.counter("serve.retries"),
            "arena_rebuilds": self.metrics.counter("serve.arena_rebuilds"),
        }
        self.reset_stats()

    # ------------------------------------------------------------- metrics --

    def reset_stats(self):
        """Zero the counters (e.g. after a warm-up drain)."""
        self.metrics.reset()
        self._round = 0
        # uids whose logits an injected "corrupt" fault poisoned
        self.poisoned_uids: set = set()

    @property
    def stats(self) -> dict:
        """Counters and derived scheduler metrics, the JAX engine's keys."""
        m = self._m
        rounds = int(m["decode_steps"].value)
        c = dict(prefills=int(m["prefills"].value),
                 decode_steps=rounds,
                 tokens_out=int(m["tokens_out"].value),
                 requests_done=int(m["requests_done"].value))
        c["occupancy"] = (m["occupied"].value
                          / (rounds * self.scfg.max_batch)) if rounds else 0.0
        c["ttft_avg_s"] = m["ttft"].mean
        decode_time = m["decode_time"].value
        c["decode_tok_s"] = (c["tokens_out"] / decode_time
                             if decode_time > 0 else 0.0)
        c["ttft_p50_s"] = m["ttft"].percentile(50)
        c["ttft_p95_s"] = m["ttft"].percentile(95)
        c["ttft_p99_s"] = m["ttft"].percentile(99)
        c["tpot_avg_s"] = m["tpot"].mean
        c["queue_wait_avg_s"] = m["queue_wait"].mean
        c["queue_wait_p99_s"] = m["queue_wait"].percentile(99)
        c["blocks_in_use"] = int(m["blocks_in_use"].value)
        c["blocks_free"] = int(m["blocks_free"].value)
        c["prefix_hit_rate"] = float(m["prefix_hit_rate"].value)
        c["timeouts"] = int(m["timeouts"].value)
        c["errors"] = int(m["errors"].value)
        c["shed"] = int(m["shed"].value)
        c["retries"] = int(m["retries"].value)
        c["arena_rebuilds"] = int(m["arena_rebuilds"].value)
        return c

    def _observe_retired(self, req: Request):
        self._m["queue_wait"].observe(req.queue_wait_s)
        n_out = len(req.out_tokens)
        if n_out > 1 and req.finish_t > req.first_token_t:
            self._m["tpot"].observe(
                (req.finish_t - req.first_token_t) / (n_out - 1))

    # ----------------------------------------------------------- frontend --

    def _validate_prompt_len(self, req: Request):
        if len(req.prompt) > self.scfg.max_len:
            raise ValueError(
                f"request {req.uid}: prompt length {len(req.prompt)} exceeds "
                f"max_len={self.scfg.max_len}")

    def submit(self, req: Request):
        self._validate_prompt_len(req)
        req.submit_t = time.perf_counter()
        req.submit_wall_t = time.time()
        # load shedding at the door (single-threaded, so qsize is exact)
        mq = self.scfg.max_queue
        if mq is not None and self.queue.qsize() >= mq:
            self._m["shed"].inc()
            if self.scfg.shed_policy == "reject":
                raise QueueFullError(
                    f"request {req.uid}: queue holds max_queue={mq} "
                    f"requests (shed_policy='reject')")
            req.done = True             # "drop": terminal without enqueue
            req.status = "shed"
            req.finish_t = time.perf_counter()
            return
        self.queue.put(req)

    def _expired(self, req: Request, now: Optional[float] = None) -> bool:
        d = (req.deadline_s if req.deadline_s is not None
             else self.scfg.deadline_s)
        if d is None:
            return False
        if now is None:
            now = time.perf_counter()
        return (now - req.submit_t) > d

    def _next_request(self) -> Optional[Request]:
        try:
            return self.queue.get_nowait()
        except queue.Empty:
            return None

    def run_until_drained(self) -> List[Request]:
        with obs_trace.span("engine.drain", scheduler=self.scfg.scheduler):
            return self._run_continuous()

    # ----------------------------------------------------------- sampling --

    def _pick(self, logits_row: np.ndarray, req: Request) -> int:
        temp = req.temperature
        if temp is None:
            temp = 0.0 if self.scfg.greedy else self.scfg.temperature
        if temp <= 0.0:
            return int(np.argmax(logits_row))
        z = np.asarray(logits_row, np.float64) / temp
        z -= z.max()
        p = np.exp(z)
        return int(self._rng.choice(p.size, p=p / p.sum()))

    def _effective_eos(self, req: Request) -> int:
        return self.scfg.eos_id if req.eos_id is None else req.eos_id

    def _bucket_len(self, plen: int) -> int:
        # oversized prompts were already rejected by _validate_prompt_len
        if self.cfg.family in ("ssm", "hybrid"):
            return plen                 # recurrent state is position-exact
        b = max(self.scfg.prefill_bucket, 1)
        while b < plen:
            b *= 2
        return min(b, self.scfg.max_len)

    # ------------------------------------------------------------ capture --

    def _captures(self) -> bool:
        return self.jit and self.device.type == "cuda"

    def _capture(self, key: tuple, fn, inputs: tuple):
        """Capture ``fn`` over ``inputs`` as the graph ``key`` (in the
        engine's one memory pool); returns the eager pass's outputs."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        name = ".".join(map(str, key))
        with obs_trace.span("engine.trace", graph=name):
            cap, out = capture(fn, inputs, key=f"lm.{name}", pool=self._pool)
        self._graphs[key] = cap
        self.traces += 1
        return out

    def _prefill_slot(self, toks: np.ndarray, plen: int):
        """(logits, fresh cache) of one right-padded prompt, (1, bucket):
        a replay of the bucket's graph under capture (a dense model), else
        the eager prefill."""
        dev = self.device
        if not (self._captures() and self.cfg.family == "dense"):
            return self.prefill(self.params, {
                "tokens": torch.from_numpy(toks).to(dev),
                "prompt_lens": torch.tensor([plen], dtype=torch.int32,
                                            device=dev)})
        key = ("prefill", toks.shape[1])
        cap = self._graphs.get(key)
        if cap is None:
            return self._capture(
                key, lambda t, n: self.prefill(
                    self.params, {"tokens": t, "prompt_lens": n}),
                (torch.from_numpy(toks).to(dev),
                 torch.tensor([plen], dtype=torch.int32, device=dev)))
        cap.inputs[0].copy_(torch.from_numpy(toks))
        cap.inputs[1].fill_(plen)
        return cap.replay()

    def _decode_logits(self, cache: dict, tok: torch.Tensor):
        """The (B, 1, V) logits of one decode round over the live cache
        ``cache`` (written in place) for the host tokens ``tok``: a replay
        of the engine's decode graph under capture, else the eager step.
        The step's returned ``"len"`` is dropped: the engine rewrites the
        arena's lengths itself."""
        dev = self.device
        if not self._captures():
            return self.decode(self.params, tok.to(dev), cache)[0]
        key = ("decode", self.scfg.max_batch)
        cap = self._graphs.get(key)
        if cap is None:
            return self._capture(
                key, lambda t: self.decode(self.params, t, cache)[0],
                (tok.to(dev),))
        cap.inputs[0].copy_(tok)
        return cap.replay()

    # --------------------------------------------------------- continuous --

    def _run_continuous(self) -> List[Request]:
        B = self.scfg.max_batch
        dev = self.device
        if self._arena is None:
            self._arena = api.init_slot_cache(self.cfg, B, self.scfg.max_len,
                                              kv=self.scfg.kv_cache,
                                              device=dev)
        # the arena's tensors persist (a captured step reads them by
        # address); each drain starts from a cleared arena
        cache = api.cache_clear(self._arena)
        slots: List[Optional[Request]] = [None] * B
        lens = self._host_len.numpy()   # host mirror of cache["len"]
        lens[:] = 0
        cur = self._host_tok.numpy()    # the next round's tokens
        cur[:] = 0
        finished: List[Request] = []

        def try_admit(i: int, req: Request) -> bool:
            """Admit ``req`` into free slot ``i``; False when the admission
            outlived max_retries and the request retired as "error". The
            ``engine.prefill`` seam fires once per attempt, before any
            device call."""
            nonlocal cache
            self._validate_prompt_len(req)   # directly enqueued requests
            plen = len(req.prompt)
            last_err: Optional[BaseException] = None
            for attempt in range(self.scfg.max_retries + 1):
                if attempt:
                    self._m["retries"].inc()
                    if self.scfg.retry_backoff_s > 0:
                        time.sleep(self.scfg.retry_backoff_s
                                   * (2 ** (attempt - 1)))
                try:
                    fired = faults.check("engine.prefill")
                    bucket = self._bucket_len(plen)
                    req.admit_t = time.perf_counter()
                    toks = np.zeros((1, bucket), np.int64)
                    toks[0, :plen] = req.prompt    # right-pad: 0..plen-1
                    with obs_trace.span("engine.prefill", uid=req.uid,
                                        slot=i, plen=plen, bucket=bucket):
                        logits, fresh = self._prefill_slot(toks, plen)
                        self._m["prefills"].inc()
                        cache = api.cache_write_slot(self.cfg, cache, fresh,
                                                     i)
                        logits = logits.cpu().numpy()
                except faults.InjectedFault as e:
                    last_err = e        # fired pre-dispatch: retry is safe
                    continue
                except Exception as e:
                    last_err = e        # a real failure: do not retry
                    break
                if fired is not None:   # corrupt directive: poison the
                    logits = fired.apply(logits)   # sampled logits only
                    self.poisoned_uids.add(req.uid)
                t = self._pick(logits[0, -1], req)
                req.first_token_t = time.perf_counter()
                req.admit_round = self._round
                req.out_tokens.append(t)
                self._m["tokens_out"].inc()
                self._m["ttft"].observe(req.ttft_s)
                cur[i, 0] = t
                slots[i] = req
                lens[i] = plen
                return True
            retire_unadmitted(req, "error", repr(last_err))
            return False

        def retire_unadmitted(req: Request, status: str,
                              err: Optional[str] = None):
            """Terminal bookkeeping for a request that never held a slot."""
            now = time.perf_counter()
            req.done = True
            req.status = status
            req.error = err
            if req.admit_t == 0.0:
                req.admit_t = now
            if req.first_token_t == 0.0:
                req.first_token_t = now
            req.finish_t = now
            req.finish_round = self._round
            finished.append(req)
            self._m["requests_done"].inc()
            self._m["timeouts" if status == "timeout" else "errors"].inc()
            self._observe_retired(req)

        def retire_slot(i: int, status: str = "ok",
                        err: Optional[str] = None):
            """Retire slot ``i``'s request and free its KV slot."""
            nonlocal cache
            req = slots[i]
            req.done = True
            req.status = status
            if err is not None:
                req.error = err
            req.finish_t = time.perf_counter()
            req.finish_round = self._round
            finished.append(req)
            self._m["requests_done"].inc()
            if status == "timeout":
                self._m["timeouts"].inc()
            elif status == "error":
                self._m["errors"].inc()
            self._observe_retired(req)
            slots[i] = None
            lens[i] = 0
            cache = api.cache_free_slot(cache, i)

        def maybe_retire(i: int):
            req = slots[i]
            if (req.out_tokens[-1] == self._effective_eos(req)
                    or len(req.out_tokens) >= req.max_new_tokens
                    or lens[i] >= self.scfg.max_len):
                retire_slot(i, "ok")

        decode_failures = 0             # consecutive failed round attempts
        while True:
            # refill free slots between decode rounds; the inner loop
            # re-admits into a slot whose request retired at admission
            for i in range(B):
                while slots[i] is None:
                    req = self._next_request()
                    if req is None:
                        break
                    if self._expired(req):
                        retire_unadmitted(req, "timeout")
                        continue
                    if try_admit(i, req):
                        maybe_retire(i)
            active = [i for i in range(B) if slots[i] is not None]
            if not active:
                break                   # the admit loop drained the queue
            try:
                round_fired = faults.check("engine.decode_round")
                t0 = time.perf_counter()
                with obs_trace.span("engine.decode_round",
                                    round=self._round, active=len(active)):
                    logits = self._decode_logits(cache, self._host_tok)
                    if dev.type == "cuda":   # device time, not the enqueue
                        torch.cuda.synchronize(dev)
                self._m["decode_time"].inc(time.perf_counter() - t0)
            except Exception as e:
                retriable = isinstance(e, faults.InjectedFault)
                decode_failures += 1
                if retriable and decode_failures <= self.scfg.max_retries:
                    self._m["retries"].inc()
                    if self.scfg.retry_backoff_s > 0:
                        time.sleep(self.scfg.retry_backoff_s
                                   * (2 ** (decode_failures - 1)))
                    continue
                # unrecoverable round: the batch shares one cache, so retire
                # the whole active set and rebuild the arena (in place)
                for i in active:
                    retire_slot(i, "error", repr(e))
                self._m["arena_rebuilds"].inc()
                cache = api.cache_clear(cache)
                decode_failures = 0
                continue
            decode_failures = 0
            logits = logits.cpu().numpy()
            if round_fired is not None:
                logits = round_fired.apply(logits)
                for i in active:
                    self.poisoned_uids.add(slots[i].uid)
            self._round += 1
            self._m["decode_steps"].inc()
            self._m["occupied"].inc(len(active))
            now_r = time.perf_counter()
            for i in active:
                lens[i] += 1            # this round wrote K/V at lens[i]
                req = slots[i]
                t = self._pick(logits[i, -1], req)
                req.out_tokens.append(t)
                self._m["tokens_out"].inc()
                cur[i, 0] = t
                maybe_retire(i)
                if slots[i] is not None and self._expired(req, now_r):
                    retire_slot(i, "timeout")   # round-boundary cancel
            # the arena's lengths from the host mirror, in place: the step
            # wrote K/V at each live row's length, and retired and empty
            # rows stay at 0
            cache["len"].copy_(self._host_len)
        return finished
