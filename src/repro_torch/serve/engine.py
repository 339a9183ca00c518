"""LM serve engine over a fixed (max_batch, max_len) budget: continuous
batching over a contiguous or a paged KV cache, or static drain batches.

Port of ``repro/serve/engine.py`` for the dense, vlm, moe and ssm
families (a vlm model is served text-only, as the JAX engine serves it:
requests carry tokens, no patch embeddings). Two
schedulers share one ``Engine`` API; ``ServeConfig.scheduler`` picks:

* ``"continuous"`` (default) — each admitted request is prefilled on its
  own, right-padded to a power-of-two length bucket (``prefill_bucket`` is
  the floor; an ssm model's recurrence is position-exact, so its prompts
  are prefilled at their exact length), and its K/V (or conv and ssm
  state) and length are written into a free slot of the ONE live batched
  cache (``models/api.cache_write_slot``). Decode then advances every
  occupied slot one token per round with per-slot lengths. A sequence
  retires the round it finishes — per-request EOS, per-request
  ``max_new_tokens``, or the ``max_len`` KV cap — and its freed slot is
  refilled from the queue between decode rounds.
* ``"static"`` — the drain baseline: up to ``max_batch`` requests, prompts
  left-padded to the longest (unmasked, the JAX engine's approximation),
  one prefill at that exact length, then the whole batch decoded to
  completion before the next batch is taken.

KV backing (continuous scheduler, attention families) is picked by
``ServeConfig.kv_layout``: ``"contiguous"`` gives every slot a (max_len,)
row; ``"paged"`` keeps K/V in a :class:`BlockPool` of ``kv_block_size``
-position pages, each slot a block table that grows a page at a time.
Full prompt pages are content-addressed (a chained sha1 over the prompt's
blocks), so requests that share a prompt prefix share its refcounted
pages. A hit shares storage only: the whole prompt is recomputed (its
logits are the first token's) and the shared pages are not written
(JAX's float hit prefills only its suffix; ``models/api.prefill_suffix_fn``
is ported and bitwise on the host, but on a card a suffix's rows do not
get the bits the whole prompt's get, so no hit runs it). On a
card each digest is also salted with the prefill's bucket
(:func:`prefix_salt`): the bf16 GEMMs' row results there depend on the
row count, so a page is shared only with prompts whose own prefill would
write it bit for bit. On the host the digests are JAX's.
Pages of retired requests park in an LRU evictable set until a shortage
reclaims them. When the pool runs dry, new admissions wait in a FIFO
holdback, and a slot that must grow preempts the youngest slot, whose
request restarts from its prompt (greedy decode replays its stream).
Greedy streams equal the contiguous layout's: the pages gathered by a
table equal the contiguous cache below each row's length
(``kv_block_size`` divides ``max_len``), positions at the length and
past it get an exact-zero attention weight, and a shared page holds the
bits the hitting request's own prefill would write.

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
quantized as it is written into its slot or pages, and each decode step
quantizes its new K/V at the row's own position), attention-family models
and the continuous scheduler only. A moe model serves in ``"float"``
only, as in the JAX package. At init the engine also casts the float32
attention (and, for ``"float"``, FFN and expert) weights, or an ssm
model's Mamba weights but ``A_log``, to the compute dtype once — the
values JAX's per-use casts give.

``Engine.stats`` has the JAX engine's keys: prefill/decode-round/token
counters, slot occupancy, TTFT/TPOT/queue-wait quantiles, decode
throughput, and the block-pool gauges (``blocks_in_use``, ``blocks_free``,
``prefix_hit_rate``; live under the paged layout, 0 otherwise);
``Engine.pool`` is the last drain's :class:`BlockPool`. A decode round's
timer stops after ``torch.cuda.synchronize``, so ``decode_tok_s``
measures device time, not the enqueue. With ``REPRO_TRACE=1`` each
admission prefill and each decode round is an ``engine.prefill`` /
``engine.decode_round`` span on the process tracer, and the paged pool's
events ``engine.prefix_lookup``, ``engine.block_alloc`` and
``engine.block_free`` (``preempt=True`` for a preemption) are spans too
(the JAX engine's per-request trace lanes are not ported).

Failure model: every request reaches exactly one terminal ``status`` —
``ok``, ``timeout`` (its ``deadline_s`` elapsed; cancelled at a round
boundary with partial ``out_tokens``), ``error`` (a prefill or decode
failure outlived ``max_retries``; an unrecoverable decode round retires the
whole active set and rebuilds the KV arena and the page pool; a static
batch retires whole), or ``shed`` (the queue held ``max_queue`` requests
at ``submit``; ``shed_policy="reject"`` raises :class:`QueueFullError`
instead). The ``engine.prefill`` and ``engine.decode_round`` fault seams
(``repro_torch.faults``) fire once per attempt, before any device work; an
injected raise is retried, a real exception (a kernel that fails to build
or launch) is not. ``blockpool.alloc`` fires in :meth:`BlockPool.alloc`;
the engine takes it as a transient page shortage. A ``corrupt`` fault
poisons the sampled host logits; the affected uids are recorded in
``Engine.poisoned_uids``.

``Engine(..., jit=True)`` (the default) is the counterpart of the JAX
engine's ``jax.jit`` of prefill and decode: on a card the continuous
decode step is captured once per engine as a CUDA graph
(``graph/capture.py``; the decode batch is always ``max_batch``) at the
first decode round, after one eager pass, which is that round's result,
and every later round replays it. Its static input is a (max_batch, 1)
token tensor, which each round fills from a pinned host buffer; its
static output the (max_batch, 1, V) float32 logits; its cache is the live
arena's own tensors (K/V or their page pools, conv and ssm state, the int8
scales, ``"block_table"`` and ``"len"``), which the engine therefore only
ever updates in place: slot and page writes and frees, the per-slot
lengths and the block table copied in before every round from pinned host
mirrors, and the arena cleared in place at each drain and after an
unrecoverable round. An attention model's prefill is captured once per
power-of-two bucket at batch 1 (static tokens and prompt length; static
logits and fresh cache, copied into the arena's slot or pages by an eager
write), all in one memory pool with the decode graph. The static
scheduler's decode is one graph per batch size over a static cache of
that size, into which each batch's prefill cache is copied; its prefill,
at the batch's exact length, stays eager, and so does an ssm model's
(its prompts run at their exact length, so capture would take one graph
per length, and the prefill is device-bound anyway). ``traces`` counts
captures (also in the process counter ``graph.compiles``). A capture or replay that fails raises, and
the round fails by the failure model above; nothing falls back to the
eager path. On the host ``jit`` has no effect; ``jit=False`` runs every
op from Python.

Not ported yet, and raising ``NotImplementedError`` (ROADMAP.md, queue A):
the hybrid and encdec families. The JAX engine's own gates keep its
messages: ``kv_cache="int8"`` and ``kv_layout="paged"`` need the continuous
scheduler and an attention-family model, and an ssm or moe model serves in
``"float"`` only.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import queue
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.check.config import PRECISIONS, paged_num_blocks
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


class BlockPool:
    """Host-side page allocator and hash-based prefix cache of the paged KV
    layout (``ServeConfig.kv_layout="paged"``); the port's copy of the JAX
    engine's.

    Page 0 is RESERVED as the garbage page: never allocated, so a retired
    slot's zeroed block-table row scatters its masked (never-read) decode
    writes there without touching a live page.

    Prompt pages are content-addressed: ``prefix_keys`` chains a sha1 over
    each FULL prompt block (every digest covers all tokens up to and
    including its block, so equal digest == equal token prefix), and
    ``publish`` registers digest -> page after the page's K/V are written.
    A page whose live refcount drops to zero is not freed: it parks in an
    LRU *evictable* set with its digest mapping intact, so a later request
    with the same prefix still hits; ``alloc`` reclaims evictable pages
    oldest-first only once the free list runs dry. Retention is safe
    because published pages are never written again (decode writes land
    strictly past the last full prompt block).

    Single-threaded: the engine drives it between device calls.

    Integrity: ``free`` / ``release`` raise ``ValueError`` on a
    double-free, an unknown page id, a page with live references, or a
    parked (evictable) page; ``acquire`` revalidates that a refcount-0 page
    it un-parks was not evicted in the meantime. :meth:`audit` returns
    every violated structural invariant (conservation ``free + allocated ==
    usable``, positive refcounts, digest bijection) as a list.
    """

    def __init__(self, num_blocks: int, block_size: int,
                 prefix_cache: bool = True):
        if num_blocks < 2:
            raise ValueError("BlockPool needs >= 2 pages (page 0 is the "
                             "reserved garbage page)")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.prefix_cache = prefix_cache
        # pop() -> lowest id first; freed pages return LIFO (deterministic)
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._allocated: set = set()          # handed out, not yet freed
        self._ref: Dict[int, int] = {}        # page id -> live refcount
        self._digest: Dict[str, int] = {}     # digest -> page id
        self._page_digest: Dict[int, str] = {}
        self._evictable: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()         # refcount-0 hashed pages, LRU
        self.lookups = 0                      # block-granular hit telemetry
        self.hits = 0

    # ------------------------------------------------------------ capacity --

    @property
    def usable(self) -> int:
        return self.num_blocks - 1

    @property
    def free_pages(self) -> int:
        """Allocatable pages: truly free plus evictable-on-demand."""
        return len(self._free) + len(self._evictable)

    @property
    def in_use(self) -> int:
        return self.usable - self.free_pages

    # -------------------------------------------------------- prefix cache --

    def prefix_keys(self, prompt: np.ndarray, salt: bytes = b"") -> List[str]:
        """Chained sha1 digest per full prompt block, excluding the block
        holding the last prompt token — at least one position is always
        recomputed so admission has last-token logits to sample from. The
        chain starts from ``salt`` (empty: JAX's digests)."""
        if not self.prefix_cache:
            return []
        bs = self.block_size
        toks = np.ascontiguousarray(np.asarray(prompt, np.int32))
        h = hashlib.sha1(salt)
        keys = []
        for j in range((len(toks) - 1) // bs):
            h.update(toks[j * bs:(j + 1) * bs].tobytes())
            keys.append(h.hexdigest())
        return keys

    def lookup(self, keys: List[str]) -> List[int]:
        """Page ids for the longest registered leading run of ``keys``.
        Read-only: ``acquire`` the result before any ``alloc`` so eviction
        cannot reclaim a page the caller is about to reference."""
        ids = []
        for k in keys:
            bid = self._digest.get(k)
            if bid is None:
                break
            ids.append(bid)
        self.lookups += len(keys)
        self.hits += len(ids)
        return ids

    def acquire(self, ids: List[int]) -> None:
        """Take a live reference on hashed pages (un-parks evictable ones);
        a refcount-0 page that is no longer parked with its digest (evicted
        since the lookup) is a ``ValueError``."""
        for bid in ids:
            if bid in self._ref:
                self._ref[bid] += 1
                continue
            if bid not in self._evictable or bid not in self._page_digest:
                raise ValueError(
                    f"acquire: page {bid} has no live references and is not "
                    f"parked evictable — it was evicted (or never published); "
                    f"re-run lookup before acquiring")
            self._evictable.pop(bid)
            self._ref[bid] = 1

    def release(self, ids: List[int]) -> None:
        """Drop a live reference; pages reaching zero park as evictable.
        Releasing a page with no live reference is a ``ValueError``."""
        for bid in ids:
            if self._ref.get(bid, 0) < 1:
                raise ValueError(
                    f"release: page {bid} has no live reference "
                    f"(double-release or unknown page id)")
            self._ref[bid] -= 1
            if self._ref[bid] == 0:
                del self._ref[bid]
                self._evictable[bid] = None

    def publish(self, keys: List[str], ids: List[int]) -> None:
        """Register freshly written full prompt blocks (digest -> page) and
        take the writing request's live reference.

        A digest can still name a parked page when an older block of its
        chain was evicted first (the lookup's leading run stops there, so
        the admission recomputed and rewrote the block). That page has no
        live reference (a holder of it would hold the older block too), so
        it is unpublished and returned to the free list, and the digest
        names the fresh page: the JAX pool re-points the digest and leaves
        the old page's mapping behind, which breaks the bijection and
        fails a later eviction."""
        for k, bid in zip(keys, ids):
            old = self._digest.get(k)
            if old is not None and old != bid:
                self._evictable.pop(old)
                del self._page_digest[old]
                self._allocated.discard(old)
                self._free.append(old)
            self._digest[k] = bid
            self._page_digest[bid] = k
            self._ref[bid] = self._ref.get(bid, 0) + 1

    # --------------------------------------------------------- allocation --

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` pages, or None when the pool cannot supply them (the
        engine then applies admission backpressure / preemption). Evicts
        LRU refcount-0 hashed pages only when the free list runs dry.
        Fault seam ``blockpool.alloc`` fires before any state changes, so
        an injected raise never half-allocates."""
        faults.check("blockpool.alloc")
        if n > self.free_pages:
            return None
        out = []
        for _ in range(n):
            if self._free:
                out.append(self._free.pop())
            else:
                bid, _ = self._evictable.popitem(last=False)
                del self._digest[self._page_digest.pop(bid)]
                out.append(bid)
        self._allocated.update(out)
        return out

    def free(self, ids: List[int], hashed: int = 0) -> None:
        """Return a retired request's pages: the leading ``hashed`` ids
        (published or hit prompt pages) drop a reference and park when it
        reaches zero; the rest go straight back to the free list, each
        validated first (allocated, unreferenced, not published)."""
        tail = ids[hashed:]
        for bid in tail:
            if bid not in self._allocated:
                raise ValueError(
                    f"free: page {bid} is not allocated "
                    f"(double-free or unknown page id)")
            if self._ref.get(bid, 0) > 0:
                raise ValueError(
                    f"free: page {bid} has {self._ref[bid]} live "
                    f"reference(s) — release them (hashed=) instead")
            if bid in self._evictable or bid in self._page_digest:
                raise ValueError(
                    f"free: page {bid} is published/parked — published "
                    f"prompt pages retire via the hashed= prefix")
        self.release(ids[:hashed])
        self._allocated.difference_update(tail)
        self._free.extend(tail)

    # ------------------------------------------------------------ auditing --

    def audit(self, expect_drained: bool = False) -> List[str]:
        """Every violated structural invariant, as human-readable strings
        (empty == healthy). With ``expect_drained=True`` additionally
        requires quiescence: no live references and no allocated page
        outside the evictable set (nothing leaked after a drain)."""
        bad: List[str] = []
        free_set = set(self._free)
        if len(free_set) != len(self._free):
            bad.append("duplicate ids on the free list")
        if 0 in free_set or 0 in self._allocated:
            bad.append("reserved garbage page 0 entered circulation")
        both = free_set & self._allocated
        if both:
            bad.append(f"pages simultaneously free and allocated: "
                       f"{sorted(both)}")
        if len(self._free) + len(self._allocated) != self.usable:
            bad.append(
                f"conservation broken: free({len(self._free)}) + "
                f"allocated({len(self._allocated)}) != usable({self.usable})")
        for bid, r in self._ref.items():
            if r < 1:
                bad.append(f"page {bid} has non-positive refcount {r}")
            if bid not in self._allocated:
                bad.append(f"referenced page {bid} is not allocated")
            if bid in self._evictable:
                bad.append(f"page {bid} parked evictable with live refs")
        for bid in self._evictable:
            if bid not in self._allocated:
                bad.append(f"evictable page {bid} is not allocated")
            if bid not in self._page_digest:
                bad.append(f"evictable page {bid} has no digest mapping")
        for d, bid in self._digest.items():
            if self._page_digest.get(bid) != d:
                bad.append(f"digest bijection broken at digest {d[:12]}…")
        for bid, d in self._page_digest.items():
            if self._digest.get(d) != bid:
                bad.append(f"digest bijection broken at page {bid}")
        if expect_drained:
            if self._ref:
                bad.append(f"live references after drain: "
                           f"{dict(sorted(self._ref.items()))}")
            leaked = self._allocated - set(self._evictable) - set(self._ref)
            if leaked:
                bad.append(f"leaked pages (allocated, unreferenced, not "
                           f"parked): {sorted(leaked)}")
        return bad


@dataclasses.dataclass
class ServeConfig:
    """Engine knobs, with the JAX package's fields and defaults (see
    ``repro/serve/engine.py`` for each). ``scheduler`` is
    ``"continuous"`` or ``"static"``; ``kv_layout`` ``"contiguous"`` or
    ``"paged"`` (continuous, attention families), with ``kv_block_size``
    positions
    a page (dividing ``max_len``), a pool of ``kv_num_blocks`` pages
    (page 0 the garbage page; None sizes it to the contiguous capacity,
    :func:`~repro_torch.check.config.paged_num_blocks`) and
    ``prefix_cache`` sharing full prompt pages; ``kv_cache`` ``"float"``
    or ``"int8"`` (continuous, attention families); ``attn_impl`` the
    prefill
    attention, ``"flash"``, ``"flash_tri"`` or ``"full"``; ``precision``
    one of ``"float"``, ``"int8"``, ``"int8-torch"``, ``"w4a8"`` and
    ``"w4a8-torch"``."""
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


def prefix_salt(bucket: int, salted: bool) -> bytes:
    """The salt of a prompt's page digests (``BlockPool.prefix_keys``):
    its prefill bucket where ``salted`` (on a card, whose bf16 GEMMs give
    the same prompt rows other bits under another row count, so pages are
    shared only between prefills of one bucket), else nothing (the host,
    where a row's products do not depend on the row count; JAX's
    digests)."""
    return f"prefill bucket {bucket}".encode() if salted else b""


def _check_gates(cfg: ModelConfig, scfg: ServeConfig):
    """The JAX engine's gates, with its messages: the int8 KV cache and the
    paged layout need the continuous scheduler and an attention-family
    model; an ssm or moe model serves in ``"float"`` only."""
    not_dense_kv = cfg.family in T.NOT_DENSE_KV
    if scfg.kv_cache == "int8":
        if scfg.scheduler != "continuous":
            raise NotImplementedError(
                "kv_cache='int8' quantizes the resident slot cache; the "
                "static scheduler decodes off the float prefill cache — "
                "use scheduler='continuous'")
        if not_dense_kv:
            raise NotImplementedError(
                "kv_cache='int8' covers attention-family dense KV caches "
                "only (no ssm / hybrid / encdec)")
    if scfg.kv_layout == "paged":
        if scfg.scheduler != "continuous":
            raise NotImplementedError(
                "kv_layout='paged' pages the live slotted decode cache; "
                "the static scheduler decodes off the prefill cache — "
                "use scheduler='continuous'")
        if not_dense_kv:
            raise NotImplementedError(
                "kv_layout='paged' covers attention-family dense KV "
                "caches only (no ssm / hybrid / encdec)")
    if (not_dense_kv or cfg.moe is not None) and scfg.precision in PRECISIONS \
            and scfg.precision != "float":
        raise NotImplementedError(
            "ServeConfig.precision='int8' quantizes dense FFN "
            "matmuls; moe/ssm/hybrid/encdec configs are unsupported")


class Engine:
    """The LM engine (module docstring); ``jit`` captures its decode steps
    and an attention model's prefill buckets on a card."""

    def __init__(self, cfg: ModelConfig, params, scfg: ServeConfig, *,
                 jit: bool = True):
        from repro_torch.check.config import check_serve_config
        T.check_family(cfg, "Engine")
        _check_gates(cfg, scfg)
        bad = check_serve_config(scfg, cfg, strict=False)
        if bad:
            raise ValueError("invalid ServeConfig:\n"
                             + "\n".join(f"  - {m}" for m in bad))
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
        self.paged = scfg.kv_layout == "paged"
        #: salt prompt-page digests with the prefill bucket (a card:
        #: :func:`prefix_salt`)
        self.salt_prefix = self.device.type == "cuda"
        self.jit = jit
        #: CUDA graph captures made (decode steps, prefill buckets)
        self.traces = 0
        self._graphs: Dict[tuple, CapturedFn] = {}
        self._graph_pool = None
        # the live cache (contiguous slots or page pools), made at the
        # first continuous drain; the static scheduler's cache per batch
        # size; the host buffers the decode step's tokens, the per-slot
        # lengths and the block table come from
        self._arena: Optional[dict] = None
        self._static: Dict[int, dict] = {}
        pinned = self.device.type == "cuda"
        self._host_tok = torch.zeros((scfg.max_batch, 1), dtype=torch.int64,
                                     pin_memory=pinned)
        self._host_len = torch.zeros((scfg.max_batch,), dtype=torch.int32,
                                     pin_memory=pinned)
        self._host_table = torch.zeros(
            (scfg.max_batch, scfg.max_len // scfg.kv_block_size
             if self.paged else 0), dtype=torch.int32, pin_memory=pinned)
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
            # block-pool gauges: live under the paged layout, 0 under the
            # contiguous one (registered for key parity)
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
        # the live BlockPool of a paged drain, kept for auditing after it
        self.pool: Optional[BlockPool] = None

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

    def _update_pool_gauges(self, pool: BlockPool):
        self._m["blocks_in_use"].set(pool.in_use)
        self._m["blocks_free"].set(pool.free_pages)
        self._m["prefix_hit_rate"].set(
            pool.hits / pool.lookups if pool.lookups else 0.0)

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

    def _take_batch(self) -> List[Request]:
        out: List[Request] = []
        while len(out) < self.scfg.max_batch:
            req = self._next_request()
            if req is None:
                break
            out.append(req)
        return out

    def run_until_drained(self) -> List[Request]:
        with obs_trace.span("engine.drain", scheduler=self.scfg.scheduler):
            if self.scfg.scheduler == "static":
                return self._run_static()
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
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        name = ".".join(map(str, key))
        with obs_trace.span("engine.trace", graph=name):
            cap, out = capture(fn, inputs, key=f"lm.{name}",
                               pool=self._graph_pool)
        self._graphs[key] = cap
        self.traces += 1
        return out

    def _run_graph(self, key: tuple, fn, inputs: tuple):
        """``fn`` on the host tensors ``inputs`` moved to the engine's
        device: eager, or under capture a replay of the graph ``key`` with
        ``inputs`` copied into its static inputs (captured at its first
        call)."""
        cap = self._graphs.get(key) if self._captures() else None
        if cap is None:
            dev_inputs = tuple(x.to(self.device) for x in inputs)
            if not self._captures():
                return fn(*dev_inputs)
            return self._capture(key, fn, dev_inputs)
        for dst, src in zip(cap.inputs, inputs):
            dst.copy_(src)
        return cap.replay()

    def _prefill_slot(self, toks: np.ndarray, plen: int):
        """(logits, fresh cache) of one right-padded prompt, (1, bucket):
        a replay of the bucket's graph under capture (an attention model),
        else the eager prefill."""
        inputs = (torch.from_numpy(toks),
                  torch.tensor([plen], dtype=torch.int32))
        fn = lambda t, n: self.prefill(    # noqa: E731
            self.params, {"tokens": t, "prompt_lens": n})
        if self.cfg.family in T.NOT_DENSE_KV:
            return fn(*(x.to(self.device) for x in inputs))
        return self._run_graph(("prefill", toks.shape[1]), fn, inputs)

    def _decode_logits(self, cache: dict, tok: torch.Tensor,
                       key: Optional[tuple] = None):
        """The (B, 1, V) logits of one decode round over ``cache`` (written
        in place) for the host tokens ``tok``: a replay of the graph
        ``key`` (the continuous step's by default) under capture, else the
        eager step. The step's returned ``"len"`` is dropped: the engine
        sets the cache's lengths itself."""
        return self._run_graph(
            key or ("decode", self.scfg.max_batch),
            lambda t: self.decode(self.params, t, cache)[0], (tok,))

    # --------------------------------------------------------- continuous --

    def _new_arena(self) -> dict:
        s, dev = self.scfg, self.device
        if self.paged:
            return api.init_paged_cache(self.cfg, s.max_batch,
                                        paged_num_blocks(s), s.kv_block_size,
                                        s.max_len, kv=s.kv_cache, device=dev)
        return api.init_slot_cache(self.cfg, s.max_batch, s.max_len,
                                   kv=s.kv_cache, device=dev)

    def _run_continuous(self) -> List[Request]:
        B = self.scfg.max_batch
        dev = self.device
        paged = self.paged
        bs = self.scfg.kv_block_size
        if self._arena is None:
            self._arena = self._new_arena()
        # the arena's tensors persist (a captured step reads them by
        # address); each drain starts from a cleared arena
        cache = api.cache_clear(self._arena)
        if paged:
            pool = BlockPool(paged_num_blocks(self.scfg), bs,
                             prefix_cache=self.scfg.prefix_cache)
            self.pool = pool
            table = self._host_table.numpy()   # host mirror of the table
            table[:] = 0
            slot_ids: List[List[int]] = [[] for _ in range(B)]
            slot_hashed = [0] * B       # leading refcounted pages per slot
            holdback: "collections.deque[Request]" = collections.deque()
            self._update_pool_gauges(pool)
        slots: List[Optional[Request]] = [None] * B
        admit_seq = [0] * B             # admission order, for victim choice
        seq = 0
        lens = self._host_len.numpy()   # host mirror of cache["len"]
        lens[:] = 0
        cur = self._host_tok.numpy()    # the next round's tokens
        cur[:] = 0
        finished: List[Request] = []

        def next_request() -> Optional[Request]:
            # the holdback (backpressured or preempted) drains before the
            # queue, so paged admission stays FIFO
            if paged and holdback:
                return holdback.popleft()
            return self._next_request()

        def admit_paged(i: int, req: Request, plen: int):
            """Last-position logits, or None when the pool cannot supply
            the prompt's pages (backpressure). Any failure after pages
            were referenced or allocated rolls the pool back first."""
            nb = -(-plen // bs)         # pages covering positions [0, plen)
            salt = prefix_salt(self._bucket_len(plen), self.salt_prefix)
            keys = pool.prefix_keys(req.prompt, salt)
            with obs_trace.span("engine.prefix_lookup", uid=req.uid,
                                blocks=len(keys)):
                hit_ids = pool.lookup(keys)
            n_hit = len(hit_ids)
            # reference the hit pages BEFORE alloc, so its eviction scan
            # cannot reclaim them
            pool.acquire(hit_ids)
            try:
                with obs_trace.span("engine.block_alloc", uid=req.uid,
                                    n=nb - n_hit):
                    fresh = pool.alloc(nb - n_hit)
            except Exception:
                pool.release(hit_ids)   # injected blockpool.alloc fault
                raise
            if fresh is None:
                pool.release(hit_ids)
                return None
            req.admit_t = time.perf_counter()
            ids = hit_ids + fresh
            try:
                logits = admit_pages(i, req, plen, hit_ids, fresh)
            except Exception:
                pool.release(hit_ids)
                pool.free(fresh)        # unpublished: straight back
                self._update_pool_gauges(pool)
                raise
            # publish at admission: the fresh full prompt pages now hold
            # their final K/V (decode writes land strictly past them)
            pool.publish(keys[n_hit:], ids[n_hit:len(keys)])
            slot_ids[i] = ids
            slot_hashed[i] = len(keys)
            table[i, :nb] = ids
            table[i, nb:] = 0
            self._update_pool_gauges(pool)
            return logits

        def admit_pages(i, req, plen, hit_ids, fresh):
            # a miss, or a hit that shares storage only: the whole prompt
            # runs and the shared pages are not written
            n_hit = len(hit_ids)
            bucket = self._bucket_len(plen)
            toks = np.zeros((1, bucket), np.int64)
            toks[0, :plen] = req.prompt
            with obs_trace.span("engine.prefill", uid=req.uid, slot=i,
                                plen=plen, bucket=bucket,
                                prefix_hit=n_hit * bs):
                logits, fresh_cache = self._prefill_slot(toks, plen)
                self._m["prefills"].inc()
                api.paged_write_prompt(self.cfg, cache, fresh_cache, fresh,
                                       skip_blocks=n_hit)
                return logits.cpu().numpy()

        def admit_slot(i: int, req: Request, plen: int):
            bucket = self._bucket_len(plen)
            req.admit_t = time.perf_counter()
            toks = np.zeros((1, bucket), np.int64)
            toks[0, :plen] = req.prompt    # right-pad: 0..plen-1
            with obs_trace.span("engine.prefill", uid=req.uid, slot=i,
                                plen=plen, bucket=bucket):
                logits, fresh = self._prefill_slot(toks, plen)
                self._m["prefills"].inc()
                api.cache_write_slot(self.cfg, cache, fresh, i)
                return logits.cpu().numpy()

        def try_admit(i: int, req: Request) -> str:
            """Admit ``req`` into free slot ``i``: "ok", "full" (paged pool
            backpressure: park it in the holdback) or "failed" (the
            admission outlived max_retries and the request retired as
            "error"). The ``engine.prefill`` seam fires once per attempt,
            before any device call or pool change."""
            nonlocal seq
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
                    if paged:
                        logits = admit_paged(i, req, plen)
                        if logits is None:
                            return "full"
                    else:
                        logits = admit_slot(i, req, plen)
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
                admit_seq[i] = seq
                seq += 1
                return "ok"
            retire_unadmitted(req, "error", repr(last_err))
            return "failed"

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

        def release_slot(i: int, **span_attrs):
            """Free slot ``i``'s length, pages and table row."""
            slots[i] = None
            lens[i] = 0
            api.cache_free_slot(cache, i)
            if not paged:
                return
            with obs_trace.span("engine.block_free", n=len(slot_ids[i]),
                                **span_attrs):
                pool.free(slot_ids[i], hashed=slot_hashed[i])
            slot_ids[i] = []
            slot_hashed[i] = 0
            table[i, :] = 0
            self._update_pool_gauges(pool)

        def retire_slot(i: int, status: str = "ok",
                        err: Optional[str] = None):
            """Retire slot ``i``'s request and reclaim its slot and pages:
            the one release path of ok, timeout and error."""
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
            release_slot(i, uid=req.uid)

        def maybe_retire(i: int):
            req = slots[i]
            if (req.out_tokens[-1] == self._effective_eos(req)
                    or len(req.out_tokens) >= req.max_new_tokens
                    or lens[i] >= self.scfg.max_len):
                retire_slot(i, "ok")

        def preempt(victim: int):
            """Evict the youngest slot mid-decode to free its pages; its
            request restarts from the prompt via the holdback (greedy
            decode replays the same stream, and its published prompt
            pages usually survive as evictable, so the re-prefill hits)."""
            req = slots[victim]
            # the discarded tokens stay in tokens_out (they were real
            # decode work); the replay counts its own
            req.out_tokens = []
            req.done = False
            holdback.appendleft(req)
            release_slot(victim, uid=req.uid, preempt=True)

        def pool_alloc(n: int) -> Optional[List[int]]:
            """``pool.alloc`` with an injected fault taken as a transient
            shortage (None), which backpressure and preemption handle."""
            try:
                return pool.alloc(n)
            except faults.InjectedFault:
                self._m["retries"].inc()
                return None

        def grow_tables():
            """The next page for every slot whose write position reached a
            page boundary; under pool pressure, preempt the youngest slots
            (oldest first, so a lone grower can always reclaim)."""
            order = sorted((i for i in range(B) if slots[i] is not None),
                           key=lambda i: admit_seq[i])
            for i in order:
                if slots[i] is None:        # preempted by an older grower
                    continue
                pos = lens[i]
                if pos >= self.scfg.max_len or pos % bs \
                        or pos // bs < len(slot_ids[i]):
                    continue
                with obs_trace.span("engine.block_alloc",
                                    uid=slots[i].uid, n=1):
                    got = pool_alloc(1)
                while got is None:
                    victim = max((v for v in range(B)
                                  if slots[v] is not None),
                                 key=lambda v: admit_seq[v])
                    preempt(victim)
                    if victim == i:
                        break
                    got = pool_alloc(1)
                if slots[i] is None or got is None:
                    continue
                slot_ids[i].append(got[0])
                table[i, pos // bs] = got[0]
            self._update_pool_gauges(pool)

        def rebuild_arena():
            """After an unrecoverable decode round: the arena cleared in
            place and, paged, a fresh pool (its digests would otherwise
            name pages of the cleared arena)."""
            nonlocal pool
            self._m["arena_rebuilds"].inc()
            api.cache_clear(cache)
            if paged:
                pool = BlockPool(pool.num_blocks, bs,
                                 prefix_cache=self.scfg.prefix_cache)
                self.pool = pool
                table[:] = 0
                for i in range(B):
                    slot_ids[i] = []
                    slot_hashed[i] = 0
                self._update_pool_gauges(pool)

        stalls = 0                      # consecutive can't-admit iterations
        decode_failures = 0             # consecutive failed round attempts
        while True:
            # refill free slots between decode rounds; the inner loop
            # re-admits into a slot whose request retired at admission. A
            # paged admission the pool cannot back parks in the holdback
            # and stops the refill until retirements release pages.
            blocked = False
            for i in range(B):
                while slots[i] is None and not blocked:
                    req = next_request()
                    if req is None:
                        break
                    if self._expired(req):
                        retire_unadmitted(req, "timeout")
                        continue
                    res = try_admit(i, req)
                    if res == "full":
                        holdback.appendleft(req)
                        blocked = True
                    elif res == "ok":
                        maybe_retire(i)
                if blocked:
                    break
            active = [i for i in range(B) if slots[i] is not None]
            if not active:
                if paged and holdback:
                    # nothing active to retire and the holdback head still
                    # does not fit: after max_retries + 1 such iterations
                    # it retires as "error" (the engine does not deadlock)
                    stalls += 1
                    if stalls > self.scfg.max_retries:
                        retire_unadmitted(
                            holdback.popleft(), "error",
                            "paged KV pool cannot admit this request even "
                            "with every page reclaimable — kv_num_blocks "
                            "is below its worst-case page need")
                        stalls = 0
                    continue
                break                   # the admit loop drained the queue
            stalls = 0
            if paged:
                grow_tables()
                active = [i for i in range(B) if slots[i] is not None]
                if not active:
                    continue            # preemption emptied the batch
            try:
                round_fired = faults.check("engine.decode_round")
                # the lengths (and block table) from the host mirrors, in
                # place: retired and empty rows are at 0
                cache["len"].copy_(self._host_len)
                if paged:
                    cache["block_table"].copy_(self._host_table)
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
                # the whole active set and rebuild the arena
                for i in active:
                    retire_slot(i, "error", repr(e))
                rebuild_arena()
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
        return finished

    # ------------------------------------------------------------- static --

    def _run_static(self) -> List[Request]:
        finished: List[Request] = []
        while True:
            batch = self._take_batch()
            if not batch:
                break
            finished.extend(self._run_batch(batch))
        return finished

    def _retry_call(self, site: str, fn):
        """Run ``fn`` behind fault site ``site`` with bounded retries:
        ``(result, fired, err)``; after ``max_retries`` injected faults (a
        real exception is not retried) the result is None and ``err`` the
        absorbed exception."""
        last_err: Optional[BaseException] = None
        for attempt in range(self.scfg.max_retries + 1):
            if attempt:
                self._m["retries"].inc()
                if self.scfg.retry_backoff_s > 0:
                    time.sleep(self.scfg.retry_backoff_s
                               * (2 ** (attempt - 1)))
            try:
                fired = faults.check(site)
                return fn(), fired, None
            except faults.InjectedFault as e:
                last_err = e
                continue
            except Exception as e:
                last_err = e
                break
        return None, None, last_err

    def _static_cache(self, cache: dict, b: int) -> dict:
        """The cache a static batch of ``b`` decodes over: under capture
        the static cache of that size (made at the size's first batch; its
        decode graph reads it by address) with the prefill cache copied
        in, else the prefill cache itself."""
        if not self._captures():
            return cache
        st = self._static.get(b)
        if st is None:
            st = self._static[b] = {k: torch.empty_like(v)
                                    for k, v in cache.items()}
        for k, v in cache.items():
            st[k].copy_(v)
        return st

    def _run_batch(self, reqs: List[Request]) -> List[Request]:
        b = len(reqs)
        dev = self.device
        plen = max(len(r.prompt) for r in reqs)
        toks = np.zeros((b, plen), np.int64)
        for i, r in enumerate(reqs):
            toks[i, plen - len(r.prompt):] = r.prompt      # left-pad
        now = time.perf_counter()
        for r in reqs:
            r.admit_t = now

        def do_prefill():
            with obs_trace.span("engine.prefill", batch=b, plen=plen):
                logits, cache = self.prefill(
                    self.params, {"tokens": torch.from_numpy(toks).to(dev)})
                self._m["prefills"].inc()
                return logits.cpu().numpy(), self._static_cache(cache, b)

        got, fired, err = self._retry_call("engine.prefill", do_prefill)
        if err is not None:
            # the batch shares one prefill: it retires whole, and the next
            # _take_batch keeps draining the queue
            for r in reqs:
                r.status = "error"
                r.error = repr(err)
                r.done = True
                self._m["errors"].inc()
            return self._finish_batch(reqs)
        lg, cache = got
        if fired is not None:
            lg = fired.apply(lg)
            self.poisoned_uids.update(r.uid for r in reqs)
        cur = torch.zeros((b, 1), dtype=torch.int64,
                          pin_memory=dev.type == "cuda")
        now = time.perf_counter()
        for i, r in enumerate(reqs):
            t = self._pick(lg[i, -1], r)
            r.first_token_t = now
            self._m["ttft"].observe(r.ttft_s)
            r.out_tokens.append(t)
            self._m["tokens_out"].inc()
            cur[i, 0] = t
            if t == self._effective_eos(r) or r.max_new_tokens <= 1:
                r.done = True
        steps = max(r.max_new_tokens for r in reqs) - 1
        for _ in range(max(steps, 0)):
            now = time.perf_counter()
            for r in reqs:
                if not r.done and self._expired(r, now):
                    r.done = True       # round-boundary cancellation
                    r.status = "timeout"
                    self._m["timeouts"].inc()
            if all(r.done for r in reqs):
                break

            def do_round():
                t0 = time.perf_counter()
                with obs_trace.span("engine.decode_round",
                                    round=self._round,
                                    active=sum(not r.done for r in reqs)):
                    logits = self._decode_logits(cache, cur, ("static", b))
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                self._m["decode_time"].inc(time.perf_counter() - t0)
                # the step wrote K/V at the lockstep length; advance it in
                # place (a captured step reads it by address)
                cache["len"].add_(1)
                return logits.cpu().numpy()

            lg, fired, err = self._retry_call("engine.decode_round",
                                              do_round)
            if err is not None:
                for r in reqs:          # one shared cache: no per-request
                    if not r.done:      # attribution possible
                        r.status = "error"
                        r.error = repr(err)
                        r.done = True
                        self._m["errors"].inc()
                break
            if fired is not None:
                lg = fired.apply(lg)
                self.poisoned_uids.update(
                    r.uid for r in reqs if not r.done)
            self._round += 1
            self._m["decode_steps"].inc()
            for i, r in enumerate(reqs):
                if r.done:
                    continue
                self._m["occupied"].inc()
                t = self._pick(lg[i, -1], r)
                r.out_tokens.append(t)
                self._m["tokens_out"].inc()
                cur[i, 0] = t
                if (t == self._effective_eos(r)
                        or len(r.out_tokens) >= r.max_new_tokens):
                    r.done = True
        return self._finish_batch(reqs)

    def _finish_batch(self, reqs: List[Request]) -> List[Request]:
        now = time.perf_counter()
        for r in reqs:
            r.done = True
            if r.status == "pending":
                r.status = "ok"
            if r.first_token_t == 0.0:  # batch failed before first token
                r.first_token_t = now
            r.finish_t = now
            r.finish_round = self._round
            self._m["requests_done"].inc()
            self._observe_retired(r)
        return reqs
