"""Serve-config static checks: every violation of a
:class:`~repro_torch.serve.engine.ServeConfig` or a
:class:`~repro_torch.serve.cnn.CNNServeConfig` at once, as a list.

The port's own copy of the JAX package's ``repro/check/config.py``:
``check_serve_config`` with the paged layout's block-size and pool checks
and the resident KV budget (:func:`kv_cache_bytes`, with the pool size
:func:`paged_num_blocks`) against an optional ``hbm_budget``,
``check_cnn_serve_config`` and ``_check_resilience``. The enums keep the
JAX package's values, so a JAX ``ServeConfig`` validates the same here;
the precisions are the port's (``"int8-torch"`` and ``"w4a8-torch"`` where
JAX has ``"int8-xla"``).
"""
from __future__ import annotations

from typing import List, Optional

SCHEDULERS = ("continuous", "static")
SHED_POLICIES = ("reject", "drop")
PRECISIONS = ("float", "int8", "int8-torch", "w4a8", "w4a8-torch")
KV_CACHES = ("float", "int8")
KV_LAYOUTS = ("contiguous", "paged")
ATTN_IMPLS = ("full", "flash", "flash_tri")

_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1}


def paged_num_blocks(scfg) -> int:
    """Resolved pool size: ``kv_num_blocks`` when set, else the contiguous
    capacity equivalent — ``max_batch * (max_len // block_size)`` usable
    pages plus the reserved garbage page 0."""
    if getattr(scfg, "kv_num_blocks", None):
        return scfg.kv_num_blocks
    return scfg.max_batch * (scfg.max_len // scfg.kv_block_size) + 1


def kv_cache_bytes(cfg, scfg) -> int:
    """Resident KV budget of the ONE live decode cache.

    Contiguous layout: ``layers * K&V * max_batch * max_len * n_kv_heads *
    head_dim * width`` (int8 kv adds the per-(position, head) f32 scale
    sideband). Paged layout: ``layers * K&V * num_blocks * block_size``
    positions instead, plus the (max_batch, max_len / block_size) int32
    block table."""
    width = 1 if scfg.kv_cache == "int8" else \
        _DTYPE_BYTES.get(cfg.compute_dtype, 4)
    per_pos = cfg.n_kv_heads * cfg.head_dim * width
    if scfg.kv_cache == "int8":
        per_pos += cfg.n_kv_heads * 4           # f32 scale per (pos, head)
    if getattr(scfg, "kv_layout", "contiguous") == "paged":
        positions = paged_num_blocks(scfg) * scfg.kv_block_size
        table = 4 * scfg.max_batch * (scfg.max_len // scfg.kv_block_size)
        return cfg.n_layers * 2 * positions * per_pos + table
    return cfg.n_layers * 2 * scfg.max_batch * scfg.max_len * per_pos


def _check_resilience(scfg, errs: List[str]):
    """Failure-model knobs: deadline_s / max_queue / shed_policy /
    max_retries / retry_backoff_s."""
    d = getattr(scfg, "deadline_s", None)
    if d is not None and (not isinstance(d, (int, float)) or d <= 0):
        errs.append(f"deadline_s must be > 0 (or None to disable), "
                    f"got {d!r}")
    mq = getattr(scfg, "max_queue", None)
    if mq is not None:
        if not isinstance(mq, int) or mq < 1:
            errs.append(f"max_queue must be a positive int (or None to "
                        f"disable shedding), got {mq!r}")
        elif isinstance(scfg.max_batch, int) and mq < scfg.max_batch:
            errs.append(
                f"max_queue={mq} is below max_batch={scfg.max_batch}: the "
                "scheduler could never fill a round before shedding — "
                "raise max_queue to at least max_batch")
    sp = getattr(scfg, "shed_policy", "reject")
    if sp not in SHED_POLICIES:
        errs.append(f"unknown shed_policy: {sp!r} "
                    f"(choose from {SHED_POLICIES})")
    mr = getattr(scfg, "max_retries", 0)
    if not isinstance(mr, int) or mr < 0:
        errs.append(f"max_retries must be an int >= 0, got {mr!r}")
    rb = getattr(scfg, "retry_backoff_s", 0.0)
    if not isinstance(rb, (int, float)) or rb < 0:
        errs.append(f"retry_backoff_s must be >= 0, got {rb!r}")


def _check_paged(scfg, strict: bool, errs: List[str]):
    """The paged layout's knobs: the scheduler, ``kv_block_size`` dividing
    ``max_len``, and a pool that one ``max_len`` request (strict: every
    slot at one page) can always grow in."""
    if scfg.scheduler != "continuous":
        errs.append("kv_layout='paged' needs scheduler='continuous' "
                    "(the static path decodes off the prefill cache)")
    bs = scfg.kv_block_size
    if not isinstance(bs, int) or bs < 1:
        errs.append(f"kv_block_size must be a positive int, got {bs!r}")
    elif isinstance(scfg.max_len, int) and scfg.max_len % bs:
        errs.append(f"kv_block_size={bs} must divide max_len="
                    f"{scfg.max_len}: the gathered block-table view "
                    "must span exactly max_len positions for paged "
                    "decode to be bit-identical to contiguous")
    nb = scfg.kv_num_blocks
    if nb is not None and (not isinstance(nb, int) or nb < 2):
        errs.append(f"kv_num_blocks must be an int >= 2 (page 0 is the "
                    f"reserved garbage page), got {nb!r}")
    elif isinstance(bs, int) and bs >= 1 \
            and isinstance(scfg.max_len, int) \
            and not scfg.max_len % bs:
        usable = paged_num_blocks(scfg) - 1
        if usable < scfg.max_len // bs:
            errs.append(
                f"kv_num_blocks={nb} leaves {usable} usable pages, "
                f"fewer than the {scfg.max_len // bs} one request at "
                f"max_len={scfg.max_len} needs — the engine could "
                "deadlock growing a lone sequence")
        elif strict and usable < scfg.max_batch:
            errs.append(
                f"kv_num_blocks={nb} leaves {usable} usable pages, "
                f"fewer than max_batch={scfg.max_batch} minimum-length "
                "requests (one page each) — slots can never all fill")


def check_serve_config(scfg, cfg=None, *, hbm_budget: Optional[int] = None,
                       strict: bool = True) -> List[str]:
    """Every violation of a :class:`~repro_torch.serve.engine.ServeConfig`
    (optionally against a :class:`~repro_torch.configs.base.ModelConfig`).
    ``strict=False`` is the subset ``Engine.__init__`` enforces; strict
    mode also flags a prefill bucket floor above ``max_len`` and a paged
    pool that cannot hold one page per slot. ``hbm_budget`` (bytes) flags
    a resident KV cache (:func:`kv_cache_bytes`) above it."""
    errs: List[str] = []
    for knob, allowed in (("scheduler", SCHEDULERS),
                          ("precision", PRECISIONS),
                          ("kv_cache", KV_CACHES),
                          ("kv_layout", KV_LAYOUTS),
                          ("attn_impl", ATTN_IMPLS)):
        v = getattr(scfg, knob)
        if v not in allowed:
            errs.append(f"unknown {knob}: {v!r} (choose from {allowed})")
    for knob in ("max_batch", "max_len", "prefill_bucket"):
        v = getattr(scfg, knob)
        if not isinstance(v, int) or v < 1:
            errs.append(f"{knob} must be a positive int, got {v!r}")
    if scfg.temperature < 0:
        errs.append(f"temperature must be >= 0, got {scfg.temperature!r}")
    _check_resilience(scfg, errs)
    if scfg.kv_cache == "int8" and scfg.scheduler != "continuous":
        errs.append("kv_cache='int8' needs scheduler='continuous' (the "
                    "static path decodes off the float prefill cache)")
    if scfg.kv_layout == "paged":
        _check_paged(scfg, strict, errs)
    if cfg is not None:
        recurrent = cfg.family in ("ssm", "hybrid", "encdec")
        if scfg.kv_layout == "paged" and recurrent:
            errs.append("kv_layout='paged' covers attention-family dense "
                        "KV caches only (no ssm / hybrid / encdec)")
        if scfg.precision != "float" and (cfg.family != "dense"
                                          or cfg.moe is not None):
            errs.append(f"precision={scfg.precision!r} quantizes dense FFN "
                        "matmuls; moe/ssm/hybrid/encdec are unsupported")
        if scfg.kv_cache == "int8" and recurrent:
            errs.append("kv_cache='int8' covers attention-family dense KV "
                        "caches only (no ssm / hybrid / encdec)")
        if strict and not cfg.sub_quadratic() and cfg.family != "encdec" \
                and isinstance(scfg.prefill_bucket, int) \
                and isinstance(scfg.max_len, int) \
                and scfg.prefill_bucket > scfg.max_len:
            errs.append(f"prefill_bucket={scfg.prefill_bucket} exceeds "
                        f"max_len={scfg.max_len}; every bucket would "
                        "overflow the per-slot KV capacity")
        if hbm_budget is not None and cfg.family not in ("ssm",):
            kv = kv_cache_bytes(cfg, scfg)
            if kv > hbm_budget:
                errs.append(
                    f"resident KV cache needs {kv / 2**20:.1f} MiB "
                    f"({cfg.n_layers} layers x 2 x {scfg.max_batch} slots "
                    f"x {scfg.max_len} positions), over the "
                    f"{hbm_budget / 2**20:.1f} MiB budget — shrink "
                    "max_batch/max_len or use kv_cache='int8'")
    return errs


def check_cnn_serve_config(scfg) -> List[str]:
    """Violations of a :class:`~repro_torch.serve.cnn.CNNServeConfig`."""
    errs: List[str] = []
    if not isinstance(scfg.max_batch, int) or scfg.max_batch < 1:
        errs.append(f"max_batch must be a positive int, got "
                    f"{scfg.max_batch!r}")
    _check_resilience(scfg, errs)
    return errs
