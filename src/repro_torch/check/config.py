"""Serve-config static checks: every violation of a
:class:`~repro_torch.serve.engine.ServeConfig` or a
:class:`~repro_torch.serve.cnn.CNNServeConfig` at once, as a list.

The port's own copy of ``check_serve_config``, ``check_cnn_serve_config``
and ``_check_resilience`` from the JAX package's ``repro/check/config.py``,
cut to the knobs the port serves: the paged layout's block-size and pool
checks are left out with the layout itself (``Engine`` raises
``NotImplementedError`` for it), and so is the KV budget against a device
size, which no caller of the port passes. The enums keep the JAX package's
values, so a JAX ``ServeConfig`` validates the same here; the precisions
are the port's (``"int8-torch"`` and ``"w4a8-torch"`` where JAX has
``"int8-xla"``).
"""
from __future__ import annotations

from typing import List

SCHEDULERS = ("continuous", "static")
SHED_POLICIES = ("reject", "drop")
PRECISIONS = ("float", "int8", "int8-torch", "w4a8", "w4a8-torch")
KV_CACHES = ("float", "int8")
KV_LAYOUTS = ("contiguous", "paged")
ATTN_IMPLS = ("full", "flash", "flash_tri")


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


def check_serve_config(scfg, cfg=None, *, strict: bool = True) -> List[str]:
    """Every violation of a :class:`~repro_torch.serve.engine.ServeConfig`
    (optionally against a :class:`~repro_torch.configs.base.ModelConfig`).
    ``strict=False`` is the subset ``Engine.__init__`` enforces; strict
    mode also flags a prefill bucket floor above ``max_len``."""
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
    return errs


def check_cnn_serve_config(scfg) -> List[str]:
    """Violations of a :class:`~repro_torch.serve.cnn.CNNServeConfig`."""
    errs: List[str] = []
    if not isinstance(scfg.max_batch, int) or scfg.max_batch < 1:
        errs.append(f"max_batch must be a positive int, got "
                    f"{scfg.max_batch!r}")
    _check_resilience(scfg, errs)
    return errs
