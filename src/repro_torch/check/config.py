"""Serve-config static checks for the CNN engine: every violation of a
:class:`~repro_torch.serve.cnn.CNNServeConfig` at once, as a list.

The port's own copy of ``check_cnn_serve_config`` and ``_check_resilience``
from the JAX package's ``repro/check/config.py``.
"""
from __future__ import annotations

from typing import List

SHED_POLICIES = ("reject", "drop")


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


def check_cnn_serve_config(scfg) -> List[str]:
    """Violations of a :class:`~repro_torch.serve.cnn.CNNServeConfig`."""
    errs: List[str] = []
    if not isinstance(scfg.max_batch, int) or scfg.max_batch < 1:
        errs.append(f"max_batch must be a positive int, got "
                    f"{scfg.max_batch!r}")
    _check_resilience(scfg, errs)
    return errs
