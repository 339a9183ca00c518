"""AdamW with decoupled weight decay, a warmup + cosine schedule and
global-norm clipping, over the port's trees of tensors.

Port of the AdamW half of ``repro/optim/optimizer.py``, with an in-place
form of the update (:func:`apply_updates_`) for the trainer. Not
``torch.optim``: the update is the JAX package's arithmetic in its order,
float32 throughout, so one step agrees with JAX's to float32 rounding. A
leaf that is not floating point (a shift table) is never updated, and its
gradient (zeros of its own dtype) is left out of the global norm.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    """AdamW's settings, the JAX package's fields but its optimizer name:
    the port has AdamW only (JAX's "sgdm" has no caller)."""
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    state_dtype: Optional[str] = None     # None -> same as params


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio``; a float32
    0-d tensor."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def global_norm(tree, axes=None) -> torch.Tensor:
    """The L2 norm over every float leaf, summed in float32. In a sharded
    step ``axes`` gives, leaf by leaf in flatten order, the mesh axes
    that split that leaf (``()`` for one held whole): each leaf's sum of
    squares over its block is summed over exactly those ranks (leaves of
    the same axes in one collective), so a replicated dim counts once and
    every rank gets the global norm."""
    float_leaves = [(i, x) for i, x in enumerate(leaves(tree))
                    if _is_float(x)]
    sums = [torch.sum(torch.square(x.to(torch.float32)))
            for _, x in float_leaves]
    if axes is not None:
        from repro_torch.parallel.sharding import psum
        by_axes: dict = {}
        for j, (i, _) in enumerate(float_leaves):
            if axes[i]:
                by_axes.setdefault(tuple(axes[i]), []).append(j)
        for ax, js in by_axes.items():
            got = psum(torch.stack([sums[j] for j in js]), ax).unbind(0)
            for j, v in zip(js, got):
                sums[j] = v
    return torch.sqrt(torch.sum(torch.stack(sums)))


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The factor that scales gradients of norm ``gnorm`` to at most
    ``max_norm``."""
    return torch.minimum(torch.ones_like(gnorm),
                         max_norm / torch.clamp(gnorm, min=1e-12))


def clip_by_global_norm(grads, max_norm: float):
    """``(grads scaled to a global norm of at most max_norm, the norm)``."""
    g = global_norm(grads)
    scale = _clip_scale(g, max_norm)
    return tree_map(lambda x: x * scale.to(x.dtype) if _is_float(x) else x,
                    grads), g


def init_opt_state(params, cfg: OptConfig) -> dict:
    """Zero moments in each parameter's dtype (``state_dtype`` overrides
    it, e.g. "bfloat16") and an int32 step counter on the parameters'
    device."""
    sdt = getattr(torch, cfg.state_dtype) if cfg.state_dtype else None

    def zeros_like(p):
        return torch.zeros(p.shape, dtype=sdt or p.dtype, device=p.device)
    dev = leaves(params)[0].device
    return {"m": tree_map(zeros_like, params),
            "v": tree_map(zeros_like, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _adamw(p, g, m, v, lr, bc1, bc2, cfg: OptConfig):
    """One float leaf's AdamW step from its clipped gradient: ``(p, m, v)``
    new, each in its own dtype."""
    b1, b2 = cfg.b1, cfg.b2
    g32 = g.to(torch.float32)
    m32 = b1 * m.to(torch.float32) + (1 - b1) * g32
    v32 = b2 * v.to(torch.float32) + (1 - b2) * g32 * g32
    mhat = m32 / bc1
    vhat = v32 / bc2
    delta = (mhat / (torch.sqrt(vhat) + cfg.eps)
             + cfg.weight_decay * p.to(torch.float32))
    return ((p.to(torch.float32) - lr * delta).to(p.dtype),
            m32.to(m.dtype), v32.to(v.dtype))


def _schedule_terms(step: torch.Tensor, cfg: OptConfig):
    """(lr, 1 - b1^step, 1 - b2^step) at ``step``."""
    s32 = step.to(torch.float32)
    return schedule(cfg, step), 1 - cfg.b1 ** s32, 1 - cfg.b2 ** s32


def apply_updates(params, grads, state: dict, cfg: OptConfig):
    """One AdamW step: clip, schedule, moments, bias correction, decoupled
    weight decay. Returns ``(new_params, new_state, {"lr", "grad_norm"})``
    and changes none of its arguments."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state["step"] + 1
    lr, bc1, bc2 = _schedule_terms(step, cfg)

    def upd(p, g, m, v):
        if not _is_float(p):             # integer leaves (shift tables)
            return p, m, v
        return _adamw(p, g, m, v, lr, bc1, bc2, cfg)

    out = tree_map(upd, params, grads, state["m"], state["v"])
    new_p, new_m, new_v = (tree_map(lambda _, o, i=i: o[i], params, out)
                           for i in range(3))
    return new_p, {"m": new_m, "v": new_v, "step": step}, \
        {"lr": lr, "grad_norm": gnorm}


#: elements a slice of :func:`apply_updates_` updates at a time
SLICE_ELEMS = 1 << 24


@torch.no_grad()
def apply_updates_(params, grads, state: dict, cfg: OptConfig, *,
                   norm_axes=None):
    """:func:`apply_updates` in place, the port's counterpart of the JAX
    trainer's buffer donation: params, ``state["m"]``, ``state["v"]`` and
    ``state["step"]`` are overwritten with the new values, bitwise those
    of :func:`apply_updates`, and returned with ``{"lr", "grad_norm"}``;
    ``grads`` are read only. Each leaf goes in slices of whole rows along
    its first axis of at most :data:`SLICE_ELEMS` elements (one row where
    a row is larger), clipping included, so the temporaries stay a slice's
    size: the functional form holds old and new params, moments and
    clipped gradients together. The arithmetic is elementwise, so slicing
    changes no bit. In a sharded step ``params``, ``grads`` and the
    moments are this rank's blocks and ``norm_axes`` the mesh axes of
    each leaf (:func:`global_norm`): the norm, and so the clipping, are
    the global ones, and the update runs on the blocks."""
    gnorm = global_norm(grads, norm_axes)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    state["step"] += 1
    lr, bc1, bc2 = _schedule_terms(state["step"], cfg)
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]),
                          leaves(state["v"])):
        if not _is_float(p):
            continue
        rows = max(1, SLICE_ELEMS // max(1, p[0].numel())) if p.dim() else 1
        parts = ((p, g, m, v),) if p.dim() == 0 else zip(
            *(t.split(rows) for t in (p, g, m, v)))
        for ps, gs, ms, vs in parts:
            gs = gs * scale.to(gs.dtype)
            for dst, new in zip((ps, ms, vs),
                                _adamw(ps, gs, ms, vs, lr, bc1, bc2, cfg)):
                dst.copy_(new)
    return params, state, {"lr": lr, "grad_norm": gnorm}
