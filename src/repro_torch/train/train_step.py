"""Train-step builder: loss, gradients and the AdamW update, with
microbatch gradient accumulation.

Port of ``repro/train/train_step.py``. Gradients come from
``torch.autograd.grad`` over the float leaves of the parameter tree
(:func:`trainable` makes them require grad). The step writes the new
params and optimizer state into the old ones (``optim.apply_updates_``,
bitwise the functional ``apply_updates``), the port's counterpart of the
JAX trainer's ``donate_argnums=(0, 1)``: the card holds one copy of each.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.optim import OptConfig, apply_updates_
from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    remat: str = "full"                 # full | dots | none
    attn_impl: str = "full"
    microbatches: int = 1               # grad accumulation steps


def trainable(params):
    """``params`` with every float leaf set to require grad (in place)."""
    for p in leaves(params):
        if p.is_floating_point() and not p.requires_grad:
            p.requires_grad_(True)
    return params


def value_and_grad(loss_fn):
    """``fn(params, batch) -> (loss, grads)``: the loss (a float32 0-d
    tensor, detached) and a tree of gradients in the structure of
    ``params``, zeros for a leaf the loss does not reach (integer leaves
    keep their own dtype)."""
    def fn(params, batch):
        flat = [p for p in leaves(trainable(params)) if p.is_floating_point()]
        with torch.enable_grad():
            loss = loss_fn(params, batch)
            gs = iter(torch.autograd.grad(loss, flat, allow_unused=True))

        def grad_of(p):
            if not p.is_floating_point():
                return torch.zeros_like(p)
            g = next(gs)
            return torch.zeros_like(p) if g is None else g
        return loss.detach(), tree_map(grad_of, params)
    return fn


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, metrics ``{"loss", "lr", "grad_norm"}``; params and
    opt_state are updated in place and returned. With ``microbatches`` n >
    1 the batch splits into n along its first axis and the gradients are
    summed over them in the parameter dtype, then scaled by 1/n, as JAX's
    scan does."""
    grad_fn = value_and_grad(api.loss_fn(cfg, attn_impl=tcfg.attn_impl,
                                         remat=tcfg.remat))

    def grads_of(params, batch):
        if tcfg.microbatches <= 1:
            return grad_fn(params, batch)
        n = tcfg.microbatches
        mbs = {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))
               for k, v in batch.items()}
        loss = torch.zeros((), dtype=torch.float32, device=leaves(
            params)[0].device)
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=p.dtype,
                                             device=p.device), params)
        for i in range(n):
            l, g = grad_fn(params, {k: v[i] for k, v in mbs.items()})
            loss = loss + l
            acc = tree_map(torch.add, acc, g)
            del g
        scale = 1.0 / n
        return loss * scale, tree_map(lambda g: g * scale, acc)

    def step(params, opt_state, batch):
        loss, grads = grads_of(params, batch)
        params, opt_state, om = apply_updates_(params, grads, opt_state,
                                               tcfg.opt)
        return params, opt_state, {"loss": loss, **om}

    return step


def estimate_model_flops(cfg: ModelConfig, tokens: int,
                         kind: str = "train") -> float:
    """MODEL_FLOPS: 6·N·D to train (2·N·D to serve), N the active
    parameters (a moe model's experts counted at top_k / num_experts)."""
    n = cfg.param_count()
    if cfg.moe is not None:
        moe = cfg.moe
        act = moe.top_k / moe.num_experts
        n_mat = 3 if cfg.act == "silu" else 2
        expert_params = n_mat * cfg.d_model * moe.d_ff * moe.num_experts
        if cfg.family == "moe":
            n_moe_layers = cfg.n_layers
        else:                       # hybrid
            n_moe_layers = cfg.n_layers // moe.every_n_layers
        total_expert = n_moe_layers * expert_params
        n = n - total_expert + total_expert * act
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * tokens
