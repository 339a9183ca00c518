"""Train-step builder: loss, gradients and the AdamW update, with
microbatch gradient accumulation.

Port of ``repro/train/train_step.py``. Gradients come from
``torch.autograd.grad`` over the float leaves of the parameter tree
(:func:`trainable` makes them require grad). The step writes the new
params and optimizer state into the old ones (``optim.apply_updates_``,
bitwise the functional ``apply_updates``), the port's counterpart of the
JAX trainer's ``donate_argnums=(0, 1)``: the card holds one copy of each.

Inside a mesh (``parallel.sharding``: ``use_mesh`` and the rules of
``make_rules(mesh, cfg, "train", fsdp=True)``, every rank of a
``launch.world.run_world`` world calling the step on its blocks of the
params and optimizer state, ``shard_tree``, and its rows of the batch)
the step is the sharded one, differentiated as JAX's ``shard_map``
differentiates: the loss is the global mean on every rank, each rank
seeds its backward with 1 / (the mesh's size), the collectives carry the
gradient back by their transposes (an FSDP leaf's gradient comes out
reduce-scattered over the batch axes by its gather's backward), and a
leaf's gradient is then summed over the ranks its spec does not split,
which hold copies of it (the ranks of a batch axis, and of the model axis
for a leaf held whole there). The gradient norm is the global one
(``optim.global_norm`` with each leaf's axes), and clipping and AdamW run
on the blocks in place. With ``microbatches`` n the rank's rows split in
n; a microbatch's loss is the mean over every rank's microbatch, so the
step equals the single-device step wherever each microbatch counts as
many labels as the others (the port's LM batches label every position).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.optim import OptConfig, apply_updates_
from repro_torch.parallel.sharding import (current_mesh, mesh_axes, psum,
                                           spec_axes)
from repro_torch.tree import leaves, paths, tree_map


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    remat: str = "full"                 # full | dots | none
    attn_impl: str = "full"
    microbatches: int = 1               # grad accumulation steps
    # int8 error-feedback all-reduce on the DP axes: carried as JAX's is,
    # and read by nothing in either package (optim.allreduce_compressed is
    # the operation)
    compress_grads: bool = False


def trainable(params):
    """``params`` with every float leaf set to require grad (in place)."""
    for p in leaves(params):
        if p.is_floating_point() and not p.requires_grad:
            p.requires_grad_(True)
    return params


def value_and_grad(loss_fn):
    """``fn(params, batch, seed=None) -> (loss, grads)``: the loss (a
    float32 0-d tensor, detached) and a tree of gradients in the structure
    of ``params``, zeros for a leaf the loss does not reach (integer
    leaves keep their own dtype). With ``seed`` the backward starts from
    ``seed`` in place of 1 and runs on the calling thread (a sharded
    step's ranks may be threads of one process, whose collectives in the
    backward would otherwise meet on autograd's one thread per device)."""
    def fn(params, batch, seed=None):
        flat = [p for p in leaves(trainable(params)) if p.is_floating_point()]
        with torch.enable_grad():
            loss = loss_fn(params, batch)
            if seed is None:
                gs = iter(torch.autograd.grad(loss, flat, allow_unused=True))
            else:
                with torch.autograd.set_multithreading_enabled(False):
                    gs = iter(torch.autograd.grad(
                        loss, flat, grad_outputs=torch.full_like(loss, seed),
                        allow_unused=True))

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
    scan does. Inside a mesh: the sharded step (module docstring)."""
    grad_fn = value_and_grad(api.loss_fn(cfg, attn_impl=tcfg.attn_impl,
                                         remat=tcfg.remat))
    specs = dict(paths_of_specs(api.param_specs(cfg)))

    def grads_of(params, batch, seed):
        if tcfg.microbatches <= 1:
            return grad_fn(params, batch, seed)
        n = tcfg.microbatches
        mbs = {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))
               for k, v in batch.items()}
        loss = torch.zeros((), dtype=torch.float32, device=leaves(
            params)[0].device)
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=p.dtype,
                                             device=p.device), params)
        for i in range(n):
            l, g = grad_fn(params, {k: v[i] for k, v in mbs.items()},
                           seed)
            loss = loss + l
            acc = tree_map(torch.add, acc, g)
            del g
        scale = 1.0 / n
        return loss * scale, tree_map(lambda g: g * scale, acc)

    def step(params, opt_state, batch):
        mesh = current_mesh()
        if mesh is None:
            loss, grads = grads_of(params, batch, None)
            params, opt_state, om = apply_updates_(params, grads, opt_state,
                                                   tcfg.opt)
            return params, opt_state, {"loss": loss, **om}
        loss, grads = grads_of(params, batch, 1.0 / mesh.size())
        axes = [spec_axes(specs[k]) for k, _ in paths(grads)]
        grads = sum_replicas(grads, axes)
        params, opt_state, om = apply_updates_(params, grads, opt_state,
                                               tcfg.opt, norm_axes=axes)
        return params, opt_state, {"loss": loss, **om}

    return step


def paths_of_specs(specs, prefix: str = "") -> list:
    """``(path, logical names)`` of every leaf of a tree of specs (dicts
    whose leaves are tuples), paths as ``tree.paths`` names them."""
    out = []
    for k in sorted(specs):
        path = f"{prefix}/{k}" if prefix else str(k)
        v = specs[k]
        out += (paths_of_specs(v, path) if isinstance(v, dict)
                else [(path, v)])
    return out


@torch.no_grad()
def sum_replicas(grads, axes: list):
    """``grads`` with each leaf summed over the current mesh's ranks that
    hold copies of it: the axes of size > 1 that its entry of ``axes``
    (leaf by leaf in flatten order, the axes that split it) leaves out.
    Leaves with the same such axes and dtype go in one collective."""
    flat = [g for _, g in paths(grads)]
    every = mesh_axes()
    groups: dict = {}
    for i, (g, ax) in enumerate(zip(flat, axes)):
        rest = tuple(a for a in every if a not in ax)
        if rest and g.is_floating_point():
            groups.setdefault((rest, g.dtype), []).append(i)
    for (rest, _), idx in groups.items():
        summed = psum(torch.cat([flat[i].reshape(-1) for i in idx]), rest)
        for i, part in zip(idx, summed.split([flat[i].numel()
                                               for i in idx])):
            flat[i] = part.view(flat[i].shape)
    it = iter(flat)
    return tree_map(lambda _: next(it), grads)


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
