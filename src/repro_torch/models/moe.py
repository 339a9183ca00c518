"""Mixture-of-Experts FFN with capacity dispatch, local and expert-parallel.

Port of ``repro/models/moe.py``. Dispatch is GShard-style
capacity + dropping without a (tokens, E, C) one-hot: a token's position in
its expert comes from a cumsum over a (tokens * top_k, E) one-hot in
flattened (token, k) order, kept pairs scatter into a dense (E, C, d)
buffer, the experts run as batched matmuls, and each token's output sums
its kept pairs' expert rows weighted by their router probabilities. A pair
past its expert's capacity is dropped, so a token's output depends on the
other tokens of the call (in a decode step: on every slot, free ones
included); the port drops exactly the pairs JAX drops.

Every step is free of host syncs (no ``nonzero``, boolean-mask indexing,
``.item()`` or tensor-count ``repeat_interleave``), so a decode step that
runs it captures as one CUDA graph. Two choices keep it deterministic:
the top-k is a stable descending sort, so on ties the lower expert index
wins as in ``lax.top_k``; and the combine sums each token's k
contributions in index order in the compute dtype, as XLA's scatter-add
does on the host (``index_add_`` on a card adds with atomics in no fixed
order, which in bf16 changes bits from run to run). The dispatch writes
unique (expert, position) rows, and every dropped pair writes zeros to
one spare row that is cut off before the experts run.

Two execution paths, as in JAX. ``moe_ffn_local`` routes every token of
the call together, with no collective. ``moe_ffn_sharded`` is JAX's
``shard_map`` expert parallelism, run SPMD on the ranks of a mesh
(``parallel.sharding``): each rank of the model axis routes its own slice
of the (padded) tokens, ``all_to_all`` sends each expert's (C, d) block to
the rank that holds that expert (E / model of them), the experts run, a
second ``all_to_all`` brings the blocks back, and a tiled ``all_gather``
gives every rank all tokens again. The collectives carry gradients (their
backward is JAX's transpose: the exchanges swapped, the gather a
reduce-scatter), so a moe model trains on this path as JAX's does under a
mesh. ``moe_ffn`` goes through
``moe_ffn_sharded``, which takes the local path outside a mesh, on a model
axis of size 1, when the experts do not split over it, or inside
:class:`prefer_local`.
"""
from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.parallel.sharding import (all_gather, all_to_all,
                                           axis_index, axis_size,
                                           current_mesh, psum, split_axes)

from .blocks import _act, stacked_normal


def init_moe(generator: torch.Generator, d: int, moe: MoEConfig, act: str,
             dtype, *, n_layers: int = 0, device=None) -> dict:
    """Random expert weights drawn from ``generator`` on its device, in the
    JAX package's layout and scales: ``router`` (d, E) * d^-1/2, ``w_up``
    and (silu) ``w_gate`` (E, d, ff) * d^-1/2, ``w_down`` (E, ff, d) *
    ff^-1/2 (stacked over ``n_layers``: :func:`~repro_torch.models.
    blocks.stacked_normal`)."""
    e, ff = moe.num_experts, moe.d_ff
    shapes = {"router": ((d, e), d ** -0.5), "w_up": ((e, d, ff), d ** -0.5),
              "w_down": ((e, ff, d), ff ** -0.5)}
    if act == "silu":
        shapes["w_gate"] = ((e, d, ff), d ** -0.5)
    return stacked_normal(generator, shapes, dtype, n_layers, device=device)


def moe_specs(act, prefix_layers=True):
    """The expert leaves' logical axis names (JAX's ``moe.moe_specs``)."""
    L = ("layers",) if prefix_layers else ()
    p = {"router": L + ("embed", None),
         "w_up": L + ("experts", "embed", "ffn_expert"),
         "w_down": L + ("experts", "ffn_expert", "embed")}
    if act == "silu":
        p["w_gate"] = L + ("experts", "embed", "ffn_expert")
    return p


def _capacity(tokens: int, moe: MoEConfig) -> int:
    c = int(moe.top_k * tokens * moe.capacity_factor / moe.num_experts)
    return max(c, 1)


def _route(x2d, router, top_k: int):
    """(probs (T, k) float32, ids (T, k) int64): the top-k experts of each
    token by float32 router logits, lower index first on ties, and the
    softmax over their k logits."""
    logits = x2d.to(torch.float32) @ router.to(torch.float32)
    vals, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    return torch.softmax(vals[:, :top_k], dim=-1), ids[:, :top_k]


def _dispatch_combine(x2d, probs, ids, expert_fn, num_experts: int,
                      cap: int):
    """Scatter the kept (token, expert) pairs to (E, C, d), run
    ``expert_fn`` on them, combine each token's kept rows back."""
    t, d = x2d.shape
    k = ids.shape[1]
    flat_ids = ids.reshape(-1)                            # (T*k,)
    tok_idx = torch.arange(t, device=x2d.device)[:, None].expand(t, k) \
        .reshape(-1)
    experts = torch.arange(num_experts, device=x2d.device)
    oh = (flat_ids[:, None] == experts).to(torch.int32)
    pos = torch.cumsum(oh, dim=0) - 1                     # running count
    pos = pos.gather(1, flat_ids[:, None])[:, 0]
    keep = pos < cap
    dest = torch.where(keep, flat_ids * cap + pos,
                       torch.full_like(flat_ids, num_experts * cap))
    kept = keep[:, None].to(x2d.dtype)
    disp = x2d.new_zeros((num_experts * cap + 1, d))
    disp[dest] = x2d[tok_idx] * kept                      # the drop row: 0s
    h = expert_fn(disp[:-1].reshape(num_experts, cap, d))
    h = torch.cat([h.reshape(num_experts * cap, d), h.new_zeros((1, d))])
    w = probs.reshape(-1)[:, None].to(h.dtype) * keep[:, None].to(h.dtype)
    gathered = (h[dest] * w).to(x2d.dtype).reshape(t, k, d)
    out = x2d.new_zeros((t, d))
    for j in range(k):                                    # JAX's add order
        out = out + gathered[:, j]
    return out


def _expert_ffn(blocks, p, act: str, cdt):
    """blocks: (E, C, d); expert weights (E, d, ff) / (E, ff, d), all in
    the compute dtype (this rank's ff columns and rows where the rules
    split ``ffn_expert``, the partial products then summed over the
    ranks)."""
    blocks = blocks.to(cdt)
    up = torch.bmm(blocks, p["w_up"].to(cdt))
    if act == "silu":
        z = F.silu(torch.bmm(blocks, p["w_gate"].to(cdt))) * up
    else:
        z = _act(up, act)
    y = torch.bmm(z, p["w_down"].to(cdt))
    ax = split_axes("ffn_expert")
    return psum(y, ax) if ax else y


def moe_ffn_local(x, p, moe: MoEConfig, act: str, cdt):
    """(B, S, d) -> (B, S, d), every token of the call routed together."""
    b, s, d = x.shape
    x2 = x.reshape(-1, d)
    probs, ids = _route(x2, p["router"], moe.top_k)
    cap = _capacity(x2.shape[0], moe)
    y = _dispatch_combine(x2, probs, ids,
                          lambda blk: _expert_ffn(blk, p, act, cdt),
                          moe.num_experts, cap)
    return y.reshape(b, s, d)


#: this thread's :class:`prefer_local` depth
_LOCAL = threading.local()


class prefer_local:
    """Inside the block :func:`moe_ffn_sharded` takes the local path (JAX's
    switch for decode, whose one token a slot is too few for the token
    split and the exchanges to pay off; JAX's models never enter it)."""
    def __enter__(self):
        _LOCAL.depth = getattr(_LOCAL, "depth", 0) + 1

    def __exit__(self, *exc):
        _LOCAL.depth -= 1


def _expert_block(w, e: int, e_local: int, j: int):
    """Rank ``j``'s ``e_local`` experts of a stacked expert leaf: a slice
    of the whole stack (``e`` experts), or the leaf itself where it holds
    that rank's experts only."""
    if w.shape[0] == e:
        return w[j * e_local:(j + 1) * e_local]
    if w.shape[0] == e_local:
        return w
    raise ValueError(f"moe_ffn_sharded: an expert leaf of {w.shape[0]} "
                     f"experts, expected {e} or this rank's {e_local}")


def moe_ffn_sharded(x, p, moe: MoEConfig, act: str, cdt,
                    model_axis: str = "model"):
    """JAX's expert-parallel path, rank-local. ``x`` (B, S, d) is this
    rank's batch (its DP block, whole across ``model_axis``); the expert
    leaves hold every expert or this rank's E / model. The steps: pad the
    tokens to a multiple of the axis size (zero rows, routed like any
    token, cut at the end), take this rank's slice, route it with the
    capacity of a slice, ``all_to_all`` the (E, C, d) dispatch blocks to
    the experts' ranks, run this rank's experts (cast to ``cdt``), send
    the blocks back, combine, and ``all_gather`` every rank's tokens. The
    local path under JAX's conditions (module docstring)."""
    nm = axis_size(model_axis)
    if current_mesh() is None or nm == 1 or moe.num_experts % nm \
            or getattr(_LOCAL, "depth", 0):
        return moe_ffn_local(x, p, moe, act, cdt)
    e_local = moe.num_experts // nm
    j = axis_index(model_axis)
    b, s, d = x.shape
    t2 = x.reshape(-1, d)
    t = t2.shape[0]
    t_pad = -(-t // nm) * nm
    tloc = t_pad // nm
    xj = F.pad(t2, (0, 0, 0, t_pad - t))[j * tloc:(j + 1) * tloc]
    probs, ids = _route(xj, p["router"], moe.top_k)
    cap = _capacity(tloc, moe)
    pw = {k: _expert_block(v, moe.num_experts, e_local, j).to(cdt)
          for k, v in p.items() if k != "router"}

    def experts_a2a(blocks):                          # (E, C, d)
        de = all_to_all(blocks, model_axis, 0, 1)     # (E/nm, nm*C, d)
        h = _expert_ffn(de, pw, act, cdt)
        return all_to_all(h, model_axis, 1, 0)        # (E, C, d)

    yj = _dispatch_combine(xj, probs, ids, experts_a2a, moe.num_experts, cap)
    y = all_gather(yj, model_axis, dim=0)             # (t_pad, d)
    return y[:t].reshape(b, s, d)


def moe_ffn(x, p, moe: MoEConfig, act: str, cdt):
    """The MoE FFN of a layer, through :func:`moe_ffn_sharded` as in
    JAX: the local path outside a mesh."""
    return moe_ffn_sharded(x, p, moe, act, cdt)
