"""Mixture-of-Experts FFN with capacity dispatch: the local path.

Port of the local path of ``repro/models/moe.py``. Dispatch is GShard-style
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

``moe_ffn`` is the local path: the expert-parallel ``moe_ffn_sharded``
(``shard_map`` over a mesh's model axis) waits for the port's sharding
(ROADMAP.md, A8).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig

from .blocks import _act, stacked_normal


def init_moe(generator: torch.Generator, d: int, moe: MoEConfig, act: str,
             dtype, *, n_layers: int = 0) -> dict:
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
    return stacked_normal(generator, shapes, dtype, n_layers)


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
    the compute dtype."""
    blocks = blocks.to(cdt)
    up = torch.bmm(blocks, p["w_up"].to(cdt))
    if act == "silu":
        z = F.silu(torch.bmm(blocks, p["w_gate"].to(cdt))) * up
    else:
        z = _act(up, act)
    return torch.bmm(z, p["w_down"].to(cdt))


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


def moe_ffn(x, p, moe: MoEConfig, act: str, cdt):
    """The MoE FFN of a layer: the local path (module docstring)."""
    return moe_ffn_local(x, p, moe, act, cdt)


def moe_ffn_sharded(x, p, moe: MoEConfig, act: str, cdt,
                    model_axis: str = "model"):
    raise NotImplementedError(
        "moe_ffn_sharded: expert parallelism over a mesh waits for the "
        "port's sharding (ROADMAP.md, A8); moe_ffn runs the local path")
