"""Logical-axis sharding rules (DP / FSDP / TP / EP / SP) for the mesh axes
("pod", "data", "model"), over ``torch.distributed``'s ``DeviceMesh``.

Port of ``repro/parallel/sharding.py``: the same :class:`ShardingRules`,
:func:`rules_for`, :func:`make_rules` (its choices and divisibility
checks), :func:`prune_batch_axes` and the active-rules stack. Models name
their tensors' dims with *logical* axes; the active rules map those to
mesh axes. The rules read only a mesh's axis names and sizes
(``mesh_dim_names``, ``size(i)``).

Conventions:
  batch    -> ("pod", "data")       pure DP (pod axis only carries DP)
  heads/ffn/vocab/experts -> "model"  TP / EP
  embed    -> "data" when fsdp=True   ZeRO-3 weight sharding
  kv_seq   -> "model" for SP serve cells (sharded KV cache)

:meth:`ShardingRules.spec` returns a plain tuple of mesh-axis entries, the
port's ``PartitionSpec``. :class:`NamedSharding` (and
:func:`tree_shardings`) is the counterpart of JAX's: a spec on a mesh, its
DTensor placements (``Shard(dim)`` or ``Replicate()`` per mesh dim) and
its per-device ``shard_shape``. A tensor dim that takes two mesh axes is
split by them in the spec's order, which DTensor's placements express only
in the mesh's order; every rule here lists axes in the mesh's order, and a
spec that does not raises.

Inside a sharded step (:class:`use_mesh` over a ``DeviceMesh`` of a real
world, ``launch.world.run_world``) the port runs explicit SPMD, as the
bodies of JAX's ``shard_map`` do: every rank calls the model functions on
plain tensors that hold its own block of the data (:func:`local_shard`,
:func:`shard_tree`), and the layers that split work across ranks say so
with collectives over the current mesh's per-axis groups
(:func:`axis_index`, :func:`psum`, :func:`pmax`, :func:`all_gather`,
:func:`all_to_all`): sequence-parallel decode and expert-parallel MoE.
:func:`constrain` and :func:`named_sharding` are JAX's.

The rules and the mesh are per thread: the card runs a world's ranks as
threads of one process, each inside its own mesh and rules.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    batch: tuple | str | None = ("pod", "data")
    seq: tuple | str | None = None            # activations' seq dim (training)
    kv_seq: tuple | str | None = None         # KV-cache seq dim (SP serve)
    heads: tuple | str | None = "model"       # flattened hq*dh weight dim
    kv_heads: tuple | str | None = "model"    # flattened hkv*dh weight dim
    ffn: tuple | str | None = "model"
    ffn_expert: tuple | str | None = None     # expert hidden dim (2nd shard)
    vocab: tuple | str | None = "model"
    experts: tuple | str | None = "model"
    embed: tuple | str | None = None          # d_model dim of weights (FSDP)
    embed_table: tuple | str | None = None    # d_model dim of the embed table
    d_inner: tuple | str | None = "model"     # mamba inner dim
    layers: tuple | str | None = None         # stacked-layer dim
    d_model_act: tuple | str | None = None    # activations' feature dim

    def spec(self, *names: Optional[str]) -> tuple:
        """The mesh-axis entry of each logical name (``None`` for an
        unsharded dim): the port's ``PartitionSpec``."""
        return tuple(None if n is None else getattr(self, n) for n in names)

    def as_dict(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}


# Default rule sets ---------------------------------------------------------

def rules_for(family: str, *, fsdp: bool = False,
              sp: bool = False) -> ShardingRules:
    kw = {}
    if fsdp:
        kw["embed"] = "data"
    if sp:
        kw["kv_seq"] = "data"
    return ShardingRules(**kw)


def _div(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` (JAX's ``mesh.shape``)."""
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def make_rules(mesh, cfg, kind: str, *, fsdp: bool = False,
               sp: bool = False, shard_residuals: bool = False
               ) -> ShardingRules:
    """Mesh- and arch-aware rules, JAX's choices. Every assignment is
    divisibility-checked so any (arch x shape x mesh) cell gets rules:

    * attention TP only with whole-head divisibility (n_heads % model ==
      0); archs with odd head counts (qwen2 14H, qwen1.5 40H, arctic 56H)
      keep attention replicated across "model"; FFN/experts stay TP/EP.
    * k/v head TP only when n_kv_heads % model == 0.
    * FSDP ("embed" -> DP axes) combines with TP dims into 2-D weight
      sharding; optimizer state inherits it (ZeRO-3).
    * decode and prefill cells shard the KV cache's seq dim over "model".

    kind: train | prefill | decode.
    """
    shape = mesh_shape(mesh)
    nm = shape.get("model", 1)
    dp_axes = tuple(a for a in ("pod", "data") if a in shape)

    def pick(dim: int, axis="model"):
        return axis if _div(dim, nm) else None

    kw = dict(
        heads="model" if _div(cfg.n_heads, nm) else None,
        kv_heads="model" if _div(cfg.n_kv_heads, nm) else None,
        ffn=pick(cfg.d_ff) if cfg.d_ff else None,
        vocab=pick(cfg.vocab),
        experts=pick(cfg.moe.num_experts) if cfg.moe else None,
        ffn_expert=None,
        d_inner=pick(cfg.mamba.expand * cfg.d_model) if cfg.mamba else None,
        batch=dp_axes if dp_axes else None,
    )
    if cfg.moe and kw["experts"] is None:
        kw["ffn_expert"] = pick(cfg.moe.d_ff)
    if fsdp:
        kw["embed"] = dp_axes or None
        kw["embed_table"] = dp_axes or None
    if sp and kind in ("decode", "prefill"):
        kw["kv_seq"] = "model"      # cache seq sharded; prefill writes it
        kw["kv_heads"] = None       # cache spec cannot use "model" twice
    if shard_residuals and _div(cfg.d_model, nm):
        kw["d_model_act"] = "model"
    return ShardingRules(**kw)


#: the logical dims a sharded step's layers split across ranks: batch (DP),
#: the cache's kv_seq (SP decode) and experts (EP MoE)
SPMD_AXES = ("batch", "kv_seq", "experts")


def spmd_rules(rules: ShardingRules) -> ShardingRules:
    """``rules`` cut to what the port's rank-local step splits
    (:data:`SPMD_AXES`); every other dim (heads, ffn, vocab, d_inner, the
    FSDP embed) is computed whole on each rank, so its tensors are held
    whole: the layout :func:`shard_tree` cuts for a sharded step."""
    return dataclasses.replace(rules, **{
        f.name: None for f in dataclasses.fields(rules)
        if f.name not in SPMD_AXES})


def prune_batch_axes(mesh, rules: ShardingRules,
                     global_batch: int) -> ShardingRules:
    """Drop batch axes that do not divide the global batch."""
    axes = rules.batch
    if axes is None:
        return rules
    if isinstance(axes, str):
        axes = (axes,)
    shape = mesh_shape(mesh)
    kept = []
    size = 1
    for a in axes:
        if global_batch % (size * shape[a]) == 0:
            kept.append(a)
            size *= shape[a]
    return dataclasses.replace(rules, batch=tuple(kept) if kept else None)


#: this thread's stacks of active rules and meshes
_LOCAL = threading.local()


def _rules_stack() -> list:
    if not hasattr(_LOCAL, "rules"):
        _LOCAL.rules = [ShardingRules()]
    return _LOCAL.rules


def _mesh_stack() -> list:
    if not hasattr(_LOCAL, "meshes"):
        _LOCAL.meshes = []
    return _LOCAL.meshes


def active_rules() -> ShardingRules:
    return _rules_stack()[-1]


class use_rules:
    def __init__(self, rules: ShardingRules):
        self.rules = rules

    def __enter__(self):
        _rules_stack().append(self.rules)
        return self.rules

    def __exit__(self, *exc):
        _rules_stack().pop()


class use_mesh:
    """The mesh :func:`current_mesh` returns inside the block (JAX's
    ``with mesh:``)."""
    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        _mesh_stack().append(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        _mesh_stack().pop()


def current_mesh():
    meshes = _mesh_stack()
    return meshes[-1] if meshes else None


def axis_size(name) -> int:
    """The product of the current mesh's sizes along ``name`` (an axis or
    a tuple of them); 1 outside a mesh or for an axis it lacks."""
    mesh = current_mesh()
    if mesh is None:
        return 1
    shape = mesh_shape(mesh)
    if isinstance(name, (tuple, list)):
        size = 1
        for n in name:
            size *= shape.get(n, 1)
        return size
    return shape.get(name, 1)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec (:meth:`ShardingRules.spec`'s tuple) on a ``DeviceMesh``."""
    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        """One DTensor placement per mesh dim: ``Shard(i)`` where tensor
        dim i takes that mesh axis, else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard
        names = list(self.mesh.mesh_dim_names)
        out = [Replicate()] * len(names)
        for dim, entry in enumerate(self.spec):
            if entry is None:
                continue
            axes = (entry,) if isinstance(entry, str) else tuple(entry)
            idx = []
            for a in axes:
                if a not in names:
                    raise ValueError(f"spec {self.spec}: no mesh axis {a!r} "
                                     f"in {tuple(names)}")
                i = names.index(a)
                if not isinstance(out[i], Replicate):
                    raise ValueError(f"spec {self.spec} uses mesh axis "
                                     f"{a!r} twice")
                out[i] = Shard(dim)
                idx.append(i)
            if idx != sorted(idx):
                raise ValueError(f"spec {self.spec}: axes {axes} are not in "
                                 f"the mesh's order {tuple(names)}")
        return tuple(out)

    def shard_shape(self, global_shape) -> tuple:
        """The shape of the first device's shard (JAX's
        ``NamedSharding.shard_shape``; a dim that does not divide gets the
        rounded-up size, the largest shard's)."""
        from torch.distributed.tensor._utils import (
            compute_local_shape_and_global_offset)
        global_shape = tuple(global_shape)
        if len(self.spec) > len(global_shape):
            raise ValueError(f"spec {self.spec} has more entries than shape "
                             f"{global_shape} has dims")
        return tuple(compute_local_shape_and_global_offset(
            global_shape, self.mesh, list(self.placements))[0])


def map_specs(fn, specs):
    """``fn`` over the leaves of a tree of logical-name tuples: nested
    dicts whose leaves are tuples (``()`` for a scalar) or ``None``."""
    if isinstance(specs, dict):
        return {k: map_specs(fn, v) for k, v in specs.items()}
    return fn(specs)


def tree_shardings(tree_of_name_tuples, mesh=None):
    """Map a tree of logical-name tuples to :class:`NamedSharding` s under
    the active rules (``None`` or ``()``: replicated)."""
    mesh = mesh or current_mesh()
    if mesh is None:
        raise ValueError("tree_shardings: no mesh given and none current")
    rules = active_rules()
    return map_specs(
        lambda names: NamedSharding(mesh, rules.spec(*(names or ()))),
        tree_of_name_tuples)


def local_bytes(tensors, shardings) -> int:
    """The first device's bytes of a tree of tensors (meta or not) under a
    tree of :class:`NamedSharding` s of the same dict structure; a single
    sharding may stand for a whole subtree."""
    if isinstance(shardings, NamedSharding):
        if isinstance(tensors, dict):
            return sum(local_bytes(t, shardings) for t in tensors.values())
        n = 1
        for d in shardings.shard_shape(tensors.shape):
            n *= d
        return n * tensors.element_size()
    if set(tensors) != set(shardings):
        raise ValueError(f"local_bytes: tensors {sorted(tensors)} against "
                         f"shardings {sorted(shardings)}")
    return sum(local_bytes(tensors[k], shardings[k]) for k in tensors)


# ------------------------------------------------ inside a sharded step --

def constrain(x, *names: Optional[str]):
    """JAX's ``with_sharding_constraint`` by logical names. Outside a mesh
    ``x`` as it is. Inside one, a ``DTensor`` is redistributed to the
    active rules' placements on the current mesh
    (:attr:`NamedSharding.placements`); a plain tensor is rank-local SPMD
    data, its rank's own block, and is returned unchanged (after one type
    check, before any mesh lookup: the model code's calls cost a plain
    tensor nothing more)."""
    if type(x) is torch.Tensor:
        return x
    mesh = current_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, NamedSharding(
        mesh, active_rules().spec(*names)).placements)


def named_sharding(*names: Optional[str], mesh=None):
    """The :class:`NamedSharding` of logical ``names`` under the active
    rules on ``mesh`` (default: the current one); ``None`` outside a
    mesh."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return None
    return NamedSharding(mesh, active_rules().spec(*names))


def local_shard(t, sharding: NamedSharding):
    """This rank's block of the global tensor ``t`` under ``sharding``
    (a view, as DTensor's ``distribute_tensor`` would cut it)."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    shape, offset = compute_local_shape_and_global_offset(
        tuple(t.shape), sharding.mesh, list(sharding.placements))
    return t[tuple(slice(o, o + n) for o, n in zip(offset, shape))]


def shard_tree(tree, specs, mesh=None):
    """This rank's blocks of a tree of global tensors whose logical axis
    names are ``specs`` (the same dict structure), under the active rules
    (a sharded step's: :func:`spmd_rules`): the layout its model functions
    take."""
    shardings = tree_shardings(specs, mesh)

    def cut(t, s):
        if isinstance(t, dict):
            return {k: cut(t[k], s[k]) for k in t}
        return local_shard(t, s)
    return cut(tree, shardings)


def _group(axis: str):
    mesh = current_mesh()
    if mesh is None or axis not in mesh.mesh_dim_names:
        raise ValueError(f"no mesh axis {axis!r} is current")
    return mesh.get_group(axis)


def axis_index(axis: str) -> int:
    """This rank's coordinate along mesh axis ``axis`` (JAX's
    ``lax.axis_index``); 0 outside a mesh or for an axis it lacks."""
    mesh = current_mesh()
    if mesh is None or axis not in mesh.mesh_dim_names:
        return 0
    return mesh.get_local_rank(axis)


def _all_reduce(x, axis: str, op):
    import torch.distributed as dist
    y = x.clone()
    dist.all_reduce(y, op=op, group=_group(axis))
    return y


def psum(x, axis: str):
    """The sum of ``x`` over the ranks of ``axis`` (JAX's ``lax.psum``)."""
    import torch.distributed as dist
    return _all_reduce(x, axis, dist.ReduceOp.SUM)


def pmax(x, axis: str):
    """The elementwise max of ``x`` over the ranks of ``axis``."""
    import torch.distributed as dist
    return _all_reduce(x, axis, dist.ReduceOp.MAX)


def all_gather(x, axis: str, dim: int = 0):
    """Every rank's ``x`` along ``axis``, concatenated along ``dim`` in
    rank order (JAX's tiled ``lax.all_gather``)."""
    import torch
    import torch.distributed as dist
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(axis_size(axis))]
    dist.all_gather(parts, x, group=_group(axis))
    return torch.cat(parts, dim=dim)


def all_to_all(x, axis: str, split_dim: int, concat_dim: int):
    """JAX's tiled ``lax.all_to_all``: ``x`` cut into ``axis_size(axis)``
    blocks along ``split_dim``, block j sent to the rank of index j, and
    the blocks this rank receives concatenated along ``concat_dim`` in
    rank order (``all_to_all_single`` over dim 0)."""
    import torch
    import torch.distributed as dist
    n = axis_size(axis)
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} "
                         f"does not split over {n} ranks of {axis!r}")
    xs = x.movedim(split_dim, 0).contiguous()
    out = torch.empty_like(xs)
    dist.all_to_all_single(out, xs, group=_group(axis))
    return torch.cat([c.movedim(0, split_dim) for c in out.chunk(n)],
                     dim=concat_dim)
