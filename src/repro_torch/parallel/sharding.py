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

Not ported yet: ``constrain`` and ``named_sharding``, which act only inside
a sharded step (ROADMAP.md, A8).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


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


_ACTIVE: list = [ShardingRules()]
_MESHES: list = []


def active_rules() -> ShardingRules:
    return _ACTIVE[-1]


class use_rules:
    def __init__(self, rules: ShardingRules):
        self.rules = rules

    def __enter__(self):
        _ACTIVE.append(self.rules)
        return self.rules

    def __exit__(self, *exc):
        _ACTIVE.pop()


class use_mesh:
    """The mesh :func:`current_mesh` returns inside the block (JAX's
    ``with mesh:``)."""
    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        _MESHES.append(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        _MESHES.pop()


def current_mesh():
    return _MESHES[-1] if _MESHES else None


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
