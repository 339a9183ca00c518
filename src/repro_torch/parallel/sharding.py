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
with collectives over the current mesh's groups, of one axis or of a
tuple of them (:func:`axis_index`, :func:`psum`, :func:`pmax`,
:func:`all_gather`, :func:`psum_scatter`, :func:`all_to_all`), each
differentiable with JAX's transpose for its backward. The active rules
decide what a layer splits (:func:`split_axes`): under
``make_rules(mesh, cfg, "train", fsdp=True)`` a rank holds and computes
only its block of the heads, the FFN, the vocabulary, the Mamba channels
and the experts, and its weights' ``embed`` dim is gathered at the start
of each layer (FSDP, :func:`gather_dims`); under :func:`spmd_rules` (the
serve paths: sequence-parallel decode, expert-parallel MoE) every such dim
is whole. :func:`constrain` and :func:`named_sharding` are JAX's.

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
    return local_tree(tree, tree_shardings(specs, mesh))


def local_tree(tree, shardings, *, copy: bool = False):
    """This rank's blocks of a tree of global tensors under a tree of
    :class:`NamedSharding` s of the same structure (``None`` for a leaf or
    subtree held whole); with ``copy``, each block a contiguous tensor of
    its own, not a view of the global one (the blocks a rank updates in
    place)."""
    if isinstance(tree, dict):
        whole = shardings is None or isinstance(shardings, NamedSharding)
        return {k: local_tree(v, shardings if whole else shardings[k],
                              copy=copy)
                for k, v in tree.items()}
    t = tree if shardings is None else local_shard(tree, shardings)
    return t.clone(memory_format=torch.contiguous_format) if copy else t


class taking_turns:
    """Inside the block this thread runs only while it holds ``lock``, a
    lock that every rank thread of a threaded world shares (the card's
    world, ``launch.world``): it takes the lock on entry and gives it up
    only while it waits on the other ranks (:func:`off_turn`: the
    collectives, making a group or a mesh). So one rank runs host code at
    a time, up to its next collective: PyTorch drops the interpreter lock
    around every operation, and ranks all running would trade it at every
    one (on an H100, a Qwen2-0.5B train step on 8 such threads took 26x
    the one-rank step's time, and 8.5x taking turns)."""
    def __init__(self, lock):
        self.lock = lock

    def __enter__(self):
        self.lock.acquire()
        _LOCAL.turn = self.lock
        return self

    def __exit__(self, *exc):
        _LOCAL.turn = None
        self.lock.release()


def off_turn(fn):
    """``fn()`` with this thread's turn (:class:`taking_turns`) given up
    while it runs: every call that waits on other ranks goes through
    here."""
    turn = getattr(_LOCAL, "turn", None)
    if turn is None:
        return fn()
    turn.release()
    try:
        return fn()
    finally:
        turn.acquire()


def _axes(axis) -> tuple:
    """``axis`` (a mesh axis name or a tuple of them) as a tuple."""
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _group(axis):
    """The process group over mesh axis ``axis``, or over the product of a
    tuple of axes (listed in the mesh's order): the ranks that share this
    rank's coordinates on every other axis, in the mesh's major-to-minor
    order of their coordinates on ``axis``, made once a mesh and cached
    on it (``new_group`` with local synchronisation: only its members
    make it)."""
    import torch.distributed as dist
    mesh = current_mesh()
    axes = _axes(axis)
    names = tuple(mesh.mesh_dim_names) if mesh is not None else ()
    if mesh is None or not axes or any(a not in names for a in axes):
        raise ValueError(f"no mesh axis {axis!r} is current")
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    idx = [names.index(a) for a in axes]
    if idx != sorted(set(idx)):
        raise ValueError(f"axes {axes} are not in the mesh's order {names}")
    cache = mesh.__dict__.setdefault("_repro_axis_groups", {})
    if axes not in cache:
        coord = mesh.get_coordinate()
        ranks = mesh.mesh[tuple(slice(None) if i in idx else coord[i]
                                for i in range(len(names)))]
        ranks = ranks.reshape(-1).tolist()
        if ranks != sorted(ranks):
            raise ValueError(f"mesh ranks {ranks} along {axes} are not in "
                             "ascending order")
        cache[axes] = off_turn(lambda: dist.new_group(
            ranks=ranks, use_local_synchronization=True))
    return cache[axes]


def axis_index(axis) -> int:
    """This rank's coordinate along mesh axis ``axis`` (JAX's
    ``lax.axis_index``), or along the product of a tuple of axes in the
    mesh's major-to-minor order; 0 outside a mesh or for an axis it
    lacks."""
    mesh = current_mesh()
    if mesh is None:
        return 0
    index = 0
    for a in _axes(axis):
        if a in mesh.mesh_dim_names:
            index = index * axis_size(a) + mesh.get_local_rank(a)
    return index


def split_axes(name: str) -> tuple:
    """The axes of the current mesh, of size > 1, over which the rank-local
    step splits logical dim ``name``: the entry of the rules the caller
    made active with :class:`use_rules`. Empty outside a mesh, under the
    default rules (no :class:`use_rules` around the call: every dim is
    whole, as the serve paths inside a bare mesh hold it) and where the
    rules name no axis (:func:`spmd_rules`' dims)."""
    mesh = current_mesh()
    stack = _rules_stack()
    if mesh is None or len(stack) < 2:
        return ()
    entry = getattr(stack[-1], name)
    if entry is None:
        return ()
    shape = mesh_shape(mesh)
    return tuple(a for a in _axes(entry) if shape.get(a, 1) > 1)


def spec_axes(names) -> tuple:
    """The mesh axes, in the mesh's order, that split a tensor whose dims
    are the logical ``names`` (:func:`split_axes` of each)."""
    mesh = current_mesh()
    used = {a for n in names or () if n is not None for a in split_axes(n)}
    return tuple(a for a in (mesh.mesh_dim_names if mesh is not None
                             else ()) if a in used)


def mesh_axes() -> tuple:
    """The current mesh's axes of size > 1, in its order."""
    mesh = current_mesh()
    if mesh is None:
        return ()
    return tuple(a for a, n in mesh_shape(mesh).items() if n > 1)


# The collectives. Each is a torch.autograd.Function whose backward is its
# transpose in JAX's shard_map: psum's is psum, all_gather's psum_scatter
# and the other way round, all_to_all's the all_to_all with the split and
# concat dims swapped. So a step differentiates a loss that every rank
# holds whole as shard_map does: each rank seeds 1 / (the mesh's size)
# (train.train_step), and a leaf that ranks hold the same copy of sums its
# ranks' gradients (:func:`psum` over the axes its spec does not name).
#
# Every transfer goes through the four helpers below (_all_reduce, _gather,
# _scatter_sum, _exchange; _GatherMany's through _gather and _scatter_sum),
# and each reports its call to the open roofline counts
# (``roofline.count.counting``): JAX's kind, the operand's bytes on this
# rank, the mesh axes of its group. Meta tensors take the same path (the
# dry run's fake backend takes them).


class _Comm:
    """A collective's group and the current mesh's axes of size > 1 that
    the group spans (what a count records of it)."""
    __slots__ = ("group", "axes")

    def __init__(self, axis):
        self.group = _group(axis)
        self.axes = tuple(a for a in _axes(axis) if axis_size(a) > 1)


def _note(kind: str, x, comm: _Comm):
    from repro_torch.roofline import count
    if count.active():
        count.collective(kind, x.numel() * x.element_size(), comm.axes)


def _all_reduce(x, comm: _Comm, op):
    import torch.distributed as dist
    y = x.detach().clone()
    _note("all-reduce", y, comm)
    off_turn(lambda: dist.all_reduce(y, op=op, group=comm.group))
    return y


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        import torch.distributed as dist
        ctx.comm = comm
        return _all_reduce(x, comm, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        return _all_reduce(g, ctx.comm, dist.ReduceOp.SUM), None


def psum(x, axis):
    """The sum of ``x`` over the ranks of ``axis`` (a mesh axis or a tuple
    of them; JAX's ``lax.psum``); its backward is the psum of the
    gradient."""
    return _PSum.apply(x, _Comm(axis))


def pmax(x, axis):
    """The elementwise max of ``x`` over the ranks of ``axis``; no
    gradient flows through it (a softmax's shift)."""
    import torch.distributed as dist
    return _all_reduce(x, _Comm(axis), dist.ReduceOp.MAX)


def _gather(x, comm: _Comm, n: int, dim: int):
    import torch.distributed as dist
    x = x.contiguous()
    _note("all-gather", x, comm)
    parts = [torch.empty_like(x) for _ in range(n)]
    off_turn(lambda: dist.all_gather(parts, x, group=comm.group))
    return torch.cat(parts, dim=dim)


def _scatter_sum(x, comm: _Comm, n: int, dim: int):
    import torch.distributed as dist
    if x.shape[dim] % n:
        raise ValueError(f"psum_scatter: dim {dim} of {tuple(x.shape)} does "
                         f"not split over {n} ranks")
    _note("reduce-scatter", x, comm)
    chunks = [c.contiguous() for c in x.chunk(n, dim)]
    out = torch.empty_like(chunks[0])
    off_turn(lambda: dist.reduce_scatter(out, chunks, group=comm.group))
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, n, dim):
        ctx.args = (comm, n, dim)
        return _gather(x, comm, n, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, *ctx.args), None, None, None


class _PSumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, n, dim):
        ctx.args = (comm, n, dim)
        return _scatter_sum(x, comm, n, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, *ctx.args), None, None, None


def all_gather(x, axis, dim: int = 0):
    """Every rank's ``x`` along ``axis``, concatenated along ``dim`` in
    rank order (JAX's tiled ``lax.all_gather``; over a tuple of axes, in
    the mesh's major-to-minor order, the order :func:`local_shard` cuts
    a dim that takes them). Its backward is :func:`psum_scatter`."""
    return _AllGather.apply(x, _Comm(axis), axis_size(axis), dim)


def psum_scatter(x, axis, dim: int = 0):
    """This rank's block along ``dim`` of the sum of ``x`` over the ranks
    of ``axis`` (JAX's tiled ``lax.psum_scatter``, a reduce-scatter). Its
    backward is :func:`all_gather`."""
    return _PSumScatter.apply(x, _Comm(axis), axis_size(axis), dim)


def _exchange(x, comm: _Comm, n: int, split_dim: int, concat_dim: int):
    import torch.distributed as dist
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    xs = x.movedim(split_dim, 0).contiguous()
    _note("all-to-all", xs, comm)
    out = torch.empty_like(xs)
    off_turn(lambda: dist.all_to_all_single(out, xs, group=comm.group))
    return torch.cat([c.movedim(0, split_dim) for c in out.chunk(n)],
                     dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, n, split_dim, concat_dim):
        ctx.args = (comm, n, split_dim, concat_dim)
        return _exchange(x, comm, n, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        comm, n, split_dim, concat_dim = ctx.args
        return _exchange(g, comm, n, concat_dim, split_dim), None, None, \
            None, None


def all_to_all(x, axis, split_dim: int, concat_dim: int):
    """JAX's tiled ``lax.all_to_all``: ``x`` cut into ``axis_size(axis)``
    blocks along ``split_dim``, block j sent to the rank of index j, and
    the blocks this rank receives concatenated along ``concat_dim`` in
    rank order (``all_to_all_single`` over dim 0). Its backward is the
    exchange with the two dims swapped."""
    return _AllToAll.apply(x, _Comm(axis), axis_size(axis), split_dim,
                           concat_dim)


class _GatherMany(torch.autograd.Function):
    """:func:`all_gather` of several tensors over one group in one
    collective: their blocks flattened side by side, each rebuilt along
    its own dim; the backward is one reduce-scatter of the gradients,
    each rank's blocks written side by side into one buffer."""

    @staticmethod
    def forward(ctx, comm, n, dims, *xs):
        ctx.args = (comm, n, dims, [x.shape for x in xs])
        flat = torch.cat([x.reshape(-1) for x in xs])
        parts = _gather(flat, comm, n, 0).view(n, -1)
        out, at = [], 0
        for x, dim in zip(xs, dims):
            k = x.numel()
            out.append(torch.cat([parts[r, at:at + k].view(x.shape)
                                  for r in range(n)], dim=dim))
            at += k
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        comm, n, dims, shapes = ctx.args
        sizes = [s.numel() for s in shapes]
        rows = gs[0].new_empty((n, sum(sizes)))
        at = 0
        for g, d, k, s in zip(gs, dims, sizes, shapes):
            for r, c in enumerate(g.chunk(n, d)):
                rows[r, at:at + k].view(s).copy_(c)
            at += k
        mine = _scatter_sum(rows, comm, n, 0)[0]
        return (None, None, None, *(m.view(s) for m, s in
                                    zip(mine.split(sizes), shapes)))


def gather_dims(tree, specs, names):
    """``tree`` (nested dicts of this rank's blocks) with every dim whose
    logical name in ``specs`` (the same structure, a tuple per leaf) is
    one of ``names`` gathered whole over the axes that split it
    (:func:`split_axes`), one collective for all the leaves gathered over
    the same axes; a leaf no such dim splits is returned as it is (so is
    the whole tree outside a sharded step). FSDP's gather of a layer's
    weights (ZeRO-3): its backward reduce-scatters their gradients."""
    flat = []

    def walk(t, s, path):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], s[k], path + (k,))
            return
        for dim, n in enumerate(s or ()):
            if n in names and split_axes(n):
                flat.append((path, t, dim, split_axes(n)))
                return
    walk(tree, specs, ())
    if not flat:
        return tree
    got = {}
    for axes in dict.fromkeys(a for *_, a in flat):
        group = [(p, t, d) for p, t, d, a in flat if a == axes]
        out = _GatherMany.apply(_Comm(axes), axis_size(axes),
                                tuple(d for _, _, d in group),
                                *(t for _, t, _ in group))
        got.update({p: o for (p, _, _), o in zip(group, out)})

    def rebuild(t, path):
        if isinstance(t, dict):
            return {k: rebuild(v, path + (k,)) for k, v in t.items()}
        return got.get(path, t)
    return rebuild(tree, ())
