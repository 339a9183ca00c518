"""Trees of tensors: nested dicts, lists and tuples with tensor (or array)
leaves, the port's parameter and optimizer-state layout. The port's
stand-in for the few ``jax.tree_util`` calls the JAX package makes on
such trees. Dict keys are visited in sorted order, as ``jax.tree_util``
flattens them, so leaf order and paths match the JAX package's."""
from __future__ import annotations


def _items(tree):
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    return list(enumerate(tree))


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree of ``rest`` (the same structure); returns a tree of its results."""
    if not _is_node(tree):
        return fn(tree, *rest)
    out = [(k, tree_map(fn, v, *(r[k] for r in rest)))
           for k, v in _items(tree)]
    if isinstance(tree, dict):
        return {k: out_v for k, out_v in out}
    return type(tree)(v for _, v in out)


def leaves(tree) -> list:
    """The leaves in flatten order."""
    return [v for _, v in paths(tree)]


def paths(tree, prefix: str = "") -> list:
    """``(path, leaf)`` pairs in flatten order; a path joins the dict keys
    and list indices with "/" (``blocks/0/conv/w``), as the JAX package's
    checkpointer names its leaves."""
    if not _is_node(tree):
        return [(prefix, tree)]
    out = []
    for k, v in _items(tree):
        out += paths(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def map_with_paths(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over the leaves; returns a tree of its results."""
    if not _is_node(tree):
        return fn(prefix, tree)
    out = {k: map_with_paths(fn, v, f"{prefix}/{k}" if prefix else str(k))
           for k, v in _items(tree)}
    if isinstance(tree, dict):
        return out
    return type(tree)(out[i] for i in range(len(tree)))
