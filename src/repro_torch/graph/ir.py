"""Layer-graph IR: the network as data, built from ``CNNConfig``.

Port of ``repro/graph/ir.py``, unchanged in logic.

A :class:`Graph` is a topologically-ordered tuple of :class:`Node`\\ s over
named values; each node names its op, its input values, and (for conv
nodes) its :class:`~repro_torch.core.primitives.ConvSpec`. The IR is deliberately
small — exactly the ops the paper's NNoM deployments chain: the five
convolution primitives (one ``conv`` op, primitive selected by the spec),
BN, ReLU, max-pool, global average pool, and the dense head.

The IR stage is *structural only*: no parameters, no scales. Lowering
(``graph/lower.py``) pairs it with trained parameters + calibration data to
produce an executable integer :class:`~repro_torch.graph.lower.Plan`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.core.primitives import ConvSpec

OPS = ("conv", "bn", "relu", "pool", "gap", "dense")


@dataclasses.dataclass(frozen=True)
class Node:
    """One layer: ``op`` over ``inputs`` producing the value named ``name``."""

    name: str
    op: str
    inputs: Tuple[str, ...]
    spec: Optional[ConvSpec] = None     # conv nodes only
    attrs: tuple = ()                   # static kwargs, e.g. pool window

    def __post_init__(self):
        if self.op not in OPS:
            raise ValueError(f"unknown graph op {self.op!r}; known: {OPS}")
        if self.op == "conv" and self.spec is None:
            raise ValueError(f"conv node {self.name!r} needs a ConvSpec")

    def attr(self, key, default=None):
        return dict(self.attrs).get(key, default)


@dataclasses.dataclass(frozen=True)
class Graph:
    """Topologically-ordered layer graph; ``input`` names the graph input."""

    nodes: Tuple[Node, ...]
    input: str = "x"

    def __post_init__(self):
        seen = {self.input}
        for n in self.nodes:
            for i in n.inputs:
                if i not in seen:
                    raise ValueError(f"node {n.name!r} consumes {i!r} before "
                                     "it is produced (not topological?)")
            seen.add(n.name)

    def node(self, name: str) -> Node:
        for n in self.nodes:
            if n.name == name:
                return n
        raise KeyError(name)

    def consumers(self, name: str) -> Tuple[Node, ...]:
        return tuple(n for n in self.nodes if name in n.inputs)

    @property
    def output(self) -> str:
        return self.nodes[-1].name


def build_cnn_graph(cfg) -> Graph:
    """The paper-side CNN as a graph: per block conv -> bn -> relu -> pool,
    then gap -> dense. ``cfg`` is a ``models.convnet.CNNConfig``; the
    per-block specs replicate its primitive-selection rules exactly (the
    grouped/dws/shift stem fallbacks), so graph execution and the legacy
    loop agree layer for layer."""
    from repro_torch.models.convnet import _specs   # single source of spec rules
    nodes = []
    prev = "x"
    for i, spec in enumerate(_specs(cfg)):
        nodes.append(Node(f"conv{i}", "conv", (prev,), spec=spec))
        nodes.append(Node(f"bn{i}", "bn", (f"conv{i}",)))
        nodes.append(Node(f"relu{i}", "relu", (f"bn{i}",)))
        nodes.append(Node(f"pool{i}", "pool", (f"relu{i}",),
                          attrs=(("window", 2), ("stride", 2))))
        prev = f"pool{i}"
    nodes.append(Node("gap", "gap", (prev,)))
    nodes.append(Node("head", "dense", ("gap",),
                      attrs=(("features", cfg.num_classes),)))
    return Graph(tuple(nodes))


def params_for(graph: Graph, params: dict) -> Dict[str, dict]:
    """Map graph node names to the CNN parameter pytree's leaves: conv{i} /
    bn{i} index ``params["blocks"]``, the dense head takes ``params["head"]``.
    """
    out: Dict[str, dict] = {}
    for n in graph.nodes:
        if n.op in ("conv", "bn"):
            idx = int(n.name[len(n.op):])
            blk = params["blocks"][idx]
            out[n.name] = blk["conv"] if n.op == "conv" else blk["bn"]
        elif n.op == "dense":
            out[n.name] = {"w": params["head"]}
    return out
