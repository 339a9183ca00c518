"""repro_torch.graph — layer-graph IR, lowering (BN fold + single-sweep
PTQ + requant/ReLU/pool fusion) and the integer executor (ports of
``repro/graph``)."""
from .executor import CompiledPlan, float_forward, unfused_forward
from .ir import Graph, Node, build_cnn_graph, params_for
from .lower import Plan, PlanNode, annotate, lower

__all__ = [
    "Graph", "Node", "build_cnn_graph", "params_for",
    "Plan", "PlanNode", "annotate", "lower",
    "CompiledPlan", "float_forward", "unfused_forward",
]
