"""Lowering passes: float graph + params + calibration data -> integer Plan.

Port of ``repro/graph/lower.py`` for the five primitives, with int8 or
nibble-packed W4 weights (``lower(..., weight_bits=4)``):

1. **annotate** — run the calibration batch through the float graph once,
   recording every node's activation; BN statistics are read off the conv
   outputs during the same sweep. On a card the sweep runs in full float32
   (``device.exact_float32``: cuDNN's TF32 default would move frac bits).
2. **quantize** — per conv block: BN-fold (``core.folding.fold``),
   power-of-two PTQ (``core.quantize``: per tensor, or per scale group
   for W4), output frac bits from the post-BN+ReLU calibration activation
   (paper Eq. 4). Add-conv cannot fold (|x - w| is not linear in w): its
   BN becomes an integer ``qbn`` node, a per-channel multiplier and bias
   (:func:`_quantize_bn_affine`).
3. **fuse** — ReLU becomes the producer kernel's ``act="relu"`` epilogue,
   max-pool an int8 ``maxpool`` node at the producer's scale, and every
   consumer reads its input at the producer's annotated frac bits:
   activations stay int8 from the first conv to the global average pool.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import apply, batchnorm_apply, fold
from repro_torch.core.folding import FOLDABLE
from repro_torch.core.primitives import ConvSpec
from repro_torch.core.qconv import quantize_conv_params
from repro_torch.core.quantize import frac_bits_for
from repro_torch.device import exact_float32

from .ir import Graph, params_for

PLAN_OPS = ("qconv", "qbn", "maxpool", "gap", "dense")


@dataclasses.dataclass
class PlanNode:
    """One executable step of the lowered plan.

    ``qparams`` holds the node's quantized parameters (QTensor or
    QTensorW4 leaves and a shift node's int32 ``shifts`` table for qconv;
    int32 ``a``/``b`` and the int ``a_frac_bits`` for qbn; the float head
    for dense). ``in_fb``/``out_fb`` are the annotated power-of-two
    scales; the implied requantization shift is chained into the kernel
    epilogue by the executor. ``act`` is the fused activation ("relu" or
    None).
    """

    name: str
    op: str
    spec: Optional[ConvSpec] = None
    qparams: Optional[dict] = None
    in_fb: Optional[int] = None
    out_fb: Optional[int] = None
    act: Optional[str] = None
    attrs: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.op not in PLAN_OPS:
            raise ValueError(f"unknown plan op {self.op!r}; known: {PLAN_OPS}")


@dataclasses.dataclass
class Plan:
    """Topologically-ordered integer execution plan for one model.
    ``graph`` is the IR it was lowered from (None for a plan loaded from
    plain data, ``weights.plan_from_numpy``)."""

    nodes: Tuple[PlanNode, ...]
    in_fb: int                      # input quantization frac bits
    graph: Optional[Graph] = None

    def conv_nodes(self) -> Tuple[PlanNode, ...]:
        return tuple(n for n in self.nodes if n.op == "qconv")


# -------------------------------------------- float interpreter + annotate --

def interpret(graph: Graph, params: dict, x: torch.Tensor, *,
              calibrate: bool = False) -> dict:
    """The float interpreter over the IR — float inference
    (``executor.float_forward``), BN re-estimation
    (``models.convnet.calibrate_bn``) and the lowering calibration sweep
    (:func:`annotate`). ``calibrate=True`` overwrites each BN node's
    buffers with the activation mean/var of its producing conv (recorded
    in the returned ``"bn"`` dict) before normalizing."""
    from repro_torch.kernels.ref import maxpool2d_ref
    node_params = params_for(graph, params)
    acts: Dict[str, torch.Tensor] = {graph.input: x}
    bn_calib: Dict[str, dict] = {}
    with exact_float32():
        for n in graph.nodes:
            h = acts[n.inputs[0]]
            if n.op == "conv":
                acts[n.name] = apply(node_params[n.name], h, n.spec)
            elif n.op == "bn":
                bn = node_params[n.name]
                if calibrate:
                    bn = dict(bn,
                              mean=h.mean(dim=(0, 1, 2)).to(torch.float32),
                              var=h.var(dim=(0, 1, 2), correction=0)
                              .to(torch.float32))
                    bn_calib[n.name] = bn
                acts[n.name] = batchnorm_apply(bn, h)
            elif n.op == "relu":
                acts[n.name] = torch.relu(h)
            elif n.op == "pool":
                acts[n.name] = maxpool2d_ref(h, window=n.attr("window", 2),
                                             stride=n.attr("stride", 2))
            elif n.op == "gap":
                acts[n.name] = h.mean(dim=(1, 2))
            elif n.op == "dense":
                acts[n.name] = h @ node_params[n.name]["w"]
    return {"acts": acts, "bn": bn_calib, "params": node_params}


def annotate(graph: Graph, params: dict, calib_x: torch.Tensor) -> dict:
    """One calibration sweep: every node's float activation + calibrated BN
    buffers (activation mean/var of the producing conv)."""
    return interpret(graph, params, calib_x, calibrate=True)


# ----------------------------------------------- pass 2+3: quantize + fuse --

def _quantize_bn_affine(bn: dict, in_fb: int, eps: float = 1e-5) -> dict:
    """Integer lowering of an unfoldable BN: y = a*x + b as a per-channel
    int32 multiplier at a power-of-two scale plus an int32 bias at the
    accumulator scale (NNoM-style integer BN). The multiplier gets a
    15-frac-bit budget, capped so that the accumulator scale stays at most
    24 frac bits and the largest |b| * 2^acc_fb below 2^30. ``a`` is
    computed in float32 and rounded half to even, as the JAX package does."""
    a = bn["gamma"] * (bn["var"] + eps) ** -0.5
    b = bn["beta"] - bn["mean"] * a
    m = float(a.abs().max())
    fb_a = 15 - math.ceil(math.log2(m)) if m > 0 else 15
    mb = float(b.abs().max())
    cap = 24 if mb <= 0 else min(24, 30 - math.ceil(math.log2(mb)))
    fb_a = max(0, min(fb_a, cap - in_fb))
    acc_fb = in_fb + fb_a
    return {
        "a": torch.round(a * 2.0 ** fb_a).to(torch.int32),
        "b": torch.round(b * 2.0 ** acc_fb).to(torch.int32),
        "a_frac_bits": fb_a,
    }


def lower(graph: Graph, params: dict, calib_x: torch.Tensor, *,
          weight_bits: int = 8, group_size: int = 32) -> Plan:
    """Lower a float graph to an integer-only Plan (single calibration
    sweep; see the module docstring). The plan's tensors live on
    ``calib_x``'s device.

    ``weight_bits=4`` lowers every conv / dws / shift / add weight tensor to
    nibble-packed W4 with per-group scales (``group_size`` elements per
    scale group along the unpack axis); the executor then runs the packed
    kernel modes (W4A8). Activations and the scale chaining are unchanged,
    int8 end to end."""
    ann = annotate(graph, params, calib_x)
    acts, bn_calib, node_params = ann["acts"], ann["bn"], ann["params"]
    in_fb = frac_bits_for(calib_x)

    # producer scale chaining: value name -> frac bits of its int8 encoding
    fb: Dict[str, int] = {graph.input: in_fb}
    plan_nodes = []
    consumed = set()                   # bn/relu nodes fused into a producer

    for n in graph.nodes:
        if n.name in consumed:
            continue
        src = n.inputs[0]
        if n.op == "conv":
            spec = n.spec
            conv_p = node_params[n.name]
            # fuse the conv -> bn -> relu chain of this block
            bnode = next((c for c in graph.consumers(n.name) if c.op == "bn"),
                         None)
            rnode = None
            if bnode is not None:
                rnode = next((c for c in graph.consumers(bnode.name)
                              if c.op == "relu"), None)
            tail = rnode or bnode or n           # last fused float node
            out_fb = frac_bits_for(acts[tail.name])
            h_in, w_in = acts[src].shape[1], acts[src].shape[2]
            act = "relu" if rnode is not None else None
            if bnode is not None and spec.primitive not in FOLDABLE:
                # add-conv: the conv at its own scale, then an integer BN
                conv_fb = frac_bits_for(acts[n.name])
                qp = quantize_conv_params(conv_p, spec, bits=weight_bits,
                                          group_size=group_size)
                plan_nodes.append(PlanNode(
                    n.name, "qconv", spec=spec, qparams=qp, in_fb=fb[src],
                    out_fb=conv_fb, act=None, attrs={"in_hw": (h_in, w_in)}))
                fb[n.name] = conv_fb
                plan_nodes.append(PlanNode(
                    bnode.name, "qbn",
                    qparams=_quantize_bn_affine(bn_calib[bnode.name],
                                                conv_fb),
                    in_fb=conv_fb, out_fb=out_fb, act=act))
            else:
                if bnode is not None:
                    conv_p = fold(conv_p, bn_calib[bnode.name], spec)
                qp = quantize_conv_params(conv_p, spec, bits=weight_bits,
                                          group_size=group_size)
                plan_nodes.append(PlanNode(
                    n.name, "qconv", spec=spec, qparams=qp, in_fb=fb[src],
                    out_fb=out_fb, act=act, attrs={"in_hw": (h_in, w_in)}))
            consumed.update(c.name for c in (bnode, rnode) if c)
            fb[tail.name] = out_fb
        elif n.op == "pool":
            # int8 max-pool at the producer's scale (max commutes with the
            # positive pow2 dequantization, so this is exact)
            plan_nodes.append(PlanNode(
                n.name, "maxpool", in_fb=fb[src], out_fb=fb[src],
                attrs={"window": n.attr("window", 2),
                       "stride": n.attr("stride", 2),
                       "in_hw": (acts[src].shape[1], acts[src].shape[2]),
                       "in_ch": acts[src].shape[3]}))
            fb[n.name] = fb[src]
        elif n.op == "gap":
            plan_nodes.append(PlanNode(n.name, "gap", in_fb=fb[src]))
        elif n.op == "dense":
            plan_nodes.append(PlanNode(
                n.name, "dense", qparams={"w": node_params[n.name]["w"]}))
        elif n.op in ("bn", "relu"):
            raise ValueError(f"dangling {n.op} node {n.name!r}: lowering "
                             "only fuses bn/relu chained behind a conv")
    return Plan(tuple(plan_nodes), in_fb, graph)
