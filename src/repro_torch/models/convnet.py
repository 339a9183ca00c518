"""Paper-side CNN: a small image classifier whose conv blocks all use one
selectable primitive (port of ``repro/models/convnet.py``; all five
primitives run here).

Inference and PTQ run through the ``repro_torch.graph`` layer IR:
``quantize_cnn`` lowers the graph in one calibration sweep and returns the
integer-only executor (activations int8 end to end, fused ReLU/pool
epilogues). ``method="cuda"`` routes every layer through the CUDA kernels.
Training (``cnn_forward(train=True)``) is not ported.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import ConvSpec, init_block
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    primitive: str = "standard"
    groups: int = 2
    widths: tuple = (16, 32, 64)
    kernel_size: int = 3
    num_classes: int = 10
    in_channels: int = 3
    image_size: int = 32


def _specs(cfg: CNNConfig):
    specs = []
    cin = cfg.in_channels
    for w in cfg.widths:
        prim = cfg.primitive
        groups = cfg.groups if prim == "grouped" else 1
        if prim == "grouped" and (cin % groups or w % groups):
            prim, groups = "standard", 1      # first layer: 3 channels
        if prim in ("dws", "shift") and cin < 4:
            prim = "standard"                 # stem stays standard (paperlike)
        specs.append(ConvSpec(primitive=prim, in_channels=cin, out_channels=w,
                              kernel_size=cfg.kernel_size, groups=groups))
        cin = w
    return specs


def init_cnn(cfg: CNNConfig, generator: torch.Generator, *, device="cuda"):
    """Random parameters drawn from ``generator`` (on its own device), moved
    to ``device``."""
    dev = resolve_device(device)
    blocks = [init_block(generator, s, with_bn=True) for s in _specs(cfg)]
    head = (torch.randn((cfg.widths[-1], cfg.num_classes),
                        generator=generator, device=generator.device)
            * cfg.widths[-1] ** -0.5)

    def to(tree):
        if isinstance(tree, dict):
            return {k: to(v) for k, v in tree.items()}
        return tree.to(dev)
    return {"blocks": [to(b) for b in blocks], "head": head.to(dev)}


def cnn_forward(params, x, cfg: CNNConfig, *, train: bool = False):
    """Float inference over the layer-graph IR (BN inference buffers)."""
    if train:
        raise NotImplementedError("training is not ported to repro_torch "
                                  "yet (ROADMAP.md, queue A)")
    from repro_torch.graph import build_cnn_graph, float_forward
    return float_forward(build_cnn_graph(cfg), params, x)


def calibrate_bn(params, cfg: CNNConfig, calib_x):
    """Deployment-time BN statistics re-estimation: one walk of the graph
    interpreter writes each block's activation mean/var into its inference
    BN buffers."""
    from repro_torch.graph import build_cnn_graph
    from repro_torch.graph.lower import interpret
    bn_calib = interpret(build_cnn_graph(cfg), params, calib_x,
                         calibrate=True)["bn"]
    new_blocks = [dict(p, bn=bn_calib[f"bn{i}"])
                  for i, p in enumerate(params["blocks"])]
    return dict(params, blocks=new_blocks)


def quantize_cnn(params, cfg: CNNConfig, calib_x, *, method: str = "cuda",
                 device="cuda"):
    """Post-training quantization (paper scheme) through
    ``repro_torch.graph``: build the IR, lower it in ONE calibration sweep
    on ``device`` (BN re-estimation + folding + power-of-two scale
    annotation + the requant/ReLU/pool fusion pass), and return the
    integer-only :class:`~repro_torch.graph.CompiledPlan`. ``params`` must
    live on ``device``; ``calib_x`` (tensor or numpy) is moved there."""
    from repro_torch.graph import CompiledPlan, build_cnn_graph, lower
    dev = resolve_device(device)
    calib = torch.as_tensor(calib_x, dtype=torch.float32, device=dev)
    plan = lower(build_cnn_graph(cfg), params, calib)
    return CompiledPlan(plan, method=method, device=dev)
