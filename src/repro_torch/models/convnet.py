"""Paper-side CNN: a small image classifier whose conv blocks all use one
selectable primitive (port of ``repro/models/convnet.py``; all five
primitives run here).

Training runs on the float primitives (``cnn_forward(train=True)``,
:func:`cnn_loss`, :func:`cnn_value_and_grad`, by autograd); inference and
PTQ run through the ``repro_torch.graph`` layer IR: ``quantize_cnn``
lowers the graph in one calibration sweep and returns the integer-only
executor (activations int8 end to end, fused ReLU/pool epilogues).
``method="cuda"`` routes every layer through the CUDA kernels. Together
they are the paper's deployment flow, train -> PTQ -> serve
(``examples/train_cnn_torch.py``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core import ConvSpec, apply_block, init_block
from repro_torch.device import resolve_device
from repro_torch.tree import tree_map


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
    """Logits of a float NHWC batch. ``train=False``: inference over the
    layer-graph IR (BN inference buffers). ``train=True``: every block
    normalises with its batch's statistics (``apply_block(train_stats=)``),
    then a 2x2/2 VALID max-pool, the spatial mean and the head."""
    if not train:
        from repro_torch.graph import build_cnn_graph, float_forward
        return float_forward(build_cnn_graph(cfg), params, x)
    h = x
    for p, s in zip(params["blocks"], _specs(cfg)):
        h = apply_block(p, h, s, train_stats={})
        # the pool's gradient goes to the first maximum of each window, as
        # XLA's reduce_window max routes it
        h = F.max_pool2d(h.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
    return h.mean(dim=(1, 2)) @ params["head"]


def cnn_loss(params, batch, cfg: CNNConfig):
    """(mean log-softmax NLL, top-1 accuracy) of ``batch`` = {"images",
    "labels"} under the training forward."""
    logits = cnn_forward(params, batch["images"], cfg, train=True)
    labels = batch["labels"].long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels[:, None]).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return nll, acc


def cnn_value_and_grad(params, batch, cfg: CNNConfig):
    """``((loss, acc), grads)``: the counterpart of ``jax.value_and_grad(
    cnn_loss, has_aux=True, allow_int=True)``. ``grads`` has ``params``'
    structure. An integer leaf (a shift table) takes no gradient: it gets
    zeros of its own dtype, and the optimizer skips it. A float leaf the
    loss does not read (the BN running statistics) gets float zeros, as
    JAX's gradient has there."""
    marked = []

    def mark(t):
        if t.is_floating_point():
            t = t.detach().requires_grad_(True)
            marked.append(t)
        return t
    p = tree_map(mark, params)
    loss, acc = cnn_loss(p, batch, cfg)
    grads = iter(torch.autograd.grad(loss, marked, allow_unused=True))

    def grad_of(t):
        g = next(grads) if t.is_floating_point() else None
        return torch.zeros_like(t) if g is None else g
    return (loss.detach(), acc), tree_map(grad_of, p)


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
