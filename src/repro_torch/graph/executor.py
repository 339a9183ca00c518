"""Plan executor: the integer network as one callable.

Port of ``repro/graph/executor.py``. :class:`CompiledPlan` takes a lowered
:class:`~repro_torch.graph.lower.Plan` and runs it eagerly: activations
stay int8 from the input quantization to the global average pool — ReLU
runs as the conv kernels' accumulator-scale epilogue and pooling runs on
int8 codes (``kernels.ops.maxpool2d``) — and the float head (gap -> dense)
is plain PyTorch ``mean`` and ``@`` in full float32, as the JAX package
leaves it to XLA.

``method="cuda"`` runs every conv and pool node through the CUDA kernels
(never through their plain versions; a node the kernels cannot express
raises), ``method="torch"`` through the plain versions. On the CPU both
run the plain versions.

Launch configs (``repro_torch.tune``): under ``"cuda"`` each qconv node's
per-stage configs are looked up once per node and batch bucket (memo,
then the installed cache, then the analytic model), checked against the
tuner's space when ``validate`` is on, recorded in ``node_configs`` and
passed to ``qconv_apply``; pool nodes look theirs up in ``ops``. No
config changes an output, so a tuned plan's trunk is bitwise the
untuned one's. :meth:`CompiledPlan.throughput` reports images/s.

Observability (``repro_torch.obs``): ``__call__``/``forward_batch`` emit a
span when tracing is on.

There is no ``degrade_to_xla`` counterpart: a plan never switches itself to
the plain versions, so a kernel that fails raises to the caller.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.qconv import qconv_apply
from repro_torch.core.quantize import QTensor, QTensorW4, quantize, requantize
from repro_torch.device import exact_float32, resolve_device
from repro_torch.kernels import ops as K
from repro_torch.kernels.common import apply_act
from repro_torch.kernels.ops import METHODS
from repro_torch.obs import trace as obs_trace

from .ir import Graph
from .lower import Plan, PlanNode


def _qbn_apply(qp: dict, x: QTensor, out_fb: int, act) -> QTensor:
    """Integer per-channel BN affine: int8 act * int32 multiplier + bias at
    accumulator scale, fused act, Algorithm-1 requantization. Plain int32
    PyTorch under both methods, as the JAX package leaves it to XLA."""
    acc = x.q.to(torch.int32) * qp["a"] + qp["b"]
    acc = apply_act(acc, act)
    return QTensor(requantize(acc, x.frac_bits + qp["a_frac_bits"], out_fb),
                   out_fb)


def _node_dtype(node: PlanNode) -> str:
    """The tuner's dtype key of one qconv node: "w4a8" when its weights are
    nibble-packed, else "int8"."""
    if any(isinstance(v, QTensorW4) for v in (node.qparams or {}).values()):
        return "w4a8"
    return "int8"


class CompiledPlan:
    """Callable integer-only forward for one lowered plan on ``device``.

    The plan's tensors must live on ``device``; inputs (tensors or numpy
    arrays) are moved there. ``validate=True`` checks every resolved launch
    config against the tuner's space (a stale or hand-edited cache entry
    raises ``ValueError`` naming the node)."""

    def __init__(self, plan: Plan, *, method: str = "cuda", device="cuda",
                 validate: bool = True):
        if method not in METHODS:
            raise ValueError(f"unknown method {method!r}; expected one of "
                             f"{METHODS}")
        self.plan = plan
        self.method = method
        self.device = resolve_device(device)
        self.validate = validate
        #: node name -> its stage configs at the last resolved batch
        self.node_configs: Dict[str, dict] = {}
        self._configs: Dict[tuple, dict] = {}

    # ------------------------------------------------------------- dispatch

    def _resolve_configs(self, node: PlanNode, xq: QTensor) -> Optional[dict]:
        """The launch configs of one qconv node's stages at this input
        shape, looked up once per node and batch bucket."""
        if self.method != "cuda":
            return None
        n, h, w, c = xq.q.shape
        key = (node.name, n, h, w)
        cfg = self._configs.get(key)
        if cfg is None:
            from repro_torch import tune
            spec = node.spec
            p = spec.primitive
            if p in ("standard", "grouped"):
                g = spec.groups if p == "grouped" else 1
                sigs = {"main": tune.sig_conv2d(n, h, w, c, spec.out_channels,
                                                spec.kernel_size, g)}
            elif p == "dws":
                sigs = {"dw": tune.sig_depthwise2d(n, h, w, c,
                                                   spec.kernel_size),
                        "pw": tune.sig_conv2d(n, h, w, c, spec.out_channels,
                                              1, 1)}
            elif p == "shift":
                sigs = {"main": tune.sig_shift_conv2d(
                    n, h, w, c, spec.out_channels,
                    max(1, spec.kernel_size // 2))}
            else:                        # add
                sigs = {"main": tune.sig_add_conv2d(n, h, w, c,
                                                    spec.out_channels,
                                                    spec.kernel_size)}
            dt = _node_dtype(node)
            cfg = {stage: tune.get_config(sig, dt, self.device)
                   for stage, sig in sigs.items()}
            if self.validate:
                for stage, sig in sigs.items():
                    try:
                        tune.check_config(sig, cfg[stage], dt)
                    except ValueError as e:
                        raise ValueError(f"node {node.name!r}, stage "
                                         f"{stage!r}: {e}") from e
            self._configs[key] = cfg
        self.node_configs[node.name] = cfg
        return cfg

    # -------------------------------------------------------------- forward

    def _run_node(self, node: PlanNode, h):
        if node.op == "qconv":
            return qconv_apply(node.qparams, h, node.spec, node.out_fb,
                               method=self.method, act=node.act,
                               configs=self._resolve_configs(node, h))
        if node.op == "qbn":
            return _qbn_apply(node.qparams, h, node.out_fb, node.act)
        if node.op == "maxpool":
            q = K.maxpool2d(h.q, window=node.attrs["window"],
                            stride=node.attrs["stride"], method=self.method)
            return QTensor(q, h.frac_bits)
        if node.op == "gap":             # head boundary: int8 -> float
            return h.dequantize().mean(dim=(1, 2))
        if node.op == "dense":
            return h @ node.qparams["w"]
        raise ValueError(f"unknown plan op {node.op!r}")

    def _input(self, x) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return x.to(device=self.device, dtype=torch.float32)

    def _forward(self, x, *, stop_at_gap: bool = False):
        h = quantize(self._input(x), self.plan.in_fb)
        with exact_float32():
            for node in self.plan.nodes:
                if stop_at_gap and node.op == "gap":
                    break
                h = self._run_node(node, h)
        return h

    def trunk(self, x) -> QTensor:
        """The int8 activation fed into ``gap``: the integer trunk, which
        tests compare bitwise."""
        return self._forward(x, stop_at_gap=True)

    def __call__(self, x) -> torch.Tensor:
        with obs_trace.span("plan.forward", n=x.shape[0]):
            return self._forward(x)

    # ------------------------------------------------------ batched serving

    @staticmethod
    def batch_bucket(n: int) -> int:
        """Smallest power of two >= n: the batch sizes forward_batch runs,
        so ragged rounds reuse a few shapes."""
        b = 1
        while b < n:
            b *= 2
        return b

    def forward_batch(self, x) -> torch.Tensor:
        """One batched forward, zero-padded up to the pow2 batch bucket and
        cropped back. The int8 trunk is bit-exact with the per-sample loop
        (every plan op is row-independent); the float head agrees to float
        rounding only."""
        x = self._input(x)
        n = x.shape[0]
        b = self.batch_bucket(n)
        with obs_trace.span("plan.forward_batch", n=n, bucket=b):
            if b != n:
                x = torch.cat([x, x.new_zeros((b - n,) + tuple(x.shape[1:]))])
            return self._forward(x)[:n]

    def throughput(self, x, *, reps: int = 5, warmup: int = 2) -> dict:
        """Measured images/s of :meth:`forward_batch` at ``x``'s batch size:
        median wall-clock time per batch after ``warmup`` calls, each call
        ending in ``torch.cuda.synchronize`` on a card (what a caller
        waits)."""
        from repro_torch.tune.runner import time_config
        x = self._input(x)
        us = time_config(self.forward_batch, x, reps=reps, warmup=warmup)
        n = x.shape[0]
        return {"batch": n, "bucket": self.batch_bucket(n),
                "us_per_batch": us, "us_per_image": us / n,
                "images_per_s": 1e6 * n / us}


# ---------------------------------------------------------------- references

def float_forward(graph: Graph, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Float inference over the IR (BN inference buffers, no stat
    re-estimation) — the eval path of ``models.convnet.cnn_forward``."""
    from .lower import interpret
    return interpret(graph, params, x)["acts"][graph.output]
