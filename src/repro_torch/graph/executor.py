"""Plan executor: the integer network as one callable.

Port of ``repro/graph/executor.py``. :class:`CompiledPlan` takes a lowered
:class:`~repro_torch.graph.lower.Plan`: activations stay int8 from the
input quantization to the global average pool (ReLU runs as the conv
kernels' accumulator-scale epilogue and pooling runs on int8 codes,
``kernels.ops.maxpool2d``), and the float head (gap -> dense) is plain
PyTorch ``mean`` and ``@`` in full float32, as the JAX package leaves it to
XLA.

``method="cuda"`` runs every conv and pool node through the CUDA kernels
(never through their plain versions; a node the kernels cannot express,
such as a stride-2 or VALID conv, raises) and ``method="torch"`` through
the plain versions. On the CPU both methods run the plain versions.

``jit=True`` (the default) is the counterpart of ``jax.jit`` over the
whole forward: on a card each batch size is captured once as a CUDA graph
(``torch.cuda.CUDAGraph``) and replayed afterwards, so a forward costs one
graph launch instead of a Python call per node. A size's first call runs
the plan eagerly once (resolving its launch configs, and building the
kernel library at a process's first launch), captures it, then replays
(``graph/capture.py``, which the LM engine shares).
``forward_batch`` captures its pow2 buckets, ``__call__`` and ``trunk``
the batch size they are given; a graph keeps the launch configs it was
captured with, as a jit trace does. Captures count into ``traces`` and
into the process metrics as ``graph.compiles`` and
``graph.compiles.n<batch>``. A failed capture raises; it never falls back
to the eager path. A replay adds to each kernel wrapper's ``launches`` the
launches its capture recorded; the wrapper calls made while capturing
execute nothing and do not count. On a CPU plan there is nothing to
capture: ``jit`` has no effect there and ``traces`` stays 0.
``jit=False`` runs every node from Python on every call.

Static checks (``repro_torch.check``), as the JAX package's: a plan is
verified at build (``validate_plan``: dataflow and int32 overflow), and a
plan that fails raises ``CheckError`` before any kernel runs.

Launch configs (``repro_torch.tune``): each ``"cuda"`` qconv node's
per-stage configs are looked up once per node and batch size (memo, then
the installed cache, then the analytic model), given the Hopper verdict
(``check.check_schedule``) when ``validate`` is on, recorded in
``node_configs`` and passed to ``qconv_apply``; pool nodes look theirs
up in ``ops``. No config changes an output, so a tuned plan's trunk is
bitwise the untuned one's. :meth:`CompiledPlan.throughput` reports
images/s and :meth:`CompiledPlan.profile` the paper's per-layer reading:
measured time, analytic MACs and the MCU latency / energy model
(``core.energy``).

Two more entry points share the plan: :func:`float_forward`, the float
interpreter over the IR, and :func:`unfused_forward`, the float-bounce
regime the fusion pass removes, bitwise equal to the fused trunk.

Observability (``repro_torch.obs``): ``__call__``/``forward_batch`` emit a
span when tracing is on, a capture a ``plan.trace`` span, and ``profile``
one ``layer.<name>`` span per row.

There is no ``degrade_to_xla`` counterpart: a plan never switches itself to
the plain versions, so a kernel that fails raises to the caller.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.energy import MCUModel
from repro_torch.core.qconv import qconv_apply
from repro_torch.core.quantize import QTensor, QTensorW4, quantize, requantize
from repro_torch.device import exact_float32, resolve_device
from repro_torch.kernels import ops as K
from repro_torch.kernels.common import apply_act
from repro_torch.obs import trace as obs_trace

#: the executor's methods, the kernel layer's two
PLAN_METHODS = ("cuda", "torch")

from .capture import CapturedFn, capture
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


def stage_sigs(node: PlanNode, n: int, h: int, w: int, c: int) -> dict:
    """The tuner's signatures of one qconv node's stages on an (n, h, w,
    c) input: ``{"main": sig}``, or ``{"dw": sig, "pw": sig}`` for dws."""
    from repro_torch import tune
    spec = node.spec
    p = spec.primitive
    if p in ("standard", "grouped"):
        g = spec.groups if p == "grouped" else 1
        return {"main": tune.sig_conv2d(n, h, w, c, spec.out_channels,
                                        spec.kernel_size, g)}
    if p == "dws":
        return {"dw": tune.sig_depthwise2d(n, h, w, c, spec.kernel_size),
                "pw": tune.sig_conv2d(n, h, w, c, spec.out_channels, 1, 1)}
    if p == "shift":
        return {"main": tune.sig_shift_conv2d(n, h, w, c, spec.out_channels,
                                              max(1, spec.kernel_size // 2))}
    return {"main": tune.sig_add_conv2d(n, h, w, c, spec.out_channels,
                                        spec.kernel_size)}


class CompiledPlan:
    """Callable integer-only forward for one lowered plan on ``device``.

    The plan's tensors must live on ``device``; inputs (tensors or numpy
    arrays) are moved there. ``validate=True`` (the default) verifies the
    plan at build, before anything is moved, captured or launched
    (``repro_torch.check.validate_plan``: dataflow legality and int32
    accumulator / requant-shift safety from the actual weight codes), and
    gives every launch config a node resolves the hard Hopper verdict
    (``check.check_schedule``, and membership of the tuner's space); each
    failure raises ``repro_torch.check.CheckError`` (a ``ValueError``)
    listing its reasons. ``validate=False`` opts out of both. ``jit``
    captures each batch size as a CUDA graph on a card (module
    docstring)."""

    def __init__(self, plan: Plan, *, method: str = "cuda", device="cuda",
                 jit: bool = True, validate: bool = True):
        if method not in PLAN_METHODS:
            raise ValueError(f"unknown method {method!r}; expected one of "
                             f"{PLAN_METHODS}")
        if validate:
            from repro_torch.check import validate_plan
            validate_plan(plan)
        self.plan = plan
        self.method = method
        self.device = resolve_device(device)
        self.jit = jit
        self.validate = validate
        #: node name -> its stage configs at the last resolved batch
        self.node_configs: Dict[str, dict] = {}
        #: CUDA graph captures made (one per batch size), as JAX counts
        #: traces
        self.traces = 0
        self._configs: Dict[tuple, dict] = {}
        self._graphs: Dict[int, CapturedFn] = {}

    # ------------------------------------------------------------- dispatch

    def _resolve_configs(self, node: PlanNode, xq: QTensor) -> Optional[dict]:
        """The launch configs of one qconv node's stages at this input
        shape, looked up once per node and batch size."""
        if self.method != "cuda":
            return None
        n, h, w, c = xq.q.shape
        key = (node.name, n, h, w)
        cfg = self._configs.get(key)
        if cfg is None:
            from repro_torch import tune
            sigs = stage_sigs(node, n, h, w, c)
            dt = _node_dtype(node)
            cfg = {stage: tune.get_config(sig, dt, self.device)
                   for stage, sig in sigs.items()}
            if self.validate:
                self._check_configs(node, sigs, cfg, dt)
            self._configs[key] = cfg
        self.node_configs[node.name] = cfg
        return cfg

    @staticmethod
    def _check_configs(node: PlanNode, sigs: dict, cfg: dict, dt: str):
        """The hard verdict on every config a node resolved: a stale or
        hand-edited cache entry could smuggle in one that cannot launch
        on the card, or one outside the tuner's space. Raises
        ``CheckError`` naming the node, its stage, its signature and the
        reasons."""
        from repro_torch.check import CheckError
        from repro_torch.check.footprint import check_schedule
        from repro_torch.tune.space import space_errors
        bad = []
        for stage, sig in sigs.items():
            v = check_schedule(sig, cfg[stage], dt)
            errs = v.errors or space_errors(sig, cfg[stage], dt)
            bad.extend(f"node {node.name!r}, stage {stage!r} "
                       f"[{sig.kernel}/{sig.key()}] {cfg[stage]}: {e}"
                       for e in errs)
        if bad:
            raise CheckError(
                f"infeasible kernel schedule for node {node.name!r} "
                "(repro_torch.check.check_schedule; pass validate=False to "
                "bypass):", bad)

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
                            stride=node.attrs["stride"],
                            method=self.method)
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

    def _forward(self, x: torch.Tensor):
        """(trunk, logits) of one float batch on the plan's device, every
        node run from Python: the int8 activation fed into ``gap`` (the
        last one for a plan without a head) and the plan's output."""
        h = quantize(x, self.plan.in_fb)
        trunk = None
        with exact_float32():
            for node in self.plan.nodes:
                if node.op == "gap":
                    trunk = h
                h = self._run_node(node, h)
        return (h if trunk is None else trunk), h

    def _captures(self) -> bool:
        return self.jit and self.device.type == "cuda"

    def _capture(self, b: int, x: torch.Tensor) -> CapturedFn:
        """Capture the forward at batch size ``b`` (``capture.capture``:
        one eager pass, which launches and counts like any forward, then
        the capture); its outputs are the trunk and the logits."""
        with obs_trace.span("plan.trace", n=b, method=self.method):
            xs = torch.zeros((b,) + tuple(x.shape[1:]), dtype=torch.float32,
                             device=self.device)
            xs[:x.shape[0]].copy_(x)
            cap, _ = capture(self._forward, (xs,), key=f"n{b}")
        self.traces += 1
        self._graphs[b] = cap
        return cap

    def _replay(self, x, b: int) -> Tuple[QTensor, torch.Tensor]:
        """Run the graph of batch size ``b`` on ``x`` (n <= b images, host
        or device), zero-padded to ``b``; returns its (trunk, logits),
        which stay in the graph's static tensors until the next replay."""
        x = torch.as_tensor(x)
        n = x.shape[0]
        cap = self._graphs.get(b)
        if cap is None:
            cap = self._capture(b, x)
        else:
            xs = cap.inputs[0]
            xs[:n].copy_(x)
            if n < b:
                xs[n:].zero_()
        return cap.replay()

    def trunk(self, x) -> QTensor:
        """The int8 activation fed into ``gap``: the integer trunk, which
        tests compare bitwise. Read from the same captured graph as
        ``__call__`` under ``jit`` on a card."""
        if self._captures():
            t = self._replay(x, x.shape[0])[0]
            return QTensor(t.q.clone(), t.frac_bits)
        return self._forward(self._input(x))[0]

    def __call__(self, x) -> torch.Tensor:
        with obs_trace.span("plan.forward", n=x.shape[0]):
            if self._captures():
                return self._replay(x, x.shape[0])[1].clone()
            return self._forward(self._input(x))[1]

    # ------------------------------------------------------ batched serving

    @staticmethod
    def batch_bucket(n: int) -> int:
        """Smallest power of two >= n: the batch sizes forward_batch runs,
        so ragged rounds reuse a few shapes (and a few captured graphs)."""
        b = 1
        while b < n:
            b *= 2
        return b

    def forward_batch(self, x) -> torch.Tensor:
        """One batched forward, zero-padded up to the pow2 batch bucket and
        cropped back. The int8 trunk is bit-exact with the per-sample loop
        (every plan op is row-independent); the float head agrees to float
        rounding only."""
        n = x.shape[0]
        b = self.batch_bucket(n)
        with obs_trace.span("plan.forward_batch", n=n, bucket=b):
            if self._captures():
                return self._replay(x, b)[1][:n].clone()
            x = self._input(x)
            if b != n:
                x = torch.cat([x, x.new_zeros((b - n,) + tuple(x.shape[1:]))])
            return self._forward(x)[1][:n]

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

    # ------------------------------------------------- per-layer attribution

    def profile(self, x, *, f_mhz: float = 84.0, reps: int = 3,
                mode: str = "latency") -> List[dict]:
        """Per-layer attribution, the paper's Table-2 reading: one row per
        plan node with its measured time (the node run alone from Python,
        ``tune.runner.time_config``, which synchronises on a card), its
        analytic MACs and, for conv nodes, the MCU model's latency and
        energy, scalar and SIMD (``core.energy.MCUModel`` at ``f_mhz``).

        ``mode="throughput"`` adds each node's ``us_per_image`` and
        ``images_per_s`` at ``x``'s batch size."""
        if mode not in ("latency", "throughput"):
            raise ValueError(f"unknown profile mode {mode!r}; expected "
                             "'latency' or 'throughput'")
        from repro_torch.tune.runner import time_config
        mcu = MCUModel()
        rows: List[dict] = []
        x = self._input(x)
        batch = x.shape[0]
        h = quantize(x, self.plan.in_fb)
        with exact_float32():
            for node in self.plan.nodes:
                def fn(v, _n=node):
                    return self._run_node(_n, v)
                with obs_trace.span(f"layer.{node.name}", cat="graph.profile",
                                    op=node.op, batch=batch) as sp:
                    us = time_config(fn, h, reps=reps, warmup=1)
                    sp.set(us=us)
                row = dict(name=node.name, op=node.op, us=us, macs=0,
                           primitive=node.spec.primitive if node.spec
                           else None)
                if node.op == "qconv":
                    width = node.attrs["in_hw"][1]
                    row["macs"] = node.spec.mac_count(width)
                    row["mcu_lat_scalar_ms"] = 1e3 * mcu.latency_s(
                        node.spec, width, simd=False, f_mhz=f_mhz)
                    row["mcu_lat_simd_ms"] = 1e3 * mcu.latency_s(
                        node.spec, width, simd=True, f_mhz=f_mhz)
                    row["mcu_e_scalar_mj"] = mcu.energy_mj(
                        node.spec, width, simd=False, f_mhz=f_mhz)
                    row["mcu_e_simd_mj"] = mcu.energy_mj(
                        node.spec, width, simd=True, f_mhz=f_mhz)
                if mode == "throughput":
                    row["us_per_image"] = us / batch
                    row["images_per_s"] = 1e6 * batch / us if us > 0 else 0.0
                h = fn(h)
                rows.append(row)
        return rows


# ---------------------------------------------------------------- references

def float_forward(graph: Graph, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Float inference over the IR (BN inference buffers, no stat
    re-estimation) — the eval path of ``models.convnet.cnn_forward``."""
    from .lower import interpret
    return interpret(graph, params, x)["acts"][graph.output]


def unfused_forward(plan: Plan, x, *, method: str = "torch"):
    """The float-bounce regime the fusion pass removes, rebuilt from the same
    plan: every conv and BN node dequantizes to float for its ReLU and
    requantizes at the node's annotated scale, and the pool runs on
    dequantized floats (the plain ``maxpool2d_ref``). Same integer conv
    arithmetic and scales, so bitwise equal to :class:`CompiledPlan` (relu
    and max commute with the positive pow2 scale, requantization is
    monotone with ``rshift_round(0) == 0``), with the two float round trips
    per block the fusion removes. ``x`` (tensor or numpy) lies on the
    plan's device; ``method`` is the conv nodes' kernel-layer method."""
    from repro_torch.kernels.ref import maxpool2d_ref
    h = quantize(torch.as_tensor(x, dtype=torch.float32), plan.in_fb)
    with exact_float32():
        for node in plan.nodes:
            if node.op == "qconv":
                y = qconv_apply(node.qparams, h, node.spec, node.out_fb,
                                method=method, act=None).dequantize()
                if node.act == "relu":
                    y = torch.relu(y)
                h = quantize(y, node.out_fb)
            elif node.op == "qbn":
                y = _qbn_apply(node.qparams, h, node.out_fb,
                               act=None).dequantize()
                if node.act == "relu":
                    y = torch.relu(y)
                h = quantize(y, node.out_fb)
            elif node.op == "maxpool":
                y = maxpool2d_ref(h.dequantize(), window=node.attrs["window"],
                                  stride=node.attrs["stride"])
                h = quantize(y, node.out_fb)
            elif node.op == "gap":
                h = h.dequantize().mean(dim=(1, 2))
            elif node.op == "dense":
                h = h @ node.qparams["w"]
    return h
