"""int32 accumulator and requant-shift range analysis per quantized node
(port of ``repro/check/overflow.py``).

CMSIS-NN's q7/q15 kernels are only correct because accumulator ranges and
shift amounts are proven safe ahead of time; this module is that proof
for the port's plans, from the ACTUAL weight codes: for each quantized
stage the worst-case accumulator magnitude is

    |acc| <= sum_over_reduction(|w_code|) * 127 + |bias_at_acc_scale|

(sum over the stage's taps and input channels, maximized over output
channels), with W4 weights expanded through their shift sideband first
(``QTensorW4.expand``: ``q4 << group_shift`` is the int8 code the kernels
accumulate). On top of the raw bound the Algorithm-1 requantization
epilogue is checked: the round-to-nearest term ``1 << (shift - 1)`` must
not push the accumulator past int32, and a negative shift (a left shift)
must not wrap. The add conv's integer BN node (``qbn``) also keeps its
int16-range multiplier budget (``graph/lower._quantize_bn_affine``).

The bound is int32 because every integer kernel of the port accumulates in
int32 or wrapping uint32: ``csrc/igemm.cuh``'s ``int acc[PT][Q]``,
``csrc/matmul_q8.cu``'s ``mma.sync`` s8 -> s32, the add's uint32 sums
(``csrc/conv_add.cu``, ``fgemm.cuh``). Sums are int64 numpy on the host;
each weight leaf is read to the host once (a plan's build, never inside a
CUDA-graph capture). No kernel runs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np

INT32_MAX = 2 ** 31 - 1
INT8_ABS_MAX = 127              # worst-case int8 activation magnitude
QBN_MULT_ABS_MAX = 2 ** 15      # lower._quantize_bn_affine's budget


@dataclasses.dataclass
class NodeBound:
    """Worst-case accumulator analysis of one quantized stage."""

    node: str
    stage: str                   # "main" | "dw" | "pw" | "qbn"
    primitive: Optional[str]
    acc_max: int                 # worst-case |int32 accumulator|
    requant_shift: int
    ok: bool
    messages: List[str]

    @property
    def acc_bits(self) -> int:
        """Magnitude bits the accumulator provably never exceeds."""
        return max(1, math.ceil(math.log2(self.acc_max + 1)))

    @property
    def headroom_bits(self) -> float:
        """Spare bits below the int32 sign boundary (>= 0 means safe)."""
        return 31 - math.log2(self.acc_max + 1) if self.acc_max >= 0 else 31.0


def _host(t) -> np.ndarray:
    """One tensor (any device) or array as int64 numpy."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.int64)


def _abs_codes(w) -> np.ndarray:
    """|weight codes| as int64 numpy: a QTensorW4 leaf's packed bytes and
    shifts are read to the host, then expanded through the sideband (the
    codes the kernels accumulate)."""
    from repro_torch.core.quantize import QTensorW4
    if isinstance(w, QTensorW4):
        q = dataclasses.replace(w, q=w.q.detach().cpu(),
                                shifts=w.shifts.detach().cpu()).expand()
    else:
        q = w.q
    return np.abs(_host(q))


def _per_co_abs_sum(a: np.ndarray, *, co_axis: int = -1) -> int:
    """max over output channels of sum(|codes|) over every other axis."""
    axes = tuple(i for i in range(a.ndim) if i != co_axis % a.ndim)
    return int(a.sum(axis=axes).max()) if a.size else 0


def _bias_abs_max(bias, acc_fb: int) -> int:
    """Worst-case |bias| after rescaling to the accumulator scale: the
    executor's ``_bias_acc`` arithmetic (rounded right shift, or left
    shift) on int64, so the bound covers the rescaled values bit for bit."""
    if bias is None:
        return 0
    q = np.abs(_host(bias.q))
    shift = bias.frac_bits - acc_fb
    if shift > 0:
        q = (q + (1 << (shift - 1))) >> shift
    elif shift < 0:
        q = q << (-shift)
    return int(q.max()) if q.size else 0


def check_requant_shift(acc_max: int, shift: int) -> List[str]:
    """Validate one Algorithm-1 requantization against a proven accumulator
    bound. Returns the (possibly empty) list of violations."""
    msgs: List[str] = []
    if not isinstance(shift, (int, np.integer)):
        return [f"requant shift must be a static int, got {shift!r}"]
    shift = int(shift)
    if abs(shift) >= 32:
        msgs.append(f"requant shift {shift} is outside the int32 shift "
                    "range (|shift| must be < 32)")
        return msgs
    if acc_max > INT32_MAX:
        msgs.append(f"worst-case |accumulator| {acc_max} "
                    f"(2^{math.log2(acc_max + 1):.1f}) overflows int32")
    elif shift > 0 and acc_max + (1 << (shift - 1)) > INT32_MAX:
        msgs.append(
            f"round-to-nearest term 1<<{shift - 1} pushes the worst-case "
            f"accumulator {acc_max} past int32 (Algorithm-1 epilogue "
            "overflows before the shift)")
    elif shift < 0 and acc_max << (-shift) > INT32_MAX:
        msgs.append(
            f"left-shift requantization (shift {shift}) wraps: "
            f"{acc_max} << {-shift} overflows int32")
    return msgs


def _bound(node_name: str, stage: str, primitive: Optional[str],
           acc_max: int, shift, extra_msgs: List[str]) -> NodeBound:
    msgs = list(extra_msgs) + check_requant_shift(acc_max, shift)
    return NodeBound(node=node_name, stage=stage, primitive=primitive,
                     acc_max=int(acc_max),
                     requant_shift=int(shift) if isinstance(
                         shift, (int, np.integer)) else 0,
                     ok=not msgs, messages=msgs)


def qconv_bounds(node) -> List[NodeBound]:
    """Per-stage accumulator bounds of one ``qconv`` plan node: the scale
    chaining of ``core.qconv.qconv_apply``, evaluated symbolically."""
    from repro_torch.core.quantize import add_preshifts

    spec, qp = node.spec, node.qparams
    p = spec.primitive
    bias = qp.get("b")
    out: List[NodeBound] = []

    if p in ("standard", "grouped"):
        w = qp["w"]
        acc_fb = node.in_fb + w.frac_bits
        acc = (_per_co_abs_sum(_abs_codes(w)) * INT8_ABS_MAX
               + _bias_abs_max(bias, acc_fb))
        out.append(_bound(node.name, "main", p, acc,
                          acc_fb - node.out_fb, []))

    elif p == "dws":
        w_dw, w_pw = qp["w_dw"], qp["w_pw"]
        mid_fb = qp.get("mid_frac_bits", node.out_fb)
        # depthwise: each output channel sees only its own channel's taps,
        # so the channel axis is the output axis
        a = _abs_codes(w_dw)
        per_c = a.reshape(a.shape[0] * a.shape[1], -1).sum(axis=0)
        acc_dw = int(per_c.max()) * INT8_ABS_MAX if per_c.size else 0
        out.append(_bound(node.name, "dw", p, acc_dw,
                          node.in_fb + w_dw.frac_bits - mid_fb, []))
        acc_fb = mid_fb + w_pw.frac_bits
        acc_pw = (_per_co_abs_sum(_abs_codes(w_pw)) * INT8_ABS_MAX
                  + _bias_abs_max(bias, acc_fb))
        out.append(_bound(node.name, "pw", p, acc_pw,
                          acc_fb - node.out_fb, []))

    elif p == "shift":
        w_pw = qp["w_pw"]
        acc_fb = node.in_fb + w_pw.frac_bits
        acc = (_per_co_abs_sum(_abs_codes(w_pw)) * INT8_ABS_MAX
               + _bias_abs_max(bias, acc_fb))
        out.append(_bound(node.name, "main", p, acc,
                          acc_fb - node.out_fb, []))

    elif p == "add":
        w = qp["w"]
        x_pre, w_pre, acc_fb = add_preshifts(node.in_fb, w.frac_bits)
        msgs = []
        if not (0 <= x_pre < 24 and 0 <= w_pre < 24):
            msgs.append(f"add-conv scale-alignment preshifts out of range: "
                        f"x_preshift={x_pre} w_preshift={w_pre}")
        # |xi - wi| <= 127 << x_pre + |w| << w_pre per tap, summed over the
        # (hk, hk, cx) reduction; the sign-flipped sum has the same bound
        codes = _abs_codes(w)
        a = (codes << w_pre).reshape(-1, codes.shape[-1])
        per_co = a.sum(axis=0)
        taps = a.shape[0]                       # hk * hk * cx reduction size
        acc = int(per_co.max()) + taps * (INT8_ABS_MAX << x_pre) \
            + _bias_abs_max(bias, acc_fb)
        out.append(_bound(node.name, "main", p, acc,
                          acc_fb - node.out_fb, msgs))

    else:
        out.append(_bound(node.name, "main", p, 0, 0,
                          [f"unknown primitive {p!r}"]))
    return out


def qbn_bounds(node) -> NodeBound:
    """The add conv's integer-BN affine: ``acc = x * a + b`` with the
    int16-range multiplier budget of ``graph/lower._quantize_bn_affine``."""
    qp = node.qparams
    a = np.abs(_host(qp["a"]))
    b = np.abs(_host(qp["b"]))
    a_max = int(a.max()) if a.size else 0
    msgs: List[str] = []
    if a_max > QBN_MULT_ABS_MAX:
        msgs.append(
            f"qbn multiplier magnitude {a_max} exceeds the int16-range "
            f"budget {QBN_MULT_ABS_MAX} (lower._quantize_bn_affine "
            "contract)")
    acc = a_max * INT8_ABS_MAX + (int(b.max()) if b.size else 0)
    shift = node.in_fb + qp["a_frac_bits"] - node.out_fb
    return _bound(node.name, "qbn", None, acc, shift, msgs)


def check_plan_overflow(plan) -> List[NodeBound]:
    """Accumulator/shift analysis of every quantized node of a plan."""
    out: List[NodeBound] = []
    for node in plan.nodes:
        if node.op == "qconv":
            out.extend(qconv_bounds(node))
        elif node.op == "qbn":
            out.append(qbn_bounds(node))
    return out


def overflow_errors(bounds: List[NodeBound]) -> List[str]:
    """Flatten failing bounds into per-node diagnostics."""
    return [f"{b.node}/{b.stage}: {m}"
            for b in bounds if not b.ok for m in b.messages]
