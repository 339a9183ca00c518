"""Abstract interpretation over a lowered plan: shape, dtype and fusion
legality, verified without running anything (port of
``repro/check/dataflow.py``, over the port's IR; its messages are the JAX
package's, word for word, so the two can be compared message by message).

The interpreter walks the plan's nodes carrying an abstract activation
(spatial extent, channels, int8 frac bits, int8 or float regime) and
checks every transition:

* **scale chaining** — each consumer reads its input at the producer's
  annotated frac bits (``node.in_fb == state.frac_bits``); a mismatch
  means the fused requantization epilogues would silently rescale.
* **shape coverage** — conv input channels match the spec, groups divide
  the channels, the recorded ``in_hw`` attrs agree with the propagated
  extents, pooling windows fit the map.
* **dtype flow** — activations stay int8 from the first conv to the global
  average pool; quantized weight leaves hold int8 codes (packed W4
  included, its shift sideband too), on whatever device; nothing
  quantized runs after the int8 -> float ``gap`` boundary.
* **fusion legality** — only the chains the kernels fuse: ``act`` is
  ``None`` or ``"relu"``, ``qbn`` only follows the add conv, ``maxpool``
  runs at an unchanged scale, the dense head is terminal.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.graph.lower import PLAN_OPS

_FB_RANGE = (-24, 31)           # sane int8 frac-bit annotations


@dataclasses.dataclass
class Diagnostic:
    node: str
    level: str                   # "error" | "warning"
    message: str


@dataclasses.dataclass
class _State:
    """Abstract activation flowing through the plan."""

    regime: str = "int8"         # "int8" until gap, then "float"
    frac_bits: Optional[int] = None
    hw: Optional[Tuple[int, int]] = None
    channels: Optional[int] = None


def _err(diags, node, msg):
    diags.append(Diagnostic(node.name, "error", f"{node.name}: {msg}"))


def _warn(diags, node, msg):
    diags.append(Diagnostic(node.name, "warning", f"{node.name}: {msg}"))


def _dtype(t) -> str:
    """A leaf's dtype as the JAX package names it (``int8``, ``int32``)."""
    return str(t.dtype).replace("torch.", "")


def _rows(t) -> int:
    return int(t.shape[0])


def _check_fb(diags, node, fb, what):
    if fb is None or not isinstance(fb, (int, np.integer)):
        _err(diags, node, f"{what} frac bits must be a static int, got "
             f"{fb!r}")
        return False
    if not (_FB_RANGE[0] <= fb <= _FB_RANGE[1]):
        _err(diags, node, f"{what} frac bits {fb} outside the sane range "
             f"{_FB_RANGE}")
        return False
    return True


def _check_weight_dtypes(diags, node):
    """Quantized leaves must hold int8 codes (packed W4 bytes are int8)."""
    from repro_torch.core.quantize import QTensor, QTensorW4
    for key, v in (node.qparams or {}).items():
        if isinstance(v, (QTensor, QTensorW4)):
            if _dtype(v.q) != "int8":
                _err(diags, node, f"quantized leaf {key!r} holds "
                     f"{_dtype(v.q)}, expected int8 codes")
        if isinstance(v, QTensorW4) and _dtype(v.shifts) != "int8":
            _err(diags, node, f"W4 leaf {key!r} shift sideband holds "
                 f"{_dtype(v.shifts)}, expected int8")


def _chain(diags, node, st: _State):
    """Scale-chain check shared by every int8-consuming op."""
    if st.regime != "int8":
        _err(diags, node, f"{node.op} consumes an int8 activation but the "
             "abstract state is already float (op after gap?)")
        return
    if (st.frac_bits is not None and node.in_fb is not None
            and node.in_fb != st.frac_bits):
        _err(diags, node, f"scale chain broken: reads input at in_fb="
             f"{node.in_fb} but the producer wrote frac_bits="
             f"{st.frac_bits}")


def check_plan(plan) -> List[Diagnostic]:
    """Run the abstract interpreter over ``plan``; returns diagnostics
    (errors and warnings). No error means the plan's dataflow is
    statically legal; ``repro_torch.check.validate_plan`` raises on
    errors. Reads shapes and dtypes only, never a weight's values."""
    diags: List[Diagnostic] = []
    st = _State(frac_bits=plan.in_fb)
    seen_gap = False
    prev = None

    for node in plan.nodes:
        if node.op not in PLAN_OPS:
            diags.append(Diagnostic(node.name, "error",
                                    f"{node.name}: unknown plan op "
                                    f"{node.op!r}"))
            continue

        if node.op == "qconv":
            spec = node.spec
            _chain(diags, node, st)
            _check_fb(diags, node, node.in_fb, "input")
            _check_fb(diags, node, node.out_fb, "output")
            _check_weight_dtypes(diags, node)
            if node.act not in (None, "relu"):
                _err(diags, node, f"unfusable activation {node.act!r}; the "
                     "kernel epilogues implement only None/'relu'")
            if spec is None:
                _err(diags, node, "qconv node without a ConvSpec")
                continue
            if spec.groups < 1 or spec.in_channels % max(spec.groups, 1):
                _err(diags, node, f"groups={spec.groups} does not divide "
                     f"in_channels={spec.in_channels}")
            if st.channels is not None and st.channels != spec.in_channels:
                _err(diags, node, f"channel mismatch: consumes "
                     f"{spec.in_channels} channels but the producer "
                     f"yields {st.channels}")
            hw = node.attrs.get("in_hw")
            if hw is not None and st.hw is not None and tuple(hw) != st.hw:
                _err(diags, node, f"recorded in_hw={tuple(hw)} disagrees "
                     f"with the propagated extent {st.hw}")
            if hw is not None:
                st.hw = tuple(hw)
            if st.hw is not None and spec.kernel_size > min(st.hw):
                _warn(diags, node, f"kernel {spec.kernel_size} larger than "
                      f"the {st.hw} map (SAME padding dominates the tile)")
            if st.hw is not None and spec.stride != 1:
                h, w = st.hw
                st.hw = ((h - 1) // spec.stride + 1,
                         (w - 1) // spec.stride + 1)
            st.channels = spec.out_channels
            st.frac_bits = node.out_fb

        elif node.op == "qbn":
            _chain(diags, node, st)
            _check_fb(diags, node, node.in_fb, "input")
            _check_fb(diags, node, node.out_fb, "output")
            if node.act not in (None, "relu"):
                _err(diags, node, f"unfusable activation {node.act!r}")
            qp = node.qparams or {}
            if not {"a", "b", "a_frac_bits"} <= set(qp):
                _err(diags, node, "qbn node missing integer-affine params "
                     "(a/b/a_frac_bits)")
            if prev is None or prev.op != "qconv" \
                    or prev.spec is None or prev.spec.primitive != "add":
                _err(diags, node, "qbn is the add-conv integer BN lowering; "
                     "it must directly follow an add-primitive qconv "
                     "(every other primitive BN-folds)")
            elif qp.get("a") is not None and st.channels is not None:
                n_ch = int(qp["a"].shape[-1])
                if n_ch != st.channels:
                    _err(diags, node, f"qbn affine covers {n_ch} channels, "
                         f"producer yields {st.channels}")
            st.frac_bits = node.out_fb

        elif node.op == "maxpool":
            _chain(diags, node, st)
            if node.in_fb != node.out_fb:
                _err(diags, node, f"maxpool on int8 codes requires an "
                     f"unchanged scale (in_fb={node.in_fb} != out_fb="
                     f"{node.out_fb}); max only commutes with the "
                     "producer's own pow2 scale")
            win = node.attrs.get("window", 2)
            s = node.attrs.get("stride", 2)
            if win < 1 or s < 1:
                _err(diags, node, f"degenerate pooling window={win} "
                     f"stride={s}")
            hw = node.attrs.get("in_hw")
            if hw is not None and st.hw is not None and tuple(hw) != st.hw:
                _err(diags, node, f"recorded in_hw={tuple(hw)} disagrees "
                     f"with the propagated extent {st.hw}")
            if hw is not None:
                st.hw = tuple(hw)
            if st.hw is not None:
                h, w = st.hw
                if win > h or win > w:
                    _err(diags, node, f"pooling window {win} does not fit "
                         f"the {st.hw} map")
                else:
                    st.hw = ((h - win) // s + 1, (w - win) // s + 1)
            st.frac_bits = node.out_fb if node.out_fb is not None \
                else st.frac_bits

        elif node.op == "gap":
            _chain(diags, node, st)
            if seen_gap:
                _err(diags, node, "second gap node; the int8 -> float "
                     "boundary must be unique")
            seen_gap = True
            st.regime = "float"
            st.hw = None
            st.frac_bits = None

        elif node.op == "dense":
            if st.regime != "float":
                _err(diags, node, "dense head expects the float gap "
                     "output; no gap node precedes it")
            w = (node.qparams or {}).get("w")
            if w is None:
                _err(diags, node, "dense node without a weight")
            elif st.channels is not None and _rows(w) != st.channels:
                _err(diags, node, f"head weight rows {_rows(w)} != gap "
                     f"features {st.channels}")
            if node is not plan.nodes[-1]:
                _err(diags, node, "dense head must be the terminal node")

        prev = node

    if plan.nodes and plan.nodes[-1].op == "dense" and not seen_gap:
        diags.append(Diagnostic(plan.nodes[-1].name, "warning",
                                "plan ends in dense without a gap boundary"))
    return diags
