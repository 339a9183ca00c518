"""A step's work, counted as it runs, against the card's peaks.

The port's counterpart of ``repro/roofline/hlo.py``. JAX walks the
compiled HLO of a step; eager PyTorch has no HLO to walk, so this module
counts the step's work while it runs, in three parts:

* the aten matmuls, convolutions and attention, by the formulas of
  ``torch.utils.flop_counter.FlopCounterMode``'s registry (the FLOPs JAX
  counts as ``dot_flops``), each by the kind of its operands (``"bf16"``
  for bfloat16 and float16 on the tensor cores, ``"f32"``, ``"int8"``);
* every call of a hand-written kernel through ``kernels.ops``: the entry
  point reports the call with :func:`kernel_work`'s operations by kind and
  bytes (each input read once, each output written once, W4 weights
  packed), and the aten operations of whatever runs inside it (a plain
  version's step-by-step arithmetic) are not counted. So a call counts the
  same work under ``method="cuda"`` and ``"torch"``, and on meta tensors.
* every collective of a sharded step (``parallel.sharding``'s ``psum``,
  ``pmax``, ``all_gather``, ``psum_scatter``, ``all_to_all`` and FSDP's
  gathers, their backwards included): its kind under JAX's HLO name, its
  operand bytes on this rank and its group's mesh axes
  (:class:`Collective`), on real tensors or on the dry run's meta tensors
  over the fake backend alike.

:func:`kernel_work` is also what ``chip_smoke.py`` phase 3 bounds each
kernel by. :func:`step_report` gives a step's FLOPs by kind, its bytes
floor (arguments and outputs, as ``benchmarks/roofline_report.py``'s
``mem_lo``) and, given a device time, each term of
:meth:`~repro_torch.core.energy.H100.roofline_terms` and the share of the
binding one. Work a kernel does not report and no aten formula covers
(elementwise operations, reductions) is not counted, as JAX's
``dot_flops`` leaves it out.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses

import torch

from repro_torch.core.energy import H100_SXM, h100_for
from repro_torch.device import resolve_device

#: the kind of an aten operation's work, by its first operand's dtype
_KINDS = {torch.bfloat16: "bf16", torch.float16: "bf16",
          torch.float32: "f32", torch.int8: "int8"}


@dataclasses.dataclass
class Work:
    """Operations by kind (:meth:`~repro_torch.core.energy.H100.peak`'s
    kinds) and bytes moved."""
    ops: dict
    nbytes: int


def _nbytes(t) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def _int(x) -> bool:
    return not x.dtype.is_floating_point


def _weights(w, w_shifts) -> int:
    """The weight bytes a kernel reads: int8 codes, or W4 packed nibbles and
    their int8 group shifts."""
    return _nbytes(w) + _nbytes(w_shifts)


def _conv_work(x, w, bias=None, *, groups=1, w_shifts=None, **_) -> Work:
    n, h, wd, cx = x.shape
    hk, cy = w.shape[0], w.shape[-1]
    macs = n * h * wd * cy * (cx // groups) * hk * hk
    if _int(x):
        return Work({"int8": 2 * macs}, _nbytes(x) + _weights(w, w_shifts)
                    + _nbytes(bias) + n * h * wd * cy)
    es = x.element_size()
    return Work({"f32": 2 * macs}, es * (x.numel() + w.numel()
                                         + n * h * wd * cy)
                + (es * bias.numel() if bias is not None else 0))


def _dw_work(x, w_dw, *, w_shifts=None, **_) -> Work:
    hk = w_dw.shape[1] if w_shifts is not None else w_dw.shape[0]
    taps = x.numel() * hk * hk
    if _int(x):
        return Work({"int8": 2 * taps},
                    2 * x.numel() + _weights(w_dw, w_shifts))
    return Work({"f32": 2 * taps},
                x.element_size() * (2 * x.numel() + w_dw.numel()))


def _pool_work(x, *, window=2, stride=None, **_) -> Work:
    n, h, wd, c = x.shape
    st = stride or window
    out = n * ((h - window) // st + 1) * ((wd - window) // st + 1) * c
    compares = out * (window * window - 1)
    return Work({"int32" if _int(x) else "f32_op": compares},
                x.element_size() * (x.numel() + out))


def _shift_work(x, shifts, w_pw, bias=None, *, w_shifts=None, **_) -> Work:
    n, h, wd, c = x.shape
    cy = w_pw.shape[-1]
    macs = n * h * wd * cy * c
    if _int(x):
        return Work({"int8": 2 * macs},
                    _nbytes(x) + _weights(w_pw, w_shifts) + _nbytes(shifts)
                    + _nbytes(bias) + n * h * wd * cy)
    return Work({"f32": 2 * macs},
                x.element_size() * (x.numel() + w_pw.numel()
                                    + n * h * wd * cy) + _nbytes(shifts))


def _add_work(x, w, bias=None, *, w_shifts=None, **_) -> Work:
    n, h, wd, cx = x.shape
    hk, cy = w.shape[0], w.shape[-1]
    taps = n * h * wd * cy * cx * hk * hk
    if _int(x):   # |x - w| accumulates on the int32 lanes (no MMA form)
        return Work({"int32": taps}, _nbytes(x) + _weights(w, w_shifts)
                    + _nbytes(bias) + n * h * wd * cy)
    return Work({"f32_op": 2 * taps},
                x.element_size() * (x.numel() + w.numel() + n * h * wd * cy))


def _matmul_work(a, b, *, w_shifts=None, **_) -> Work:
    k = a.shape[-1]
    m = a.numel() // k
    n = b.shape[-1]
    if _int(a):
        return Work({"int8": 2 * m * n * k},
                    _nbytes(a) + _weights(b, w_shifts) + m * n)
    return Work({"f32": 2 * m * n * k},
                a.element_size() * (a.numel() + b.numel() + m * n))


def _c1d_work(x, w, **_) -> Work:
    b, l, d = x.shape
    k = w.shape[0]
    return Work({"f32": 2 * k * b * l * d},
                (2 * b * l * d + k * d) * x.element_size())


#: each hand-written kernel's work, from the operands of its call
_WORK = {
    "conv2d_q8": _conv_work, "conv2d_w4": _conv_work, "conv2d_f": _conv_work,
    "depthwise2d_q8": _dw_work, "depthwise2d_w4": _dw_work,
    "depthwise2d_f": _dw_work,
    "maxpool2d_s8": _pool_work, "maxpool2d_f": _pool_work,
    "shift_conv2d_q8": _shift_work, "shift_conv2d_w4": _shift_work,
    "shift_conv2d_f": _shift_work,
    "add_conv2d_q8": _add_work, "add_conv2d_w4": _add_work,
    "add_conv2d_f": _add_work,
    "matmul_q8": _matmul_work, "matmul_w4": _matmul_work,
    "matmul_f": _matmul_work,
    "causal_conv1d": _c1d_work,
}
KERNELS = tuple(_WORK)


def kernel_work(kernel: str, *args, **kwargs) -> Work:
    """The work of one call of hand-written kernel ``kernel`` (a name of
    :data:`KERNELS`: the wrapper's) on the operands of that call, as the
    wrapper or its ``kernels.ops`` entry point takes them (tensors, meta
    ones too): operations by kind (int8 tensor-core operations, 2 a
    multiply-add; float32 FLOPs, 2 a multiply-add; the add convs' ``|x -
    w|`` accumulates and the pools' compares, which have no FMA form), and
    bytes with each input read once, each output written once and W4
    weights as packed nibbles plus their group shifts."""
    if kernel not in _WORK:
        raise KeyError(f"unknown kernel {kernel!r}; kernels: {KERNELS}")
    return _WORK[kernel](*args, **kwargs)


def kernel_of(entry: str, x, *, requant_shift=None, w_shifts=None) -> str:
    """The hand-written kernel a ``kernels.ops`` entry point's call runs:
    its W4 mode with ``w_shifts``, its float mode without
    ``requant_shift`` (the pool: on float ``x``), else its int8 mode."""
    if entry == "causal_conv1d":
        return entry
    if entry == "maxpool2d":
        return "maxpool2d_f" if x.dtype.is_floating_point else "maxpool2d_s8"
    if w_shifts is not None:
        return f"{entry}_w4"
    return f"{entry}_f" if requant_shift is None else f"{entry}_q8"


# ------------------------------------------------------------------ counting

#: the collectives' kinds, JAX's HLO names (``repro/roofline/hlo.py``)
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all")


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective call on this rank: its kind (:data:`COLLECTIVE_KINDS`),
    its operand's bytes here (the tensor it sends: an all-gather's block,
    a reduce-scatter's whole input, as ``analyze_hlo`` counts an HLO
    collective's operands) and the mesh axes of size > 1 its group spans.
    A group that spans ``"pod"`` crosses pods (JAX's ``_crosses_pod``:
    the DCN bytes)."""
    kind: str
    nbytes: int
    axes: tuple

    @property
    def cross_pod(self) -> bool:
        return "pod" in self.axes


class Count:
    """What :func:`counting` saw: FLOPs (operations) by kind, aten's and
    the kernels' together, the kernels' bytes, each kernel's calls, and
    every collective call in order (:class:`Collective`)."""

    def __init__(self):
        self.aten = collections.Counter()
        self.kernel_ops = collections.Counter()
        self.kernel_bytes = 0
        self.calls = collections.Counter()
        self.collectives = []

    @property
    def flops(self) -> dict:
        """Operations by kind, aten's and the kernels'."""
        return dict(self.aten + self.kernel_ops)

    @property
    def total(self) -> float:
        return float(sum(self.flops.values()))

    def add_kernel(self, kernel: str, work: Work):
        self.calls[kernel] += 1
        self.kernel_ops.update(work.ops)
        self.kernel_bytes += work.nbytes

    def collective_bytes(self) -> dict:
        """``{"bytes_in_pod", "bytes_cross_pod", "by_kind", "calls"}`` of
        the collectives seen: bytes summed within pods and across them (a
        record's ``hlo.coll_bytes_ici`` / ``coll_bytes_dcn`` in JAX's dry
        run), by kind, and the number of calls."""
        by_kind = collections.Counter()
        cross = 0
        for c in self.collectives:
            by_kind[c.kind] += c.nbytes
            cross += c.nbytes if c.cross_pod else 0
        total = sum(by_kind.values())
        return {"bytes_in_pod": total - cross, "bytes_cross_pod": cross,
                "by_kind": dict(sorted(by_kind.items())),
                "calls": len(self.collectives)}


#: the open counts, and how deep inside kernel calls the running code is
_ACTIVE: list = []
_QUIET = [0]


def active() -> bool:
    return bool(_ACTIVE)


def collective(kind: str, nbytes: int, axes: tuple):
    """Report one collective call (:class:`Collective`) to every open
    count; ``parallel.sharding``'s helpers call it for every transfer."""
    if kind not in COLLECTIVE_KINDS:
        raise KeyError(f"unknown collective {kind!r}; kinds: "
                       f"{COLLECTIVE_KINDS}")
    rec = Collective(kind, int(nbytes), tuple(axes))
    for c in _ACTIVE:
        c.collectives.append(rec)


@contextlib.contextmanager
def kernel_call(kernel: str, *args, **kwargs):
    """Report one call of ``kernel`` on these operands to every open count,
    and keep the aten operations of the block (its plain version or its
    launch) out of them."""
    if not _ACTIVE:
        yield
        return
    work = kernel_work(kernel, *args, **kwargs)
    for c in _ACTIVE:
        c.add_kernel(kernel, work)
    _QUIET[0] += 1
    try:
        yield
    finally:
        _QUIET[0] -= 1


def _aten_mode(count: Count):
    """A dispatch mode that files the FLOPs of each operation
    ``torch.utils.flop_counter`` has a formula for (``FlopCounterMode``'s
    registry: matmuls, convolutions, attention, forward and backward) under
    its operands' kind in ``count``, and counts nothing inside a kernel
    call. It does no more than that: ``FlopCounterMode`` itself also
    tracks modules and tries to decompose every other operation, which
    costs as much again on the dry run's meta tensors."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class _Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None and not _QUIET[0]:
                first = next((a for a in args
                              if isinstance(a, torch.Tensor)), None)
                kind = _KINDS.get(first.dtype, str(first.dtype)) \
                    if first is not None else "f32"
                count.aten[kind] += formula(*args, **kwargs, out_val=out)
            return out
    return _Mode()


@contextlib.contextmanager
def counting(flops: bool = True):
    """``with counting() as c:`` counts the work of whatever runs inside,
    forward and backward (:class:`Count`). ``flops=False`` leaves the aten
    operations uncounted (no dispatch mode: each operation then costs no
    more than it does uncounted) and counts the kernel calls and the
    collectives alone."""
    c = Count()
    _ACTIVE.append(c)
    try:
        with _aten_mode(c) if flops else contextlib.nullcontext():
            yield c
    finally:
        _ACTIVE.remove(c)


def _tensors(tree, out: dict):
    if isinstance(tree, torch.Tensor):
        out[id(tree)] = tree
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors(v, out)
    return out


def tree_bytes(tree) -> int:
    """The bytes of every distinct tensor in a tree (dicts, lists, tuples;
    other leaves ignored)."""
    return sum(_nbytes(t) for t in _tensors(tree, {}).values())


def report(flops: dict, bytes_floor: float, *, device_s=None,
           card=H100_SXM) -> dict:
    """A step's roofline: FLOPs by kind, their total, the bytes floor and,
    with a device time (seconds), ``card``'s roofline terms, the binding
    one and its share of the device time."""
    out = {"flops": dict(flops), "dot_flops": float(sum(flops.values())),
           "bytes_floor": float(bytes_floor)}
    if device_s is not None:
        terms = card.roofline_terms(flops, bytes_floor)
        binding = max(terms, key=terms.get)
        out.update(device_s=device_s, terms=terms, binding=binding,
                   share=terms[binding] / device_s)
    return out


def step_report(fn, *args, device_s=None, device="cuda", **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once under :func:`counting` and return
    :func:`report` of it, its bytes floor the distinct tensors of the
    arguments plus those of the outputs, against the model of ``device``'s
    card (an H100 SXM for a host device), with the kernel calls and bytes
    it counted (``"kernel_calls"``, ``"kernel_bytes"``) and its outputs
    (``"outputs"``)."""
    dev = resolve_device(device)
    card = h100_for(torch.cuda.get_device_name(dev)) \
        if dev.type == "cuda" else H100_SXM
    with counting() as c:
        out = fn(*args, **kwargs)
    floor = tree_bytes((args, kwargs)) + tree_bytes(out)
    rep = report(c.flops, floor, device_s=device_s, card=card)
    rep.update(kernel_calls=dict(c.calls), kernel_bytes=c.kernel_bytes,
               outputs=out)
    return rep
