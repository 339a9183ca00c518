"""int8 error-feedback gradient compression for the data-parallel
all-reduce (port of ``repro/optim/compression.py``).

The paper's power-of-two int8 scheme (``core.quantize``) applied to
gradient traffic: each leaf is quantized to int8 with a per-tensor
power-of-two scale, the ranks agree on the largest scale (``pmax``),
requantize to it, sum the int8 codes as int32 (exact), and dequantize;
the quantization residual is carried into the next step (error
feedback). The JAX package's arithmetic step by step: the scale, round
half to even, the common scale, the int32 sum, ``tot * s_max / n``. It
runs inside a sharded step (``parallel.sharding``'s collectives over the
current mesh), one call per rank on its own gradients.

One difference: the scale here is an exact power of two (``torch.exp2``
of an integer is exact); JAX's ``exp2`` and ``log2`` on the host are off
by an ulp at some integer exponents (``2 ** -13`` and beyond ``2 ** 12``
among them), so where a leaf's largest magnitude makes such an exponent
the two packages' scales, and so their outputs, differ in the last bits.
"""
from __future__ import annotations

import torch

from repro_torch.parallel.sharding import axis_size, pmax, psum
from repro_torch.tree import tree_map


def _pow2_scale(x: torch.Tensor) -> torch.Tensor:
    """The power-of-two scale covering max|x| at int8's full scale
    (Eq. 4, computed on the tensor)."""
    m = torch.max(torch.abs(x))
    exp = torch.ceil(torch.log2(torch.clamp(m, min=1e-30)))
    return torch.exp2(exp - 7.0)


def compress(x: torch.Tensor, err: torch.Tensor):
    """``(int8 codes, scale, new residual)`` of ``x + err`` (float32)."""
    t = x.to(torch.float32) + err
    s = _pow2_scale(t)
    q = torch.clamp(torch.round(t / s), -128, 127).to(torch.int8)
    deq = q.to(torch.float32) * s
    return q, s, t - deq


def allreduce_compressed(grads, errors, axis_names):
    """The mean of every leaf of ``grads`` over the ranks of
    ``axis_names`` (a mesh axis or a tuple of them), each leaf sent as
    int8 codes with error feedback. Returns ``(mean grads, new
    errors)``, trees of ``grads``' structure."""
    n = axis_size(axis_names)

    def leaf(g, e):
        q, s, new_e = compress(g, e)
        s_max = pmax(s, axis_names)
        q_common = torch.clamp(torch.round(q.to(torch.float32) * (s / s_max)),
                               -128, 127).to(torch.int32)
        tot = psum(q_common, axis_names)
        return (tot.to(torch.float32) * s_max / n).to(g.dtype), new_e

    out = tree_map(lambda g, e: leaf(g, e), grads, errors)
    return (tree_map(lambda _, o: o[0], grads, out),
            tree_map(lambda _, o: o[1], grads, out))


def init_errors(params):
    """Zero float32 residuals in the shape of every leaf of ``params``."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
