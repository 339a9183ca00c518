"""Mamba-1 block: the depthwise causal conv1d (the paper's primitive, a CUDA
kernel) and the selective state-space scan.

Port of ``repro/models/mamba.py`` and of the state-returning prefill
``_mamba_forward_with_state`` of ``repro/models/transformer.py``, with the
JAX package's parameter names, layouts and scales. The conv1d stage runs
``kernels.ops.causal_conv1d``: ``conv_method="cuda"`` is the kernel (the
JAX package's ``"auto"`` off a mesh, the Pallas kernel), ``"torch"`` its
plain version (``"xla"``). Under a mesh the kernel stays: JAX's ``"auto"``
takes XLA there (and counts ``kernels.fallback.causal_conv1d.mesh``)
because the partitioner would gather an opaque ``pallas_call``'s
operands, which does not hold for the port's rank-local tensors. A decode step computes its one conv window in
plain PyTorch, as JAX's does, and launches no kernel.

The selective scan is plain PyTorch, as JAX's is plain ``jnp``: a
sequential loop over chunks (JAX's chunk search: the largest divisor of L
not above ``chunk``) carries the (B, d_inner, d_state) float32 state;
inside a chunk the recurrence h_t = a_t * h_{t-1} + b_t runs as a
log-depth doubling scan (Hillis-Steele), with a = exp(dt*A) and b =
dt*x*B discretised lazily per chunk, so no (B, L, d_inner, d_state) tensor
is ever made. Its sums run in another order than ``lax.associative_scan``,
so it agrees with JAX within float32 rounding, not bitwise.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MambaConfig
from repro_torch.kernels import ops as K
from repro_torch.parallel.sharding import (all_gather, axis_index,
                                           constrain, psum, split_axes)


def init_mamba(generator: torch.Generator, d: int, m: MambaConfig, dtype, *,
               n_layers=None, device=None):
    """Random Mamba parameters drawn from ``generator`` on its device, with
    the JAX package's distributions and scales. With ``n_layers`` every
    leaf carries a leading layer axis (drawn in one go, so a full-width
    stack never exists twice)."""
    di = m.expand * d
    rank = m.rank(d)
    dev = generator.device if device is None else device
    lead = () if n_layers is None else (n_layers,)

    def normal(shape, std):
        return torch.randn(lead + shape, generator=generator, dtype=dtype,
                           device=dev).mul_(std)

    u = torch.rand(lead + (di,), generator=generator, dtype=torch.float32,
                   device=dev)
    dt = torch.clamp(torch.exp(u * 7.0 - 7.0) * 0.099 + 0.001, min=1e-4)
    a = torch.arange(1, m.d_state + 1, dtype=torch.float32, device=dev)
    return {
        "in_proj": normal((d, 2 * di), d ** -0.5),
        "conv_w": normal((m.d_conv, di), m.d_conv ** -0.5),
        "conv_b": torch.zeros(lead + (di,), dtype=dtype, device=dev),
        "x_proj": normal((di, rank + 2 * m.d_state), di ** -0.5),
        "dt_proj": normal((rank, di), rank ** -0.5),
        "dt_bias": torch.log(torch.expm1(dt)).to(dtype),
        "A_log": torch.log(a).expand(lead + (di, m.d_state)).to(dtype)
        .contiguous(),
        "D": torch.ones(lead + (di,), dtype=dtype, device=dev),
        "out_proj": normal((di, d), di ** -0.5),
    }


def mamba_specs(prefix_layers=True):
    """The Mamba leaves' logical axis names (JAX's ``mamba.mamba_specs``)."""
    L = ("layers",) if prefix_layers else ()
    return {
        "in_proj": L + ("embed", "d_inner"),
        "conv_w": L + (None, "d_inner"),
        "conv_b": L + ("d_inner",),
        "x_proj": L + ("d_inner", None),
        "dt_proj": L + (None, "d_inner"),
        "dt_bias": L + ("d_inner",),
        "A_log": L + ("d_inner", None),
        "D": L + ("d_inner",),
        "out_proj": L + ("d_inner", "embed"),
    }


def _doubling_scan(a, b):
    """Inclusive scan of h_t = a_t * h_{t-1} + b_t along axis 1 from h = 0:
    returns (prod_{s<=t} a_s, h_t). Hillis-Steele: log2(L) rounds, each
    combining element t with element t - off."""
    off = 1
    while off < a.shape[1]:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], 1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], 1)
        off *= 2
    return a, b


def chunk_size(length: int, chunk: int) -> int:
    """JAX's chunk search: the largest divisor of ``length`` <= ``chunk``."""
    ch = min(chunk, length)
    while length % ch:
        ch -= 1
    return ch


#: one entry for each open :func:`whole_sequence_scans`
_WHOLE: list = []


@contextlib.contextmanager
def whole_sequence_scans():
    """Every :func:`mamba_scan` inside the block runs its whole sequence as
    one chunk, whatever chunk its caller passes. Its matmuls are the same
    (one (dI, N) x N product a position in any chunking); only the number
    of operations that issue them falls, which is what the dry run's count
    on meta tensors pays for (``launch.dryrun``)."""
    _WHOLE.append(True)
    try:
        yield
    finally:
        _WHOLE.pop()


def mamba_scan(x_c, dt, A, B_t, C_t, *, chunk: int = 256, h0=None):
    """Selective scan. x_c, dt: (B,L,dI); A: (dI,N); B_t, C_t: (B,L,N).
    Returns (y (B,L,dI) in x_c's dtype, h_last (B,dI,N) float32)."""
    b, l, di = x_c.shape
    n = A.shape[-1]
    ch = chunk_size(l, l if _WHOLE else chunk)
    a32 = A.to(torch.float32)
    h = torch.zeros((b, di, n), dtype=torch.float32, device=x_c.device) \
        if h0 is None else h0
    ys = []
    for s in range(0, l, ch):
        dt32 = dt[:, s:s + ch].to(torch.float32)
        a_c = torch.exp(dt32[..., None] * a32)                # (B,ch,dI,N)
        bx_c = (dt32 * x_c[:, s:s + ch].to(torch.float32))[..., None] \
            * B_t[:, s:s + ch].to(torch.float32)[:, :, None, :]
        cum_a, cum_b = _doubling_scan(a_c, bx_c)
        hs = cum_a * h[:, None] + cum_b                       # (B,ch,dI,N)
        c32 = C_t[:, s:s + ch].to(torch.float32)
        ys.append(torch.matmul(hs, c32[..., None])[..., 0])   # (B,ch,dI)
        # a copy: a view would keep the chunk's (B,ch,dI,N) states alive
        # as long as the returned state
        h = hs[:, -1].clone()
    return torch.cat(ys, 1).to(x_c.dtype), h


def _own_in_proj(w, di: int, ax: tuple):
    """This rank's ``x`` and ``z`` columns of ``in_proj``, side by side,
    where the rules split ``d_inner`` over ``ax``: ``w`` is the rank's
    block of the (d, 2 * d_inner) weight, whose columns hold all of ``x``
    then all of ``z`` (so on two ranks one block is ``x``, the other
    ``z``); it is gathered over ``ax`` and the rank's ``di`` channels of
    each half taken (the gather's backward reduce-scatters the
    gradient)."""
    full = all_gather(w, ax, dim=1)
    half = full.shape[1] // 2
    lo = axis_index(ax) * di
    return torch.cat([full[:, lo:lo + di], full[:, half + lo:half + lo + di]],
                     dim=1)


def _mixer(p, x, cdt, chunk, conv_method):
    """The block's body: (out, x_in before the conv, h_last). Where the
    rules split ``d_inner``, ``p`` holds this rank's channels (the conv,
    ``dt_proj``, ``A_log``, ``D``: per channel; ``x_proj`` and
    ``out_proj``: row-parallel, their products summed over the ranks), and
    ``in_proj``'s are taken by :func:`_own_in_proj`; the scan is per
    channel."""
    rank = p["dt_proj"].shape[0]
    n = p["A_log"].shape[-1]
    ax = split_axes("d_inner")
    w_in = p["in_proj"]
    if ax:
        w_in = _own_in_proj(w_in, p["D"].shape[-1], ax)
    xz = x @ w_in.to(cdt)
    # x_in is a view of xz's first D columns: the conv reads it in place
    x_in, z = xz.chunk(2, dim=-1)
    x_in = constrain(x_in, "batch", None, "d_inner")
    x_c = K.causal_conv1d(x_in, p["conv_w"].to(cdt), method=conv_method)
    x_c = F.silu(x_c + p["conv_b"].to(cdt))
    dbc = x_c @ p["x_proj"].to(cdt)
    if ax:
        dbc = psum(dbc, ax)
    dt_low, b_t, c_t = torch.split(dbc, [rank, n, n], dim=-1)
    dt = F.softplus(dt_low @ p["dt_proj"].to(cdt) + p["dt_bias"].to(cdt))
    A = -torch.exp(p["A_log"].to(torch.float32))
    y, h_last = mamba_scan(x_c, dt, A, b_t, c_t, chunk=chunk)
    y = y + p["D"].to(cdt) * x_c
    y = constrain(y * F.silu(z), "batch", None, "d_inner")
    out = y @ p["out_proj"].to(cdt)
    return (psum(out, ax) if ax else out), x_in, h_last


def mamba_forward(p, x, m: MambaConfig, cdt, *, chunk: int = 256,
                  conv_method: str = "cuda"):
    """Full-sequence Mamba block. x: (B, L, d) -> (B, L, d)."""
    return _mixer(p, x, cdt, chunk, conv_method)[0]


def mamba_forward_with_state(p, x, m: MambaConfig, cdt, *,
                             chunk: int = 256, conv_method: str = "cuda"):
    """:func:`mamba_forward` that also returns the final ``{conv, ssm}``
    state (JAX's ``transformer._mamba_forward_with_state``): the last K-1
    conv inputs (zero rows before position 0 when L < K-1) and the scan's
    last state."""
    out, x_in, h_last = _mixer(p, x, cdt, chunk, conv_method)
    k = p["conv_w"].shape[0]
    tail = x_in[:, max(x_in.shape[1] - (k - 1), 0):]
    if tail.shape[1] < k - 1:
        tail = F.pad(tail, (0, 0, k - 1 - tail.shape[1], 0))
    return out, {"conv": tail, "ssm": h_last}


# ---------------------------------------------------------------- decode ---

def mamba_init_state(cfg_d: int, m: MambaConfig, batch: int,
                     dtype=torch.float32, device="cuda"):
    di = m.expand * cfg_d
    return {"conv": torch.zeros((batch, m.d_conv - 1, di), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, di, m.d_state), dtype=torch.float32,
                               device=device)}


def mamba_decode_step(p, x_t, state, m: MambaConfig, cdt):
    """One token. x_t: (B, 1, d); state: {conv (B,K-1,dI), ssm (B,dI,N)}.
    Returns (out (B,1,d), new state); the state's tensors are new."""
    rank = p["dt_proj"].shape[0]
    n = p["A_log"].shape[-1]
    xz = x_t @ p["in_proj"].to(cdt)
    x_in, z = xz.chunk(2, dim=-1)                          # (B,1,dI)
    window = torch.cat([state["conv"].to(cdt), x_in], dim=1)
    w = p["conv_w"].to(cdt)                                # (K, dI)
    x_c = torch.einsum("bkd,kd->bd", window, w)[:, None] + p["conv_b"].to(cdt)
    x_c = F.silu(x_c)
    dbc = x_c @ p["x_proj"].to(cdt)
    dt_low, b_t, c_t = torch.split(dbc, [rank, n, n], dim=-1)
    dt = F.softplus(dt_low @ p["dt_proj"].to(cdt) + p["dt_bias"].to(cdt))
    A = -torch.exp(p["A_log"].to(torch.float32))
    dt32 = dt.to(torch.float32)[:, 0]                      # (B,dI)
    a = torch.exp(dt32[..., None] * A)                     # (B,dI,N)
    bx = (dt32 * x_c.to(torch.float32)[:, 0])[..., None] \
        * b_t.to(torch.float32)[:, 0, None, :]
    h = a * state["ssm"] + bx
    y = torch.matmul(h, c_t.to(torch.float32)[:, 0, :, None])[..., 0][:, None]
    y = y.to(cdt) + p["D"].to(cdt) * x_c
    y = y * F.silu(z)
    out = y @ p["out_proj"].to(cdt)
    return out, {"conv": window[:, 1:].to(state["conv"].dtype), "ssm": h}

