"""Per-kernel search spaces of the port's autotuner (port of
``repro/tune/space.py``).

The knobs are what the port's CUDA kernels expose, not the Pallas block
names, which mean nothing to them:

* ``maxpool2d`` (every mode; a thread owns one output element, or one
  16-byte vector of a pixel's channels on the vector paths, which the
  kernels take by shape and alignment): the block size ``threads``, one
  of 64, 128, 256, 512 or 1024 (default 256, its launch before the tuner
  existed);
* ``depthwise2d`` in every mode (a staged-row kernel): a thread's output
  pixels along a row ``pt`` (1, 2 or 4) and a block's output rows
  ``rows`` (1, 2, 4 or 8); the default is the wrapper's
  (``kernels.conv_dw.default_dw_tile``), which depends on the shape;
* ``conv2d`` in every mode (the integer modes an implicit GEMM, the float
  mode a float implicit GEMM), ``shift_conv2d`` in every mode (the integer
  modes on the integer conv's implicit GEMM, the float mode a
  register-tiled kernel) and ``add_conv2d`` in every mode (on the float
  conv's implicit GEMM): the block's run of output pixels ``bp`` (32, 64,
  128 or 256) and a thread's output channels ``q`` (4, 8 or 16); the
  default is the wrapper's (``kernels.conv_im2col.default_tile`` /
  ``default_f_tile``, ``kernels.conv_shift.default_shift_tile``), which
  depends on the shape;
* ``matmul``: in the integer modes the block's tile, ``bn`` output
  columns x ``bm`` rows of a, one of the instantiated ``MMQ_TILES`` (``bm``
  at most the least power of two from 8 that holds M), and the
  ``cluster`` of blocks that split K (1, 2, 4 or 8, and no more than give
  every warp a 64-deep K stage); default
  ``kernels.matmul_q8.default_mmq_config``, by the shape; in the float
  mode the block tile ``bm`` x ``bn`` and the thread tile ``tm`` x ``tn``,
  one of the instantiated ``MMF_TILES`` (default
  ``kernels.matmul_q8.default_mmf_tile``, by the shape). The float mode
  sums K in order and has no split;
* ``causal_conv1d``: a thread's run of positions on the vector path,
  ``run`` (1, 2, 4 or 8), and the block size ``threads`` (64, 128 or
  256), each a template argument; the default is the wrapper's
  (``kernels.conv1d_causal.default_c1d_config``), which depends on the
  shape. Where D * elsize is not a multiple of 16 the kernel takes its
  scalar path, which has no run: there only ``threads`` varies.

No knob changes the value of an output: each changes only the launch
shape, and the integer split sums are exact. So every candidate gives
output bitwise equal to the default's, which is what makes the tuner safe
to leave on. :func:`launch_errors` holds each config to the H100's limits
through ``repro_torch.check.check_schedule``, the one footprint model and
verdict (``check/footprint.py``): the grid, threads per block, the integer
matmul's cluster (at most 8 blocks, the portable limit), for the kernels
that stage tiles in shared memory (``conv2d``, ``depthwise2d``,
``shift_conv2d``, ``add_conv2d``, ``matmul``) their dynamic shared bytes,
at most 232,448 a block (past 48 KB the sources raise the kernel's limit
with ``cudaFuncSetAttribute``), and where this process loaded a built
library, ``ptxas``'s registers.

A *config* is a plain dict of those kwargs. :func:`candidates` enumerates
the configs a shape can launch, default first and deduplicated by the
schedule they run (:func:`effective_config`); :func:`check_config` raises
``repro_torch.check.CheckError`` for one outside that space. Shape
signatures and their ``key()`` strings are the JAX package's, so one
(kernel, key, dtype) names the same job in both.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Iterator, List, Tuple

from repro_torch.check import footprint as _footprint
from repro_torch.core.energy import H100_SXM
from repro_torch.kernels import _build
from repro_torch.kernels.common import DEFAULT_THREADS, cdiv
from repro_torch.kernels.conv1d_causal import RUNS as C1D_RUNS
from repro_torch.kernels.conv1d_causal import THREADS as C1D_THREADS
from repro_torch.kernels.conv1d_causal import c1d_plan, default_c1d_config
from repro_torch.kernels.conv_add import add_f_plan
from repro_torch.kernels.conv_dw import (DW_PT, DW_ROWS, default_dw_tile,
                                         dw_plan)
from repro_torch.kernels.conv_im2col import (CONV_BP, CONV_Q, conv_f_plan,
                                             conv_plan, default_f_tile,
                                             default_tile)
from repro_torch.kernels.conv_shift import (default_shift_tile, shift_f_plan,
                                            shift_plan)
from repro_torch.kernels.matmul_q8 import (MMF_KNOBS, MMF_TILES,
                                           MMQ_CLUSTERS, MMQ_KNOBS,
                                           MMQ_TILES, default_mmf_tile,
                                           default_mmq_config, mmq_bm_cap,
                                           mmq_cluster_cap)
from repro_torch.kernels.pool import pool_f_plan, pool_plan

# Kernels the tuner knows about. Names match repro_torch.kernels.ops.
KERNELS = ("conv2d", "depthwise2d", "shift_conv2d", "add_conv2d",
           "causal_conv1d", "matmul", "maxpool2d")

#: the kernels whose one knob is the block size, and its values, default
#: first
THREADED = ("maxpool2d",)
#: the kernels whose knobs are an implicit GEMM's tile (bp, q)
TILED = ("conv2d", "shift_conv2d", "add_conv2d")
THREADS = (DEFAULT_THREADS, 64, 128, 512, 1024)
#: SMs of the card the space is sized for (an H100 SXM): the integer
#: matmul's default cluster depends on it
SMS = H100_SXM.sms
#: CUDA grid limits: x, and y and z
MAX_GRID_X, MAX_GRID_YZ = 2 ** 31 - 1, 65535


def dtype_key(dtype) -> str:
    """The cache's dtype string: ``"float32"``, ``"bfloat16"``, ``"int8"``
    or ``"w4a8"`` (packed weights), as the JAX package writes them; a
    ``torch.dtype`` is named without its ``torch.`` prefix."""
    return str(dtype).replace("torch.", "")


def integer(dtype) -> bool:
    """int8 codes (and W4A8: packed weights, int8 activations)."""
    return dtype_key(dtype) in ("int8", "uint8", "w4a8")


@dataclasses.dataclass(frozen=True)
class ShapeSig:
    """Canonical shape signature of one kernel invocation.

    ``dims`` is a tuple of named ints in kernel-specific order; it is what the
    cache keys on and what the space enumerates against.
    """

    kernel: str
    dims: Tuple[Tuple[str, int], ...]

    def __post_init__(self):
        if self.kernel not in KERNELS:
            raise ValueError(f"unknown kernel {self.kernel!r}; "
                             f"known: {KERNELS}")

    def get(self, name: str) -> int:
        for k, v in self.dims:
            if k == name:
                return v
        raise KeyError(name)

    def key(self) -> str:
        return "_".join(f"{k}{v}" for k, v in self.dims)


def sig_conv2d(n, h, w, cx, cy, hk, groups=1) -> ShapeSig:
    return ShapeSig("conv2d", (("n", n), ("h", h), ("w", w), ("ci", cx),
                               ("co", cy), ("k", hk), ("g", groups)))


def sig_depthwise2d(n, h, w, c, hk) -> ShapeSig:
    return ShapeSig("depthwise2d", (("n", n), ("h", h), ("w", w), ("c", c),
                                    ("k", hk)))


def sig_shift_conv2d(n, h, w, c, cy, d=1) -> ShapeSig:
    """``d``: the shift table's bound (``max_shift``, at least 1), which
    sizes the integer kernels' window. Keyed only where it is not 1, so
    the paper's 3x3 shift grid keeps the JAX package's key (whose kernel
    has no window)."""
    dims = (("n", n), ("h", h), ("w", w), ("c", c), ("co", cy))
    return ShapeSig("shift_conv2d", dims + ((("d", d),) if d != 1 else ()))


def sig_add_conv2d(n, h, w, cx, cy, hk) -> ShapeSig:
    return ShapeSig("add_conv2d", (("n", n), ("h", h), ("w", w), ("ci", cx),
                                   ("co", cy), ("k", hk)))


def sig_causal_conv1d(b, l, d, k) -> ShapeSig:
    return ShapeSig("causal_conv1d", (("b", b), ("l", l), ("d", d), ("k", k)))


def sig_matmul(m, k, n) -> ShapeSig:
    return ShapeSig("matmul", (("m", m), ("k", k), ("n", n)))


def sig_maxpool2d(n, h, w, c, window, stride) -> ShapeSig:
    return ShapeSig("maxpool2d", (("n", n), ("h", h), ("w", w), ("c", c),
                                  ("k", window), ("s", stride)))


def outputs(sig: ShapeSig) -> int:
    """Output elements of one invocation."""
    g = sig.get
    k = sig.kernel
    if k == "maxpool2d":
        win, s = g("k"), g("s")
        return (g("n") * ((g("h") - win) // s + 1) * ((g("w") - win) // s + 1)
                * g("c"))
    if k == "depthwise2d":
        return g("n") * g("h") * g("w") * g("c")
    if k in ("conv2d", "shift_conv2d", "add_conv2d"):
        return g("n") * g("h") * g("w") * g("co")
    if k == "causal_conv1d":
        return g("b") * g("l") * g("d")
    return g("m") * g("n")


def threaded(kernel: str, dtype=None) -> bool:
    """Whether ``kernel``'s one knob is ``threads`` (the pool), in every
    mode."""
    return kernel in THREADED


def pool_launch(sig: ShapeSig, threads: int, dtype) -> dict:
    """A pool job's launch (``kernels.pool.pool_plan`` / ``pool_f_plan``)
    on 16-byte aligned tensors, as the tuner's jobs and the CNN plans give
    them: ``blocks``, ``threads`` and ``vector``."""
    g = sig.get
    win, s = g("k"), g("s")
    ho, wo = (g("h") - win) // s + 1, (g("w") - win) // s + 1
    if integer(dtype):
        return pool_plan(g("n"), ho, wo, g("c"), True, threads)
    return pool_f_plan(g("n"), ho, wo, g("c"), dw_esize(dtype), True,
                       threads)


def c1d_launch(sig: ShapeSig, cfg: Dict[str, int], dtype) -> dict:
    """A causal_conv1d job's launch (``kernels.conv1d_causal.c1d_plan``)
    under ``cfg`` on 16-byte aligned tensors."""
    g = sig.get
    return c1d_plan(g("b"), g("l"), g("d"), dw_esize(dtype), True,
                    cfg["run"], cfg["threads"])


def tiled(kernel: str, dtype=None) -> bool:
    """Whether ``kernel`` takes an implicit GEMM's tile (bp, q): every mode
    of ``conv2d``, ``shift_conv2d`` and ``add_conv2d``."""
    return kernel in TILED


def dw_esize(dtype) -> int:
    """Bytes an element of a depthwise mode's x: the plan's ``esize``."""
    return {"bfloat16": 2, "float32": 4}.get(dtype_key(dtype), 1)


def knobs(kernel: str, dtype) -> Tuple[str, ...]:
    """The config keys ``kernel`` takes in ``dtype``."""
    if threaded(kernel, dtype):
        return ("threads",)
    if kernel == "causal_conv1d":
        return ("run", "threads")
    if tiled(kernel, dtype):
        return ("bp", "q")
    if kernel == "depthwise2d":
        return ("pt", "rows")
    if kernel == "matmul":
        return MMQ_KNOBS if integer(dtype) else MMF_KNOBS
    raise ValueError(f"unknown kernel {kernel!r}")


def conv_shape(sig: ShapeSig) -> tuple:
    """A conv2d signature as the kernels' (n, h, w, cx, cy, hk, groups)."""
    g = sig.get
    return (g("n"), g("h"), g("w"), g("ci"), g("co"), g("k"), g("g"))


def shift_shape(sig: ShapeSig) -> tuple:
    """A shift_conv2d signature as the kernels' (n, h, w, c, cy, d)."""
    g = sig.get
    d = dict(sig.dims).get("d", 1)
    return (g("n"), g("h"), g("w"), g("c"), g("co"), d)


def dw_shape(sig: ShapeSig) -> tuple:
    """A depthwise2d signature as the kernels' (n, h, w, c, hk)."""
    g = sig.get
    return (g("n"), g("h"), g("w"), g("c"), g("k"))


def add_shape(sig: ShapeSig) -> tuple:
    """An add_conv2d signature as the kernels' (n, h, w, cx, cy, hk)."""
    g = sig.get
    return (g("n"), g("h"), g("w"), g("ci"), g("co"), g("k"))


def tile_plan(sig: ShapeSig, bp: int, q: int, dtype) -> dict:
    """The launch arithmetic of a TILED kernel's (bp, q) on this shape."""
    if sig.kernel == "conv2d":
        plan = conv_plan if integer(dtype) else conv_f_plan
        return plan(*conv_shape(sig), bp, q)
    if sig.kernel == "add_conv2d":
        return add_f_plan(*add_shape(sig), bp, q)
    n, h, w, c, cy, d = shift_shape(sig)
    if integer(dtype):
        return shift_plan(n, h, w, c, cy, d, bp, q)
    return shift_f_plan(n, h, w, c, cy, bp, q)


def default_config(kernel: str, sig: ShapeSig = None,
                   dtype="float32") -> Dict[str, int]:
    """Today's launch: what each wrapper does when given no config. The
    tiled kernels' and the matmul's depend on the shape (``sig``)."""
    if threaded(kernel, dtype):
        return {"threads": DEFAULT_THREADS}
    if kernel not in ("matmul", "conv2d", "shift_conv2d", "add_conv2d",
                      "depthwise2d", "causal_conv1d"):
        raise ValueError(f"unknown kernel {kernel!r}")
    if sig is None:
        raise ValueError(f"{kernel}'s default config depends on its shape: "
                         "pass sig")
    if kernel == "conv2d":
        tile = default_tile if integer(dtype) else default_f_tile
        return tile(*conv_shape(sig))
    if kernel == "add_conv2d":
        return default_f_tile(*add_shape(sig), 1)
    if kernel == "depthwise2d":
        return default_dw_tile(*dw_shape(sig), dw_esize(dtype))
    if kernel == "causal_conv1d":
        return default_c1d_config(sig.get("b"), sig.get("l"), sig.get("d"),
                                  sig.get("k"), dw_esize(dtype))
    if kernel == "shift_conv2d":
        return default_shift_tile(*shift_shape(sig), integer=integer(dtype))
    m, k, n = sig.get("m"), sig.get("k"), sig.get("n")
    if not integer(dtype):
        return default_mmf_tile(m, n)
    return default_mmq_config(m, k, n, SMS)


def effective_config(sig: ShapeSig, cfg: Dict[str, int],
                     dtype="float32") -> Dict[str, int]:
    """The launch ``cfg`` runs on this shape, absent knobs at their
    default. Two configs with equal effective configs are the same launch;
    the space dedupes on this."""
    eff = dict(default_config(sig.kernel, sig, dtype))
    eff.update({k: v for k, v in cfg.items() if k in eff})
    return eff


def launch_errors(sig: ShapeSig, cfg: Dict[str, int], dtype) -> List[str]:
    """Why a config cannot launch on this shape on an H100, empty if it
    can: the errors of ``repro_torch.check.check_schedule``, the one
    verdict the tuner, ``kernels.ops`` and the executor share (the block
    size, the grid limits, the integer matmul's cluster, for the kernels
    that stage tiles shared bytes a block and threads a block, and where
    this process loaded a build, ``ptxas``'s registers)."""
    return _footprint.check_schedule(sig, cfg, dtype).errors


def _key(cfg) -> tuple:
    return tuple(sorted(cfg.items()))


def candidates(sig: ShapeSig, dtype="float32") -> Iterator[Dict[str, int]]:
    """Enumerate the configs this shape can launch, default first, each
    effective launch once. The default is always a member."""
    k = sig.kernel
    out: List[Dict[str, int]] = []
    seen = set()

    def emit(cfg, prune=True):
        eff = effective_config(sig, cfg, dtype)
        if _key(eff) in seen or (prune and launch_errors(sig, eff, dtype)):
            return
        seen.add(_key(eff))
        out.append(dict(cfg))

    default = default_config(k, sig, dtype)
    emit(default, prune=False)
    if threaded(k, dtype):
        for t in THREADS:
            emit({"threads": t})
    elif k == "causal_conv1d":
        # the scalar path (D * elsize off 16 bytes) has no run
        vector = c1d_launch(sig, default, dtype)["vector"]
        for r in C1D_RUNS if vector else (default["run"],):
            for t in C1D_THREADS:
                emit({"run": r, "threads": t})
    elif tiled(k, dtype):       # conv2d, shift_conv2d, add_conv2d
        for bp in CONV_BP:
            for q in CONV_Q:
                emit({"bp": bp, "q": q})
    elif k == "depthwise2d":
        for pt in DW_PT:
            for rows in DW_ROWS:
                emit({"pt": pt, "rows": rows})
    elif not integer(dtype):                       # float matmul
        for tile in MMF_TILES:
            emit(dict(zip(MMF_KNOBS, tile)))
    else:                                          # integer matmul
        bm_cap = mmq_bm_cap(sig.get("m"))
        for bn, bm in MMQ_TILES:
            for c in MMQ_CLUSTERS:
                if bm <= bm_cap and c <= mmq_cluster_cap(sig.get("k"), bm):
                    emit({"bn": bn, "bm": bm, "cluster": c})
    return iter(out)


def space_size(sig: ShapeSig, dtype="float32") -> int:
    return sum(1 for _ in candidates(sig, dtype))


@functools.lru_cache(maxsize=1024)
def _space_keys(sig: ShapeSig, dtype: str, build: int,
                budget: int) -> frozenset:
    """The effective launches of a shape's candidates, per loaded build
    and shared-memory budget (the verdict that prunes them reads both)."""
    return frozenset(_key(effective_config(sig, c, dtype))
                     for c in candidates(sig, dtype))


def space_errors(sig: ShapeSig, cfg: Dict[str, int], dtype) -> List[str]:
    """Why a config that can launch is still not one of the tuner's
    candidates for this shape. Empty if it is."""
    dt = dtype_key(dtype)
    keys = _space_keys(sig, dt, _build.library.cache_info().currsize,
                       _footprint.smem_budget())
    if _key(effective_config(sig, cfg, dt)) in keys:
        return []
    return [f"config {cfg} is outside the tuner's space"]


@functools.lru_cache(maxsize=4096)
def _check(sig: ShapeSig, items: tuple, dtype: str, build: int, budget: int):
    from repro_torch.check import CheckError
    v = _footprint.check_schedule(sig, dict(items), dtype)
    if not v.ok:
        raise CheckError(f"infeasible schedule for {v.kernel}/{v.sig_key} "
                         f"[{v.dtype}] {v.config}: it cannot launch:",
                         v.errors)
    errs = space_errors(sig, v.config, dtype)
    if errs:
        raise CheckError(f"infeasible schedule for {v.kernel}/{v.sig_key} "
                         f"[{v.dtype}] {v.config}:", errs)


def check_config(sig: ShapeSig, config: Dict[str, int], dtype="float32"):
    """Raise ``repro_torch.check.CheckError`` (a ``ValueError``) for a
    config that cannot launch (``check_schedule``'s verdict) or lies
    outside the space; return the config unchanged. Verdicts are memoized
    per loaded build and shared-memory budget, so a config checked once
    costs a dict probe after."""
    try:
        items = _key(config)
        hash(items)
    except TypeError:
        raise ValueError(f"config must be a dict of ints, got {config!r}")
    _check(sig, items, dtype_key(dtype),
           _build.library.cache_info().currsize, _footprint.smem_budget())
    return config
