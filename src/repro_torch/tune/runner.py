"""Measured autotuner and analytic fallback cost model (port of
``repro/tune/runner.py``).

Two ways to pick a schedule, as in the JAX package:

* :func:`autotune` runs every candidate of ``space.candidates`` through the
  real kernel entry point and keeps the fastest. On the card it ranks them
  by :func:`device_us`, the profiler's device time of the kernels a call
  launched (CUDA events around a Python call time the host, PERF.md). On
  the host it ranks the plain versions by :func:`time_config` and tags the
  results ``cpu``, so a card never consumes them.
* :func:`analytic_config` measures nothing: the lowest price under
  :func:`estimate_s`, a first-order H100 model (the larger of the bytes and
  the operations term, times a tail-wave factor, plus the launch overhead;
  for the tiled kernels, conv2d, shift_conv2d, add_conv2d and the float
  matmul, the operations term is the instructions their tiles issue, over
  the SMs' issue rate, slowed where too few warps are resident to hide
  latency; for the integer matmul, whose blocks wait on device memory,
  its waves of blocks times each block's chain (trips to device memory,
  instructions, a cluster's barrier) plus its bytes, constants fitted to
  the card's sweep of its configs; for depthwise2d the bytes term counts its staged halo and the
  sectors a narrow channel slab wastes, and a grid of fewer than 128
  blocks is slowed in proportion; for causal_conv1d the kernel module's
  model, fitted to the card's sweep, whose pick is the wrapper's default;
  the pools' blocks are those of their vector or scalar launch).

:func:`get_config` is the dispatch layer's lookup: memo, then the loaded
cache, then the analytic model. Every knob changes only a launch shape, so
whichever config a lookup returns, every output is the same bit for bit.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import statistics
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels.conv1d_causal import c1d_cost_s
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import trace as _obs_trace

from . import cache as _cache
from . import space as _space
from .space import ShapeSig, dtype_key, effective_config, integer

# H100 SXM (NVIDIA's data sheet; 1,980 MHz boost clock): per-SM residency
# limits, device-memory bandwidth, CUDA-core rates
SMS = _space.SMS
THREADS_PER_SM, BLOCKS_PER_SM = 2048, 32
HBM_BPS = 3.35e12
#: float32 multiply-adds as FMAs: 132 SMs x 128 lanes x 2 x 1.98 GHz
F32_FMA_FLOPS = 66.9e12
#: float32 operations with no FMA form (|x - w|'s subtract and add, max)
F32_OPS = 33.45e12
#: int32 lanes: 132 SMs x 64 x 1.98 GHz
INT32_OPS = 16.73e12
#: int8 operations on the tensor cores (dense peak; the integer matmul's)
INT8_TC_OPS = 1979e12
#: the integer matmul's latency terms, fitted to every config's device time
#: at Qwen2-0.5B's FFN shapes (scripts/torch_matmul_tiles.py on an NVIDIA
#: H100 80GB HBM3 at 700 W, PERF.md): a trip to device memory and back (a
#: warp requests its stages ring - 1 at a time), a warp instruction of one
#: warp's chain (about 8 cycles), a cluster's launch and barrier, and its
#: leader's inbox per block and 256 outputs; and the L2's rate for the
#: operands a grid reads more than once
DRAM_TRIP_S, WARP_INSTR_S = 0.25e-6, 4e-9
CLUSTER_S, CLUSTER_TILE_S = 2e-6, 2e-7
L2_BPS = 6e12
#: bytes device memory moves for one access however few are asked for
DRAM_BURST = 64
#: fixed cost of one kernel launch on the device
LAUNCH_S = 3e-6
#: device memory's access granularity (bytes), and the blocks a job needs
#: to keep the card's SMs busy (kernels.conv_im2col.DEFAULT_BLOCKS)
SECTOR, DEFAULT_BLOCKS = 32, 128
#: the tiled kernels' issue model: warp instructions an SM issues a cycle
#: (four schedulers), its clock, the resident warps an SM needs to keep
#: them busy, its shared memory, and instructions per element staged by
#: index arithmetic (divisions and bounds checks)
ISSUE_PER_CLK, CLOCK_HZ, WARPS_TO_HIDE = 4, 1.98e9, 8
SMEM_PER_SM, STAGE_INSTR = 228 * 1024, 20
#: profiler sessions tried before the device timer gives up, the pause
#: after a session that recorded nothing (doubled each time), the fewest
#: calls a session times, and the sessions each measurement merges. On the
#: card's machine (an H100 under torch.profiler's CUPTI tracing) a session
#: now and then records none, or only part, of the device activity it ran,
#: more often late in a long process
PROFILE_TRIES, PROFILE_PAUSE_S, PROFILE_MIN_CALLS = 8, 0.05, 20
PROFILE_SESSIONS = 2


# --------------------------------------------------------------------------
# Backend tag
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _card_tag(index: int) -> str:
    major, minor = torch.cuda.get_device_capability(index)
    name = torch.cuda.get_device_name(index).replace(" ", "_")
    return f"cuda:{name}:sm{major}{minor}"


def backend_tag(device=None) -> str:
    """Cache-key backend tag: ``"cpu"`` for the host (plain versions), else
    the card's name and compute capability, so a cache from another card or
    from the host is never consumed. ``device=None`` means the card if
    there is one."""
    if device is None:
        if not torch.cuda.is_available():
            return "cpu"
        return _card_tag(torch.cuda.current_device())
    dev = device if isinstance(device, torch.device) else torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    return _card_tag(dev.index if dev.index is not None
                     else torch.cuda.current_device())


# --------------------------------------------------------------------------
# Analytic fallback cost model
# --------------------------------------------------------------------------

def _elem_bytes(dtype) -> Tuple[float, float]:
    """(activation bytes, weight bytes) per element."""
    d = dtype_key(dtype)
    if d == "w4a8":
        return 1.0, 0.5
    if d in ("int8", "uint8"):
        return 1.0, 1.0
    if d in ("bfloat16", "float16"):
        return 2.0, 2.0
    return 4.0, 4.0


def _work(sig: ShapeSig, dtype) -> Tuple[float, float]:
    """(bytes, operation seconds) of one invocation: each input read once
    and each output written once, and its arithmetic at the rate of the
    units that run it: the CUDA cores' for its type, the integer matmul's
    the int8 tensor cores'."""
    g = sig.get
    k = sig.kernel
    xb, wb = _elem_bytes(dtype)
    ints = integer(dtype)
    out = _space.outputs(sig)
    if k == "conv2d":
        grp = max(g("g"), 1)
        macs = out * (g("ci") // grp) * g("k") ** 2
        nbytes = (xb * g("n") * g("h") * g("w") * g("ci")
                  + wb * g("k") ** 2 * (g("ci") // grp) * g("co") + xb * out)
    elif k == "depthwise2d":
        macs = out * g("k") ** 2
        nbytes = 2 * xb * out + wb * g("k") ** 2 * g("c")
    elif k == "shift_conv2d":
        macs = out * g("c")
        nbytes = (xb * g("n") * g("h") * g("w") * g("c") + 8 * g("c")
                  + wb * g("c") * g("co") + xb * out)
    elif k == "add_conv2d":
        taps = out * g("ci") * g("k") ** 2
        nbytes = (xb * g("n") * g("h") * g("w") * g("ci")
                  + wb * g("k") ** 2 * g("ci") * g("co") + xb * out)
        # |x - w| and the accumulate: no FMA form
        return nbytes, (3 * taps / INT32_OPS if ints else 2 * taps / F32_OPS)
    elif k == "maxpool2d":
        nbytes = xb * (g("n") * g("h") * g("w") * g("c") + out)
        return nbytes, out * g("k") ** 2 / (INT32_OPS if ints else F32_OPS)
    elif k == "causal_conv1d":
        macs = out * g("k")
        nbytes = 2 * xb * out + wb * g("k") * g("d")
    elif k == "matmul":
        macs = out * g("k")
        nbytes = xb * g("m") * g("k") + wb * g("k") * g("n") + xb * out
        return nbytes, 2 * macs / (INT8_TC_OPS if ints else F32_FMA_FLOPS)
    else:
        raise ValueError(f"unknown kernel {k!r}")
    return nbytes, (macs / INT32_OPS if ints else 2 * macs / F32_FMA_FLOPS)


def _tail(blocks: int, threads: int) -> float:
    """Tail-wave factor: whole waves launched over the waves the blocks
    fill, with ``min(32, 2048 / threads)`` blocks resident per SM."""
    resident = max(1, min(BLOCKS_PER_SM, THREADS_PER_SM // threads))
    waves = blocks / (SMS * resident)
    return math.ceil(waves) / waves if waves > 0 else 1.0


def _issue_s(blocks: int, threads: int, smem: int,
             instr_per_thread: float) -> float:
    """Seconds an H100 takes to issue ``blocks`` blocks of ``threads``
    threads that each issue ``instr_per_thread`` instructions, with
    ``smem`` shared bytes a block: the warp instructions over the SMs'
    issue rate, slowed by WARPS_TO_HIDE / the resident warps where fewer
    are resident."""
    warps = _space.cdiv(threads, 32)
    resident = max(1, min(BLOCKS_PER_SM, THREADS_PER_SM // threads,
                          SMEM_PER_SM // max(smem, 1)))
    per_sm = min(blocks / SMS, resident) * warps
    slow = max(1.0, WARPS_TO_HIDE / per_sm)
    return (blocks * warps * instr_per_thread * slow
            / (SMS * ISSUE_PER_CLK * CLOCK_HZ))


def _tiled_s(sig: ShapeSig, eff: Dict[str, int], dtype) -> float:
    """The operations term of the implicit GEMMs (conv2d and shift_conv2d
    in the integer modes; conv2d in the float mode and add_conv2d in every
    mode), of the float shift conv's and of the float matmul's register
    tiles, from the instructions they issue."""
    if _space.tiled(sig.kernel, dtype):
        q, bp = eff["q"], eff["bp"]
        plan = _space.tile_plan(sig, bp, q, dtype)
        t, bn = plan["threads"], plan["block_channels"]
        gx, gy = plan["grid"]
        if sig.kernel == "add_conv2d" or (sig.kernel == "conv2d"
                                          and not integer(dtype)):
            # the float implicit GEMM (conv2d, add_conv2d): pt x q a
            # thread, per K element two float instructions an output (the
            # integer add three), pt window loads, q/4 weight loads and an
            # offset; the window and the weights staged once a block. A
            # warp's K step also takes pt + q cycles of the SM's
            # shared-memory bandwidth (a broadcast 16-byte load delivers
            # 512 bytes)
            pt = plan["pixels"]
            grp = dict(sig.dims).get("g", 1)
            kk = sig.get("k") ** 2 * (sig.get("ci") // grp)
            terms = 3 if integer(dtype) else 2
            per_thread = (kk * (terms * pt * q + pt + q // 4 + 1)
                          + STAGE_INSTR * (plan["window"] / 4 + kk * bn) / t)
            lsu_s = (gx * gy * _space.cdiv(t, 32) * kk * (pt + q)
                     / (SMS * CLOCK_HZ))
            return max(lsu_s, _issue_s(gx * gy, t, plan["smem"],
                                       per_thread))
        if not integer(dtype):           # the float shift conv: 1 x q a thread
            c = sig.get("c")
            per_thread = (c * (2 * q + 1 + q // 4)
                          + STAGE_INSTR * c * (bp + bn) / t)
            return _issue_s(gx * gy, t, plan["smem"], per_thread)
        kw, pt = plan["k_words"], 32 // q
        # the tile's threads sum and requantize; all of them stage (a shift
        # conv gathers each im2col word as four bytes)
        summing = (bp // pt) * (bn // q)
        gather = 4 if sig.kernel == "shift_conv2d" else 1
        staged = plan["window"] + kw * (gather * bp + bn * 4)
        per_thread = (summing * (pt * q * kw + kw * (pt + q // 4)
                                 + 10 * pt * q) + STAGE_INSTR * staged) / t
        return _issue_s(gx * gy, t, plan["smem"], per_thread)
    from repro_torch.kernels.matmul_q8 import mmf_plan
    m, kk, n = sig.get("m"), sig.get("k"), sig.get("n")
    tile = tuple(eff[x] for x in _space.MMF_KNOBS)
    plan = mmf_plan(m, n, tile, int(_elem_bytes(dtype)[0]))
    bm, bn, tm, tn = tile
    t = plan["threads"]
    # a multiply and an add per element, the vector loads of the operands,
    # and each stage's copies
    per_thread = kk * (2 * tm * tn + _space.cdiv(tm, 4) + _space.cdiv(tn, 4)
                       + (bm + bn) / t)
    gx, gy = plan["grid"]
    return _issue_s(gx * gy, t, plan["smem"], per_thread)


def _mmq_s(sig: ShapeSig, eff: Dict[str, int], dtype) -> float:
    """The integer matmul's device seconds under (bn, bm, cluster): one
    launch, no workspace, blocks that stream K and wait on device memory.
    The waves of blocks the SMs hold at once (by shared memory), each as
    long as its warps' chain: a trip to device memory per ring - 1 K
    stages, the stages' instructions (a's fragments, the weights' word
    loads and transposes, W4's unpack, the mma, the copies) slowed by the
    warps that share a scheduler, and a cluster's launch, barrier and
    inbox; plus the bytes, each operand once over HBM_BPS (a weight row
    read in pieces narrower than DRAM_BURST counted whole) or all the
    grid's re-reads (the weight once a row tile, a once a column tile)
    over L2_BPS, slowed where the grid has fewer than WARPS_TO_HIDE warps
    an SM, or its operations at the tensor cores' rate if longer."""
    from repro_torch.kernels.matmul_q8 import mmq_plan
    m, kk, n = sig.get("m"), sig.get("k"), sig.get("n")
    w4 = dtype_key(dtype) == "w4a8"
    bn, bm, cs = eff["bn"], eff["bm"], eff["cluster"]
    plan = mmq_plan(m, kk, n, bn, bm, cs, w4)
    gx, gy = plan["grid"]
    blocks, tiles_n = gx * gy, gx // cs
    resident = max(1, min(BLOCKS_PER_SM, THREADS_PER_SM // plan["threads"],
                          SMEM_PER_SM // plan["smem"]))
    waves = math.ceil(blocks / (SMS * resident))
    no, nt = bn // 32, bm // 8
    # per 32-deep half of a stage: nt x 2 fragment loads of a; per 32
    # columns 8 word loads and 16 byte permutes (W4: 4 loads and the
    # unpack), 2 nt mma and the addressing; then the stage's 16-byte
    # copies, a lane's share
    per_half = 2 * nt + no * ((28 if w4 else 24) + 2 * nt + 4)
    copies = ((32 if w4 else 64) * bn + 64 * bm) / 16 / 32
    instr = 2 * per_half + STAGE_INSTR * copies
    sharing = max(1.0, min(blocks / SMS, resident) * plan["threads"] / 32
                  / ISSUE_PER_CLK)
    chain = plan["stages"] * instr * WARP_INSTR_S * sharing
    trips = _space.cdiv(plan["stages"], plan["ring"] - 1)
    cluster = (CLUSTER_S + CLUSTER_TILE_S * (cs - 1) * bm * bn / 256
               if cs > 1 else 0.0)
    xb, wb = _elem_bytes(dtype)
    # a block reads bn bytes of each weight row: narrower than a DRAM burst,
    # the rest of the burst is read for nothing
    burst = max(1.0, DRAM_BURST / bn)
    once = wb * kk * n * burst + xb * m * kk + xb * m * n
    reread = wb * kk * n * gy + xb * m * kk * tiles_n + xb * m * n
    warps = blocks * plan["threads"] / 32
    bytes_s = (max(once / HBM_BPS, reread / L2_BPS)
               / min(1.0, warps / (SMS * WARPS_TO_HIDE)))
    ops_s = _work(sig, dtype)[1]
    return (waves * (trips * DRAM_TRIP_S + chain + cluster)
            + max(bytes_s, ops_s))


def estimate_s(sig: ShapeSig, config: Dict[str, int], dtype) -> float:
    """Estimated seconds for one invocation under ``config``."""
    k = sig.kernel
    eff = effective_config(sig, config, dtype)
    if k == "matmul" and integer(dtype):
        return _mmq_s(sig, eff, dtype) + LAUNCH_S
    nbytes, ops_s = _work(sig, dtype)
    if _space.tiled(k, dtype) or (k == "matmul" and not integer(dtype)):
        return max(nbytes / HBM_BPS, _tiled_s(sig, eff, dtype)) + LAUNCH_S
    if k == "depthwise2d":
        # a staged-row block reads its rows' and columns' halo too, and a
        # slab of fewer channels than a pixel reads whole 32-byte sectors
        # for its share of each pixel; fewer blocks than DEFAULT_BLOCKS
        # leave SMs idle on a job that is one trip through device memory
        n, h, w, c, hk = _space.dw_shape(sig)
        plan = _space.dw_plan(n, h, w, c, hk, _space.dw_esize(dtype),
                              eff["pt"], eff["rows"])
        xb = _elem_bytes(dtype)[0]
        rows, cols, slab = (plan["rows"], plan["columns"],
                            plan["channels"] * xb)
        halo = (rows + hk - 1) / rows * (cols + hk - 1) / cols
        waste = (1.0 if slab >= c * xb
                 else math.ceil(slab / SECTOR) * SECTOR / slab)
        x_bytes = xb * n * h * w * c
        staged = nbytes - x_bytes + x_bytes * halo * waste
        gx, gy = plan["grid"]
        return (max(staged / HBM_BPS, ops_s)
                * max(1.0, DEFAULT_BLOCKS / (gx * gy)) + LAUNCH_S)
    if k in _space.THREADED:
        threads = eff["threads"]
        blocks = _space.pool_launch(sig, threads, dtype)["blocks"]
        return (max(nbytes / HBM_BPS, ops_s) * _tail(blocks, threads)
                + LAUNCH_S)
    return _c1d_s(sig, eff, dtype)


def _c1d_s(sig: ShapeSig, eff: Dict[str, int], dtype) -> float:
    """causal_conv1d's device seconds under (run, threads), launch
    included: ``kernels.conv1d_causal.c1d_cost_s``, the model fitted to
    the card's sweep whose cheapest config is the wrapper's default."""
    g = sig.get
    return c1d_cost_s(g("b"), g("l"), g("d"), g("k"),
                      int(_elem_bytes(dtype)[0]), eff["run"], eff["threads"])


def analytic_config(sig: ShapeSig, dtype="float32") -> Dict[str, int]:
    """The lowest-priced candidate under :func:`estimate_s` (the first one,
    the default, on a tie)."""
    best, best_s = None, float("inf")
    for cfg in _space.candidates(sig, dtype):
        s = estimate_s(sig, cfg, dtype)
        if s < best_s:
            best, best_s = cfg, s
    return best


# --------------------------------------------------------------------------
# Timers
# --------------------------------------------------------------------------

def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_config(fn: Callable, *args, reps: int = 5, warmup: int = 2) -> float:
    """Median wall-clock microseconds of one call, each call ending in
    ``torch.cuda.synchronize`` when a card is in use: what a caller
    waits, host time included."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        ts.append(time.perf_counter() - t0)
    return float(statistics.median(ts) * 1e6)


@dataclasses.dataclass(frozen=True)
class DeviceRow:
    """One kernel (or memset, memcpy) of a call: its name, its launches
    per call and its device microseconds per call."""
    key: str
    launches: float
    us: float


def device_kernels(fn: Callable, *args,
                   calls: int = PROFILE_MIN_CALLS) -> list:
    """The device activity of one call of ``fn``, one :class:`DeviceRow`
    per kernel name, from ``PROFILE_SESSIONS`` ``torch.profiler`` sessions
    of ``calls`` calls each. Records a session lost are filled in: a
    kernel's launches per call are the most any session saw, rounded up to
    a whole number (a call launches each of its kernels a fixed whole
    number of times), its time per launch the mean over every record of
    it. A session that recorded
    nothing is run again after a pause; raises if too few sessions, of
    ``PROFILE_TRIES``, recorded anything."""
    from torch.profiler import ProfilerActivity, profile
    fn(*args)
    torch.cuda.synchronize()
    sessions = []
    for i in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn(*args)
            torch.cuda.synchronize()
        rows = {e.key: (e.count, e.self_device_time_total)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA}
        if not rows:
            _obs_metrics.counter("tune.profile.lost_sessions").inc()
            time.sleep(PROFILE_PAUSE_S * 2 ** i)
            continue
        sessions.append(rows)
        if len(sessions) == PROFILE_SESSIONS:
            break
    else:
        raise RuntimeError(f"device_kernels: {PROFILE_TRIES} torch.profiler "
                           f"sessions gave {len(sessions)} that recorded "
                           f"device activity, not {PROFILE_SESSIONS}")
    out = []
    for key in sorted(set().union(*sessions)):
        seen = [r[key] for r in sessions if key in r]
        # a call launches each of its kernels a whole number of times;
        # both sessions can lose many records of one kernel
        launches = math.ceil(max(n for n, _ in seen) / calls - 1e-9)
        per_launch = sum(us for _, us in seen) / sum(n for n, _ in seen)
        out.append(DeviceRow(key, launches, launches * per_launch))
    expected = round(calls * sum(o.launches for o in out))
    for r in sessions:                  # sessions that lost some records
        if sum(n for n, _ in r.values()) < expected:
            _obs_metrics.counter("tune.profile.lost_sessions").inc()
    return out


def device_us(fn: Callable, *args, reps: int = 10) -> float:
    """Device microseconds of one call: the summed time of the device
    activity the call launched (:func:`device_kernels` over ``max(reps,
    20)`` calls), without the host time between launches."""
    return sum(r.us for r in device_kernels(
        fn, *args, calls=max(reps, PROFILE_MIN_CALLS)))


# --------------------------------------------------------------------------
# Measured autotuner
# --------------------------------------------------------------------------

def _kernel_call(kernel: str) -> Callable:
    """``(args, config, kwargs) -> output`` through the op entry point,
    ``method="cuda"`` with an explicit config (the plain version on host
    tensors)."""
    from repro_torch.kernels import ops
    if kernel not in _space.KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}")
    fn = getattr(ops, kernel)
    return lambda args, cfg, kw: fn(*args, method="cuda", config=cfg, **kw)


def _device(args):
    return next(a.device for a in args if hasattr(a, "device"))


def autotune(kernel: str, sig: ShapeSig, args: Tuple, *,
             kwargs: Optional[dict] = None, dtype="float32",
             reps: int = 5, warmup: int = 2,
             max_candidates: Optional[int] = None,
             verbose: bool = False) -> Tuple[Dict[str, int], float, list]:
    """Measure every candidate on ``args``; return ``(best_config,
    best_us, [(config, us), ...])``. ``kwargs`` are the call's other
    arguments, held fixed across candidates. On the card each candidate is
    ranked by :func:`device_us` (at least 20 calls), on the host by
    :func:`time_config` over ``reps``. A candidate that fails to launch
    raises."""
    call = _kernel_call(kernel)
    kw = kwargs or {}
    on_card = _device(args).type == "cuda"
    # throwaway pass: first-launch costs (the build, library handles) must
    # not land on the first timed candidate, the default
    call(args, _space.default_config(kernel, sig, dtype), kw)
    results = []
    for i, cfg in enumerate(_space.candidates(sig, dtype)):
        if max_candidates is not None and i >= max_candidates:
            break
        with _obs_trace.span("tune.candidate", kernel=kernel,
                             shape=sig.key(), config=dict(cfg)) as sp:
            fn = lambda a=args, c=cfg: call(a, c, kw)     # noqa: E731
            us = (device_us(fn, reps=reps) if on_card
                  else time_config(fn, reps=reps, warmup=warmup))
            sp.set(us=us)
        results.append((cfg, us))
        if verbose:
            print(f"  {kernel}/{sig.key()} {cfg} -> {us:.2f}us")
    best, best_us = min(results, key=lambda t: t[1])
    return best, best_us, results


def autotune_into(cache: _cache.TuneCache, kernel: str, sig: ShapeSig,
                  args: Tuple, dtype, **kw) -> Tuple[Dict[str, int], float]:
    """Autotune one (kernel, shape) and record the winner in ``cache``."""
    best, best_us, results = autotune(kernel, sig, args, dtype=dtype, **kw)
    default = _space.default_config(kernel, sig, dtype)
    default_us = next((us for cfg, us in results if cfg == default), None)
    key = _cache.cache_key(kernel, sig.key(), dtype_key(dtype),
                           backend_tag(_device(args)))
    cache.put(key, best, us=best_us, source="measured",
              default_us=default_us, n_candidates=len(results))
    return best, best_us


# --------------------------------------------------------------------------
# Whole-plan pre-tuning (repro_torch.graph integration)
# --------------------------------------------------------------------------

def plan_jobs(plan, *, batch: int = 1) -> list:
    """Autotune jobs covering every kernel invocation of a lowered
    ``repro_torch.graph`` Plan: one ``(kernel, sig, arrays, dtype, kwargs)``
    tuple per distinct (kernel, shape, dtype) the executor dispatches, on
    the plan's device. dws layers give their depthwise and pointwise
    stages, maxpool nodes their own job; W4 leaves tune under ``"w4a8"``
    and carry their group shifts. Requant shifts and pre-shifts are read
    off the plan, so the timed epilogues are the ones the executor runs.
    Tune at the batch you serve: the batch is part of every key."""
    from repro_torch.core.quantize import QTensorW4, add_preshifts

    weights = [v for n in plan.nodes if n.op == "qconv"
               for v in n.qparams.values() if hasattr(v, "q")]
    dev = weights[0].q.device if weights else torch.device("cpu")
    gen = torch.Generator(device=dev).manual_seed(0)

    def i8(shape):
        return torch.randint(-100, 100, shape, generator=gen, device=dev,
                             dtype=torch.int32).to(torch.int8)

    def wkw(wq):
        if isinstance(wq, QTensorW4):
            return {"w_shifts": wq.shifts}, "w4a8"
        return {}, "int8"

    jobs, seen = [], set()

    def emit(kernel, sig, arrays, kwargs, dtype="int8"):
        k = (kernel, sig.key(), dtype)
        if k not in seen:
            seen.add(k)
            jobs.append((kernel, sig, arrays, dtype, kwargs))

    for node in plan.nodes:
        if node.op == "maxpool" and "in_hw" in node.attrs:
            h, w = node.attrs["in_hw"]
            c = node.attrs["in_ch"]
            win, s = node.attrs["window"], node.attrs["stride"]
            emit("maxpool2d", _space.sig_maxpool2d(batch, h, w, c, win, s),
                 (i8((batch, h, w, c)),), dict(window=win, stride=s))
            continue
        if node.op != "qconv":
            continue
        spec = node.spec
        h, w = node.attrs["in_hw"]
        ci, co, hk = spec.in_channels, spec.out_channels, spec.kernel_size
        p = spec.primitive
        x = i8((batch, h, w, ci))
        if p in ("standard", "grouped"):
            g = spec.groups if p == "grouped" else 1
            wq = node.qparams["w"]
            kw, dt = wkw(wq)
            shift = node.in_fb + wq.frac_bits - node.out_fb
            emit("conv2d", _space.sig_conv2d(batch, h, w, ci, co, hk, g),
                 (x, wq.q),
                 dict(groups=g, requant_shift=shift, act=node.act, **kw), dt)
        elif p == "dws":
            w_dw, w_pw = node.qparams["w_dw"], node.qparams["w_pw"]
            mid_fb = node.qparams.get("mid_frac_bits", node.out_fb)
            kw_dw, dt_dw = wkw(w_dw)
            kw_pw, dt_pw = wkw(w_pw)
            emit("depthwise2d", _space.sig_depthwise2d(batch, h, w, ci, hk),
                 (x, w_dw.q[..., 0]),
                 dict(requant_shift=node.in_fb + w_dw.frac_bits - mid_fb,
                      **kw_dw), dt_dw)
            emit("conv2d", _space.sig_conv2d(batch, h, w, ci, co, 1, 1),
                 (x, w_pw.q),
                 dict(requant_shift=mid_fb + w_pw.frac_bits - node.out_fb,
                      act=node.act, **kw_pw), dt_pw)
        elif p == "shift":
            w_pw = node.qparams["w_pw"]
            kw, dt = wkw(w_pw)
            emit("shift_conv2d",
                 _space.sig_shift_conv2d(batch, h, w, ci, co,
                                         max(1, hk // 2)),
                 (x, node.qparams["shifts"],
                  w_pw.q[0, 0] if w_pw.q.dim() == 4 else w_pw.q),
                 dict(requant_shift=node.in_fb + w_pw.frac_bits - node.out_fb,
                      act=node.act, max_shift=hk // 2, **kw), dt)
        elif p == "add":
            wq = node.qparams["w"]
            kw, dt = wkw(wq)
            x_pre, w_pre, acc_fb = add_preshifts(node.in_fb, wq.frac_bits)
            emit("add_conv2d", _space.sig_add_conv2d(batch, h, w, ci, co, hk),
                 (x, wq.q),
                 dict(requant_shift=acc_fb - node.out_fb, x_preshift=x_pre,
                      w_preshift=w_pre, act=node.act, **kw), dt)
    return jobs


def autotune_plan(cache: _cache.TuneCache, plan, *, batch: int = 1,
                  **kw) -> list:
    """Pre-tune every distinct kernel invocation of ``plan`` into
    ``cache``. Returns ``[(kernel, sig, best_config, best_us), ...]``."""
    out = []
    for kernel, sig, arrays, dtype, kwargs in plan_jobs(plan, batch=batch):
        best, best_us = autotune_into(cache, kernel, sig, arrays, dtype,
                                      kwargs=kwargs, **kw)
        out.append((kernel, sig, best, best_us))
    return out


# --------------------------------------------------------------------------
# Dispatch-layer lookup: memo -> persistent cache -> analytic fallback
# --------------------------------------------------------------------------

_CACHE_HIT = _obs_metrics.counter("tune.cache.hit")
_ANALYTIC = _obs_metrics.counter("tune.cache.analytic_fallback")

def get_config(sig: ShapeSig, dtype, device=None) -> Dict[str, int]:
    """The config a ``"cuda"`` call on ``device`` launches: the memo, then
    the default cache (counted as ``tune.cache.hit``), then the analytic
    model (counted as ``tune.cache.analytic_fallback``), memoized. A
    cached entry is not checked here: ``CompiledPlan(validate=True)``
    checks what it resolves, and a kernel wrapper refuses a knob it cannot
    launch."""
    tag = backend_tag(device)
    dt = dtype if type(dtype) is str else dtype_key(dtype)
    # the memo keys on the hashable signature itself (no string building
    # on a hit); the cache file on the (kernel, key, dtype, backend) string
    hit = _cache.memo_get((sig, dt, tag))
    if hit is not None:
        return hit["config"]
    entry = _cache.get_default_cache().get(
        _cache.cache_key(sig.kernel, sig.key(), dt, tag))
    if entry is None:
        _ANALYTIC.inc()
        entry = {"config": analytic_config(sig, dt), "us": None,
                 "source": "analytic"}
    else:
        _CACHE_HIT.inc()
    _cache.memo_put((sig, dt, tag), entry)
    return entry["config"]
