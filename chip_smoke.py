#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py            (from the repository root)

Phases, one line each, any failure exits non-zero:

1. device   — a CUDA card is present; its name and power limit.
2. build    — the CUDA kernels built from ``src/repro_torch/kernels/csrc``;
              ptxas's registers, shared memory and spills of every
              instantiation of the implicit GEMM (the integer conv and
              shift conv), the float implicit GEMM (the float conv and
              every add conv mode), the float shift conv, the depthwise
              conv, the float matmul, the integer matmul (every tile, int8
              and W4), the int8 and float pools' vector kernels and the
              causal conv1d's vector kernel (bf16, K = 4).
3. kernels  — each of the eighteen kernel entry points (six int8, five
              W4, six float32 / bfloat16 and the float causal_conv1d) held
              bitwise against its plain PyTorch version at every
              shape of the dws, standard, shift and add plans at B=256, a
              groups=2 conv, odd and even-HK shapes, shift tables with
              |shift| up to 2 and with every channel on one shift, add
              pre-shifts (0,0), (0,3), (2,0) and one that wraps int32, and
              requant shifts {-2, 0, 1, 7} with relu and bias on and off;
              the W4 modes with random packed nibbles (-8 and +7 included),
              group shifts in [0, 4] (all 4 in some cases), odd Cx (a pad
              nibble) and depthwise HK 1, 2, 3, 5 and 7; the staged-row
              depthwise kernel also at C = 7 and 19, x at an odd address and
              a 300-wide row (runs of columns), in every mode; the integer
              add on the float implicit GEMM's body also at pre-shifts
              (31,0) and (0,31), HK 1, 2, 5 and 7, Cy = 20 and 24, x at an
              odd address and the tuner's Table-2 int8 add job (timed, not
              summed), W4 with odd Cx and every group shift at 4; the int8
              pool also at C = 19 (its scalar path), x at an odd address,
              windows 3/2 and 2/1; the
              redesigned rows (the integer matmul, the int8 pool) printed
              beside their earlier times; the LM's matmul_q8 and
              matmul_w4 at Qwen2-0.5B's decode shapes (8x896x4864,
              8x4864x896), prefill shapes (16, 32, 64 and 128 x896x4864,
              64x4864x896) and ragged ones
              (K = 45, 33 and 4864 with N = 37 and 100, M = 1, 5, 13, 17
              and 70), operands at an odd address, requant shifts -2 to
              16, W4 nibbles -8 and +7 with every group shift at 4; the
              integer conv's implicit GEMM also at the
              tuner's Table-2 int8 jobs (Cx = 128 at 10^2, g = 1 and 4;
              16->16 at 32^2, n = 1 and 8; timed with the standard plan's
              conv1 and conv2, not summed), HK 5 and 7, groups of 3, odd
              Cx/g in W4, Cy = 20 and x at an odd address; the integer
              shift conv on the same implicit GEMM at |shift| up to 3, C =
              9 and 19, C = 130 (K chunks), Cy = 20 with x at an odd
              address, W4 with every group shift at 4 and the tuner's
              Table-2 int8 shift jobs (n = 1 and 8, timed, not summed); the
              launch arithmetic of the integer conv, the float conv and
              the add conv, the shift conv (integer and float), the
              depthwise conv, the float matmul (every tile), the integer
              matmul (every tile and cluster size) and the int8 pool
              (vector or scalar) equal to their sources'; causal_conv1d at Falcon-Mamba's
              prefill shapes (1 x L x 8192 bf16 for L = 16, 33, 96 and 256, and
              8 x 64 x 8192), in float32, at D = 100 with K 1, 2 and 4 and
              relu on and off, with (K,1,D) weights, and its backward (dx
              bitwise against flip-plain-flip, dw against the plain
              reduction, both within 1e-5 of autograd through the plain
              version); the float modes of conv2d, depthwise2d,
              maxpool2d, shift_conv2d, add_conv2d and matmul in float32
              and bfloat16 at the tuner's Table-2 jobs, at every layer
              shape of the four CNN plans at B=256 and at edges (HK 1, 2
              and 5, groups, C = 19, the pool at C = 4, 8, 12 and 64
              with windows 2/2, 3/2 and 4/3, NaN taps of three bit
              patterns (compared bit for bit) and x at an odd address,
              each timed pool beside its scalar path on the same values,
              shifts up to 3 at C = 5, C = 130 with
              x at an unaligned address, the add at HK = 5, Cx = 19, Cy =
              20 and the conv at ci = 130, g = 2, both with x at an
              unaligned address, M = 1, K = 33 and 45, matmuls of
              37x45x33 and 257x513x255 and with operands at unaligned
              addresses, relu and bias on and off); every config of the
              tuner's space of every
              entry point, at one shape each, bitwise equal to the default
              config's output; per main-path shape the kernel's time, its
              bound, the plain version's time and one PyTorch call's time
              as a yardstick (device times from torch.profiler, TF32 off),
              and the time of back-to-back wrapper calls.
4. plan     — CNNConfig(primitive=...) for "dws", "standard", "shift" and
              "add" at full width with seeded random weights, lowered with
              a 256-image calibration batch on the card, with int8 weights
              and with W4 weights (weight_bits=4, group_size=32; and one
              standard plan at group_size=8): method="cuda" trunk bitwise
              equal to method="torch" and to a host run, logits within
              1e-5; a W4 forward launches no int8 conv kernel. Every plan
              is served captured (jit=True, one CUDA graph per batch
              size): this phase warms and captures each plan at every
              bucket phase 5 serves (256, and 64 for the ragged round of
              37) before phase 5 sets the counts to 0, holds each
              bucket's captured trunk (its capture call and a replay)
              bitwise against the same plan with jit=False, a replay's
              launches equal to an eager forward's, and at each bucket
              the launches its capture recorded (which every replay adds
              to the counts) equal to the port's kernels that
              torch.profiler sees one replay run on the card.
5. serve    — CNNEngine(max_batch=256) over 2,085 images of the int8 dws
              plan (8 full rounds and a ragged round of 37) and 549 images
              each of the int8 shift and add plans and the W4 dws, shift
              and add plans (2 full rounds and a ragged round of 37),
              launch counts set to 0 before each run: every status ok, no
              error or retry, each plan's kernels launched exactly as often
              as its forwards need and no other kernel, all nine kernels
              launched across the six runs (each round one replay of a
              graph phase 4 captured), logits equal to the plan's
              forward_batch; then a breakdown of one 256-image round of
              each plan: the captured plan and the same plan with
              jit=False in one run, each with its device-resident
              forward ms, device busy ms and idle share and throughput
              images/s, beside the card's name and power limit.
6. lm       — Qwen2-0.5B at full width and depth (24 layers, d_model 896,
              d_ff 4864, vocab 151,936), seeded random weights made on the
              card, served by Engine(max_batch=8, max_len=256): 24 requests,
              prompts of 16-96 tokens, 32 new tokens each, greedy, captured
              (jit=True: one decode graph, one prefill graph per bucket),
              in the precisions "int8", "int8-torch", "w4a8"
              (group_size=32), "w4a8-torch" and "float", and "int8",
              "int8-torch" and "float" over the int8 KV cache; each engine
              warmed up with one request into every prefill bucket the
              timed run serves (16, 32, 64, 128), each graph's first call
              (eager pass + capture) printed, so that the timed run only
              replays; every status ok, the kernel precisions' token
              streams equal to their plain versions' (the int8-KV ones
              too), matmul_q8 (int8) or matmul_w4 (w4a8) launched exactly
              72 times per prefill and per decode step and no other kernel;
              "float" and "int8" again with jit=False on the first 8
              requests, their token streams equal to the captured
              engines'; the float engine's token agreement over the int8
              KV cache printed; tokens/s, decode-step ms and TTFT per
              engine; then one decode step's device breakdown (its count
              of device operations, kernels and memsets) captured and
              with jit=False for float, int8, w4a8 and int8 over the int8
              KV cache, and the captured prefill against the eager one at
              buckets 32 and 128.
7. ssm      — Falcon-Mamba-7B at full width and depth (64 layers, d_model
              4096, d_inner 8192, d_state 16, d_conv 4, dt_rank 256, vocab
              65,024; 7.27 B parameters), seeded random weights made on the
              card after phase 6's model is freed, served by
              Engine(max_batch=8, max_len=256) in "float", its decode step
              captured (each prompt prefilled eagerly at its exact length):
              16 requests, prompts of 16-96 tokens, 32 new tokens each,
              greedy, after a two-request warm-up; every status ok,
              causal_conv1d launched exactly 64 times per prefill and never
              in a decode step, no other kernel; the first 4 requests again
              with jit=False, token streams equal; mamba_forward with the
              kernel bitwise equal to the plain version on three layers at
              a served prompt; tokens/s, decode-step ms, TTFT p50/p99 and
              one decode step's device breakdown, captured and with
              jit=False; one 96-token prefill's breakdown (its time,
              device busy and idle, device operations, the 64
              causal_conv1d launches' time and the copy kernels), and the
              same prefill with x_in copied before each conv taking
              exactly 64 device operations more.
8. tune     — the autotuner: ``python -m repro_torch.tune``'s main over
              the paper's Table-2 jobs and the four CNN primitives' int8
              and W4 plans at B=256, plus the tuner's float32 and bfloat16
              pool jobs, every candidate ranked by device time (each
              candidate's time printed); the cache
              written under build/repro_torch/, reloaded and installed; the
              int8 dws and W4 shift plans of phase 4 served through
              CompiledPlan with it, trunks bitwise equal to phase 4's,
              configs read from the cache, throughput in images/s tuned
              and on the analytic configs; every kernel but matmul_w4
              (which no job runs) launched; the host time of a memo-hit
              config lookup. The tuned plans are new CompiledPlans, so
              each captures its graphs after the cache is installed, and
              node_configs shows the configs it captured with.
9. cnn-flow — the paper's deployment flow (examples/train_cnn_torch.py)
              for each of the five primitives: CNNConfig(widths=(16, 32,
              64)) at 32x32 trained from seeded weights for 100 AdamW
              steps (lr 2e-3, warmup 20, cosine) at batch 64 on
              IndexedDataset(kind="image", seed=7), TF32 off and cuDNN
              deterministic, launching no int8 kernel; the mean loss of
              the last 10 steps below the first 10's; a checkpoint at step
              50 restored into fresh state reproduces the uninterrupted
              run's losses within 1e-4; then calibrate_bn, quantize_cnn(
              method="cuda"), its first forward launching exactly one
              eager forward and one replay, its captured trunk bitwise
              equal to method="torch"'s on 256 test images; profile of the
              int8 plan at B=256 (a line per row: measured us, MACs, the
              MCU latency and energy model); steps/s, training images/s
              and the float / int8 top-1 agreement (printed, not gated).

The second-to-last line is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
BATCH = 256
N_SERVE = 8 * BATCH + 37
N_SHORT = 2 * BATCH + 37
#: images served per plan: the int8 dws plan's run is the long one
SERVED = {"dws": N_SERVE, "shift": N_SHORT, "add": N_SHORT,
          "dws-w4": N_SHORT, "shift-w4": N_SHORT, "add-w4": N_SHORT}
#: kernel launches per forward of each served plan (widths 16/32/64)
PER_FORWARD = {
    "dws": {"conv2d_q8": 3, "depthwise2d_q8": 2, "maxpool2d_s8": 3},
    "shift": {"conv2d_q8": 1, "shift_conv2d_q8": 2, "maxpool2d_s8": 3},
    "add": {"add_conv2d_q8": 3, "maxpool2d_s8": 3},
    "dws-w4": {"conv2d_w4": 3, "depthwise2d_w4": 2, "maxpool2d_s8": 3},
    "shift-w4": {"conv2d_w4": 1, "shift_conv2d_w4": 2, "maxpool2d_s8": 3},
    "add-w4": {"add_conv2d_w4": 3, "maxpool2d_s8": 3},
}
#: plans lowered in phase 4: (primitive, weight_bits, group_size). The
#: group_size=8 plan's weights fall by an octave from one group of 8 input
#: channels to the next, so its layers carry several distinct group shifts.
PLANS = {"dws": ("dws", 8, 32), "standard": ("standard", 8, 32),
         "shift": ("shift", 8, 32), "add": ("add", 8, 32),
         "dws-w4": ("dws", 4, 32), "standard-w4": ("standard", 4, 32),
         "shift-w4": ("shift", 4, 32), "add-w4": ("add", 4, 32),
         "standard-w4-g8": ("standard", 4, 8)}
#: phase 4 captures each served plan at the buckets phase 5 serves: full
#: rounds of 256 and the ragged round of 37, padded to 64
CAPTURED_BUCKETS = (BATCH, 1 << (N_SHORT % BATCH - 1).bit_length())
#: the device kernel (a part of its name in a torch.profiler record) that
#: each CNN wrapper launches once per call; wrappers that share one kernel
#: are summed
DEVICE_KERNEL = {"conv2d_q8": "igemm_kernel", "conv2d_w4": "igemm_kernel",
                 "shift_conv2d_q8": "igemm_kernel",
                 "shift_conv2d_w4": "igemm_kernel",
                 "add_conv2d_q8": "fgemm_kernel",
                 "add_conv2d_w4": "fgemm_kernel",
                 "depthwise2d_q8": "depthwise2d_kernel",
                 "depthwise2d_w4": "depthwise2d_kernel",
                 "maxpool2d_s8": "maxpool2d_s8"}
#: the plan whose B=256 forward each kernel's times are summed over
TIMED_PLAN = {"conv2d": "dws", "depthwise2d": "dws", "maxpool2d": "dws",
              "shift_conv2d": "shift", "add_conv2d": "add"}
#: the W4 mode's pre-shifts (x, w) and requant shift of each add layer
W4_ADD_PRESHIFTS = ((0, 3, 9), (2, 0, 9), (28, 20, 24))
#: phase 6: the served model and its traffic
LM_ARCH = "qwen2-0.5b"
#: (precision, KV cache) of the captured engines; LM_EAGER again with
#: jit=False on the first LM_EAGER_REQUESTS requests
LM_RUNS = (("int8", "float"), ("int8-torch", "float"), ("w4a8", "float"),
           ("w4a8-torch", "float"), ("float", "float"), ("int8", "int8"),
           ("int8-torch", "int8"), ("float", "int8"))
LM_EAGER, LM_EAGER_REQUESTS = ("float", "int8"), 8
#: the served engines whose decode step is broken down
LM_BREAKDOWN = ("float", "int8", "w4a8", "int8 kv=int8")
#: the prefill buckets whose captured and eager times are printed
LM_PREFILL_TIMED = (32, 128)
LM_BATCH, LM_MAX_LEN, LM_REQUESTS, LM_NEW = 8, 256, 24, 32
LM_PROMPT = (16, 96)
#: each kernel precision's matmul entry point; 3 FFN matmuls per layer
LM_KERNEL = {"int8": "matmul_q8", "w4a8": "matmul_w4"}
#: phase 7: the served ssm model and its traffic (prompts as in phase 6)
SSM_ARCH = "falcon-mamba-7b"
SSM_REQUESTS = 16
#: of them served again with jit=False
SSM_EAGER_REQUESTS = 4
#: mamba_forward layers held kernel against plain version at full width
SSM_CHECK_LAYERS = 3
#: the prompt length of phase 7's prefill breakdown (the longest served)
SSM_BREAKDOWN_LEN = 96
#: phase 3: causal_conv1d at Falcon-Mamba's prefill shapes (B, L), bf16,
#: d_inner 8192, K=4; the L=96 row (the longest served prompt) is summed
#: over one prefill's 64 launches into the kernel's JSON row
C1D_SHAPES = ((1, 16), (1, 33), (1, 96), (1, 256), (8, 64))
C1D_WIDTH, C1D_TAPS, C1D_SUMMED = 8192, 4, (1, 96)
C1D_PER_PREFILL = 64           # Falcon-Mamba-7B's layers

# Published dense peaks (NVIDIA data sheets): HBM bytes/s and int8 ops/s;
# float32 outside the tensor cores (causal_conv1d's multiply-adds).
PEAKS = {"SXM": (3.35e12, 1979e12), "PCIe": (2.0e12, 1513e12)}
F32_PEAKS = {"SXM": 67e12, "PCIe": 51e12}
#: int32 lanes per SM (Hopper: 64 INT32 units per SM), for add-conv's bound
INT32_LANES_PER_SM = 64


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def peaks(name: str):
    return PEAKS["PCIe"] if "PCIe" in name else PEAKS["SXM"]


def sms_and_clock(torch) -> tuple:
    """(SMs, maximum SM clock in MHz as nvidia-smi reports it)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return sms, float(out.stdout.strip().splitlines()[0])


def int32_rate(torch) -> tuple:
    """(ops/s, text): the CUDA cores' int32 rate, SMs x 64 lanes x the
    maximum SM clock (nvidia-smi), the ceiling of add-conv, which has no
    tensor-core form."""
    sms, mhz = sms_and_clock(torch)
    rate = sms * INT32_LANES_PER_SM * mhz * 1e6
    return rate, (f"{sms} SMs x {INT32_LANES_PER_SM} int32 lanes x "
                  f"{mhz:.0f} MHz = {rate / 1e12:.2f} T ops/s")


def time_ms(torch, fn, reps=20, trials=7) -> float:
    """Median over trials of the mean time of ``reps`` back-to-back calls,
    by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def device_kernels(torch, fn, reps):
    """The device activity of one call of ``fn`` (``repro_torch.tune.
    runner.device_kernels``: one row per kernel with its launches and
    device microseconds per call, from two torch.profiler sessions of
    ``reps`` calls, the records a session lost filled in; on the card's
    machine a session now and then records none or only part of its
    device activity); fails if too few sessions recorded anything."""
    from repro_torch.tune.runner import device_kernels as per_call
    try:
        return per_call(fn, calls=reps)
    except RuntimeError as e:
        raise SmokeFailure(str(e)) from e


def device_ms(torch, fn, reps=20) -> float:
    """Device time of one call: the summed time of every kernel the call
    launches (torch.profiler), without the host time between launches.
    Fails if no profiler session sees device time."""
    ms = sum(r.us for r in device_kernels(torch, fn, reps)) / 1e3
    check(ms > 0, "torch.profiler saw no device time")
    return ms


# ---------------------------------------------------------------- phase 3 --

#: the tuner's Table-2 int8 conv jobs (repro_torch.tune.__main__
#: shapes_table2): (n, h, w, cx, cy, hk, groups)
T2_INT8_CONV = ((1, 10, 10, 128, 64, 3, 1), (1, 10, 10, 128, 64, 3, 4),
                (1, 32, 32, 16, 16, 3, 1), (8, 32, 32, 16, 16, 3, 1))


def offset_view(torch, t, offset: int):
    """A contiguous tensor equal to ``t`` whose data starts ``offset``
    elements into a larger buffer: an operand at an unaligned address."""
    buf = torch.zeros(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:offset + t.numel()].view(t.shape)
    view.copy_(t)
    return view

def main_path_shapes(primitive: str):
    """(kernel, label, args) of every launch of one plan's forward at
    B=256 (32x32x3 images, widths 16/32/64)."""
    shapes, hw, cin = [], 32, 3
    for i, cout in enumerate((16, 32, 64)):
        if primitive == "add":
            shapes.append(("add_conv2d", f"add{i} {cin}->{cout} {hw}^2",
                           dict(n=BATCH, h=hw, w=hw, cx=cin, cy=cout, hk=3)))
        elif primitive == "shift" and cin >= 4:
            shapes.append(("shift_conv2d", f"shift{i} {cin}->{cout} {hw}^2",
                           dict(n=BATCH, h=hw, w=hw, c=cin, cy=cout, d=1)))
        elif primitive == "dws" and cin >= 4:
            shapes.append(("depthwise2d", f"dw{i} {cin}ch {hw}^2",
                           dict(n=BATCH, h=hw, w=hw, c=cin, hk=3)))
            shapes.append(("conv2d", f"pw{i} {cin}->{cout} {hw}^2",
                           dict(n=BATCH, h=hw, w=hw, cx=cin, cy=cout, hk=1,
                                g=1)))
        else:
            shapes.append(("conv2d", f"conv{i} {cin}->{cout} {hw}^2",
                           dict(n=BATCH, h=hw, w=hw, cx=cin, cy=cout, hk=3,
                                g=1)))
        shapes.append(("maxpool2d", f"pool{i} {cout}ch {hw}^2",
                       dict(n=BATCH, h=hw, w=hw, c=cout)))
        hw, cin = hw // 2, cout
    return shapes


def grid_table(c: int, d: int):
    """The paper's shift assignment (the JAX package's ``init``): channels
    in order round the (2d+1) x (2d+1) displacement grid, int32 (C, 2)."""
    grid = [(a, b) for a in range(-d, d + 1) for b in range(-d, d + 1)]
    return np.array([grid[i % len(grid)] for i in range(c)], np.int32)


def kernel_cases(torch, K, dev, rng):
    """Yield (kernel, label, on_main_path, run_kernel, run_plain, run_lib,
    bytes, ops) for every comparison of phase 3. ``ops`` is (count, kind):
    int8 tensor-core operations, or add-conv's int32 |x - w| accumulates."""
    import torch.nn.functional as F
    from repro_torch.core.primitives import shift_channels
    from repro_torch.core.quantize import expand_w4, pack_w4

    def i8(shape):
        return torch.from_numpy(rng.integers(-128, 128, shape)
                                .astype("int8")).to(dev)

    def i32(shape):
        return torch.from_numpy(rng.integers(-4096, 4096, shape)
                                .astype("int32")).to(dev)

    def w4(shape, axis, all_max=False):
        """Random int4 codes (-8 and +7 included) packed along ``axis``,
        group shifts in [0, 4] (all 4 with ``all_max``), and the int8 codes
        they expand to (for the yardstick only)."""
        q = rng.integers(-8, 8, shape).astype("int8")
        q.flat[0], q.flat[-1] = -8, 7
        n = shape[axis]
        ws = (np.full(n, 4) if all_max else rng.integers(0, 5, n)) \
            .astype("int8")
        wp = pack_w4(torch.from_numpy(q), axis).contiguous().to(dev)
        ws = torch.from_numpy(ws).to(dev)
        return wp, ws, expand_w4(wp, ws, n, axis)

    def conv(label, n, h, w, cx, cy, hk, g, bias=True, act="relu", shift=7,
             main=False, w4_mode=False, all_max=False, x_offset=0):
        x = i8((n, h, w, cx))
        if x_offset:                 # the same codes at an odd address
            x = offset_view(torch, x, x_offset)
        if w4_mode:
            wp, ws, wt = w4((hk, hk, cx // g, cy), 2, all_max)
            wbytes = wp.numel() + ws.numel()
        else:
            wt = i8((hk, hk, cx // g, cy))
            wbytes = wt.numel()
        b = i32((cy,)) if bias else None
        kw = dict(groups=g, requant_shift=shift, act=act)
        # yardstick: cuDNN float32 convolution of the same (expanded) codes
        # (contraction only), NCHW copies made before timing
        xf = x.permute(0, 3, 1, 2).float().contiguous()
        wf = wt.permute(3, 2, 0, 1).float().contiguous()
        pad = (hk // 2, (hk - 1) // 2, hk // 2, (hk - 1) // 2)
        xf = F.pad(xf, pad)
        nbytes = x.numel() + wbytes + (4 * cy if bias else 0) + n * h * w * cy
        ops = (2 * n * h * w * cy * (cx // g) * hk * hk, "int8")
        lib = lambda: F.conv2d(xf, wf, groups=g)       # noqa: E731
        if w4_mode:
            return ("conv2d_w4", label, main,
                    lambda: K.conv2d_w4(x, wp, ws, b, **kw),
                    lambda: K.conv2d_w4_plain(x, wp, ws, b, **kw),
                    lib, nbytes, ops)
        return ("conv2d", label, main,
                lambda: K.conv2d_q8(x, wt, b, **kw),
                lambda: K.conv2d_q8_plain(x, wt, b, **kw),
                lib, nbytes, ops)

    def dw(label, n, h, w, c, hk, act=None, shift=7, layout4=True,
           main=False, w4_mode=False, all_max=False, x_offset=0):
        x = i8((n, h, w, c))
        if x_offset:                 # the same codes at an odd address
            x = offset_view(torch, x, x_offset)
        shape = (hk, hk, c, 1) if layout4 else (hk, hk, c)
        if w4_mode:                      # packed along the tap rows
            wp, ws, wt = w4(shape, 0, all_max)
            wbytes = wp.numel() + ws.numel()
        else:
            wt = i8(shape)
            wbytes = wt.numel()
        kw = dict(requant_shift=shift, act=act)
        xf = x.permute(0, 3, 1, 2).float().contiguous()
        xf = F.pad(xf, (hk // 2, (hk - 1) // 2, hk // 2, (hk - 1) // 2))
        wf = wt.reshape(hk, hk, c).permute(2, 0, 1)[:, None].float() \
            .contiguous()
        nbytes = 2 * x.numel() + wbytes
        ops = (2 * x.numel() * hk * hk, "int8")
        lib = lambda: F.conv2d(xf, wf, groups=c)       # noqa: E731
        if w4_mode:
            return ("depthwise2d_w4", label, main,
                    lambda: K.depthwise2d_w4(x, wp, ws, **kw),
                    lambda: K.depthwise2d_w4_plain(x, wp, ws, **kw),
                    lib, nbytes, ops)
        return ("depthwise2d", label, main,
                lambda: K.depthwise2d_q8(x, wt, **kw),
                lambda: K.depthwise2d_q8_plain(x, wt, **kw),
                lib, nbytes, ops)

    def pool(label, n, h, w, c, win=2, stride=2, main=False, x_offset=0):
        x = i8((n, h, w, c))
        if x_offset:                 # the same codes at an odd address
            x = offset_view(torch, x, x_offset)
        ho, wo = (h - win) // stride + 1, (w - win) // stride + 1
        nbytes = x.numel() + n * ho * wo * c
        ops = (n * ho * wo * c * (win * win - 1), "int8")
        lib = None
        if win == stride and h % win == 0 and w % win == 0:
            # yardstick: one reduction over a free view of the same int8s
            v = x.view(n, h // win, win, w // win, win, c)
            lib = lambda: v.amax(dim=(2, 4))          # noqa: E731
        return ("maxpool2d", label, main,
                lambda: K.maxpool2d_s8(x, window=win, stride=stride),
                lambda: K.maxpool2d_plain(x, window=win, stride=stride),
                lib, nbytes, ops)

    def shift_conv(label, n, h, w, c, cy, table, bias=True, act="relu", rs=7,
                   main=False, w4_mode=False, all_max=False, x_offset=0):
        x = i8((n, h, w, c))
        if x_offset:                 # the same codes at an odd address
            x = offset_view(torch, x, x_offset)
        if w4_mode:
            wp, ws, wt = w4((c, cy), 0, all_max)
            wbytes = wp.numel() + ws.numel()
        else:
            wt = i8((c, cy))
            wbytes = wt.numel()
        s = torch.from_numpy(table).to(dev)
        d = int(np.abs(table).max())
        b = i32((cy,)) if bias else None
        kw = dict(requant_shift=rs, act=act, max_shift=max(1, d))
        # yardstick: cuDNN float32 1x1 convolution of the already shifted
        # codes (contraction only), made before timing
        xs = shift_channels(x, s).permute(0, 3, 1, 2).float().contiguous()
        wf = wt.t().float()[:, :, None, None].contiguous()
        nbytes = (x.numel() + wbytes + s.numel() * 4
                  + (4 * cy if bias else 0) + n * h * w * cy)
        ops = (2 * n * h * w * cy * c, "int8")
        lib = lambda: F.conv2d(xs, wf)                 # noqa: E731
        if w4_mode:
            return ("shift_conv2d_w4", label, main,
                    lambda: K.shift_conv2d_w4(x, s, wp, ws, b, **kw),
                    lambda: K.shift_conv2d_w4_plain(x, s, wp, ws, b, **kw),
                    lib, nbytes, ops)
        return ("shift_conv2d", label, main,
                lambda: K.shift_conv2d_q8(x, s, wt, b, **kw),
                lambda: K.shift_conv2d_q8_plain(x, s, wt, b, **kw),
                lib, nbytes, ops)

    def mm(label, m, k, n, shift=9, act=None, weight=None, w4_mode=False,
           all_max=False, offset=0):
        """One matmul case; ``weight`` is how often the shape runs per
        Qwen2-0.5B decode step (0: timed, not summed; None: bitwise only);
        ``offset``: every operand that many bytes past an aligned address
        (the kernel's bytewise staging)."""
        a = i8((m, k))
        if w4_mode:
            wp, ws, wt = w4((k, n), 0, all_max)
            wbytes = wp.numel() + ws.numel()
        else:
            wt = i8((k, n))
            wbytes = wt.numel()
        if offset:
            a = offset_view(torch, a, offset)
            if w4_mode:
                wp, ws = (offset_view(torch, t, offset) for t in (wp, ws))
            else:
                wt = offset_view(torch, wt, offset)
        kw = dict(requant_shift=shift, act=act)
        nbytes = a.numel() + wbytes + m * n
        ops = (2 * m * n * k, "int8")
        lib = None
        if k % 8 == 0 and n % 8 == 0:
            # yardstick: torch._int_mm on the same (expanded) codes, its a
            # padded with zero rows to 32 where M <= 16 (its shape rule),
            # made before timing; the int32 product only
            ap = a if m > 16 else torch.cat(
                [a, a.new_zeros((32 - m, k))]).contiguous()
            lib = lambda: torch._int_mm(ap, wt)        # noqa: E731
        if w4_mode:
            return ("matmul_w4", label, weight,
                    lambda: K.matmul_w4(a, wp, ws, **kw),
                    lambda: K.matmul_w4_plain(a, wp, ws, **kw),
                    lib, nbytes, ops)
        return ("matmul", label, weight,
                lambda: K.matmul_q8(a, wt, **kw),
                lambda: K.matmul_q8_plain(a, wt, **kw),
                lib, nbytes, ops)

    def add_conv(label, n, h, w, cx, cy, hk, xp=2, wp=0, bias=True, act=None,
                 rs=9, main=False, w4_mode=False, all_max=False, x_offset=0):
        x = i8((n, h, w, cx))
        if x_offset:                 # the same codes at an odd address
            x = offset_view(torch, x, x_offset)
        if w4_mode:
            wpk, ws, wt = w4((hk, hk, cx, cy), 2, all_max)
            wbytes = wpk.numel() + ws.numel()
        else:
            wt = i8((hk, hk, cx, cy))
            wbytes = wt.numel()
        b = i32((cy,)) if bias else None
        kw = dict(requant_shift=rs, x_preshift=xp, w_preshift=wp, act=act)
        # yardstick: torch.cdist(p=1) between float32 patches extracted
        # beforehand (feature order (c, i, j), as F.unfold gives it) and
        # the filters
        pad = (hk // 2, (hk - 1) // 2, hk // 2, (hk - 1) // 2)
        xf = F.pad(x.permute(0, 3, 1, 2).float(), pad)
        patches = F.unfold(xf, hk).transpose(1, 2) \
            .reshape(n * h * w, cx * hk * hk).contiguous()
        wf = wt.permute(3, 2, 0, 1).reshape(cy, cx * hk * hk).float() \
            .contiguous()
        nbytes = x.numel() + wbytes + (4 * cy if bias else 0) \
            + n * h * w * cy
        ops = (n * h * w * cy * cx * hk * hk, "int32")
        lib = lambda: torch.cdist(patches, wf, p=1)    # noqa: E731
        if w4_mode:
            return ("add_conv2d_w4", label, main,
                    lambda: K.add_conv2d_w4(x, wpk, ws, b, **kw),
                    lambda: K.add_conv2d_w4_plain(x, wpk, ws, b, **kw),
                    lib, nbytes, ops)
        return ("add_conv2d", label, main,
                lambda: K.add_conv2d_q8(x, wt, b, **kw),
                lambda: K.add_conv2d_q8_plain(x, wt, b, **kw),
                lib, nbytes, ops)

    seen = set()
    for prim in ("dws", "standard", "shift", "add"):
        for kernel, label, a in main_path_shapes(prim):
            key = (kernel, tuple(sorted(a.items())))
            main = prim == TIMED_PLAN[kernel]
            if kernel == "conv2d" and prim == "standard" and not main:
                main = 0                      # timed, not summed
            if key in seen and not main:
                continue
            seen.add(key)
            tag = f"{prim} {label}"
            if kernel == "conv2d":
                yield conv(tag, a["n"], a["h"], a["w"], a["cx"], a["cy"],
                           a["hk"], a["g"], main=main)
            elif kernel == "depthwise2d":
                yield dw(tag, a["n"], a["h"], a["w"], a["c"], a["hk"],
                         main=main)
            elif kernel == "shift_conv2d":
                yield shift_conv(tag, a["n"], a["h"], a["w"], a["c"],
                                 a["cy"], grid_table(a["c"], a["d"]),
                                 main=main)
            elif kernel == "add_conv2d":
                yield add_conv(tag, a["n"], a["h"], a["w"], a["cx"],
                               a["cy"], a["hk"], main=main)
            else:
                yield pool(tag, a["n"], a["h"], a["w"], a["c"], main=main)
    yield conv("grouped g=2 16->32 16^2", BATCH, 16, 16, 16, 32, 3, 2)
    yield conv("odd 2x15x13x3->8 hk3", 2, 15, 13, 3, 8, 3, 1)
    yield conv("even hk2 2x6x7x4->8", 2, 6, 7, 4, 8, 2, 1)
    # the tuner's Table-2 int8 conv jobs (timed, not summed) and the
    # implicit GEMM's edges: K chunks (K words > 32), HK 5 and 7, groups
    # of 3, Cy off a multiple of the thread's 4-16 channels, x at an odd
    # address (the bytewise window)
    for shape in T2_INT8_CONV:
        yield conv(f"table2 {shape}", *shape, main=0)
    yield conv("hk5 2x15x13x19->37", 2, 15, 13, 19, 37, 5, 1)
    yield conv("hk7 g=2 1x12x11x8->12", 1, 12, 11, 8, 12, 7, 2)
    yield conv("grouped g=3 2x9x9x6->9", 2, 9, 9, 6, 9, 3, 3)
    yield conv("Cy=20 3x5x40x8->20", 3, 5, 40, 8, 20, 3, 1)
    yield conv("x offset by 1 byte 2x16x16x16->32", 2, 16, 16, 16, 32, 3, 1,
               x_offset=1)
    yield dw("odd 2x15x13x8 hk3 (HK,HK,C)", 2, 15, 13, 8, 3, layout4=False)
    # the staged-row depthwise kernel's edges: C off a multiple of 4, even
    # HK, HK 5 and 7 (weights read from shared memory a tap), x at an odd
    # address (element loads), a row cut into runs of columns
    yield dw("C=19 hk5 2x15x13", 2, 15, 13, 19, 5, act="relu")
    yield dw("C=7 even hk2 2x5x13", 2, 5, 13, 7, 2, shift=1)
    yield dw("hk7 1x12x11x8", 1, 12, 11, 8, 7, act="relu", shift=9)
    yield dw("x offset by 1 byte 4x12x10x16", 4, 12, 10, 16, 3, x_offset=1)
    yield dw("wide row 1x3x300x8", 1, 3, 300, 8, 3)
    yield pool("odd 2x15x13x8 3/2", 2, 15, 13, 8, win=3, stride=2)
    # the vector path (C a multiple of 16, x aligned) and the scalar one
    # (C = 19, x at an odd address), windows 3/2 and 2/1
    for c in (16, 32, 64, 19):
        for win, st in ((3, 2), (2, 1)):
            yield pool(f"C={c} {win}/{st} 3x11x10", 3, 11, 10, c, win=win,
                       stride=st)
    yield pool("x offset by 1 byte 8x16x16x32 2/2", 8, 16, 16, 32,
               x_offset=1)
    for shift in (-2, 0, 1, 7):
        for act in (None, "relu"):
            for bias in (False, True):
                yield conv(f"shift={shift} act={act} bias={bias}", 8, 16,
                           16, 16, 32, 3, 1, bias=bias, act=act, shift=shift)
            yield dw(f"shift={shift} act={act}", 8, 16, 16, 16, 3, act=act,
                     shift=shift)
    yield shift_conv("odd 2x15x13x16->8 grid3", 2, 15, 13, 16, 8,
                     grid_table(16, 1))
    yield shift_conv("|shift|<=2 4x16x16x32->16 grid5", 4, 16, 16, 32, 16,
                     grid_table(32, 2))
    yield shift_conv("one shift (1,-1) 4x16x16x16->32", 4, 16, 16, 16, 32,
                     np.tile(np.array([[1, -1]], np.int32), (16, 1)))
    # the shift conv's implicit GEMM at its edges: d = 3 (a 7-wide window),
    # C off a multiple of 4 (the bytewise window), K chunks (C = 130: 33
    # words), Cy off a multiple of q, x at an odd address
    yield shift_conv("|shift|<=3 2x12x11x9->24 grid7", 2, 12, 11, 9, 24,
                     grid_table(9, 3))
    yield shift_conv("|shift|<=2 C=19 2x15x13->8 grid5", 2, 15, 13, 19, 8,
                     grid_table(19, 2), bias=False, act=None, rs=0)
    yield shift_conv("K chunks C=130 1x10x10->16 grid3", 1, 10, 10, 130, 16,
                     grid_table(130, 1))
    yield shift_conv("Cy=20 x offset by 1 byte 2x9x7x12", 2, 9, 7, 12, 20,
                     grid_table(12, 2), x_offset=1)
    # the tuner's Table-2 int8 shift jobs (timed, not summed)
    for n in (1, 8):
        yield shift_conv(f"table2 {n}x32x32x64->64", n, 32, 32, 64, 64,
                         grid_table(64, 1), main=0)
    yield add_conv("odd 2x15x13x3->8", 2, 15, 13, 3, 8, 3)
    for xp, wp in ((0, 0), (0, 3), (2, 0)):
        yield add_conv(f"preshift ({xp},{wp}) 4x16x16x16->32", 4, 16, 16,
                       16, 32, 3, xp=xp, wp=wp)
    # 127 << 28 leaves int32: the sum wraps, as JAX's int32 does
    yield add_conv("preshift (28,20) wraps 2x8x8x16->16", 2, 8, 8, 16, 16,
                   3, xp=28, wp=20, rs=24)
    # the integer add's implicit GEMM at its edges: differences that wrap
    # from either operand, HK 1, 2, 5 and 7, Cx off a multiple of 4, Cy off
    # q, x at an odd address; and the tuner's Table-2 int8 add job (timed,
    # not summed)
    yield add_conv("preshift (31,0) hk1 2x8x8x19->8", 2, 8, 8, 19, 8, 1,
                   xp=31, wp=0, rs=24)
    yield add_conv("preshift (0,31) even hk2 2x6x7x4->8", 2, 6, 7, 4, 8, 2,
                   xp=0, wp=31, rs=24, act="relu")
    yield add_conv("hk5 Cy=20 2x9x9x7->20", 2, 9, 9, 7, 20, 5, xp=0, wp=3)
    yield add_conv("hk7 1x12x11x5->12", 1, 12, 11, 5, 12, 7, bias=False)
    yield add_conv("Cy=24 x offset by 1 byte 4x12x10x16", 4, 12, 10, 16, 24,
                   3, x_offset=1)
    yield add_conv("table2 1x10x10x16->16", 1, 10, 10, 16, 16, 3, main=0)
    for rs in (-2, 0, 1, 7):
        for act in (None, "relu"):
            for bias in (False, True):
                tag = f"requant={rs} act={act} bias={bias}"
                yield shift_conv(tag, 8, 16, 16, 16, 32, grid_table(16, 1),
                                 bias=bias, act=act, rs=rs)
                yield add_conv(tag, 8, 16, 16, 16, 32, 3, bias=bias, act=act,
                               rs=rs)
    yield from w4_cases(conv, dw, shift_conv, add_conv)
    yield from matmul_cases(mm)


def w4_cases(conv, dw, shift_conv, add_conv):
    """The W4 mode of the four weight-carrying kernels: every W4 launch of
    the dws, shift and add plans' forwards at B=256 (timed), then odd
    shapes, a pad nibble, every group shift at 4 and depthwise HK 1 and 5
    (bitwise only)."""
    packed = dict(w4_mode=True)
    yield conv("W4 dws conv0 3->16 32^2", BATCH, 32, 32, 3, 16, 3, 1,
               main=True, **packed)
    yield dw("W4 dws dw1 16ch 16^2", BATCH, 16, 16, 16, 3, main=True, **packed)
    yield conv("W4 dws pw1 16->32 16^2", BATCH, 16, 16, 16, 32, 1, 1,
               main=True, **packed)
    yield dw("W4 dws dw2 32ch 8^2", BATCH, 8, 8, 32, 3, main=True, **packed)
    yield conv("W4 dws pw2 32->64 8^2", BATCH, 8, 8, 32, 64, 1, 1, main=True,
               **packed)
    yield shift_conv("W4 shift shift1 16->32 16^2", BATCH, 16, 16, 16, 32,
                     grid_table(16, 1), main=True, **packed)
    yield shift_conv("W4 shift shift2 32->64 8^2", BATCH, 8, 8, 32, 64,
                     grid_table(32, 1), main=True, **packed)
    hw, cin = 32, 3
    for i, cout in enumerate((16, 32, 64)):
        xp, wp, rs = W4_ADD_PRESHIFTS[i]
        yield add_conv(f"W4 add add{i} {cin}->{cout} {hw}^2 ({xp},{wp})",
                       BATCH, hw, hw, cin, cout, 3, xp=xp, wp=wp, rs=rs,
                       main=True, **packed)
        hw, cin = hw // 2, cout
    yield conv("W4 standard conv1 16->32 16^2", BATCH, 16, 16, 16, 32, 3, 1,
               main=0, **packed)
    yield conv("W4 standard conv2 32->64 8^2", BATCH, 8, 8, 32, 64, 3, 1,
               main=0, **packed)
    for shape in T2_INT8_CONV:
        yield conv(f"W4 table2 {shape}", *shape, main=0, **packed)
    yield conv("W4 standard conv1 16->32 16^2 all shifts 4", BATCH, 16, 16,
               16, 32, 3, 1, all_max=True, **packed)
    yield conv("W4 odd Cx/g=5 g=2 2x9x9x10->8 hk5", 2, 9, 9, 10, 8, 5, 2,
               **packed)
    yield conv("W4 hk7 odd Cx/g=3 1x12x11x3->20", 1, 12, 11, 3, 20, 7, 1,
               **packed)
    yield conv("W4 grouped g=2 16->32 16^2", BATCH, 16, 16, 16, 32, 3, 2,
               **packed)
    yield conv("W4 odd 2x15x13x5->8 hk3 g=1", 2, 15, 13, 5, 8, 3, 1,
               bias=False, act=None, shift=0, **packed)
    yield conv("W4 even hk2 2x6x7x12->8 g=2", 2, 6, 7, 12, 8, 2, 2,
               shift=-2, **packed)
    for hk in (1, 5):
        yield dw(f"W4 hk{hk} 4x16x16x16 (HK,HK,C)", 4, 16, 16, 16, hk,
                 act="relu", layout4=False, all_max=hk == 5, **packed)
    yield shift_conv("W4 odd 2x15x13x7->8 grid5 all shifts 4", 2, 15, 13, 7,
                     8, grid_table(7, 2), all_max=True, **packed)
    yield shift_conv("W4 |shift|<=3 odd C=9 1x12x11->24 all shifts 4", 1, 12,
                     11, 9, 24, grid_table(9, 3), all_max=True, **packed)
    yield shift_conv("W4 shift1 16->32 16^2 all shifts 4", BATCH, 16, 16, 16,
                     32, grid_table(16, 1), all_max=True, **packed)
    yield add_conv("W4 odd 2x15x13x3->8 all shifts 4", 2, 15, 13, 3, 8, 3,
                   xp=0, wp=3, all_max=True, **packed)
    yield add_conv("W4 preshift (28,20) 2x8x8x5->16 relu", 2, 8, 8, 5, 16, 3,
                   xp=28, wp=20, rs=24, act="relu", **packed)
    yield add_conv("W4 preshift (31,0) odd Cx=7 hk5 2x9x9->20 all shifts 4",
                   2, 9, 9, 7, 20, 5, xp=31, wp=0, rs=24, all_max=True,
                   **packed)
    yield add_conv("W4 preshift (0,31) hk1 x offset by 3 2x8x8x19->8", 2, 8,
                   8, 19, 8, 1, xp=0, wp=31, rs=24, x_offset=3, **packed)
    yield add_conv("W4 table2 1x10x10x16->16", 1, 10, 10, 16, 16, 3, main=0,
                   **packed)
    yield dw("W4 hk2 C=7 2x5x13 all shifts 4", 2, 5, 13, 7, 2, act="relu",
             layout4=False, all_max=True, **packed)
    yield dw("W4 hk7 x offset by 1 byte 1x12x11x8", 1, 12, 11, 8, 7,
             x_offset=1, **packed)


def matmul_cases(mm):
    """The LM FFN's matmuls at Qwen2-0.5B's widths: the decode shapes
    (timed and summed over one decode step's 72 launches), prefill shapes
    of 32, 64 and 128 tokens (timed), and ragged, odd-K and shift cases (bitwise
    only), in both modes."""
    layers, d, ff = 24, 896, 4864
    for w4_mode in (False, True):
        tag = "W4 " if w4_mode else ""
        yield mm(f"{tag}decode gate/up 8x{d}x{ff}", 8, d, ff, shift=14,
                 weight=2 * layers, w4_mode=w4_mode)
        yield mm(f"{tag}decode down 8x{ff}x{d}", 8, ff, d, shift=16,
                 weight=layers, w4_mode=w4_mode)
        for m in (16, 32, 64, 128):    # phase 6's prefill buckets
            yield mm(f"{tag}prefill gate/up {m}x{d}x{ff}", m, d, ff,
                     shift=14, act="relu", weight=0, w4_mode=w4_mode)
        yield mm(f"{tag}prefill down 64x{ff}x{d}", 64, ff, d, shift=16,
                 weight=0, w4_mode=w4_mode)
        yield mm(f"{tag}ragged 5x45x37 shift -2 relu", 5, 45, 37, shift=-2,
                 act="relu", w4_mode=w4_mode)
        yield mm(f"{tag}odd K 13x33x37 shift 0", 13, 33, 37, shift=0,
                 w4_mode=w4_mode)
        yield mm(f"{tag}ragged 70x{ff}x37 relu", 70, ff, 37, shift=16,
                 act="relu", w4_mode=w4_mode)
        yield mm(f"{tag}ragged 17x{d}x100", 17, d, 100, shift=13,
                 w4_mode=w4_mode)
        yield mm(f"{tag}M=1 1x{d}x{ff}", 1, d, ff, shift=12, act="relu",
                 w4_mode=w4_mode)
        yield mm(f"{tag}operands offset by 1 byte 8x{ff}x{d}", 8, ff, d,
                 shift=16, w4_mode=w4_mode, offset=1)
        yield mm(f"{tag}operands offset by 3 bytes 20x100x48", 20, 100, 48,
                 shift=10, act="relu", w4_mode=w4_mode, offset=3)
    yield mm(f"W4 all shifts 4 8x{d}x{ff}", 8, d, ff, shift=16,
             w4_mode=True, all_max=True)
    yield mm(f"W4 all shifts 4 odd K 16x45x{ff}", 16, 45, ff, shift=4,
             w4_mode=True, all_max=True)


#: the shift conv's launch arithmetic checked against its source: (n, h,
#: w, c, cy, d) of the shift plan's rows, Table-2's job at d = 1, 2 and 3,
#: an odd C and a C of K chunks
SHIFT_PLAN_SHAPES = ((BATCH, 16, 16, 16, 32, 1), (BATCH, 8, 8, 32, 64, 1),
                     (1, 32, 32, 64, 64, 1), (1, 32, 32, 64, 64, 2),
                     (1, 32, 32, 64, 64, 3), (2, 15, 13, 19, 8, 2),
                     (1, 10, 10, 130, 16, 1))
#: the float implicit GEMM's launch arithmetic checked against its
#: sources: (n, h, w, cx, cy, hk, groups) of Table-2's float convs, the
#: B=256 layers (the add plan's are the standard plan's shapes), a
#: pointwise layer, edges (odd sizes, ci = 130 with g = 2, HK = 7) and a
#: window too large for the larger tiles
F_PLAN_SHAPES = ((1, 10, 10, 128, 64, 3, 1), (1, 10, 10, 128, 64, 3, 4),
                 (1, 32, 32, 16, 16, 3, 1), (1, 32, 32, 16, 16, 7, 1),
                 (1, 8, 8, 16, 16, 3, 1), (1, 32, 32, 32, 32, 3, 1),
                 (1, 10, 10, 16, 16, 3, 1), (BATCH, 32, 32, 3, 16, 3, 1),
                 (BATCH, 16, 16, 16, 32, 3, 1), (BATCH, 8, 8, 32, 64, 3, 1),
                 (BATCH, 16, 16, 16, 32, 1, 1), (2, 15, 13, 19, 37, 5, 1),
                 (1, 10, 10, 130, 20, 3, 2), (1, 12, 11, 8, 12, 7, 2),
                 (1, 64, 64, 512, 64, 3, 1))
#: the depthwise conv's launch arithmetic checked against its source, at
#: every tile and element size: (n, h, w, c, hk) of the dws rows, Table-2's
#: job, C off 4, HK 1, 2, 5 and 7, a row cut into runs, a window too large
DW_PLAN_SHAPES = ((BATCH, 16, 16, 16, 3), (BATCH, 8, 8, 32, 3),
                  (1, 32, 32, 64, 3), (2, 15, 13, 19, 5), (2, 5, 13, 7, 2),
                  (2, 8, 8, 12, 1), (1, 12, 11, 8, 7), (1, 3, 300, 8, 3),
                  (1, 4, 4, 4, 181))
#: the integer matmul's launch arithmetic checked against its source at
#: every tile and cluster size: (m, k, n) of Qwen2-0.5B's decode and
#: prefill shapes and a ragged one
MM_PLAN_SHAPES = ((8, 896, 4864), (8, 4864, 896), (32, 896, 4864),
                  (128, 896, 4864), (64, 4864, 896), (5, 45, 37))
#: the int8 and float pools' vector or scalar launches checked against
#: their source: (n, hout, wout, c) of the dws plan's pools, the tuner's
#: float pool job, C = 4, 8 and 12 and C off 16
POOL_PLAN_SHAPES = ((BATCH, 16, 16, 16), (BATCH, 8, 8, 32), (BATCH, 4, 4, 64),
                    (2, 7, 6, 19), (3, 5, 4, 33), (8, 16, 16, 64),
                    (3, 5, 4, 4), (3, 5, 4, 8), (3, 5, 4, 12))
#: the causal conv1d's launch arithmetic checked at every run and block
#: size: Falcon-Mamba's prefill shapes, D = 100, 8196, 320 and L < K
C1D_PLAN_SHAPES = ((1, 16, 8192), (1, 33, 8192), (1, 96, 8192),
                   (1, 256, 8192), (8, 64, 8192), (3, 45, 100),
                   (1, 20, 8196), (2, 70, 320), (2, 2, 100))
#: the kernels whose shared-memory tiles this repository sizes itself, and
#: the int8 pool's vector kernel: each instantiation's ptxas report is
#: printed at a fresh build (igemm_kernel: the integer conv's and the
#: integer shift conv's implicit GEMM; fgemm_kernel: the float conv's and
#: every add conv mode's; depthwise2d_kernel: every depthwise mode's staged
#: rows; matmul_q_kernel: the integer matmul's tiles, int8 and W4; the
#: pools' vector kernels; the causal conv1d's vector kernel at bf16 K=4,
#: every run and block size), as regular expressions of the name
TILED_KERNELS = ("igemm_kernel", "fgemm_kernel", "matmul_f_kernel",
                 "shift_conv2d_f_kernel", "depthwise2d_kernel",
                 "matmul_q_kernel", "maxpool2d_s8_vec_kernel",
                 "maxpool2d_f_vec_kernel",
                 "causal_conv1d_vec_kernel(?=<__nv_bfloat16, 4,)")


def ptxas_report(log: str, kernels) -> list:
    """One line per instantiation of ``kernels`` in ``nvcc -Xptxas -v``'s
    output: its name (demangled by c++filt where the machine has it), its
    registers, static shared memory and spill bytes."""
    import re
    out, name, props = [], None, {}

    def flush():
        if name is not None and any(
                re.search(rf"(?<!\w){k}<", name) for k in kernels):
            out.append(f"{name}: {props.get('regs', '?')} registers, "
                       f"{props.get('smem', '0')} bytes static shared "
                       "memory (its tiles: dynamic, sized per launch), "
                       f"spill stores {props.get('st', '?')} loads "
                       f"{props.get('ld', '?')} bytes")
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            flush()
            name = _demangle(m.group(1)).replace("(anonymous namespace)::", "")
            name, props = name.split("(")[0], {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            props["st"], props["ld"] = m.group(1), m.group(2)
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            props["regs"] = m.group(1)
            s = re.search(r"(\d+) bytes smem", ln)
            props["smem"] = s.group(1) if s else "0"
    flush()
    return out


def _demangle(sym: str) -> str:
    try:
        r = subprocess.run(["c++filt", sym], capture_output=True, text=True,
                           timeout=30)
        return r.stdout.strip() or sym if r.returncode == 0 else sym
    except (OSError, subprocess.SubprocessError):
        return sym


def check_plans(K):
    """The Python launch arithmetic of the tiled kernels (the tuner's
    footprint check reads it) equal to their sources' own, at every tile
    of the dws plan's convs, the Table-2 int8 convs and Table-2 matmuls,
    of the shift conv's rows, Table-2 job and edges, of the float conv
    and the add conv (every mode) at F_PLAN_SHAPES, of the depthwise conv
    at DW_PLAN_SHAPES, and the pools' and the causal conv1d's vector or
    scalar launches."""
    import ctypes
    import importlib
    from repro_torch.kernels import _build
    ci = importlib.import_module("repro_torch.kernels.conv_im2col")
    mq = importlib.import_module("repro_torch.kernels.matmul_q8")
    lib = _build.library()
    shapes = [(BATCH, 32, 32, 3, 16, 3, 1), (BATCH, 16, 16, 16, 32, 1, 1),
              (BATCH, 8, 8, 32, 64, 1, 1), (2, 15, 13, 19, 37, 5, 1),
              *T2_INT8_CONV]
    n = 0
    for s in shapes:
        for bp in ci.CONV_BP:
            for q in ci.CONV_Q:
                c = (ctypes.c_int * 6)()
                lib.repro_conv2d_i8_plan(c, *s, bp, q)
                p = ci.conv_plan(*s, bp, q)
                check(list(c) == [*p["grid"], p["threads"], p["smem"],
                                  p["k_words"], p["window"]],
                      f"conv2d plan {s} bp={bp} q={q}: source {list(c)} vs "
                      f"Python {p}")
                n += 1
    cs = importlib.import_module("repro_torch.kernels.conv_shift")
    for s in SHIFT_PLAN_SHAPES:
        for bp in ci.CONV_BP:
            for q in ci.CONV_Q:
                c = (ctypes.c_int * 6)()
                rc = lib.repro_shift_conv2d_i8_plan(c, *s, bp, q)
                p = cs.shift_plan(*s, bp, q)
                check(list(c) == [*p["grid"], p["threads"], p["smem"],
                                  p["k_words"], p["window"]]
                      and (rc == 0) == (not ci.tile_errors(p)),
                      f"shift_conv2d plan {s} bp={bp} q={q}: source "
                      f"{list(c)} (rc {rc}) vs Python {p}")
                c = (ctypes.c_int * 4)()
                rc = lib.repro_shift_conv2d_f_plan(c, *s[:5], bp, q)
                p = cs.shift_f_plan(*s[:5], bp, q)
                check(list(c) == [*p["grid"], p["threads"], p["smem"]]
                      and (rc == 0) == (not ci.tile_errors(p)),
                      f"shift_conv2d_f plan {s[:5]} bp={bp} q={q}: source "
                      f"{list(c)} (rc {rc}) vs Python {p}")
                n += 2
    ca = importlib.import_module("repro_torch.kernels.conv_add")
    tiles = [(bp, q) for bp in (*ci.CONV_BP, 96) for q in ci.CONV_Q]
    for s in F_PLAN_SHAPES:
        for bp, q in tiles:
            c = (ctypes.c_int * 5)()
            rc = lib.repro_conv2d_f_plan(c, *s, bp, q)
            p = ci.conv_f_plan(*s, bp, q)
            check(list(c) == [*p["grid"], p["threads"], p["smem"],
                              p["window"]]
                  and (rc == 0) == (not ci.tile_errors(p)),
                  f"conv2d_f plan {s} bp={bp} q={q}: source {list(c)} (rc "
                  f"{rc}) vs Python {p}")
            n += 1
            if s[6] != 1:
                continue
            c = (ctypes.c_int * 5)()
            rc = lib.repro_add_conv2d_f_plan(c, *s[:6], bp, q)
            p = ca.add_f_plan(*s[:6], bp, q)
            check(list(c) == [*p["grid"], p["threads"], p["smem"],
                              p["window"]]
                  and (rc == 0) == (not ci.tile_errors(p)),
                  f"add_conv2d_f plan {s[:6]} bp={bp} q={q}: source "
                  f"{list(c)} (rc {rc}) vs Python {p}")
            n += 1
    cd = importlib.import_module("repro_torch.kernels.conv_dw")
    for s in DW_PLAN_SHAPES:
        for es in (1, 2, 4):
            for pt in cd.DW_PT:
                for rows in cd.DW_ROWS:
                    c = (ctypes.c_int * 5)()
                    rc = lib.repro_depthwise2d_plan(c, *s, es, pt, rows)
                    p = cd.dw_plan(*s, es, pt, rows)
                    check(list(c) == [*p["grid"], p["threads"], p["smem"],
                                      p["window"]]
                          and (rc == 0) == (not cd.dw_tile_errors(p)),
                          f"depthwise2d plan {s} esize {es} pt={pt} "
                          f"rows={rows}: source {list(c)} (rc {rc}) vs "
                          f"Python {p}")
                    n += 1
    for m, _, nn in T2_MATMUL:
        for tile in mq.MMF_TILES:
            for code, es in ((0, 4), (1, 2)):
                c = (ctypes.c_int * 4)()
                check(lib.repro_matmul_f_plan(c, m, nn, *tile, code) == 0,
                      f"matmul_f tile {tile} not instantiated")
                p = mq.mmf_plan(m, nn, tile, es)
                check(list(c) == [*p["grid"], p["threads"], p["smem"]],
                      f"matmul_f plan {tile}: source {list(c)} vs {p}")
                n += 1
    for shape in MM_PLAN_SHAPES:
        for bn, bm in mq.MMQ_TILES:
            for cs in mq.MMQ_CLUSTERS:
                for w4 in (0, 1):
                    c = (ctypes.c_int * 7)()
                    rc = lib.repro_matmul_q8_plan(c, *shape, bn, bm, cs, w4)
                    p = mq.mmq_plan(*shape, bn, bm, cs, bool(w4))
                    check(rc == 0 and list(c) == [
                        *p["grid"], p["cluster"], p["threads"], p["smem"],
                        p["stages"], p["ring"]],
                          f"matmul plan {shape} {(bn, bm, cs)} w4={w4}: "
                          f"source {list(c)} (rc {rc}) vs Python {p}")
                    n += 1
    pl = importlib.import_module("repro_torch.kernels.pool")
    for shape in POOL_PLAN_SHAPES:
        for aligned in (0, 1):
            for threads in (64, 256, 1024):
                c = (ctypes.c_int * 3)()
                rc = lib.repro_maxpool2d_s8_plan(c, *shape, aligned, threads)
                p = pl.pool_plan(*shape, aligned, threads)
                check(rc == 0 and list(c) == [p["blocks"], p["threads"],
                                              int(p["vector"])],
                      f"maxpool2d_s8 plan {shape} aligned={aligned} "
                      f"threads={threads}: source {list(c)} vs Python {p}")
                n += 1
                for es in (2, 4):
                    c = (ctypes.c_int * 3)()
                    rc = lib.repro_maxpool2d_f_plan(c, *shape, es, aligned,
                                                    threads)
                    p = pl.pool_f_plan(*shape, es, aligned, threads)
                    check(rc == 0 and list(c) == [p["blocks"], p["threads"],
                                                  int(p["vector"])],
                          f"maxpool2d_f plan {shape} esize {es} aligned="
                          f"{aligned} threads={threads}: source {list(c)} "
                          f"vs Python {p}")
                    n += 1
    c1 = importlib.import_module("repro_torch.kernels.conv1d_causal")
    for shape in C1D_PLAN_SHAPES:
        for es in (2, 4):
            for aligned in (0, 1):
                for run in c1.RUNS:
                    for threads in c1.THREADS:
                        c = (ctypes.c_int * 6)()
                        rc = lib.repro_causal_conv1d_plan(
                            c, *shape, es, aligned, run, threads)
                        p = c1.c1d_plan(*shape, es, aligned, run, threads)
                        check(rc == 0 and list(c) == [
                            *p["grid"], p["threads"], p["run"],
                            int(p["vector"])],
                              f"causal_conv1d plan {shape} esize {es} "
                              f"aligned={aligned} run={run} threads="
                              f"{threads}: source {list(c)} vs Python {p}")
                        n += 1
    print(f"[kernels] launch arithmetic: {n} plans of the integer conv, the "
          "float conv and the add conv, the shift conv (integer and "
          "float), the depthwise conv, the float matmul, the integer "
          "matmul, the int8 and float pools and the causal conv1d equal "
          "to their sources'")


#: the redesigned kernels' rows before their design (PERF.md §6: run 8 on
#: an NVIDIA H100 80GB HBM3 at 700.00 W), printed beside this run's: a
#: Qwen2-0.5B decode step's 72 launches (matmul, matmul_w4), the dws
#: plan's three pools (maxpool2d), a 96-token Falcon-Mamba-7B prefill's 64
#: launches (causal_conv1d), the tuner's float32 pool job (maxpool2d_f)
EARLIER_MS = {"matmul": 0.7678, "matmul_w4": 0.8064, "maxpool2d": 0.0178,
              "causal_conv1d": 0.2345, "maxpool2d_f": 0.0027}
#: causal_conv1d's launch before its vector design at each timed (B, L)
#: (PERF.md §6 row 7, run 8), printed beside each timed line
EARLIER_C1D_MS = {(1, 16): 0.0029, (1, 33): 0.0032, (1, 96): 0.0037,
                  (1, 256): 0.0053, (8, 64): 0.0093}


def phase_kernels(torch, K, dev, name, rng):
    from repro_torch.device import exact_float32
    bw, int8_rate = peaks(name)
    i32_rate, i32_text = int32_rate(torch)
    print(f"[kernels] bounds: bytes / {bw / 1e12:.2f} TB/s; int8 ops / "
          f"{int8_rate / 1e12:.0f} T ops/s (tensor cores); add-conv's "
          f"|x - w| accumulates / {i32_text}")
    rates = {"int8": int8_rate, "int32": i32_rate}
    f32_rate = F32_PEAKS["PCIe" if "PCIe" in name else "SXM"]
    check_plans(K)
    with exact_float32():      # the float32 yardsticks run without TF32
        per_kernel = _phase_kernels(torch, K, dev, rng, bw, rates)
        per_kernel["causal_conv1d"] = phase_conv1d(torch, K, dev, rng, bw,
                                                   f32_rate)
        per_kernel.update(phase_float(torch, K, dev, rng, bw))
    for kernel, before in EARLIER_MS.items():
        r = per_kernel[kernel]
        lib = r["library_ms"]
        print(f"[kernels] {kernel} row: {r['ms']:.4f} ms (before this "
              f"design {before:.4f} ms, {before / r['ms']:.2f}x); bound "
              f"{r['bound_ms']:.5f} ms; library "
              f"{'n/a' if lib is None else f'{lib:.4f} ms'}")
    phase_candidates(torch, K, dev, rng)
    return per_kernel


def _phase_kernels(torch, K, dev, rng, bw, rates):
    per_kernel = {}
    for (kernel, label, main, run_k, run_p, run_lib, nbytes,
         (n_ops, kind)) in kernel_cases(torch, K, dev, rng):
        got = run_k()
        want = run_p()
        torch.cuda.synchronize()
        check(got.dtype == want.dtype == torch.int8
              and got.shape == want.shape,
              f"{kernel} {label}: kernel {got.dtype}{tuple(got.shape)} vs "
              f"plain {want.dtype}{tuple(want.shape)}")
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        check(err == 0, f"{kernel} {label}: kernel differs from its plain "
                        f"version, max |diff| = {err}")
        row = per_kernel.setdefault(kernel, dict(
            max_abs_err=0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
            bytes_ms=0.0, ops_ms=0.0, shapes=0))
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["shapes"] += 1
        if main is None or main is False:
            continue
        weight = 1 if main is True else main      # launches per summed unit
        bytes_ms, ops_ms = 1e3 * nbytes / bw, 1e3 * n_ops / rates[kind]
        t_k = device_ms(torch, run_k)
        t_p = device_ms(torch, run_p, reps=5)
        t_l = device_ms(torch, run_lib) if run_lib is not None else None
        call = time_ms(torch, run_k)
        bound = max(bytes_ms, ops_ms)
        print(f"[kernels] {kernel:12s} {label:26s} bitwise ok  "
              f"kernel {t_k:.4f} ms  bound {bound:.5f} ms "
              f"({'bytes' if bytes_ms >= ops_ms else 'operations'})  "
              f"plain {t_p:.4f} ms  library "
              f"{'n/a' if t_l is None else f'{t_l:.4f} ms'}  "
              f"(device times; back-to-back wrapper calls {call:.4f} ms "
              f"each)")
        row["ms"] += weight * t_k
        row["plain_ms"] += weight * t_p
        row["bound_ms"] += weight * bound
        row["bytes_ms"] += weight * bytes_ms
        row["ops_ms"] += weight * ops_ms
        if not weight:
            continue
        if t_l is None or row["library_ms"] is None:
            row["library_ms"] = None
        else:
            row["library_ms"] += weight * t_l
    for kernel, row in per_kernel.items():
        print(f"[kernels] {kernel}: {row['shapes']} shapes bitwise equal to "
              f"the plain version")
    return per_kernel


def _bits(torch, t):
    """A float tensor's bit pattern, for bitwise comparison."""
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


#: quiet NaNs of several bit patterns (+NaN, a payload, -NaN) as int16
#: (bfloat16) and int32 (float32) words
NAN_BITS = {2: (0x7FC0, 0x7FC5, 0xFFC0 - 0x10000),
            4: (0x7FC00000, 0x7FC00005, 0xFFC00000 - 2 ** 32)}


def plant_nans(torch, t, rng, share=0.15):
    """Set about ``share`` of float tensor ``t``'s elements, in place, to
    NaNs drawn from NAN_BITS: windows with several NaN taps of different
    bits, compared bit for bit."""
    flat = _bits(torch, t).view(-1)
    hit = torch.from_numpy(rng.random(t.numel()) < share).to(t.device)
    pick = torch.from_numpy(rng.integers(0, 3, t.numel())).to(t.device)
    bits = torch.tensor(NAN_BITS[t.element_size()], dtype=flat.dtype,
                        device=t.device)[pick]
    flat[hit] = bits[hit]


def conv1d_cases(torch, dev, rng):
    """(label, timed, x, w, act) of every causal_conv1d comparison: the
    model's prefill shapes in bfloat16, x the x half of a (B, L, 2D)
    in_proj product read in place as the model reads it (timed), then
    float32, D=100 with K in {1, 2, 4, 8} and relu on and off, the in_proj
    view, x at an odd address and bf16 D = 8196 (the scalar path), K = 8
    and L < K in both dtypes, (K,1,D) weights (bitwise only)."""
    def f(shape, dtype=torch.bfloat16):
        return torch.from_numpy(rng.standard_normal(shape).astype("float32")
                                ).to(dev).to(dtype)

    def in_proj(b, l, d, dtype=torch.bfloat16):
        return f((b, l, 2 * d), dtype).chunk(2, dim=-1)[0]
    bf16, f32 = torch.bfloat16, torch.float32
    for b, l in C1D_SHAPES:
        yield (f"bf16 {b}x{l}x{C1D_WIDTH} K={C1D_TAPS} in_proj view",
               (b, l), in_proj(b, l, C1D_WIDTH),
               f((C1D_TAPS, C1D_WIDTH)), None)
    yield (f"f32 1x96x{C1D_WIDTH} K=4", False,
           f((1, 96, C1D_WIDTH), f32), f((4, C1D_WIDTH), f32), None)
    yield (f"f32 2x37x{C1D_WIDTH} K=4 in_proj view relu", False,
           in_proj(2, 37, C1D_WIDTH, f32), f((4, C1D_WIDTH), f32), "relu")
    for dtype in (f32, bf16):
        tag = str(dtype)[6:]
        yield (f"{tag} 1x96x{C1D_WIDTH} K=4 offset by 1 (scalar path)",
               False, offset_view(torch, f((1, 96, C1D_WIDTH), dtype), 1),
               f((4, C1D_WIDTH), dtype), "relu")
        for k in (1, 2, 4, 8):
            for act in (None, "relu"):
                yield (f"{tag} 3x45x100 K={k} act={act}", False,
                       f((3, 45, 100), dtype), f((k, 100), dtype), act)
            yield (f"{tag} 2x37x256 K={k} in_proj view", False,
                   in_proj(2, 37, 256, dtype), f((k, 256), dtype), None)
            yield (f"{tag} 2x3x64 K={k} (L < K for K = 4, 8)", False,
                   f((2, 3, 64), dtype), f((k, 64), dtype), "relu")
    yield ("bf16 1x20x8196 K=4 (D * 2 off 16 bytes: scalar path)", False,
           f((1, 20, 8196)), f((4, 8196)), None)
    yield ("bf16 2x2x100 K=4 (L < K)", False, f((2, 2, 100)), f((4, 100)),
           None)
    yield ("bf16 2x70x96 (K,1,D) weights relu", False, f((2, 70, 96)),
           f((4, 1, 96)), "relu")


def phase_conv1d(torch, K, dev, rng, bw, f32_rate):
    """Phase 3 for causal_conv1d: bitwise against its plain version at
    every case, times at the model's shapes (each beside the first design's
    launch in PERF.md and the same values through this run's scalar path,
    the first design's kernel, at an odd address), then the backward."""
    import torch.nn.functional as F
    from repro_torch.kernels.conv1d_causal import c1d_plan, row_stride
    row = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
               library_ms=0.0, bytes_ms=0.0, ops_ms=0.0, shapes=0)
    paths = {True: 0, False: 0}
    for label, timed, x, w, act in conv1d_cases(torch, dev, rng):
        got = K.causal_conv1d(x, w, act=act)
        want = K.causal_conv1d_plain(x, w, act=act)
        torch.cuda.synchronize()
        check(got.dtype == want.dtype == x.dtype and got.shape == x.shape
              and got.is_contiguous(),
              f"causal_conv1d {label}: kernel {got.dtype}{tuple(got.shape)} "
              f"vs plain {want.dtype}{tuple(want.shape)}")
        err = float((got.float() - want.float()).abs().max())
        check(torch.equal(_bits(torch, got), _bits(torch, want)),
              f"causal_conv1d {label}: kernel differs from its plain "
              f"version, max |diff| = {err}")
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["shapes"] += 1
        es = x.element_size()
        paths[c1d_plan(*x.shape, es, x.data_ptr() % 16 == 0
                       and w.data_ptr() % 16 == 0
                       and row_stride("c1d", x) * es % 16 == 0, 1,
                       64)["vector"]] += 1
        if not timed:
            continue
        b, l, d = x.shape
        k = w.shape[0]
        nbytes = (2 * b * l * d + k * d) * x.element_size()
        bytes_ms = 1e3 * nbytes / bw
        ops_ms = 1e3 * 2 * k * b * l * d / f32_rate
        # yardstick: cuDNN's depthwise conv1d (groups=D) on channel-major
        # copies left-padded by K-1, made before timing
        xt = F.pad(x.transpose(1, 2).contiguous(), (k - 1, 0))
        wt = w.t().contiguous()[:, None, :]
        lib = lambda: F.conv1d(xt, wt, groups=d)      # noqa: E731
        lib_err = float((lib().transpose(1, 2).float() - want.float())
                        .abs().max())
        check(lib_err <= 0.05, f"causal_conv1d {label}: the library call "
                               f"computes another function ({lib_err})")
        xo = offset_view(torch, x.contiguous(), 1)    # the scalar path
        check(torch.equal(_bits(torch, K.causal_conv1d(xo, w, act=act)),
                          _bits(torch, want)),
              f"causal_conv1d {label}: the scalar path differs")
        t_k = device_ms(torch, lambda: K.causal_conv1d(x, w, act=act))
        t_s = device_ms(torch, lambda: K.causal_conv1d(xo, w, act=act))
        t_p = device_ms(torch, lambda: K.causal_conv1d_plain(x, w, act=act),
                        reps=5)
        t_l = device_ms(torch, lib)
        call = time_ms(torch, lambda: K.causal_conv1d(x, w, act=act))
        bound = max(bytes_ms, ops_ms)
        before = EARLIER_C1D_MS[timed]
        print(f"[kernels] causal_conv1d {label:34s} bitwise ok  kernel "
              f"{t_k:.4f} ms  bound {bound:.5f} ms "
              f"({'bytes' if bytes_ms >= ops_ms else 'operations'})  plain "
              f"{t_p:.4f} ms  library {t_l:.4f} ms  before this design "
              f"{before:.4f} ms ({before / t_k:.2f}x; the scalar path, its "
              f"kernel, on these values {t_s:.4f} ms) (device times; "
              f"back-to-back wrapper calls {call:.4f} ms each)")
        if timed == C1D_SUMMED:        # one prefill: a launch per layer
            n = C1D_PER_PREFILL
            row["ms"], row["plain_ms"] = n * t_k, n * t_p
            row["bound_ms"], row["library_ms"] = n * bound, n * t_l
            row["bytes_ms"], row["ops_ms"] = n * bytes_ms, n * ops_ms
    check(paths[True] and paths[False],
          f"causal_conv1d: the cases took the vector path {paths[True]} and "
          f"the scalar path {paths[False]} times; both must run")
    conv1d_backward(torch, K, dev, rng)
    print(f"[kernels] causal_conv1d: {row['shapes']} shapes bitwise equal to "
          f"the plain version ({paths[True]} on the vector path, "
          f"{paths[False]} on the scalar path)")
    return row


def conv1d_backward(torch, K, dev, rng, shape=(2, 96, C1D_WIDTH)):
    """The differentiable entry point's backward on the card: dx bitwise
    equal to flip-plain-flip, dw to the plain reduction (the ``"torch"``
    method's), and in float32 both within 1e-5 (relative to the largest
    magnitude) of autograd through the plain version."""
    from repro_torch.kernels import ops
    for dtype in (torch.bfloat16, torch.float32):
        def f(s):
            return torch.from_numpy(rng.standard_normal(s).astype("float32")
                                    ).to(dev).to(dtype)
        x = f(shape).requires_grad_()
        w = f((C1D_TAPS, shape[2])).requires_grad_()
        g = f(shape)
        gx, gw = torch.autograd.grad(ops.causal_conv1d(x, w), (x, w), g)
        flip = torch.flip(K.causal_conv1d_plain(torch.flip(g, [1]),
                                                w.detach()), [1])
        _, pw = torch.autograd.grad(ops.causal_conv1d(x, w, method="torch"),
                                    (x, w), g)
        torch.cuda.synchronize()
        name = str(dtype)[6:]
        check(torch.equal(_bits(torch, gx), _bits(torch, flip)),
              f"causal_conv1d backward {name}: dx differs from "
              "flip-plain-flip")
        check(torch.equal(_bits(torch, gw), _bits(torch, pw)),
              f"causal_conv1d backward {name}: dw differs from the plain "
              "reduction")
        worst = 0.0
        if dtype == torch.float32:
            ax, aw = torch.autograd.grad(K.causal_conv1d_plain(x, w), (x, w),
                                         g)
            for got, want in ((gx, ax), (gw, aw)):
                scale = max(1.0, float(want.abs().max()))
                worst = max(worst, float((got - want).abs().max()) / scale)
            check(worst <= 1e-5, f"causal_conv1d backward: {worst:.2e} from "
                                 "autograd through the plain version")
        print(f"[kernels] causal_conv1d backward {name} {tuple(shape)}: dx "
              "bitwise == flip-plain-flip, dw == plain reduction"
              + (f", within {worst:.1e} of autograd through the plain "
                 "version" if dtype == torch.float32 else ""))


# ------------------------------------------------- phase 3: float modes --

#: the float jobs of the tuner's Table-2 plan (repro_torch.tune.__main__
#: shapes_table2), plus the tuner's float pool job: each float kernel's
#: JSON row sums its times over these
T2_CONV = ((1, 10, 10, 128, 64, 3, 1), (1, 10, 10, 128, 64, 3, 4),
           (1, 32, 32, 16, 16, 3, 1), (1, 32, 32, 16, 16, 7, 1),
           (1, 8, 8, 16, 16, 3, 1), (1, 32, 32, 32, 32, 3, 1))
T2_DW, T2_SHIFT, T2_ADD = (1, 32, 32, 64, 3), (1, 32, 32, 64, 64), \
    (1, 10, 10, 16, 16, 3)
T2_MATMUL = ((256, 512, 256), (512, 512, 512))
T2_POOL = (8, 32, 32, 64, 2, 2)


def f32_rates(torch) -> tuple:
    """(FMA flop/s, non-FMA op/s, text): float32 on the CUDA cores, SMs x
    128 lanes x the maximum SM clock (nvidia-smi), x 2 for an FMA."""
    sms, mhz = sms_and_clock(torch)
    ops = sms * 128 * mhz * 1e6
    return 2 * ops, ops, (f"{sms} SMs x 128 float32 lanes x {mhz:.0f} MHz "
                          f"= {ops / 1e12:.2f} T ops/s, {2 * ops / 1e12:.2f} "
                          "TFLOP/s as FMAs")


def float_cases(torch, K, dev, rng, earlier):
    """Yield (kernel, label, timed, run_kernel, run_plain, run_lib, bytes,
    (ops, kind)) for every float-mode comparison of phase 3: the tuner's
    Table-2 float jobs and the CNN plans' layer shapes at B=256 (float32,
    timed; the Table-2 ones summed into the JSON row, ``timed == "t2"``),
    the same in bfloat16, then HK=1, even HK, grouped, C off a multiple of
    32, M=1, K off a multiple of 32, relu and bias on and off (bitwise
    only). ``kind`` is "fma" (float32 multiply-adds, 2 flops each) or
    "op" (float32 operations with no FMA form). Each timed pool case puts
    into ``earlier``, under its label, a call of the first design's kernel
    (the scalar path) on the same values at an odd address."""
    import torch.nn.functional as F
    from repro_torch.core.primitives import shift_channels

    def f(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype("float32")
                                ).to(dev).to(dtype)

    def pads(hk):
        return (hk // 2, (hk - 1) // 2, hk // 2, (hk - 1) // 2)

    def conv(label, shape, dtype, timed=False, bias=True, act="relu",
             off=0):
        n, h, w, cx, cy, hk, g = shape
        x, wt = f((n, h, w, cx), dtype), f((hk, hk, cx // g, cy), dtype)
        if off:                      # x at an unaligned address
            x = offset_view(torch, x, off)
        b = f((cy,), dtype) if bias else None
        kw = dict(groups=g, act=act)
        es = x.element_size()
        xf = F.pad(x.permute(0, 3, 1, 2).float(), pads(hk)).contiguous()
        wf = wt.permute(3, 2, 0, 1).float().contiguous()
        return ("conv2d_f", label, timed,
                lambda: K.conv2d_f(x, wt, b, **kw),
                lambda: K.conv2d_f_plain(x, wt, b, **kw),
                lambda: F.conv2d(xf, wf, groups=g),
                es * (x.numel() + wt.numel() + n * h * w * cy + (cy if bias
                                                                 else 0)),
                (n * h * w * cy * (cx // g) * hk * hk, "fma"))

    def dw(label, shape, dtype, timed=False, act="relu", off=0):
        n, h, w, c, hk = shape
        x, wt = f((n, h, w, c), dtype), f((hk, hk, c), dtype)
        if off:                      # x at an unaligned address
            x = offset_view(torch, x, off)
        xf = F.pad(x.permute(0, 3, 1, 2).float(), pads(hk)).contiguous()
        wf = wt.permute(2, 0, 1)[:, None].float().contiguous()
        return ("depthwise2d_f", label, timed,
                lambda: K.depthwise2d_f(x, wt, act=act),
                lambda: K.depthwise2d_f_plain(x, wt, act=act),
                lambda: F.conv2d(xf, wf, groups=c),
                x.element_size() * (2 * x.numel() + wt.numel()),
                (x.numel() * hk * hk, "fma"))

    def pool(label, shape, dtype, timed=False, off=0, nans=False):
        n, h, w, c, win, st = shape
        x = f((n, h, w, c), dtype)
        if nans:                     # NaN taps of several bit patterns
            plant_nans(torch, x, rng)
        if off:                      # x at an unaligned address
            x = offset_view(torch, x, off)
        ho, wo = (h - win) // st + 1, (w - win) // st + 1
        if timed:
            xo = offset_view(torch, x, 1)
            earlier[label] = lambda: K.maxpool2d_f(xo, window=win,
                                                   stride=st)
        lib = None
        if win == st and h % win == 0 and w % win == 0 and not off:
            v = x.view(n, h // win, win, w // win, win, c)
            lib = lambda: v.amax(dim=(2, 4))          # noqa: E731
        return ("maxpool2d_f", label, timed,
                lambda: K.maxpool2d_f(x, window=win, stride=st),
                lambda: K.maxpool2d_plain(x, window=win, stride=st), lib,
                x.element_size() * (x.numel() + n * ho * wo * c),
                (n * ho * wo * c * (win * win - 1), "op"))

    def shift(label, shape, dtype, d=1, timed=False, act="relu", off=0):
        n, h, w, c, cy = shape
        x, wt = f((n, h, w, c), dtype), f((c, cy), dtype)
        if off:                      # x at an unaligned address
            x = offset_view(torch, x, off)
        table = torch.from_numpy(grid_table(c, d)).to(dev)
        xs = shift_channels(x.float(), table).permute(0, 3, 1, 2) \
            .contiguous()
        wf = wt.t().float()[:, :, None, None].contiguous()
        return ("shift_conv2d_f", label, timed,
                lambda: K.shift_conv2d_f(x, table, wt, max_shift=d, act=act),
                lambda: K.shift_conv2d_f_plain(x, table, wt, max_shift=d,
                                               act=act),
                lambda: F.conv2d(xs, wf),
                x.element_size() * (x.numel() + wt.numel() + n * h * w * cy)
                + 8 * c, (n * h * w * cy * c, "fma"))

    def add(label, shape, dtype, timed=False, act=None, off=0):
        n, h, w, cx, cy, hk = shape
        x, wt = f((n, h, w, cx), dtype), f((hk, hk, cx, cy), dtype)
        if off:                      # x at an unaligned address
            x = offset_view(torch, x, off)
        xf = F.pad(x.permute(0, 3, 1, 2).float(), pads(hk))
        patches = F.unfold(xf, hk).transpose(1, 2) \
            .reshape(n * h * w, cx * hk * hk).contiguous()
        wf = wt.permute(3, 2, 0, 1).reshape(cy, cx * hk * hk).float() \
            .contiguous()
        return ("add_conv2d_f", label, timed,
                lambda: K.add_conv2d_f(x, wt, act=act),
                lambda: K.add_conv2d_f_plain(x, wt, act=act),
                lambda: torch.cdist(patches, wf, p=1),
                x.element_size() * (x.numel() + wt.numel() + n * h * w * cy),
                (2 * n * h * w * cy * cx * hk * hk, "op"))

    def mm(label, shape, dtype, timed=False, act=None, off=0):
        m, k, n = shape
        a, b = f((m, k), dtype), f((k, n), dtype)
        if off:                      # operands at unaligned addresses
            a, b = offset_view(torch, a, off), offset_view(torch, b, off)
        af, bf = a.float(), b.float()
        return ("matmul_f", label, timed,
                lambda: K.matmul_f(a, b, act=act),
                lambda: K.matmul_f_plain(a, b, act=act),
                lambda: torch.matmul(af, bf),
                a.element_size() * (a.numel() + b.numel() + m * n),
                (m * n * k, "fma"))

    f32, bf16 = torch.float32, torch.bfloat16
    for dtype in (f32, bf16):
        tag = "f32" if dtype == f32 else "bf16"
        t2 = "t2" if dtype == f32 else True       # bf16: timed, not summed
        timed = dtype == f32
        for shape in T2_CONV:
            yield conv(f"{tag} table2 {shape}", shape, dtype, t2)
        yield dw(f"{tag} table2 {T2_DW}", T2_DW, dtype, t2)
        yield shift(f"{tag} table2 {T2_SHIFT}", T2_SHIFT, dtype, timed=t2)
        yield add(f"{tag} table2 {T2_ADD}", T2_ADD, dtype, t2)
        for shape in T2_MATMUL:
            yield mm(f"{tag} table2 {shape}", shape, dtype, t2)
        yield pool(f"{tag} tuner pool {T2_POOL}", T2_POOL, dtype, t2)
        seen = set()
        for prim in ("dws", "standard", "shift", "add"):
            for kernel, label, a in main_path_shapes(prim):
                key = (kernel, tuple(sorted(a.items())))
                if key in seen:
                    continue
                seen.add(key)
                lab = f"{tag} {prim} {label} B={BATCH}"
                if kernel == "conv2d":
                    yield conv(lab, (a["n"], a["h"], a["w"], a["cx"],
                                     a["cy"], a["hk"], a["g"]), dtype, timed)
                elif kernel == "depthwise2d":
                    yield dw(lab, (a["n"], a["h"], a["w"], a["c"], a["hk"]),
                             dtype, timed)
                elif kernel == "shift_conv2d":
                    yield shift(lab, (a["n"], a["h"], a["w"], a["c"],
                                      a["cy"]), dtype, a["d"], timed)
                elif kernel == "add_conv2d":
                    yield add(lab, (a["n"], a["h"], a["w"], a["cx"], a["cy"],
                                    a["hk"]), dtype, timed)
                else:
                    yield pool(lab, (a["n"], a["h"], a["w"], a["c"], 2, 2),
                               dtype, timed)
        # edges: bitwise only
        yield conv(f"{tag} HK=1 2x8x8x5->7", (2, 8, 8, 5, 7, 1, 1), dtype)
        yield conv(f"{tag} even HK=2 2x6x7x4->8 no bias", (2, 6, 7, 4, 8, 2,
                                                           1), dtype,
                   bias=False, act=None)
        yield conv(f"{tag} grouped g=3 2x9x9x6->9", (2, 9, 9, 6, 9, 3, 3),
                   dtype)
        yield conv(f"{tag} C=19 2x15x13x19->37 HK=5", (2, 15, 13, 19, 37, 5,
                                                       1), dtype, act=None)
        yield dw(f"{tag} C=19 HK=5 2x15x13", (2, 15, 13, 19, 5), dtype)
        yield dw(f"{tag} HK=1 2x8x8x7", (2, 8, 8, 7, 1), dtype, act=None)
        yield dw(f"{tag} even HK=2 C=7 2x5x13", (2, 5, 13, 7, 2), dtype)
        yield dw(f"{tag} HK=7 offset by 1 1x12x11x8", (1, 12, 11, 8, 7),
                 dtype, off=1)
        yield dw(f"{tag} wide row 1x3x300x8", (1, 3, 300, 8, 3), dtype,
                 act=None)
        yield pool(f"{tag} 3/2 2x15x13x19", (2, 15, 13, 19, 3, 2), dtype)
        yield pool(f"{tag} 3/1 2x9x8x33", (2, 9, 8, 33, 3, 1), dtype)
        for c in (4, 8, 12, 64):
            for win, st in ((2, 2), (3, 2), (4, 3)):
                yield pool(f"{tag} C={c} {win}/{st} NaN taps 3x11x10",
                           (3, 11, 10, c, win, st), dtype, nans=True)
            yield pool(f"{tag} C={c} offset by 1 NaN taps 3x11x10",
                       (3, 11, 10, c, 2, 2), dtype, off=1, nans=True)
        yield shift(f"{tag} |shift|<=2 C=19 2x15x13->8", (2, 15, 13, 19, 8),
                    dtype, d=2)
        yield shift(f"{tag} no relu 4x16x16x16->32", (4, 16, 16, 16, 32),
                    dtype, act=None)
        yield shift(f"{tag} |shift|<=3 C=5 2x9x7->37", (2, 9, 7, 5, 37), dtype,
                    d=3, act=None)
        yield shift(f"{tag} C=130 (chunks) offset by 1 2x8x8->12",
                    (2, 8, 8, 130, 12), dtype, off=1)
        yield add(f"{tag} 2x15x13x3->8 relu", (2, 15, 13, 3, 8, 3), dtype,
                  act="relu")
        yield add(f"{tag} HK=1 C=19 2x8x8->8", (2, 8, 8, 19, 8, 1), dtype)
        yield add(f"{tag} HK=5 C=19->20 offset by 3 2x9x11", (2, 9, 11, 19,
                                                             20, 5), dtype,
                  act="relu", off=3)
        yield conv(f"{tag} ci=130 g=2 (K chunks) offset by 1 2x10x10->20",
                   (2, 10, 10, 130, 20, 3, 2), dtype, off=1)
        for shape in ((1, 896, 37), (1, 45, 37), (13, 33, 300),
                      (70, 4864, 37), (17, 64, 100), (37, 45, 33),
                      (257, 513, 255)):
            yield mm(f"{tag} {shape}", shape, dtype, act="relu" if
                     shape[0] % 2 else None)
        # M, N, K off every tile; the bytewise staging of misaligned rows
        for off in (1, 3):
            yield mm(f"{tag} (70, 33, 100) offset by {off}", (70, 33, 100),
                     dtype, act="relu", off=off)


def phase_float(torch, K, dev, rng, bw):
    """Phase 3 for the six float modes: bitwise against the plain versions
    at every case, device times at the timed ones."""
    fma_rate, op_rate, text = f32_rates(torch)
    print(f"[kernels] float bounds: bytes / {bw / 1e12:.2f} TB/s; float32 "
          f"multiply-adds and |x - w| / max operations against {text}")
    rates = {"fma": fma_rate / 2, "op": op_rate}    # per MAC / per op
    rows, earlier = {}, {}
    for (kernel, label, timed, run_k, run_p, run_lib, nbytes,
         (n_ops, kind)) in float_cases(torch, K, dev, rng, earlier):
        got = run_k()
        want = run_p()
        torch.cuda.synchronize()
        check(got.dtype == want.dtype and got.shape == want.shape,
              f"{kernel} {label}: kernel {got.dtype}{tuple(got.shape)} vs "
              f"plain {want.dtype}{tuple(want.shape)}")
        err = float((got.float() - want.float()).abs().max())
        check(torch.equal(_bits(torch, got), _bits(torch, want)),
              f"{kernel} {label}: kernel differs from its plain version, "
              f"max |diff| = {err}")
        row = rows.setdefault(kernel, dict(
            max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
            library_ms=0.0, bytes_ms=0.0, ops_ms=0.0, shapes=0))
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["shapes"] += 1
        if not timed:
            continue
        bytes_ms, ops_ms = 1e3 * nbytes / bw, 1e3 * n_ops / rates[kind]
        t_k = device_ms(torch, run_k)
        t_p = device_ms(torch, run_p, reps=3)
        t_l = device_ms(torch, run_lib) if run_lib is not None else None
        bound = max(bytes_ms, ops_ms)
        before = ""
        if label in earlier:         # the pool's first design, this run
            t_e = device_ms(torch, earlier[label])
            was = (f"{EARLIER_MS[kernel]:.4f} ms, " if timed == "t2"
                   else "")
            before = (f"  before this design {was}the scalar path, its "
                      f"kernel, on these values {t_e:.4f} ms "
                      f"({t_e / t_k:.2f}x)")
        print(f"[kernels] {kernel:14s} {label:44s} bitwise ok  kernel "
              f"{t_k:.4f} ms  bound {bound:.5f} ms "
              f"({'bytes' if bytes_ms >= ops_ms else 'operations'})  plain "
              f"{t_p:.4f} ms  library "
              f"{'n/a' if t_l is None else f'{t_l:.4f} ms'}{before}")
        if timed != "t2":
            continue
        row["ms"] += t_k
        row["plain_ms"] += t_p
        row["bound_ms"] += bound
        row["bytes_ms"] += bytes_ms
        row["ops_ms"] += ops_ms
        if t_l is None or row["library_ms"] is None:
            row["library_ms"] = None
        else:
            row["library_ms"] += t_l
    for kernel, row in rows.items():
        print(f"[kernels] {kernel}: {row['shapes']} cases (float32 and "
              "bfloat16) bitwise equal to the plain version")
    return rows


def entry_points(torch, K, dev, rng):
    """(name, sig, dtype, call(**config)) of every kernel entry point at
    one shape, for the candidate-invariance check."""
    from repro_torch import tune
    from repro_torch.core.quantize import pack_w4

    def i8(shape):
        return torch.from_numpy(rng.integers(-128, 128, shape)
                                .astype("int8")).to(dev)

    def f(shape, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape).astype("float32")
                                ).to(dev).to(dtype)

    def w4(shape, axis):
        q = torch.from_numpy(rng.integers(-8, 8, shape).astype("int8"))
        ws = torch.from_numpy(rng.integers(0, 5, shape[axis])
                              .astype("int8")).to(dev)
        return pack_w4(q, axis).contiguous().to(dev), ws

    n, h, w, c, cy = 8, 16, 16, 16, 32
    x8, xf = i8((n, h, w, c)), f((n, h, w, c))
    b = torch.from_numpy(rng.integers(-4000, 4000, cy).astype("int32")) \
        .to(dev)
    table = torch.from_numpy(grid_table(c, 1)).to(dev)
    q = dict(requant_shift=7, act="relu")
    conv_sig = tune.sig_conv2d(n, h, w, c, cy, 3, 1)
    dw_sig = tune.sig_depthwise2d(n, h, w, c, 3)
    pool_sig = tune.sig_maxpool2d(n, h, w, c, 2, 2)
    shift_sig = tune.sig_shift_conv2d(n, h, w, c, cy)
    add_sig = tune.sig_add_conv2d(n, h, w, c, cy, 3)
    mm_sig = tune.sig_matmul(8, 896, 4864)
    wc, wd, ws_, wa = (i8((3, 3, c, cy)), i8((3, 3, c)), i8((c, cy)),
                       i8((3, 3, c, cy)))
    pc, pd, pshift, pa = (w4((3, 3, c, cy), 2), w4((3, 3, c), 0),
                          w4((c, cy), 0), w4((3, 3, c, cy), 2))
    a8, bm8 = i8((8, 896)), i8((896, 4864))
    pm = w4((896, 4864), 0)
    fc, fd, fs, fa = (f((3, 3, c, cy)), f((3, 3, c)), f((c, cy)),
                      f((3, 3, c, cy)))
    fa_, fb_ = f((40, 300)), f((300, 520))
    xc, wcv = f((2, 70, 320), torch.bfloat16), f((4, 320), torch.bfloat16)
    akw = dict(requant_shift=9, x_preshift=2, w_preshift=0)
    return [
        ("conv2d_q8", conv_sig, "int8",
         lambda **k: K.conv2d_q8(x8, wc, b, **q, **k)),
        ("depthwise2d_q8", dw_sig, "int8",
         lambda **k: K.depthwise2d_q8(x8, wd, **q, **k)),
        ("maxpool2d_s8", pool_sig, "int8",
         lambda **k: K.maxpool2d_s8(x8, **k)),
        ("shift_conv2d_q8", shift_sig, "int8",
         lambda **k: K.shift_conv2d_q8(x8, table, ws_, b, max_shift=1, **q,
                                       **k)),
        ("add_conv2d_q8", add_sig, "int8",
         lambda **k: K.add_conv2d_q8(x8, wa, b, **akw, **k)),
        ("conv2d_w4", conv_sig, "w4a8",
         lambda **k: K.conv2d_w4(x8, *pc, b, **q, **k)),
        ("depthwise2d_w4", dw_sig, "w4a8",
         lambda **k: K.depthwise2d_w4(x8, *pd, **q, **k)),
        ("shift_conv2d_w4", shift_sig, "w4a8",
         lambda **k: K.shift_conv2d_w4(x8, table, *pshift, b, max_shift=1,
                                       **q, **k)),
        ("add_conv2d_w4", add_sig, "w4a8",
         lambda **k: K.add_conv2d_w4(x8, *pa, b, **akw, **k)),
        ("matmul_q8", mm_sig, "int8",
         lambda **k: K.matmul_q8(a8, bm8, requant_shift=14, **k)),
        ("matmul_w4", mm_sig, "w4a8",
         lambda **k: K.matmul_w4(a8, *pm, requant_shift=14, **k)),
        ("causal_conv1d", tune.sig_causal_conv1d(2, 70, 320, 4), "bfloat16",
         lambda **k: K.causal_conv1d(xc, wcv, **k)),
        ("conv2d_f", conv_sig, "float32",
         lambda **k: K.conv2d_f(xf, fc, act="relu", **k)),
        ("depthwise2d_f", dw_sig, "float32",
         lambda **k: K.depthwise2d_f(xf, fd, **k)),
        ("maxpool2d_f", pool_sig, "float32",
         lambda **k: K.maxpool2d_f(xf, **k)),
        ("shift_conv2d_f", shift_sig, "float32",
         lambda **k: K.shift_conv2d_f(xf, table, fs, max_shift=1, **k)),
        ("add_conv2d_f", add_sig, "float32",
         lambda **k: K.add_conv2d_f(xf, fa, **k)),
        ("matmul_f", tune.sig_matmul(40, 300, 520), "float32",
         lambda **k: K.matmul_f(fa_, fb_, **k)),
    ]


def phase_candidates(torch, K, dev, rng):
    """Every config in the tuner's space of every entry point, at one shape
    each, bitwise equal to the default config's output."""
    from repro_torch import tune
    total = 0
    for name, sig, dtype, call in entry_points(torch, K, dev, rng):
        cands = list(tune.candidates(sig, dtype))
        check(len(cands) >= 2, f"{name}: a space of {len(cands)}")
        want = call(**tune.default_config(sig.kernel, sig, dtype))
        for cfg in cands:
            got = call(**cfg)
            torch.cuda.synchronize()
            check(torch.equal(_bits(torch, got) if got.is_floating_point()
                              else got,
                              _bits(torch, want) if want.is_floating_point()
                              else want),
                  f"{name} {sig.key()} {cfg}: output differs from the "
                  "default config's")
        total += len(cands)
        print(f"[kernels] {name} {sig.key()} [{dtype}]: all "
              f"{len(cands)} candidates {cands} bitwise equal to the "
              "default")
    print(f"[kernels] tuner candidates: {total} configs of 18 entry points "
          "bitwise equal to their defaults")


# ---------------------------------------------------------------- phase 4 --

def numpy_params(cfg, rng, group_spread=None):
    """CNN parameters in the JAX package's layout, He-normal from ``rng``.
    With ``group_spread=g``, each conv weight's input channels are scaled
    by 2^-((c // g) % 4): one octave down per group of ``g``."""
    from repro_torch.models.convnet import _specs
    blocks = []
    for s in _specs(cfg):
        hk, cx, cy = s.kernel_size, s.in_channels, s.out_channels

        def he(shape, fan_in):
            return (rng.standard_normal(shape) * (2.0 / fan_in) ** 0.5) \
                .astype("float32")
        if s.primitive == "dws":
            conv = {"w_dw": he((hk, hk, cx, 1), hk * hk),
                    "w_pw": he((1, 1, cx, cy), cx)}
        elif s.primitive == "shift":
            conv = {"shifts": grid_table(cx, hk // 2),
                    "w_pw": he((1, 1, cx, cy), cx)}
        else:
            conv = {"w": he((hk, hk, cx // s.groups, cy),
                            hk * hk * cx // s.groups)}
        if group_spread:
            for k in ("w", "w_pw"):
                if k in conv:
                    c = conv[k].shape[2]
                    octave = (np.arange(c) // group_spread) % 4
                    conv[k] *= (2.0 ** -octave)[:, None].astype("float32")
        conv["b"] = (rng.standard_normal(cy) * 0.1).astype("float32")
        # mean/var are re-estimated by the calibration sweep
        bn = {"gamma": (1.0 + 0.1 * rng.standard_normal(cy)).astype("float32"),
              "beta": (0.1 * rng.standard_normal(cy)).astype("float32"),
              "mean": np.zeros(cy, "float32"), "var": np.ones(cy, "float32")}
        blocks.append({"conv": conv, "bn": bn})
    head = (rng.standard_normal((cfg.widths[-1], cfg.num_classes))
            * cfg.widths[-1] ** -0.5).astype("float32")
    return {"blocks": blocks, "head": head}


def plan_to_host(plan):
    """A copy of ``plan`` with every tensor on the host."""
    from repro_torch.core.quantize import QTensor, QTensorW4

    def host(v):
        if isinstance(v, QTensor):
            return QTensor(v.q.cpu(), v.frac_bits)
        if isinstance(v, QTensorW4):
            return dataclasses.replace(v, q=v.q.cpu(), shifts=v.shifts.cpu())
        return v.cpu() if hasattr(v, "cpu") else v
    nodes = tuple(dataclasses.replace(
        n, qparams=None if n.qparams is None
        else {k: host(v) for k, v in n.qparams.items()}) for n in plan.nodes)
    return dataclasses.replace(plan, nodes=nodes)


def phase_plan(torch, K, name, rng, dev="cuda"):
    """Lower one plan of ``PLANS`` on ``dev`` and hold its cuda trunk
    against the torch trunk and a host run; returns ``(plan, x, trunk)``,
    the CompiledPlan, its 256 input images and its cuda trunk."""
    from repro_torch.core.quantize import QTensorW4
    from repro_torch.graph import CompiledPlan, build_cnn_graph, lower
    from repro_torch.models import CNNConfig, quantize_cnn
    from repro_torch.weights import params_from_numpy
    primitive, bits, group = PLANS[name]
    cfg = CNNConfig(primitive=primitive)
    spread = group if bits == 4 and group < 32 else None
    params = params_from_numpy(numpy_params(cfg, rng, spread), device=dev)
    calib = (rng.standard_normal((BATCH, 32, 32, 3)) * 0.5).astype("float32")
    x = (rng.standard_normal((BATCH, 32, 32, 3)) * 0.5).astype("float32")
    t0 = time.perf_counter()
    if bits == 8:
        cuda_plan = quantize_cnn(params, cfg, calib, method="cuda",
                                 device=dev)
    else:        # W4A8: JAX's quantize_cnn has no weight_bits, nor the port's
        plan = lower(build_cnn_graph(cfg), params,
                     torch.as_tensor(calib, device=dev), weight_bits=bits,
                     group_size=group)
        cuda_plan = CompiledPlan(plan, method="cuda", device=dev)
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    t_lower = time.perf_counter() - t0
    weights = [v for n in cuda_plan.plan.nodes if n.op == "qconv"
               for k, v in n.qparams.items() if k in ("w", "w_dw", "w_pw")]
    check(all(isinstance(v, QTensorW4) == (bits == 4) for v in weights),
          f"{name}: not every conv weight is {'W4' if bits == 4 else 'int8'}")
    torch_plan = CompiledPlan(cuda_plan.plan, method="torch", device=dev)
    host_plan = CompiledPlan(plan_to_host(cuda_plan.plan), method="torch",
                             device="cpu")
    captured = ""
    if torch.device(dev).type == "cuda":
        captured = check_captured(torch, K, name, cuda_plan, x)
    K.reset_launches()
    tc = cuda_plan.trunk(x)
    used = sorted(k.__name__ for k in K.KERNELS if k.launches)
    suffix = "_w4" if bits == 4 else "_q8"
    check(all(u.endswith(suffix) or u == "maxpool2d_s8" for u in used),
          f"{name}: a {bits}-bit forward launched {used}")
    tt = torch_plan.trunk(x)
    check(tc.q.dtype == torch.int8 and tc.frac_bits == tt.frac_bits,
          f"{name}: trunk dtype/scale mismatch")
    diff = int((tc.q.int() - tt.q.int()).abs().max())
    check(diff == 0, f"{name}: cuda trunk differs from torch trunk by "
                     f"{diff}")
    th = host_plan.trunk(x[:8])
    check(torch.equal(tc.q[:8].cpu(), th.q),
          f"{name}: card trunk differs from the host run")
    lc, lt = cuda_plan(x), torch_plan(x)
    check(tuple(lc.shape) == (BATCH, cfg.num_classes)
          and bool(torch.isfinite(lc).all()),
          f"{name}: logits not finite of shape (256, 10)")
    err = float((lc - lt).abs().max())
    check(err <= 1e-5, f"{name}: logits differ by {err} > 1e-5")
    nz = float((tc.q != 0).float().mean())
    groups = ""
    if bits == 4:
        n_groups = [len(set(v.shifts.tolist())) for v in weights]
        check(not spread or max(n_groups) > 1,
              f"{name}: no layer carries more than one group shift")
        groups = (f", W4 group_size={group}, distinct group shifts per "
                  f"weight {n_groups}, kernels {used}")
    print(f"[plan] {name}: lowered in {t_lower:.2f} s, in_fb="
          f"{cuda_plan.plan.in_fb}, cuda trunk == torch trunk bitwise "
          f"({tuple(tc.q.shape)}, {nz:.3f} nonzero) == host trunk, "
          f"logits max |diff| {err:.2e}{groups}{captured}")
    return cuda_plan, x, tc


def check_captured(torch, K, name, plan, x):
    """Capture ``plan`` (jit=True) at every bucket phase 5 serves and hold
    each captured trunk bitwise against the same plan run node by node
    from Python (jit=False): the capture's first call and a replay. A
    replay then counts exactly the launches an eager forward counts, and
    at each bucket the launches its capture recorded (what every replay
    adds to the wrappers' counts) equal the port's kernels that
    torch.profiler sees one replay run on the card. Returns a note for
    the [plan] line."""
    from repro_torch.graph import CompiledPlan
    check(plan.jit and plan.traces == 0,
          f"{name}: the served plan is not a fresh jit=True plan")
    eager = CompiledPlan(plan.plan, method=plan.method, device=plan.device,
                         jit=False)
    first_ms = []
    for b in CAPTURED_BUCKETS:
        want = eager.trunk(x[:b])
        for call in ("capture", "replay"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = plan.trunk(x[:b])
            torch.cuda.synchronize()
            if call == "capture":
                first_ms.append(1e3 * (time.perf_counter() - t0))
            check(torch.equal(got.q, want.q)
                  and got.frac_bits == want.frac_bits,
                  f"{name}: the captured trunk at batch {b} ({call}) "
                  "differs from jit=False")
        err = float((plan(x[:b]) - eager(x[:b])).abs().max())
        check(err <= 1e-5, f"{name}: captured logits at batch {b} differ "
                           f"from jit=False by {err}")
    check(plan.traces == len(CAPTURED_BUCKETS),
          f"{name}: {plan.traces} captures for buckets {CAPTURED_BUCKETS}")
    K.reset_launches()
    eager.trunk(x)
    want = {k.__name__: k.launches for k in K.KERNELS}
    K.reset_launches()
    plan.trunk(x)
    got = {k.__name__: k.launches for k in K.KERNELS}
    check(got == want and any(got.values()),
          f"{name}: a replay launched {got}, an eager forward {want}")
    seen = []
    for b in CAPTURED_BUCKETS:
        recorded = {}
        for k, n in plan._graphs[b].launches.items():
            sym = DEVICE_KERNEL[k.__name__]
            recorded[sym] = recorded.get(sym, 0) + n
        x_dev = torch.from_numpy(x[:b]).cuda()
        rows = device_kernels(torch, lambda: plan.forward_batch(x_dev), 5)
        ran = {sym: sum(r.launches for r in rows if sym in r.key)
               for sym in set(DEVICE_KERNEL.values())}
        ran = {sym: n for sym, n in ran.items() if n}
        check(ran == recorded,
              f"{name}: one replay at batch {b} ran {ran} on the card "
              f"(torch.profiler), its capture recorded {recorded}")
        seen.append(f"{b}: {dict(sorted(ran.items()))}")
    return (f"; captured at batches {CAPTURED_BUCKETS} ({plan.traces} "
            "graphs; first call, warm-up + capture + replay, "
            + " and ".join(f"{ms:.1f}" for ms in first_ms) + " ms), each "
            "trunk == jit=False bitwise, a replay's launches == an eager "
            "forward's == the kernels torch.profiler saw one replay run ("
            + "; ".join(seen) + ")")


# ---------------------------------------------------------------- phase 5 --

def phase_serve(torch, K, name, plan, card, rng):
    """Serve one plan's images through CNNEngine; returns the launch count
    of every kernel in that run."""
    from repro_torch.serve import CNNEngine, CNNServeConfig, ImageRequest
    n_img = SERVED[name]
    images = (rng.standard_normal((n_img, 32, 32, 3)) * 0.5) \
        .astype("float32")
    eng = CNNEngine(plan, CNNServeConfig(max_batch=BATCH))
    for i in range(n_img):
        eng.submit(ImageRequest(uid=i, image=images[i]))
    K.reset_launches()
    done = eng.run_until_drained()
    launches = {k.__name__: k.launches for k in K.KERNELS}
    st = eng.stats
    statuses = {r.status for r in done}
    check(len(done) == n_img and statuses == {"ok"},
          f"serve {name}: {len(done)} requests, statuses {statuses}")
    check(st["errors"] == 0 and st["retries"] == 0,
          f"serve {name}: errors={st['errors']} "
          f"retries={st['retries']}")
    rounds = -(-n_img // BATCH)
    check(st["batch_rounds"] == rounds,
          f"serve {name}: {st['batch_rounds']} rounds, not {rounds}")
    want_launches = {k: rounds * PER_FORWARD[name].get(k, 0)
                     for k in launches}
    check(launches == want_launches,
          f"serve {name}: launches {launches}, a plan of "
          f"{rounds} forwards needs {want_launches}")
    by_uid = {r.uid: r for r in done}
    worst = 0.0
    for start in range(0, n_img, BATCH):
        chunk = images[start:start + BATCH]
        want = plan.forward_batch(chunk).cpu().numpy()
        got = [by_uid[start + j].logits for j in range(len(chunk))]
        worst = max(worst, float(np.abs(np.stack(got) - want).max()))
    check(worst <= 1e-5, f"serve {name}: logits differ from "
                         f"forward_batch by {worst}")
    round_ms = 1e3 * eng.metrics.counter("serve.cnn.batch_time_s").value \
        / st["batch_rounds"]
    print(f"[serve] {name}: {n_img} images in {st['batch_rounds']} "
          f"rounds, all ok; images_per_s={st['images_per_s']:.1f} "
          f"latency_p50_s={st['latency_p50_s']:.5f} "
          f"latency_p99_s={st['latency_p99_s']:.5f} on {card}; "
          f"launches {launches}; logits vs forward_batch max |diff| "
          f"{worst:.1e}")
    serve_breakdown(torch, name, plan, images[:BATCH], round_ms, card)
    return launches


def serve_breakdown(torch, name, plan, x_host, round_ms, card):
    """Where one full 256-image round goes: the engine's round (host images
    in, host logits out), forward_batch on host input, and, for the plan
    as served (its captured graph) and the same plan run node by node from
    Python (jit=False), in one run: forward_batch on device-resident input
    (CUDA events), the device time of its kernels (torch.profiler), the
    device's idle share and throughput images/s."""
    from repro_torch.graph import CompiledPlan
    x_dev = torch.from_numpy(x_host).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        plan.forward_batch(x_host).cpu()
    fwd_host_ms = 1e3 * (time.perf_counter() - t0) / 10
    eager = CompiledPlan(plan.plan, method=plan.method, device=plan.device,
                         jit=False)
    parts, rows = [], None
    for label, ex in (("captured", plan), ("jit=False", eager)):
        fwd_ms = time_ms(torch, lambda: ex.forward_batch(x_dev), reps=10,
                         trials=5)
        kernels = device_kernels(torch, lambda: ex.forward_batch(x_dev), 5)
        dev_ms = sum(r.us for r in kernels) / 1e3
        n_kern = sum(r.launches for r in kernels)
        check(dev_ms > 0, f"torch.profiler saw no device time ({label})")
        ips = ex.throughput(x_dev, reps=10, warmup=3)["images_per_s"]
        parts.append(f"{label}: forward_batch device-resident {fwd_ms:.4f} "
                     f"ms, device busy {dev_ms:.4f} ms in {n_kern:.0f} "
                     f"kernels, idle {1 - dev_ms / fwd_ms:.3f}, throughput "
                     f"{ips:.1f} images/s")
        rows = rows or kernels
    print(f"[breakdown] {name}: one 256-image round: engine round "
          f"{round_ms:.4f} ms; forward_batch host in/out {fwd_host_ms:.4f} "
          f"ms; {'; '.join(parts)}; on {card}")
    for r in sorted(rows, key=lambda r: -r.us):
        kernel = r.key.replace("void ", "").replace("at::native::", "")
        print(f"[breakdown] {name}   {r.us:9.1f} us x{r.launches:3.0f}  "
              f"{kernel[:110]}")


# ---------------------------------------------------------------- phase 6 --

def phase_lm(torch, K, card, rng, dev="cuda", cfg=None, n_req=LM_REQUESTS,
             new_tokens=LM_NEW, prompt=LM_PROMPT, n_eager=LM_EAGER_REQUESTS):
    """Serve Qwen2-0.5B in every (precision, KV cache) of ``LM_RUNS``,
    captured, and ``LM_EAGER`` again with jit=False on the first
    ``n_eager`` requests; returns the launch count of every kernel over
    the runs."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serve import Engine, ServeConfig
    cfg = cfg or get_config(LM_ARCH)
    t0 = time.perf_counter()
    params = api.init_params(cfg, torch.Generator(device=dev)
                             .manual_seed(SEED), device=dev)
    sync(torch, dev)
    n_params = sum(v.numel() for v in _leaves(params))
    # the config's analytic count leaves out the final norm's d_model
    check(n_params == cfg.param_count() + cfg.d_model,
          f"lm: {n_params} parameters, the config counts "
          f"{cfg.param_count()} + {cfg.d_model}")
    print(f"[lm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, {n_params:,} parameters "
          f"made on the card in {time.perf_counter() - t0:.2f} s")
    prompts = [rng.integers(0, cfg.vocab, (int(n),)).astype(np.int32)
               for n in rng.integers(prompt[0], prompt[1] + 1, n_req)]
    launches = dict.fromkeys((k.__name__ for k in K.KERNELS), 0)
    streams, engines = {}, {}
    runs = [(prec, kv, True, prompts) for prec, kv in LM_RUNS] + \
        [(prec, "float", False, prompts[:n_eager]) for prec in LM_EAGER]
    for prec, kv, jit, served in runs:
        label = prec + (" kv=int8" if kv == "int8" else "") + \
            ("" if jit else " jit=False")
        t0 = time.perf_counter()
        eng = Engine(cfg, params, ServeConfig(max_batch=LM_BATCH,
                                              max_len=LM_MAX_LEN,
                                              precision=prec, kv_cache=kv),
                     jit=jit)
        sync(torch, dev)
        t_init = time.perf_counter() - t0
        got, done, wall = serve_lm(torch, K, eng, served, new_tokens, label,
                                   dev)
        st = eng.stats
        calls = 3 * cfg.n_layers * (st["prefills"] + st["decode_steps"])
        want = dict.fromkeys(got, 0)
        if prec in LM_KERNEL and torch.device(dev).type == "cuda":
            want[LM_KERNEL[prec]] = calls     # a host run launches nothing
        check(got == want, f"lm {label}: launches {got}, "
                           f"{st['prefills']} prefills and "
                           f"{st['decode_steps']} decode steps need {want}")
        for k, v in got.items():
            launches[k] += v
        streams[label] = [r.out_tokens for r in done]
        ttft = np.percentile([r.ttft_s for r in done], [50, 99])
        step_ms = 1e3 * eng.metrics.counter("serve.decode_time_s").value \
            / st["decode_steps"]
        print(f"[lm] {label}: {len(served)} requests ok, {st['tokens_out']} "
              f"tokens in {wall:.2f} s ({st['tokens_out'] / wall:.1f} "
              f"tokens/s end to end; decode_tok_s="
              f"{st['decode_tok_s']:.1f}), {st['prefills']} prefills, "
              f"{st['decode_steps']} decode steps at {step_ms:.3f} ms, "
              f"occupancy {st['occupancy']:.3f}, TTFT p50 {ttft[0]:.4f} s "
              f"p99 {ttft[1]:.4f} s (over the {len(served)} requests), "
              f"engine init {t_init:.2f} s, {eng.traces} graphs; launches "
              f"{ {k: v for k, v in got.items() if v} } on {card}")
        if jit and label in LM_BREAKDOWN:
            engines[label] = eng
        del eng
    for prec in LM_KERNEL:
        check(streams[prec] == streams[prec + "-torch"],
              f"lm {prec}: the kernel's token streams differ from the "
              "plain version's")
        agree = agreement(streams[prec], streams["float"])
        print(f"[lm] {prec}: token streams equal to {prec}-torch's "
              f"({n_req} x {new_tokens} tokens); {agree:.3f} of tokens "
              "equal to the float engine's")
    for prec in LM_EAGER:
        check(streams[prec + " jit=False"] == streams[prec][:n_eager],
              f"lm {prec}: jit=False token streams differ from the "
              "captured engine's")
        print(f"[lm] {prec}: captured token streams equal to jit=False's "
              f"({n_eager} x {new_tokens} tokens)")
    check(streams["int8 kv=int8"] == streams["int8-torch kv=int8"],
          "lm int8 kv=int8: the kernel's token streams differ from the "
          "plain version's")
    print(f"[lm] kv=int8: int8 token streams equal to int8-torch's "
          f"({n_req} x {new_tokens} tokens); token agreement with the float "
          f"KV cache: float "
          f"{agreement(streams['float kv=int8'], streams['float']):.3f}, "
          f"int8 {agreement(streams['int8 kv=int8'], streams['int8']):.3f}")
    for label, eng in engines.items():
        lm_breakdown(torch, label, eng, cfg, dev)
    return launches


def agreement(a, b) -> float:
    """The share of equal tokens of two sets of token streams."""
    return float(np.mean([x == y for s, t in zip(a, b)
                          for x, y in zip(s, t)]))


def serve_lm(torch, K, eng, prompts, new_tokens, label, dev):
    """Warm ``eng`` up with one request into each prefill bucket the
    prompts fall into (for a captured engine: each graph's capture, whose
    first-call ms is printed), zero its stats and the launch counts, then
    serve ``prompts``: every status ok, streams of ``new_tokens`` ids in
    the vocabulary, no error or retry, and no capture in the timed run.
    Returns (launches, requests by uid, wall seconds)."""
    from repro_torch.serve import Request
    vocab = eng.cfg.vocab
    buckets = sorted({eng._bucket_len(len(p)) for p in prompts})
    if eng.cfg.family == "dense":
        warm = [np.resize(prompts[0], b) for b in buckets]
    else:                       # exact lengths, an eager prefill each
        warm = [p[:LM_PROMPT[0]] for p in prompts[:2]]
    for i, p in enumerate(warm):
        eng.submit(Request(uid=-1 - i, prompt=p, max_new_tokens=2))
    eng.run_until_drained()
    eng.reset_stats()
    if eng._captures():
        want = 1 + (len(buckets) if eng.cfg.family == "dense" else 0)
        check(eng.traces == want, f"lm {label}: {eng.traces} graphs after "
                                  f"the warm-up, not {want}")
        for key, cap in eng._graphs.items():
            print(f"[lm] {label}: graph {key[0]} "
                  f"{'batch' if key[0] == 'decode' else 'bucket'} {key[1]}"
                  f": first call (eager pass + capture) "
                  f"{1e3 * cap.seconds:.1f} ms, "
                  f"{sum(cap.launches.values())} kernel launches a replay")
    traces = eng.traces
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=new_tokens))
    K.reset_launches()
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    wall = time.perf_counter() - t0
    got = {k.__name__: k.launches for k in K.KERNELS}
    st = eng.stats
    statuses = {r.status for r in done}
    check(len(done) == len(prompts) and statuses == {"ok"},
          f"lm {label}: {len(done)} requests, statuses {statuses}")
    done = sorted(done, key=lambda r: r.uid)
    check(all(len(r.out_tokens) == new_tokens
              and all(0 <= t < vocab for t in r.out_tokens)
              for r in done),
          f"lm {label}: a stream is short or holds an id outside the "
          "vocabulary")
    check(st["errors"] == st["retries"] == 0,
          f"lm {label}: errors={st['errors']} retries={st['retries']}")
    check(eng.traces == traces, f"lm {label}: the timed run captured "
                                f"{eng.traces - traces} graphs")
    return got, done, wall


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def sync(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def lm_breakdown(torch, label, eng, cfg, dev, pos=128, reps=5,
                 port=("matmul_q_kernel",), what="the port's matmul kernel"):
    """One decode step of all ``LM_BATCH`` slots at position ``pos`` over a
    cache of the engine's KV dtype, captured (``graph.capture``, as the
    engine captures its step) and run op by op from Python (jit=False):
    each one's time (CUDA events), the device time of its device
    operations (kernels and memsets, torch.profiler) and their count,
    split into those whose names contain one of ``port`` and everything
    else, and the idle share. For a dense engine also the captured
    prefill (the engine's own graph) against the eager one at the buckets
    ``LM_PREFILL_TIMED``."""
    from repro_torch.graph.capture import capture
    from repro_torch.models import api
    cache = api.init_slot_cache(cfg, LM_BATCH, LM_MAX_LEN,
                                kv=eng.scfg.kv_cache, device=dev)
    cache["len"].fill_(pos)
    tok = torch.zeros((LM_BATCH, 1), dtype=torch.long, device=dev)
    step = lambda: eng.decode(eng.params, tok, cache)     # noqa: E731
    cap, _ = capture(lambda t: eng.decode(eng.params, t, cache)[0], (tok,),
                     key="lm.breakdown")
    rows = None
    for variant, fn in (("captured", cap.replay), ("jit=False", step)):
        step_ms = time_ms(torch, fn, reps=reps, trials=3)
        kernels = device_kernels(torch, fn, reps)
        dev_ms = sum(r.us for r in kernels) / 1e3
        check(dev_ms > 0, "torch.profiler saw no device time")
        mine = [r for r in kernels if any(t in r.key for t in port)]
        mm_ms = sum(r.us for r in mine) / 1e3
        n_ops = sum(r.launches for r in kernels)
        n_mine = sum(r.launches for r in mine)
        n_memset = sum(r.launches for r in kernels if "Memset" in r.key)
        print(f"[lm-breakdown] {label}: one decode step {variant}, "
              f"{LM_BATCH} slots at position {pos}: {step_ms:.4f} ms (CUDA "
              f"events), device busy {dev_ms:.4f} ms in {n_ops:.0f} device "
              f"operations ({n_memset:.0f} of them memsets), of which "
              f"{what} {mm_ms:.4f} ms in {n_mine:.0f} launches and the rest "
              f"{dev_ms - mm_ms:.4f} ms; device idle "
              f"{1 - dev_ms / step_ms:.3f}")
        rows = rows or kernels
    for r in sorted(rows, key=lambda r: -r.us)[:8]:
        kernel = r.key.replace("void ", "").replace("at::native::", "")
        print(f"[lm-breakdown] {label}   {r.us:9.1f} us x{r.launches:4.0f}  "
              f"{kernel[:100]}")
    # the round's host work after the step, as the engine does it: the
    # logits to the host, then each slot's greedy pick there
    logits = cap.replay()
    sync(torch, dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        host = logits.cpu().numpy()
    copy_ms = 1e3 * (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        picks = [int(np.argmax(host[i, -1])) for i in range(LM_BATCH)]
    pick_ms = 1e3 * (time.perf_counter() - t0) / reps
    check(len(picks) == LM_BATCH, "lm-breakdown: a slot has no pick")
    print(f"[lm-breakdown] {label}: a decode round's host work (host "
          f"clock, mean of {reps}): the {tuple(logits.shape)} float32 "
          f"logits ({logits.numel() * 4 / 1e6:.2f} MB) to the host "
          f"{copy_ms:.4f} ms, the greedy pick of its {LM_BATCH} rows "
          f"{pick_ms:.4f} ms")
    if cfg.family != "dense":
        return
    for b in LM_PREFILL_TIMED:
        graph = eng._graphs[("prefill", b)]
        toks, plen = graph.inputs
        eager = lambda: eng.prefill(eng.params, {    # noqa: E731
            "tokens": toks, "prompt_lens": plen})
        ms = {v: time_ms(torch, fn, reps=reps, trials=3)
              for v, fn in (("captured", graph.replay), ("eager", eager))}
        print(f"[lm-breakdown] {label}: one prefill at bucket {b} (batch 1): "
              f"captured {ms['captured']:.4f} ms, eager {ms['eager']:.4f} ms "
              f"(CUDA events)")


# ---------------------------------------------------------------- phase 7 --

def phase_ssm(torch, K, card, rng, dev="cuda", cfg=None, n_req=SSM_REQUESTS,
              new_tokens=LM_NEW, prompt=LM_PROMPT,
              check_layers=SSM_CHECK_LAYERS, n_eager=SSM_EAGER_REQUESTS):
    """Serve Falcon-Mamba-7B in "float", captured, and its first
    ``n_eager`` requests again with jit=False; returns the launch count of
    every kernel in the captured run."""
    from repro_torch.configs import get_config
    from repro_torch.models import api, mamba
    from repro_torch.models import transformer as T
    from repro_torch.models.blocks import rmsnorm
    from repro_torch.serve import Engine, ServeConfig
    cfg = cfg or get_config(SSM_ARCH)
    t0 = time.perf_counter()
    params = api.init_params(cfg, torch.Generator(device=dev)
                             .manual_seed(SEED), device=dev)
    sync(torch, dev)
    n_params = sum(v.numel() for v in _leaves(params))
    check(n_params == cfg.param_count() + cfg.d_model,
          f"ssm: {n_params} parameters, the config counts "
          f"{cfg.param_count()} + {cfg.d_model}")
    m = cfg.mamba
    print(f"[ssm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"d_inner {m.expand * cfg.d_model}, d_state {m.d_state}, d_conv "
          f"{m.d_conv}, dt_rank {m.rank(cfg.d_model)}, vocab {cfg.vocab}, "
          f"{n_params:,} parameters made on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    prompts = [rng.integers(0, cfg.vocab, (int(n),)).astype(np.int32)
               for n in rng.integers(prompt[0], prompt[1] + 1, n_req)]
    scfg = ServeConfig(max_batch=LM_BATCH, max_len=LM_MAX_LEN)
    t0 = time.perf_counter()
    eng = Engine(cfg, params, scfg)
    del params                  # the engine holds the cast copy it serves
    sync(torch, dev)
    t_init = time.perf_counter() - t0
    got, done, wall = serve_lm(torch, K, eng, prompts, new_tokens, "ssm",
                               dev)
    st = eng.stats
    check(st["prefills"] == n_req, f"ssm: {st['prefills']} prefills")
    want = dict.fromkeys(got, 0)
    if torch.device(dev).type == "cuda":   # a host run launches nothing
        want["causal_conv1d"] = cfg.n_layers * st["prefills"]
    check(got == want, f"ssm: launches {got}, {st['prefills']} prefills "
                       f"and {st['decode_steps']} decode steps need {want}")
    ttft = np.percentile([r.ttft_s for r in done], [50, 99])
    step_ms = 1e3 * eng.metrics.counter("serve.decode_time_s").value \
        / st["decode_steps"]
    print(f"[ssm] float: {n_req} requests ok, {st['tokens_out']} tokens in "
          f"{wall:.2f} s ({st['tokens_out'] / wall:.1f} tokens/s end to "
          f"end; decode_tok_s={st['decode_tok_s']:.1f}), {st['prefills']} "
          f"prefills at their exact lengths ({min(map(len, prompts))}-"
          f"{max(map(len, prompts))} tokens), {st['decode_steps']} decode "
          f"steps at {step_ms:.3f} ms, occupancy {st['occupancy']:.3f}, "
          f"TTFT p50 {ttft[0]:.4f} s p99 {ttft[1]:.4f} s (over the {n_req} "
          f"requests), engine init {t_init:.2f} s, {eng.traces} graph; "
          f"launches { {k: v for k, v in got.items() if v} } ({cfg.n_layers} "
          f"per prefill, 0 per decode step) on {card}")
    # the same engine op by op (it shares the cast weights) on the first
    # requests: the captured step changes no token
    eager = Engine(cfg, eng.params, scfg, jit=False)
    _, done_e, wall_e = serve_lm(torch, K, eager, prompts[:n_eager],
                                 new_tokens, "ssm jit=False", dev)
    check([r.out_tokens for r in done_e]
          == [r.out_tokens for r in done[:n_eager]],
          "ssm: jit=False token streams differ from the captured engine's")
    st_e = eager.stats
    step_e = 1e3 * eager.metrics.counter("serve.decode_time_s").value \
        / st_e["decode_steps"]
    print(f"[ssm] float jit=False: {n_eager} requests ok, captured token "
          f"streams equal to jit=False's ({n_eager} x {new_tokens} tokens); "
          f"decode_tok_s={st_e['decode_tok_s']:.1f}, "
          f"{st_e['decode_steps']} decode steps at {step_e:.3f} ms, "
          f"{st_e['tokens_out'] / wall_e:.1f} tokens/s end to end")
    del eager
    # the block with the kernel against the block with its plain version,
    # on the first layers of the served (cast) weights at a served prompt
    cdt = T._cdt(cfg)
    tok = torch.as_tensor(prompts[0][None].astype(np.int64), device=dev)
    h = T.embed_tokens(eng.params, tok, cfg, cdt)
    for layer in range(check_layers):
        lp = T._take(eng.params["layers"], layer)
        x = rmsnorm(h, lp["ln"], cfg.norm_eps)
        y = mamba.mamba_forward(lp["mamba"], x, m, cdt, conv_method="cuda")
        y_plain = mamba.mamba_forward(lp["mamba"], x, m, cdt,
                                      conv_method="torch")
        sync(torch, dev)
        check(bool(torch.isfinite(y).all()) and torch.equal(y, y_plain),
              f"ssm: layer {layer}'s block with the kernel differs from "
              "the block with the plain version (or is not finite)")
        h = h + y
    logits, _ = eng.prefill(eng.params, {
        "tokens": tok, "prompt_lens": torch.tensor(
            [tok.shape[1]], dtype=torch.int32, device=dev)})
    check(tuple(logits.shape) == (1, 1, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          f"ssm: prefill logits {tuple(logits.shape)} not finite of shape "
          f"(1, 1, {cfg.vocab})")
    print(f"[ssm] mamba_forward with the kernel == with the plain version "
          f"bitwise on layers 0-{check_layers - 1} at a "
          f"{tok.shape[1]}-token prompt; prefill logits finite, "
          f"{tuple(logits.shape)}")
    lm_breakdown(torch, "ssm float", eng, cfg, dev,
                 port=("causal_conv1d",),
                 what="the port's causal_conv1d kernel")
    ssm_breakdown(torch, eng, cfg, dev, rng)
    return got


def ssm_breakdown(torch, eng, cfg, dev, rng, length=SSM_BREAKDOWN_LEN,
                  reps=3, tries=3):
    """One prefill of a ``length``-token prompt, as the engine runs it: its
    time (CUDA events), the device time of its device operations and their
    count, the causal_conv1d launches' share and the copy kernels; then
    the same prefill with each layer's x_in copied before the conv (the
    layout before the conv read the in_proj view in place), which must
    take exactly one device operation a layer more. Each pair is measured
    again, up to ``tries`` times, where a profiler session lost records."""
    from repro_torch.models import mamba
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, (1, length)),
                          device=dev)
    batch = {"tokens": tok, "prompt_lens": torch.tensor(
        [length], dtype=torch.int32, device=dev)}
    prefill = lambda: eng.prefill(eng.params, batch)      # noqa: E731
    real = mamba.K.causal_conv1d

    def copied(x, w, **kw):
        return real(x.contiguous(), w, **kw)

    def measure():
        ms = time_ms(torch, prefill, reps=reps, trials=3)
        rows = device_kernels(torch, prefill, reps)
        return ms, rows
    for _ in range(tries):
        wall, rows = measure()
        mamba.K.causal_conv1d = copied
        try:
            wall_c, rows_c = measure()
        finally:
            mamba.K.causal_conv1d = real
        n_ops = sum(r.launches for r in rows)
        n_ops_c = sum(r.launches for r in rows_c)
        if n_ops_c - n_ops == cfg.n_layers:
            break
    busy = sum(r.us for r in rows) / 1e3
    conv = [r for r in rows if "causal_conv1d" in r.key]
    conv_ms = sum(r.us for r in conv) / 1e3
    n_conv = sum(r.launches for r in conv)

    def copies(rs):
        return sum(r.launches for r in rs if "copy" in r.key.lower())
    check(busy > 0, "torch.profiler saw no device time")
    check(n_conv == cfg.n_layers, f"ssm-breakdown: {n_conv} causal_conv1d "
                                  f"launches a prefill, not {cfg.n_layers}")
    check(n_ops_c - n_ops == cfg.n_layers,
          f"ssm-breakdown: the prefill takes {n_ops} device operations, "
          f"with x_in copied {n_ops_c}: not {cfg.n_layers} fewer")
    print(f"[ssm-breakdown] float: one {length}-token prefill: {wall:.4f} "
          f"ms (CUDA events), device busy {busy:.4f} ms in {n_ops:.0f} "
          f"device operations, of which the {n_conv:.0f} causal_conv1d "
          f"launches {conv_ms:.4f} ms ({conv_ms / busy:.4f} of busy) and "
          f"{copies(rows):.0f} copy kernels; device idle "
          f"{1 - busy / wall:.3f}. With x_in copied before each conv (the "
          f"earlier layout): {wall_c:.4f} ms, busy "
          f"{sum(r.us for r in rows_c) / 1e3:.4f} ms in {n_ops_c:.0f} device "
          f"operations ({n_ops_c - n_ops:.0f} more), {copies(rows_c):.0f} "
          "copy kernels")
    for r in sorted(rows, key=lambda r: -r.us)[:8]:
        kernel = r.key.replace("void ", "").replace("at::native::", "")
        print(f"[ssm-breakdown]   {r.us:9.1f} us x{r.launches:4.0f}  "
              f"{kernel[:100]}")


# ---------------------------------------------------------------- phase 8 --

#: phase 8: the phase-4 plans served again with the tuned cache installed
TUNED_PLANS = ("dws", "shift-w4")
TUNE_CACHE = ROOT / "build" / "repro_torch" / "tune_cache.json"


def phase_tune(torch, K, card, plans, dev="cuda"):
    """The autotuner path: ``python -m repro_torch.tune``'s main over the
    Table-2 jobs and the four CNN primitives' int8 and W4 plans at B=256,
    plus the tuner's float pool jobs; the cache written, reloaded and
    installed; the int8 dws and W4 shift plans of phase 4 served through
    CompiledPlan with it, their trunks bitwise equal to phase 4's; their
    throughput; the host cost of a memo-hit lookup. Returns the launch
    count of every kernel over the phase."""
    from repro_torch import tune
    from repro_torch.graph import CompiledPlan
    from repro_torch.obs import metrics
    from repro_torch.tune.__main__ import _Maker, _pool
    from repro_torch.tune.__main__ import main as tune_main
    tune.reset()
    K.reset_launches()
    t0 = time.perf_counter()
    # --verbose: every candidate's device time, one line each (the tile
    # sweeps of the integer conv and the float matmul among them)
    cache = tune_main(["--shapes", "table2", "--cnn",
                       "standard,dws,shift,add", "--cnn-batch", str(BATCH),
                       "--out", str(TUNE_CACHE), "--device", str(dev),
                       "--verbose"])
    # shapes_table2 pools int8: the tuner's float pool jobs, as the JAX
    # script's _pool(dtype=...) would give them
    mk = _Maker(dev)
    for dt in ("float32", "bfloat16"):
        kernel, sig, arrays, dtype, kw = _pool(mk, 8, 32, 32, 64, 2, 2,
                                               dtype=dt)
        best, best_us = tune.autotune_into(cache, kernel, sig, arrays,
                                           dtype, kwargs=kw, reps=3,
                                           warmup=1)
        e = cache.get(tune.cache_key(kernel, sig.key(), dtype,
                                     tune.backend_tag(dev)))
        print(f"{kernel}/{sig.key()}/{dtype}: best={best} {best_us:.2f}us "
              f"default={e['default_us']:.2f}us speedup="
              f"{e['default_us'] / best_us:.2f}x")
    cache.save(str(TUNE_CACHE))
    t_tune = time.perf_counter() - t0
    entries = cache.entries
    wins = sum(e["us"] < e["default_us"] for e in entries.values())
    speedups = [e["default_us"] / e["us"] for e in entries.values()]
    print(f"[tune] {len(entries)} jobs tuned on {tune.backend_tag(dev)} in "
          f"{t_tune:.1f} s ({sum(e['n_candidates'] for e in entries.values())}"
          f" candidates, ranked by device time); {wins} beat their default "
          "config; "
          f"default/best {min(speedups):.3f}-{max(speedups):.3f}x, geometric "
          f"mean {float(np.exp(np.mean(np.log(speedups)))):.3f}x; wrote "
          f"{TUNE_CACHE.relative_to(ROOT)}")

    reloaded = tune.TuneCache(str(TUNE_CACHE))
    check(not reloaded.stale and reloaded.entries == json.loads(
        json.dumps(entries)), "tune: the reloaded cache differs from the "
                              "one written")
    tune.set_default_cache(reloaded)
    hits = metrics.counter("tune.cache.hit")
    for name in TUNED_PLANS:
        plan, x, want = plans[name]
        h0 = hits.value
        ex = CompiledPlan(plan.plan, method="cuda", device=dev)
        got = ex.trunk(x)
        check(torch.equal(got.q, want.q) and got.frac_bits == want.frac_bits,
              f"tune {name}: the tuned plan's trunk differs from phase 4's")
        n_cfg = sum(len(c) for c in ex.node_configs.values())
        check(hits.value - h0 >= n_cfg > 0,
              f"tune {name}: {hits.value - h0} cache hits for {n_cfg} "
              "resolved node configs")
        # the analytic configs (no cache) and the tuned ones, in turns:
        # analytic, tuned, tuned, analytic
        untuned = CompiledPlan(plan.plan, method="cuda", device=dev)
        ips = {"tuned": [], "analytic": []}
        for which in ("analytic", "tuned", "tuned", "analytic"):
            tune.set_default_cache(reloaded if which == "tuned"
                                   else tune.TuneCache(None))
            r = (ex if which == "tuned" else untuned).throughput(
                x, reps=10, warmup=3)
            check(r["images_per_s"] > 0, f"tune {name}: no throughput")
            ips[which].append(r["images_per_s"])
        tune.set_default_cache(reloaded)
        print(f"[tune] {name}: trunk with the tuned cache == phase 4's "
              f"bitwise; node configs {ex.node_configs}; throughput (images/s"
              f", batch {BATCH}, wall clock, in turns) tuned "
              f"{ips['tuned'][0]:.1f} and {ips['tuned'][1]:.1f}, analytic "
              f"configs {ips['analytic'][0]:.1f} and {ips['analytic'][1]:.1f} "
              f"on {card}")
    launches = {k.__name__: k.launches for k in K.KERNELS}
    missing = [k for k, v in launches.items() if not v and k != "matmul_w4"]
    check(not missing, f"tune: the tuner never launched {missing}")

    sig = tune.sig_conv2d(BATCH, 32, 32, 3, 16, 3, 1)
    tune.get_config(sig, "int8", dev)
    n = 20000
    t0 = time.perf_counter()
    for _ in range(n):
        tune.get_config(sig, "int8", dev)
    us = 1e6 * (time.perf_counter() - t0) / n
    lost = metrics.counter("tune.profile.lost_sessions").value
    print(f"[tune] a memo-hit get_config takes {us:.3f} us of host time "
          f"({n} calls); {lost:.0f} profiler sessions of this run (phases "
          "3-8) recorded none or only part of their device activity (run "
          f"again, or filled in); launches {launches}")
    tune.reset()
    return launches


# ---------------------------------------------------------------- phase 9 --

#: phase 9: the paper's deployment flow, as examples/train_cnn_torch.py runs
#: it: each primitive trained at full width, quantized, served and profiled
FLOW_PRIMS = ("standard", "grouped", "dws", "shift", "add")
FLOW_BATCH, FLOW_STEPS, FLOW_RESUME = 64, 100, 50
#: int8 kernel launches per forward of each primitive's plan (widths
#: 16/32/64; the 3-channel stem is a standard conv, PER_FORWARD's rows)
FLOW_PER_FORWARD = {"standard": {"conv2d_q8": 3, "maxpool2d_s8": 3},
                    "grouped": {"conv2d_q8": 3, "maxpool2d_s8": 3},
                    "dws": PER_FORWARD["dws"], "shift": PER_FORWARD["shift"],
                    "add": PER_FORWARD["add"]}
FLOW_CKPT = ROOT / "build" / "chip_smoke_ckpt"


def phase_cnn_flow(torch, K, card, dev="cuda", prims=FLOW_PRIMS,
                   steps=FLOW_STEPS, resume_at=FLOW_RESUME):
    """Train -> checkpoint -> resume -> PTQ -> serve -> profile for each
    primitive; returns the kernel launches of the plans' forwards and
    profiles (training launches none: it runs the float primitives)."""
    import shutil
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data import DataConfig, IndexedDataset, PrefetchLoader
    from repro_torch.device import exact_float32
    from repro_torch.graph import CompiledPlan
    from repro_torch.models import (CNNConfig, calibrate_bn, cnn_forward,
                                    cnn_value_and_grad, init_cnn,
                                    quantize_cnn)
    from repro_torch.optim import OptConfig, apply_updates, init_opt_state
    ds = IndexedDataset(DataConfig(kind="image", global_batch=FLOW_BATCH,
                                   image_size=32, num_classes=10, seed=7))
    test = IndexedDataset(DataConfig(kind="image", global_batch=BATCH,
                                     image_size=32, num_classes=10,
                                     seed=7)).batch(10_000)
    x = torch.as_tensor(test["images"], dtype=torch.float32, device=dev)
    labels = torch.as_tensor(test["labels"], device=dev).long()
    calib = torch.as_tensor(ds.batch(20_000)["images"], dtype=torch.float32,
                            device=dev)
    opt = OptConfig(lr=2e-3, warmup_steps=20, total_steps=steps,
                    weight_decay=1e-4, grad_clip=1.0)
    on_card = torch.device(dev).type == "cuda"
    launches = dict.fromkeys((k.__name__ for k in K.KERNELS), 0)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    for prim in prims:
        cfg = CNNConfig(primitive=prim, widths=(16, 32, 64))
        ckdir = FLOW_CKPT / prim
        shutil.rmtree(ckdir, ignore_errors=True)
        ck = Checkpointer(str(ckdir), keep=2)

        def fresh(seed):
            p = init_cnn(cfg, torch.Generator(dev).manual_seed(seed),
                         device=dev)
            return p, init_opt_state(p, opt)

        def train(params, state, start, save_at=None):
            loader = PrefetchLoader(ds, start_step=start, device=dev)
            losses = []
            # full float32 and deterministic cuDNN, so a resumed run
            # repeats the uninterrupted one's sums
            with exact_float32(), torch.backends.cudnn.flags(
                    enabled=True, benchmark=False, deterministic=True,
                    allow_tf32=False):
                for i in range(start, steps):
                    (loss, _), grads = cnn_value_and_grad(
                        params, next(loader), cfg)
                    params, state, _ = apply_updates(params, grads, state,
                                                     opt)
                    losses.append(loss)
                    if i + 1 == save_at:
                        ck.save(i + 1, {"params": params, "opt": state})
            return params, state, [float(v) for v in losses]

        K.reset_launches()
        sync()
        t0 = time.perf_counter()
        params, _, losses = train(*fresh(0), 0, save_at=resume_at)
        sync()
        t_train = time.perf_counter() - t0
        ck.wait()
        check(not any(k.launches for k in K.KERNELS),
              f"flow {prim}: training launched a kernel of the int8 path")
        first, last = np.mean(losses[:10]), np.mean(losses[-10:])
        check(np.isfinite(losses).all() and last < first,
              f"flow {prim}: mean loss of the last 10 steps {last:.4f} not "
              f"below the first 10's {first:.4f}")
        # kill and resume: fresh state from another seed, then the
        # checkpoint of step resume_at
        p2, s2 = fresh(1)
        tree, start = ck.restore({"params": p2, "opt": s2})
        check(start == resume_at, f"flow {prim}: restored step {start}")
        _, _, resumed = train(tree["params"], tree["opt"], start)
        gap = max(abs(a - b) for a, b in zip(resumed, losses[start:]))
        check(len(resumed) == steps - start and gap <= 1e-4,
              f"flow {prim}: resumed losses differ from the uninterrupted "
              f"run by {gap}")

        params = calibrate_bn(params, cfg, calib)
        K.reset_launches()
        plan = quantize_cnn(params, cfg, calib, method="cuda", device=dev)
        trunk = plan.trunk(x)                 # eager warm-up, capture, replay
        per = {k.__name__: k.launches for k in K.KERNELS}
        want = {k: 2 * FLOW_PER_FORWARD[prim].get(k, 0) for k in per} \
            if on_card else dict.fromkeys(per, 0)
        check(per == want, f"flow {prim}: the first forward launched {per}, "
                           f"not {want}")
        plain = CompiledPlan(plan.plan, method="torch", device=dev).trunk(x)
        check(torch.equal(trunk.q, plain.q)
              and trunk.frac_bits == plain.frac_bits,
              f"flow {prim}: cuda trunk differs from the torch trunk")
        with exact_float32():
            lf = cnn_forward(params, x, cfg)
        lq = plan(x)
        check(bool(torch.isfinite(lq).all()) and tuple(lq.shape) ==
              (BATCH, cfg.num_classes), f"flow {prim}: bad int8 logits")
        agree = float((lf.argmax(-1) == lq.argmax(-1)).float().mean())
        acc_f = float((lf.argmax(-1) == labels).float().mean())
        acc_q = float((lq.argmax(-1) == labels).float().mean())
        rows = plan.profile(x, reps=3)
        for k in K.KERNELS:
            launches[k.__name__] += k.launches
        check(all(launches[k] for k in FLOW_PER_FORWARD[prim]) or
              not on_card, f"flow {prim}: a kernel of the plan never ran")
        n = steps + steps - resume_at
        print(f"[flow] {prim}: {steps} AdamW steps (batch {FLOW_BATCH}, "
              f"32x32, widths 16/32/64) in {t_train:.2f} s, "
              f"{steps / t_train:.1f} steps/s, "
              f"{steps * FLOW_BATCH / t_train:.1f} training images/s; loss "
              f"first 10 {first:.4f} -> last 10 {last:.4f}; resumed from "
              f"step {start}: max |loss diff| {gap:.2e} over {steps - start} "
              f"steps ({n} steps in all); int8 trunk (cuda, {plan.traces} "
              f"captured graph) == torch trunk bitwise; top-1 float {acc_f:.3f}, int8 "
              f"{acc_q:.3f}, float/int8 agreement {agree:.3f} (not gated) "
              f"on {BATCH} test images; on {card}")
        for r in rows:
            mcu = "".join(f" {k} {r[k]:.4f}" for k in r if k.startswith("mcu"))
            print(f"[flow] {prim}   profile {r['name']:6s} {r['op']:8s} "
                  f"{r['us']:9.1f} us  macs {r['macs']:>10d}{mcu}")
    return launches


# ------------------------------------------------------------------- main --

SOURCES = {
    "conv2d": ("conv2d_q8", "src/repro_torch/kernels/csrc/conv_im2col.cu",
               "src/repro/kernels/conv_im2col.py:107"),
    "depthwise2d": ("depthwise2d_q8",
                    "src/repro_torch/kernels/csrc/conv_dw.cu",
                    "src/repro/kernels/conv_dw.py:85"),
    "maxpool2d": ("maxpool2d_s8", "src/repro_torch/kernels/csrc/pool.cu",
                  "src/repro/kernels/pool.py:65"),
    "shift_conv2d": ("shift_conv2d_q8",
                     "src/repro_torch/kernels/csrc/conv_shift.cu",
                     "src/repro/kernels/conv_shift.py:55"),
    "add_conv2d": ("add_conv2d_q8", "src/repro_torch/kernels/csrc/conv_add.cu",
                   "src/repro/kernels/conv_add.py:103"),
    "conv2d_w4": ("conv2d_w4", "src/repro_torch/kernels/csrc/conv_im2col.cu",
                  "src/repro/kernels/conv_im2col.py:107"),
    "depthwise2d_w4": ("depthwise2d_w4",
                       "src/repro_torch/kernels/csrc/conv_dw.cu",
                       "src/repro/kernels/conv_dw.py:85"),
    "shift_conv2d_w4": ("shift_conv2d_w4",
                        "src/repro_torch/kernels/csrc/conv_shift.cu",
                        "src/repro/kernels/conv_shift.py:55"),
    "add_conv2d_w4": ("add_conv2d_w4",
                      "src/repro_torch/kernels/csrc/conv_add.cu",
                      "src/repro/kernels/conv_add.py:103"),
    "matmul": ("matmul_q8", "src/repro_torch/kernels/csrc/matmul_q8.cu",
               "src/repro/kernels/matmul_q8.py:106"),
    "matmul_w4": ("matmul_w4", "src/repro_torch/kernels/csrc/matmul_q8.cu",
                  "src/repro/kernels/matmul_q8.py:106"),
    "causal_conv1d": ("causal_conv1d",
                      "src/repro_torch/kernels/csrc/conv1d_causal.cu",
                      "src/repro/kernels/conv1d_causal.py:58"),
    "conv2d_f": ("conv2d_f", "src/repro_torch/kernels/csrc/conv_im2col.cu",
                 "src/repro/kernels/conv_im2col.py:107"),
    "depthwise2d_f": ("depthwise2d_f",
                      "src/repro_torch/kernels/csrc/conv_dw.cu",
                      "src/repro/kernels/conv_dw.py:85"),
    "maxpool2d_f": ("maxpool2d_f", "src/repro_torch/kernels/csrc/pool.cu",
                    "src/repro/kernels/pool.py:65"),
    "shift_conv2d_f": ("shift_conv2d_f",
                       "src/repro_torch/kernels/csrc/conv_shift.cu",
                       "src/repro/kernels/conv_shift.py:55"),
    "add_conv2d_f": ("add_conv2d_f",
                     "src/repro_torch/kernels/csrc/conv_add.cu",
                     "src/repro/kernels/conv_add.py:103"),
    "matmul_f": ("matmul_f", "src/repro_torch/kernels/csrc/matmul_q8.cu",
                 "src/repro/kernels/matmul_q8.py:106"),
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("[device] FAIL: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"[device] FAIL: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels as K
    from repro_torch.kernels import _build

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"[device] {kind}, {count} visible; nvidia-smi name,power.limit:")
    print(card)
    dev = torch.device("cuda")

    info = _build.build()
    _build.library()
    log = (_build.BUILD_DIR / "build.log").read_text()
    regs = [ln.strip() for ln in log.splitlines()
            if "registers" in ln] if info["built"] else []
    print(f"[build] {'built' if info['built'] else 'up to date'} "
          f"{info['path'].relative_to(ROOT)} in {info['seconds']:.1f} s; "
          + " | ".join(regs))
    # ptxas's report of the build that made the library (this run's, or
    # the one an earlier process made from the same sources)
    for line in ptxas_report(log, TILED_KERNELS):
        print(f"[build] {line}")

    rng = np.random.default_rng(SEED)
    per_kernel = phase_kernels(torch, K, dev, kind, rng)
    plans = {name: phase_plan(torch, K, name, rng) for name in PLANS}
    launches = dict.fromkeys((k.__name__ for k in K.KERNELS), 0)
    for p in SERVED:
        for k, v in phase_serve(torch, K, p, plans[p][0], card,
                                rng).items():
            launches[k] += v
    plans = {name: plans[name] for name in TUNED_PLANS}   # for phase 8
    for k, v in phase_lm(torch, K, card, rng).items():
        launches[k] += v
    torch.cuda.empty_cache()    # phase 6's model is gone; 7.27 B params next
    for k, v in phase_ssm(torch, K, card, rng).items():
        launches[k] += v
    integer = [k for k in launches if not k.endswith("_f")]
    check(all(launches[k] > 0 for k in integer),
          f"serve: a kernel was never launched: {launches}")
    torch.cuda.empty_cache()    # phase 7's model is gone
    for k, v in phase_tune(torch, K, card, plans).items():
        launches[k] += v
    for k, v in phase_cnn_flow(torch, K, card).items():
        launches[k] += v
    check(all(v > 0 for v in launches.values()),
          f"a kernel was never launched: {launches}")

    rows = []
    for kernel, (wrapper, source, replaces) in SOURCES.items():
        r = per_kernel[kernel]
        rows.append({
            "name": wrapper, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[wrapper],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes" if r["bytes_ms"] >= r["ops_ms"]
            else "operations",
            "library_ms": r["library_ms"]})
    print("# per kernel: ms, plain_ms and library_ms are device times "
          "(torch.profiler) and bound_ms the larger of the HBM and the "
          "operations floor, each summed over that kernel's launches in one "
          "256-image forward of the dws plan (the shift and add plans for "
          "the shift and add kernels; the W4 rows in the W4 plans, bytes "
          "counting the packed weights), and for matmul_q8 and matmul_w4 "
          "over the 72 launches of one Qwen2-0.5B decode step at 8 slots "
          "(library: torch._int_mm), and for causal_conv1d over the 64 "
          "launches of one 96-token Falcon-Mamba-7B prefill (1 x 96 x 8192 "
          "bf16, the in_proj view; library: cuDNN conv1d, groups=D); the float rows (*_f) "
          "over the tuner's float32 Table-2 jobs of that kernel, one launch "
          "each (pool: the tuner's float pool job; library: cuDNN conv2d, "
          "amax, torch.cdist(p=1), torch.matmul, TF32 off); launches are "
          "summed over the six served CNN runs, the ten LM runs, the ssm "
          "run, the tuner's run (phase 8) and the five trained plans' "
          f"forwards and profiles (phase 9); card: {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        sys.exit(1)
