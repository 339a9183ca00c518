#!/usr/bin/env python3
"""Time every launch config of the port's causal conv1d and both paths of
its float max-pool, on one NVIDIA card.

    python3 scripts/torch_conv1d_tiles.py       (from the repository root)

``causal_conv1d`` (``src/repro_torch/kernels/csrc/conv1d_causal.cu``)
takes a run of positions a thread (``run``) and a block size
(``threads``) on its 16-byte vector path. This script times each config
of the tuner's space, with ``chip_smoke.py``'s device timer
(``torch.profiler`` through ``repro_torch.tune.device_kernels``, two
sessions merged), at Falcon-Mamba-7B's prefill shapes (1 x L x 8192 bf16
for L = 16, 33, 96 and 256, 8 x 64 x 8192, K = 4) and at 1 x 96 x 8192 in
float32, x the x half of a (B, L, 16384) in_proj product, read in place as
the model reads it. It checks every config bitwise against the plain
version and prints one line per shape: the wrapper's default and its
time, the analytic model's pick, the fastest config, every config's time,
and in turns with the default the first design's launch (the scalar path,
taken on the same values at an odd address) and the copy that the model
made of x before this design (``x.contiguous()``). Then ``maxpool2d_f`` at
the tuner's pool job (8 x 32 x 32 x 64, 2x2/2) in float32 and bfloat16:
every block size on the vector path and on the scalar path (x at an odd
address). Every line carries the card's name and power limit. It builds
the kernels at first use, needs a card, and is not on any path of the
port.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
#: (B, L, dtype): Falcon-Mamba-7B's prefill shapes, d_inner 8192, K = 4
C1D = ((1, 16, "bfloat16"), (1, 33, "bfloat16"), (1, 96, "bfloat16"),
       (1, 256, "bfloat16"), (8, 64, "bfloat16"), (1, 96, "float32"))
D, K = 8192, 4
#: the tuner's float pool job: (n, h, w, c, window, stride)
POOL = (8, 32, 32, 64, 2, 2)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch import kernels as Kn
    from repro_torch import tune
    card = cs.card_line()
    print(card)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def f(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                ).to(dev).to(dtype)

    def us(fn):
        rows = cs.device_kernels(torch, fn, 20)
        return sum(r.us for r in rows), sum(r.launches for r in rows)

    for b, l, dt in C1D:
        dtype = getattr(torch, dt)
        x = f((b, l, 2 * D), dtype).chunk(2, dim=-1)[0]
        w = f((K, D), dtype)
        xo = cs.offset_view(torch, x.contiguous(), 1)
        want = Kn.causal_conv1d_plain(x, w)
        sig = tune.sig_causal_conv1d(b, l, D, K)
        default = tune.default_config("causal_conv1d", sig, dt)
        times = {}
        for cfg in tune.candidates(sig, dt):
            got = Kn.causal_conv1d(x, w, **cfg)
            torch.cuda.synchronize()
            cs.check(torch.equal(cs._bits(torch, got), cs._bits(torch, want)),
                     f"causal_conv1d {(b, l, dt)} {cfg}: differs from the "
                     "plain version")
            t, ops = us(lambda: Kn.causal_conv1d(x, w, **cfg))
            cs.check(ops == 1, f"causal_conv1d {cfg}: {ops} device "
                               "operations a call, not 1")
            times[(cfg["run"], cfg["threads"])] = t
        got = Kn.causal_conv1d(xo, w)
        torch.cuda.synchronize()
        cs.check(torch.equal(cs._bits(torch, got), cs._bits(torch, want)),
                 f"causal_conv1d {(b, l, dt)}: the scalar path differs")
        turns = {"default": [], "scalar": [], "copy": []}
        for which in ("default", "scalar", "copy", "copy", "scalar",
                      "default"):
            fn = {"default": lambda: Kn.causal_conv1d(x, w),
                  "scalar": lambda: Kn.causal_conv1d(xo, w),
                  "copy": lambda: x.contiguous()}[which]
            turns[which].append(us(fn)[0])
        key = (default["run"], default["threads"])
        best = min(times, key=times.get)
        ana = tune.analytic_config(sig, dt)
        ana = (ana["run"], ana["threads"])
        nbytes = (2 * b * l * D + K * D) * x.element_size()
        print(f"[c1d-tiles] {dt} {b}x{l}x{D} K={K} (in_proj view): default "
              f"(run, threads) {key} {times[key] / 1e3:.4f} ms; analytic "
              f"{ana} {times[ana] / 1e3:.4f} ms; fastest {best} "
              f"{times[best] / 1e3:.4f} ms ({times[key] / times[best]:.2f}x); "
              "in turns: default "
              + " and ".join(f"{v / 1e3:.4f}" for v in turns["default"])
              + " ms, the first design (scalar path, x at an odd address) "
              + " and ".join(f"{v / 1e3:.4f}" for v in turns["scalar"])
              + " ms, the copy x.contiguous() "
              + " and ".join(f"{v / 1e3:.4f}" for v in turns["copy"])
              + f" ms; byte bound {1e3 * nbytes / 3.35e12:.5f} ms; every "
              "config, 1 device operation a call, bitwise: "
              + ", ".join(f"{c} {v / 1e3:.4f}" for c, v in
                          sorted(times.items()))
              + f" ms; {card}")
    n, h, wd, c, win, st = POOL
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        x = f((n, h, wd, c), dtype)
        xo = cs.offset_view(torch, x, 1)
        want = Kn.maxpool2d_plain(x, window=win, stride=st)
        sig = tune.sig_maxpool2d(*POOL)
        times = {}
        for cfg in tune.candidates(sig, dt):
            for path, v in (("vector", x), ("scalar", xo)):
                got = Kn.maxpool2d_f(v, window=win, stride=st, **cfg)
                torch.cuda.synchronize()
                cs.check(torch.equal(cs._bits(torch, got),
                                     cs._bits(torch, want)),
                         f"maxpool2d_f {dt} {path} {cfg}: differs")
                times[(path, cfg["threads"])] = us(
                    lambda: Kn.maxpool2d_f(v, window=win, stride=st,
                                           **cfg))[0]
        default = tune.default_config("maxpool2d", sig, dt)["threads"]
        ana = tune.analytic_config(sig, dt)["threads"]
        vec = {t: v for (p, t), v in times.items() if p == "vector"}
        best = min(vec, key=vec.get)
        nbytes = x.element_size() * (x.numel() + x.numel() // 4)
        print(f"[pool-f-paths] {dt} {n}x{h}x{wd}x{c} 2x2/2: vector path "
              f"default threads {default} {vec[default] / 1e3:.4f} ms; "
              f"analytic {ana} {vec[ana] / 1e3:.4f} ms; fastest {best} "
              f"{vec[best] / 1e3:.4f} ms; byte bound "
              f"{1e3 * nbytes / 3.35e12:.5f} ms; every block size, bitwise: "
              + ", ".join(f"{p} {t} {v / 1e3:.4f}" for (p, t), v in
                          sorted(times.items()))
              + f" ms; {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
