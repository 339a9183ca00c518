#!/usr/bin/env python3
"""Time every tile and cluster size of the port's integer matmul, and both
paths of its int8 max-pool, on one NVIDIA card.

    python3 scripts/torch_matmul_tiles.py       (from the repository root)

``matmul_q8`` and ``matmul_w4`` run ``matmul_q_kernel`` of
``src/repro_torch/kernels/csrc/matmul_q8.cu``, whose launch is a tile (bn:
output columns a block, bm: rows of a a block) and a cluster size (blocks
that split K). This script times each config of the tuner's space, with
``chip_smoke.py``'s device timer (``torch.profiler`` through
``repro_torch.tune.device_kernels``, two sessions merged), at Qwen2-0.5B's
FFN shapes: the decode shapes (8 x 896 x 4864 gate/up, 8 x 4864 x 896
down) and the prefill buckets (16, 32, 64 and 128 x 896 x 4864, 64 x 4864
x 896), in int8 and W4. It checks every config bitwise against the plain
version and that a call is one device operation, and prints one line per
shape and mode: the wrappers' default and its time, the analytic model's
pick, the fastest config and its time, and every config's time. Then the
int8 pool at the dws plan's three pools (B=256): the 16-channel vector
path on aligned x, and the scalar path on the same values at an odd
address, in turns. Every line carries the card's name and power limit. It
builds the kernels at first use, needs a card, and is not on any path of
the port.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
#: (m, k, n): Qwen2-0.5B's FFN at decode (8 slots) and its prefill buckets
SHAPES = ((8, 896, 4864), (8, 4864, 896), (16, 896, 4864), (32, 896, 4864),
          (64, 896, 4864), (128, 896, 4864), (64, 4864, 896))
#: the dws plan's pools at B=256: (n, h, w, c), 2x2/2
POOLS = ((256, 32, 32, 16), (256, 16, 16, 32), (256, 8, 8, 64))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch import kernels as K
    from repro_torch import tune
    from repro_torch.core.quantize import pack_w4
    card = cs.card_line()
    hbm = cs.card_model().hbm_bps
    print(card)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def i8(shape):
        return torch.from_numpy(rng.integers(-128, 128, shape)
                                .astype(np.int8)).to(dev)

    def us(fn):
        rows = cs.device_kernels(torch, fn, 20)
        return sum(r.us for r in rows), sum(r.launches for r in rows)

    for m, k, n in SHAPES:
        a, b = i8((m, k)), i8((k, n))
        q = rng.integers(-8, 8, (k, n)).astype(np.int8)
        wp = pack_w4(torch.from_numpy(q), 0).contiguous().to(dev)
        ws = torch.from_numpy(rng.integers(0, 5, k).astype(np.int8)).to(dev)
        for dt in ("int8", "w4a8"):
            kw = dict(requant_shift=14)
            if dt == "int8":
                run = lambda **c: K.matmul_q8(a, b, **kw, **c)  # noqa: E731
                want = K.matmul_q8_plain(a, b, **kw)
            else:
                run = lambda **c: K.matmul_w4(a, wp, ws, **kw,  # noqa: E731
                                              **c)
                want = K.matmul_w4_plain(a, wp, ws, **kw)
            sig = tune.sig_matmul(m, k, n)
            default = tune.default_config("matmul", sig, dt)
            times = {}
            for cfg in tune.candidates(sig, dt):
                got = run(**cfg)
                torch.cuda.synchronize()
                cs.check(torch.equal(got, want),
                         f"matmul {dt} {(m, k, n)} {cfg}: differs from the "
                         "plain version")
                t, ops = us(lambda: run(**cfg))
                cs.check(ops == 1, f"matmul {dt} {(m, k, n)} {cfg}: {ops} "
                                   "device operations a call, not 1")
                times[tuple(cfg.values())] = t
            key = tuple(default.values())
            best = min(times, key=times.get)
            ana = tuple(tune.analytic_config(sig, dt).values())
            print(f"[mm-tiles] {dt} {m}x{k}x{n}: default (bn, bm, cluster) "
                  f"{key} {times[key] / 1e3:.4f} ms; analytic {ana} "
                  f"{times[ana] / 1e3:.4f} ms; fastest {best} "
                  f"{times[best] / 1e3:.4f} ms ({times[key] / times[best]:.2f}"
                  f"x); every config, 1 device operation a call, bitwise: "
                  + ", ".join(f"{c} {v / 1e3:.4f}" for c, v in
                              sorted(times.items()))
                  + f" ms; {card}")
    for n, h, w, c in POOLS:
        x = i8((n, h, w, c))
        xo = cs.offset_view(torch, x, 1)
        want = K.maxpool2d_plain(x)
        for v in (x, xo):
            got = K.maxpool2d_s8(v)
            torch.cuda.synchronize()
            cs.check(torch.equal(got, want), f"pool {(n, h, w, c)}: differs")
        vec, sca = [], []
        for order in (0, 1, 1, 0):
            (vec if order == 0 else sca).append(
                us(lambda: K.maxpool2d_s8(x if order == 0 else xo))[0])
        bound = 1e3 * (x.numel() + x.numel() // 4) / hbm
        print(f"[pool-paths] {n}x{h}x{w}x{c} 2x2/2: vector path (16 "
              f"channels a thread) {vec[0] / 1e3:.4f} and "
              f"{vec[1] / 1e3:.4f} ms, scalar path (x at an odd address, a "
              f"thread a byte) {sca[0] / 1e3:.4f} and {sca[1] / 1e3:.4f} ms "
              f"(in turns); byte bound {bound:.5f} ms; {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
