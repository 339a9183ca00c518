#!/usr/bin/env python3
"""Time every tile of the float conv and the float add conv on one NVIDIA
card.

    python3 scripts/torch_float_tiles.py        (from the repository root)

``conv2d_f`` and ``add_conv2d_f`` run the float implicit GEMM of
``src/repro_torch/kernels/csrc/fgemm.cuh``, whose tile is (bp: pixels a
block, q: channels a thread). This script times each of the tuner's twelve
tiles in float32, with ``chip_smoke.py``'s device timer (``torch.profiler``
through ``repro_torch.tune.device_kernels``, two sessions merged), at the
paper's Table-2 float jobs (n = 1) and at the layers of the standard,
dws and add plans at B=256, checks every tile bitwise against the plain
version, and prints one line per shape: the wrappers' default tile and its
time, the fastest tile and its time, and every tile's time, beside the
card's name and power limit. It builds the kernels at first use, needs a
card, and is not on any path of the port.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
#: the float conv's Table-2 jobs (chip_smoke.T2_CONV) and the B=256
#: layers; (n, h, w, cx, cy, hk, groups)
CONV = ((1, 10, 10, 128, 64, 3, 1), (1, 10, 10, 128, 64, 3, 4),
        (1, 32, 32, 16, 16, 3, 1), (1, 32, 32, 16, 16, 7, 1),
        (1, 8, 8, 16, 16, 3, 1), (1, 32, 32, 32, 32, 3, 1),
        (256, 32, 32, 3, 16, 3, 1), (256, 16, 16, 16, 32, 3, 1),
        (256, 8, 8, 32, 64, 3, 1), (256, 16, 16, 16, 32, 1, 1),
        (256, 8, 8, 32, 64, 1, 1))
#: the float add conv's Table-2 job and the add plan's layers at B=256;
#: (n, h, w, cx, cy, hk)
ADD = ((1, 10, 10, 16, 16, 3), (256, 32, 32, 3, 16, 3),
       (256, 16, 16, 16, 32, 3), (256, 8, 8, 32, 64, 3))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch import kernels as K
    from repro_torch.device import exact_float32
    from repro_torch.kernels.conv_im2col import CONV_BP, CONV_Q, \
        default_f_tile
    card = cs.card_line()
    print(card)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    tiles = [(bp, q) for bp in CONV_BP for q in CONV_Q]

    def f(shape):
        return torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32)).to(dev)

    with exact_float32():
        for kind, shapes in (("conv2d_f", CONV), ("add_conv2d_f", ADD)):
            for s in shapes:
                n, h, w, cx, cy, hk = s[:6]
                g = s[6] if kind == "conv2d_f" else 1
                x = f((n, h, w, cx))
                if kind == "conv2d_f":
                    wt = f((hk, hk, cx // g, cy))
                    run = lambda bp, q: K.conv2d_f(  # noqa: E731
                        x, wt, groups=g, act="relu", bp=bp, q=q)
                    want = K.conv2d_f_plain(x, wt, groups=g, act="relu")
                    d = default_f_tile(*s)
                else:
                    wt = f((hk, hk, cx, cy))
                    run = lambda bp, q: K.add_conv2d_f(  # noqa: E731
                        x, wt, bp=bp, q=q)
                    want = K.add_conv2d_f_plain(x, wt)
                    d = default_f_tile(*s, 1)
                ms = {}
                for t in tiles:
                    got = run(*t)
                    torch.cuda.synchronize()
                    cs.check(torch.equal(got.view(torch.int32),
                                         want.view(torch.int32)),
                             f"{kind} {s} tile {t}: differs from the plain "
                             "version")
                    ms[t] = cs.device_ms(torch, lambda: run(*t))
                best = min(ms, key=ms.get)
                dt = (d["bp"], d["q"])
                print(f"{kind} {s}: default {dt} {ms[dt]:.4f} ms, best "
                      f"{best} {ms[best]:.4f} ms ({ms[dt] / ms[best]:.3f}x)"
                      " | " + " ".join(f"{bp}x{q} {v:.4f}"
                                       for (bp, q), v in sorted(ms.items())),
                      flush=True)
    print(f"all tiles bitwise equal to the plain versions; device ms "
          f"(torch.profiler), float32, TF32 off; card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
