#!/usr/bin/env python3
"""Time every tile of the port's tiled conv kernels on one NVIDIA card.

    python3 scripts/torch_float_tiles.py        (from the repository root)

``conv2d_f`` and every mode of ``add_conv2d`` run the implicit GEMM of
``src/repro_torch/kernels/csrc/fgemm.cuh``, whose tile is (bp: pixels a
block, q: channels a thread); every mode of ``depthwise2d`` runs the
staged-row kernel of ``csrc/conv_dw.cu``, whose tile is (pt: pixels a
thread, rows: output rows a block). This script times each tile of the
tuner's space, with ``chip_smoke.py``'s device timer (``torch.profiler``
through ``repro_torch.tune.device_kernels``, two sessions merged), at the
paper's Table-2 jobs (n = 1) and at the layers of the standard, dws and add
plans at B=256: the float conv and float add in float32, the integer add
in int8 and W4, the depthwise conv in int8, W4, float32 and bfloat16. It
checks every tile bitwise against the plain version, and prints one line
per shape and mode: the wrappers' default tile and its time, the fastest
tile and its time, and every tile's time, beside the card's name and power
limit. It builds the kernels at first use, needs a card, and is not on any
path of the port.
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
#: the add conv's Table-2 job and the add plan's layers at B=256, with the
#: W4 add plan's pre-shifts (chip_smoke.W4_ADD_PRESHIFTS);
#: (n, h, w, cx, cy, hk), (x_preshift, w_preshift, requant_shift)
ADD = (((1, 10, 10, 16, 16, 3), (2, 0, 9)),
       ((256, 32, 32, 3, 16, 3), (0, 3, 9)),
       ((256, 16, 16, 16, 32, 3), (2, 0, 9)),
       ((256, 8, 8, 32, 64, 3), (28, 20, 24)))
#: the depthwise conv's Table-2 job and the dws plan's rows at B=256;
#: (n, h, w, c, hk)
DW = ((1, 32, 32, 64, 3), (256, 16, 16, 16, 3), (256, 8, 8, 32, 3))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch import kernels as K
    from repro_torch.core.quantize import pack_w4
    from repro_torch.device import exact_float32
    from repro_torch.kernels.conv_dw import DW_PT, DW_ROWS, default_dw_tile
    from repro_torch.kernels.conv_im2col import CONV_BP, CONV_Q, \
        default_f_tile
    card = cs.card_line()
    print(card)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    tiles = [(bp, q) for bp in CONV_BP for q in CONV_Q]
    dw_tiles = [(pt, r) for pt in DW_PT for r in DW_ROWS]

    def f(shape, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32)).to(dev).to(dtype)

    def i8(shape):
        return torch.from_numpy(rng.integers(-128, 128, shape)
                                .astype(np.int8)).to(dev)

    def w4(shape, axis):
        q = rng.integers(-8, 8, shape).astype(np.int8)
        ws = rng.integers(0, 5, shape[axis]).astype(np.int8)
        return (pack_w4(torch.from_numpy(q), axis).contiguous().to(dev),
                torch.from_numpy(ws).to(dev))

    def bits(t):
        if not t.is_floating_point():
            return t
        return t.view(torch.int16 if t.dtype == torch.bfloat16
                      else torch.int32)

    def sweep(label, run, want, default, knobs, space):
        ms = {}
        for t in space:
            kw = dict(zip(knobs, t))
            got = run(**kw)
            torch.cuda.synchronize()
            cs.check(torch.equal(bits(got), bits(want)),
                     f"{label} tile {t}: differs from the plain version")
            ms[t] = cs.device_ms(torch, lambda: run(**kw))
        best = min(ms, key=ms.get)
        dt = tuple(default[k] for k in knobs)
        print(f"{label}: default {dt} {ms[dt]:.4f} ms, best {best} "
              f"{ms[best]:.4f} ms ({ms[dt] / ms[best]:.3f}x) | "
              + " ".join(f"{'x'.join(map(str, t))} {v:.4f}"
                         for t, v in sorted(ms.items())), flush=True)

    with exact_float32():
        for s in CONV:
            n, h, w, cx, cy, hk, g = s
            x, wt = f((n, h, w, cx)), f((hk, hk, cx // g, cy))
            sweep(f"conv2d_f {s}",
                  lambda **t: K.conv2d_f(x, wt, groups=g, act="relu", **t),
                  K.conv2d_f_plain(x, wt, groups=g, act="relu"),
                  default_f_tile(*s), ("bp", "q"), tiles)
        for s, (xp, wp, rs) in ADD:
            n, h, w, cx, cy, hk = s
            x, wt = f((n, h, w, cx)), f((hk, hk, cx, cy))
            d = default_f_tile(*s, 1)
            sweep(f"add_conv2d_f {s}", lambda **t: K.add_conv2d_f(x, wt, **t),
                  K.add_conv2d_f_plain(x, wt), d, ("bp", "q"), tiles)
            x8, w8 = i8((n, h, w, cx)), i8((hk, hk, cx, cy))
            kw = dict(requant_shift=rs, x_preshift=xp, w_preshift=wp,
                      act="relu")
            sweep(f"add_conv2d_q8 {s} ({xp},{wp})",
                  lambda **t: K.add_conv2d_q8(x8, w8, **kw, **t),
                  K.add_conv2d_q8_plain(x8, w8, **kw), d, ("bp", "q"),
                  tiles)
            wp4, ws4 = w4((hk, hk, cx, cy), 2)
            sweep(f"add_conv2d_w4 {s} ({xp},{wp})",
                  lambda **t: K.add_conv2d_w4(x8, wp4, ws4, **kw, **t),
                  K.add_conv2d_w4_plain(x8, wp4, ws4, **kw), d, ("bp", "q"),
                  tiles)
        for s in DW:
            n, h, w, c, hk = s
            x8, w8 = i8((n, h, w, c)), i8((hk, hk, c))
            kw = dict(requant_shift=7, act="relu")
            d = default_dw_tile(*s, 1)
            sweep(f"depthwise2d_q8 {s}",
                  lambda **t: K.depthwise2d_q8(x8, w8, **kw, **t),
                  K.depthwise2d_q8_plain(x8, w8, **kw), d, ("pt", "rows"),
                  dw_tiles)
            wp4, ws4 = w4((hk, hk, c), 0)
            sweep(f"depthwise2d_w4 {s}",
                  lambda **t: K.depthwise2d_w4(x8, wp4, ws4, **kw, **t),
                  K.depthwise2d_w4_plain(x8, wp4, ws4, **kw), d,
                  ("pt", "rows"), dw_tiles)
            for dt, es in ((torch.float32, 4), (torch.bfloat16, 2)):
                xf, wf = f((n, h, w, c), dt), f((hk, hk, c), dt)
                sweep(f"depthwise2d_f {str(dt)[6:]} {s}",
                      lambda **t: K.depthwise2d_f(xf, wf, act="relu", **t),
                      K.depthwise2d_f_plain(xf, wf, act="relu"),
                      default_dw_tile(*s, es), ("pt", "rows"), dw_tiles)
    print(f"all tiles bitwise equal to the plain versions; device ms "
          f"(torch.profiler), TF32 off; card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
