"""Pre-tune the port's CUDA kernels over the paper's Table-2 sweep shapes
and whole CNN plans, and write a config cache (the port's twin of the JAX
package's ``scripts/tune.py``, with the same job lists and flags):

    PYTHONPATH=src python -m repro_torch.tune --shapes table2 \\
        --cnn standard,dws,shift,add --cnn-batch 256 \\
        --out build/repro_torch/tune_cache.json

``--cnn`` tunes each primitive's int8 plan and its W4A8 plan (the W4
plans' packed-weight jobs keep a ``"w4a8"`` dtype key). Install the result for the dispatch layer with
``REPRO_TORCH_TUNE_CACHE=<path>`` (or ``tune.set_default_cache``).
Without a cache every kernel runs the analytic model's config: the cache
is an optimization, never a requirement, and no config changes an output.
Runs on the card (``--device cuda``, the default); ``--device cpu`` times
the plain versions and writes ``cpu`` entries, which a card never reads.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import tune

# int8 jobs time the kernels' fused requantized epilogue (Algorithm 1): a
# representative per-layer shift, held fixed across candidates
_REQUANT = 7
DEFAULT_OUT = "build/repro_torch/tune_cache.json"


class _Maker:
    """Seeded operands on one device: standard-normal float32 and int8
    codes in [-100, 100)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(0)

    def f32(self, shape):
        return torch.randn(shape, generator=self.gen, device=self.device)

    def i8(self, shape):
        return torch.randint(-100, 100, shape, generator=self.gen,
                             device=self.device,
                             dtype=torch.int32).to(torch.int8)

    def make(self, dtype):
        return self.i8 if dtype == "int8" else self.f32


def _qkw(dtype, **extra):
    kw = dict(extra)
    if dtype == "int8":
        kw["requant_shift"] = _REQUANT
    return kw or None


def _conv2d(mk, n, h, w, ci, co, k, g=1, dtype="float32"):
    f = mk.make(dtype)
    return ("conv2d", tune.sig_conv2d(n, h, w, ci, co, k, g),
            (f((n, h, w, ci)), f((k, k, ci // g, co))), dtype,
            _qkw(dtype, groups=g))


def _depthwise(mk, n, h, w, c, k, dtype="float32"):
    f = mk.make(dtype)
    return ("depthwise2d", tune.sig_depthwise2d(n, h, w, c, k),
            (f((n, h, w, c)), f((k, k, c))), dtype, _qkw(dtype))


def _shift(mk, n, h, w, c, co, dtype="float32"):
    f = mk.make(dtype)
    shifts = torch.tensor([[(i % 3) - 1, ((i // 3) % 3) - 1]
                           for i in range(c)], dtype=torch.int32,
                          device=mk.device)
    return ("shift_conv2d", tune.sig_shift_conv2d(n, h, w, c, co, 1),
            (f((n, h, w, c)), shifts, f((c, co))), dtype,
            _qkw(dtype, max_shift=1))


def _add(mk, n, h, w, ci, co, k, dtype="float32"):
    f = mk.make(dtype)
    return ("add_conv2d", tune.sig_add_conv2d(n, h, w, ci, co, k),
            (f((n, h, w, ci)), f((k, k, ci, co))), dtype, _qkw(dtype))


def _pool(mk, n, h, w, c, window, stride, dtype="int8"):
    f = mk.make(dtype)
    return ("maxpool2d", tune.sig_maxpool2d(n, h, w, c, window, stride),
            (f((n, h, w, c)),), dtype, dict(window=window, stride=stride))


def _c1d(mk, b, l, d, k):
    return ("causal_conv1d", tune.sig_causal_conv1d(b, l, d, k),
            (mk.f32((b, l, d)), mk.f32((k, d))), "float32")


def _matmul(mk, m, k, n, dtype="float32"):
    f = mk.make(dtype)
    return ("matmul", tune.sig_matmul(m, k, n), (f((m, k)), f((k, n))),
            dtype, _qkw(dtype))


def shapes_table2(device="cuda"):
    """The paper's Table-2 sweep plan, one tuning job per (primitive, axis
    extreme): groups / kernel size / width / cin / cout, plus the LM-side
    shapes (matmul, Mamba's causal conv1d). The same jobs as the JAX
    package's ``scripts/tune.py``."""
    mk = _Maker(device)
    return [
        # exp1 groups sweep @ w=10, ci=128, co=64, k=3
        _conv2d(mk, 1, 10, 10, 128, 64, 3, 1),
        _conv2d(mk, 1, 10, 10, 128, 64, 3, 4),
        # exp2 kernel-size sweep @ w=32, ci=co=16
        _conv2d(mk, 1, 32, 32, 16, 16, 3),
        _conv2d(mk, 1, 32, 32, 16, 16, 7),
        # exp3/4/5 width / cin / cout extremes
        _conv2d(mk, 1, 8, 8, 16, 16, 3),
        _conv2d(mk, 1, 32, 32, 32, 32, 3),
        # non-standard primitives at the sweep's center point
        _depthwise(mk, 1, 32, 32, 64, 3),
        _shift(mk, 1, 32, 32, 64, 64),
        _add(mk, 1, 10, 10, 16, 16, 3),
        # integer-only (Algorithm 1) variants at the same shapes
        _conv2d(mk, 1, 10, 10, 128, 64, 3, 1, dtype="int8"),
        _conv2d(mk, 1, 10, 10, 128, 64, 3, 4, dtype="int8"),
        _conv2d(mk, 1, 32, 32, 16, 16, 3, dtype="int8"),
        _depthwise(mk, 1, 32, 32, 64, 3, dtype="int8"),
        _shift(mk, 1, 32, 32, 64, 64, dtype="int8"),
        _add(mk, 1, 10, 10, 16, 16, 3, dtype="int8"),
        # batched serving shapes
        _conv2d(mk, 8, 32, 32, 16, 16, 3, dtype="int8"),
        _depthwise(mk, 8, 32, 32, 64, 3, dtype="int8"),
        _shift(mk, 8, 32, 32, 64, 64, dtype="int8"),
        _add(mk, 8, 10, 10, 16, 16, 3, dtype="int8"),
        _pool(mk, 8, 32, 32, 64, 2, 2),
        # LM-side kernels
        _c1d(mk, 2, 512, 256, 4),
        _matmul(mk, 256, 512, 256),
        _matmul(mk, 512, 512, 512),
        _matmul(mk, 256, 256, 256, dtype="int8"),
        _matmul(mk, 512, 512, 512, dtype="int8"),
    ]


def shapes_smoke(device="cuda"):
    """Tiny job list for fast sanity runs."""
    mk = _Maker(device)
    return [
        _conv2d(mk, 1, 8, 8, 8, 16, 3),
        _conv2d(mk, 1, 8, 8, 8, 16, 3, dtype="int8"),
        _depthwise(mk, 1, 8, 8, 16, 3),
        _add(mk, 1, 6, 6, 4, 8, 3),
        _matmul(mk, 64, 64, 64),
        _matmul(mk, 64, 64, 64, dtype="int8"),
    ]


SHAPE_SETS = {"table2": shapes_table2, "smoke": shapes_smoke}


def cnn_plans(primitives: str, *, widths=(16, 32, 64), image_size=32,
              device="cuda"):
    """Two lowered plans per requested primitive, int8 and W4A8 weights,
    seeded (``models.convnet.init_cnn``), calibrated on 4 seeded
    images."""
    from repro_torch.graph import build_cnn_graph, lower
    from repro_torch.models.convnet import CNNConfig, init_cnn
    plans = []
    for i, prim in enumerate(primitives.split(",")):
        cfg = CNNConfig(primitive=prim.strip(), widths=tuple(widths),
                        image_size=image_size)
        gen = torch.Generator(device=device).manual_seed(i)
        params = init_cnn(cfg, gen, device=device)
        calib = torch.randn((4, image_size, image_size, cfg.in_channels),
                            generator=gen, device=device) * 0.5
        for bits in (8, 4):
            plans.append(lower(build_cnn_graph(cfg), params, calib,
                               weight_bits=bits))
    return plans


def cnn_plan_jobs(primitives: str, *, widths=(16, 32, 64), image_size=32,
                  batch=1, device="cuda"):
    """Whole-plan pre-tuning: every kernel invocation of each requested
    primitive's lowered plan as a tuning job (``tune.plan_jobs``), so a
    deployed CompiledPlan finds every node's config in the cache."""
    jobs = []
    for plan in cnn_plans(primitives, widths=widths, image_size=image_size,
                          device=device):
        jobs.extend(tune.plan_jobs(plan, batch=batch))
    return jobs


def main(argv=None) -> tune.TuneCache:
    """Tune the requested jobs, print one line per job, write ``--out``;
    returns the cache."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--shapes", choices=sorted(SHAPE_SETS), default="table2")
    ap.add_argument("--cnn", default="",
                    help="comma-separated CNN primitives: pre-tune each "
                         "model's whole lowered plans, int8 and W4A8, e.g. "
                         "--cnn standard,dws,shift")
    ap.add_argument("--cnn-batch", type=int, default=1,
                    help="batch the --cnn plans are tuned at (cache keys "
                         "include it: tune at the batch you serve)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--kernels", default="",
                    help="comma-separated kernel filter (default: all)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--max-candidates", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    jobs = SHAPE_SETS[args.shapes](args.device)
    if args.cnn:
        jobs += cnn_plan_jobs(args.cnn, batch=args.cnn_batch,
                              device=args.device)
    if args.kernels:
        keep = set(args.kernels.split(","))
        jobs = [j for j in jobs if j[0] in keep]
    # plans share layers (every plan's pools, the W4 plans' int8 pools):
    # each (kernel, key, dtype) is tuned once
    seen = set()
    jobs = [j for j in jobs if (j[0], j[1].key(), j[3]) not in seen
            and not seen.add((j[0], j[1].key(), j[3]))]

    cache = tune.TuneCache(None)
    backend = tune.backend_tag(args.device)
    print(f"# tuning {len(jobs)} (kernel, shape) jobs on backend={backend}")
    wins = 0
    for kernel, sig, arrays, dtype, *rest in jobs:
        kwargs = rest[0] if rest else None
        best, best_us = tune.autotune_into(
            cache, kernel, sig, arrays, dtype, kwargs=kwargs, reps=args.reps,
            warmup=args.warmup, max_candidates=args.max_candidates,
            verbose=args.verbose)
        entry = cache.get(tune.cache_key(kernel, sig.key(), dtype, backend))
        d_us = entry.get("default_us")
        sp = (d_us / best_us) if (d_us and best_us) else float("nan")
        tag = "TUNED-WIN" if d_us and best_us < d_us else "default-best"
        wins += tag == "TUNED-WIN"
        print(f"{kernel}/{sig.key()}/{dtype}: best={best} {best_us:.2f}us "
              f"default={d_us and round(d_us, 2)}us speedup={sp:.2f}x "
              f"[{tag}]")
    cache.save(args.out)
    print(f"# wrote {len(cache)} entries -> {args.out} "
          f"({wins}/{len(jobs)} shapes improved over the default config)")
    print(f"# install: REPRO_TORCH_TUNE_CACHE={args.out}")
    return cache


if __name__ == "__main__":
    main()
