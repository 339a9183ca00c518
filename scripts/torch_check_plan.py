"""Static-verification CLI of the PyTorch port: every ``repro_torch.check``
pass over the port's tune cache, lowered plans, launch configs, serve
configs and source tree (the port's twin of ``scripts/check_plan.py``).
No kernel runs.

Sections, in run order:

1. **cache** — re-verify every entry of the tune cache (``--cache``, else
   the file ``REPRO_TORCH_TUNE_CACHE`` names; the JAX package's
   ``artifacts/tune_cache.json`` is never read) against the Hopper
   verdict (``repro_torch.check.audit_cache``).
2. **plans** — lower one small CNN plan per primitive x weight width
   (int8 and W4A8) on ``--device`` and run the dataflow interpreter and
   the int32 accumulator / requant-shift analysis over each: the passes
   ``CompiledPlan`` runs at build.
3. **schedules** — the Hopper verdict (``check_schedule``) of the config
   each of those plans' nodes resolves at ``--batch`` images (the
   installed cache, else the analytic model).
4. **serve** — ``check_serve_config`` over LM ServeConfigs against a small
   ModelConfig and ``check_cnn_serve_config`` over CNN configs.
5. **lint** — ``repro_torch.check.astlint`` over ``src/repro_torch``,
   ``chip_smoke.py`` and ``scripts/torch_*.py``.

With ``--device cuda`` the kernel library is loaded first (built if its
sources changed), so every verdict, the audit's too, holds this build's
``ptxas`` registers; on the CPU the register term is absent. Exit status:
non-zero on any error; ``--strict`` also fails on warnings (spills,
submit-time serve-config hazards). Runs on the CPU by default::

    PYTHONPATH=src python scripts/torch_check_plan.py --strict
    PYTHONPATH=src python scripts/torch_check_plan.py --strict --device cuda
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

# one plan per primitive per weight width; small shapes keep lowering
# cheap while still crossing every scale-chain and fusion rule
PRIMITIVES = ("standard", "grouped", "dws", "shift", "add")
PLAN_WIDTHS = (8, 12)
PLAN_IMAGE = 16
WEIGHT_BITS = (8, 4)


def section(title: str):
    print(f"\n== {title} " + "=" * max(0, 66 - len(title)))


def run_cache(args, errors: List[str], warnings: List[str]) -> None:
    from repro_torch.check import audit_cache, summarize_audit
    from repro_torch.tune import cache as tune_cache

    section("tune cache audit")
    path = args.cache or tune_cache.default_cache_path()
    if path is None or not os.path.exists(path):
        print("no tune cache named (--cache or REPRO_TORCH_TUNE_CACHE): "
              "nothing to audit")
        return
    rows = audit_cache(path)
    summ = summarize_audit(rows)
    print(f"cache: {path}")
    print(f"entries={summ['entries']} feasible={summ['feasible']} "
          f"warnings={summ['warnings']} notes={summ['notes']}")
    for r in rows:
        errors.extend(f"cache[{r['key']}]: {e}" for e in r["errors"])
        warnings.extend(f"cache[{r['key']}]: {w}" for w in r["warnings"])


def lowered_plans(device: str):
    """``{(primitive, bits): plan}``, seeded, at ``PLAN_WIDTHS``."""
    import torch

    from repro_torch.graph import build_cnn_graph, lower
    from repro_torch.models.convnet import CNNConfig, init_cnn
    plans = {}
    for i, prim in enumerate(PRIMITIVES):
        cfg = CNNConfig(primitive=prim, widths=PLAN_WIDTHS,
                        image_size=PLAN_IMAGE)
        gen = torch.Generator(device=device).manual_seed(1 + i)
        params = init_cnn(cfg, gen, device=device)
        calib = torch.randn((4, PLAN_IMAGE, PLAN_IMAGE, 3), generator=gen,
                            device=device) * 0.5
        for bits in WEIGHT_BITS:
            plans[prim, bits] = lower(build_cnn_graph(cfg), params, calib,
                                      weight_bits=bits)
    return plans


def run_plans(plans, errors: List[str], warnings: List[str]) -> None:
    from repro_torch.check import (check_plan, check_plan_overflow,
                                   overflow_errors)

    section("plan dataflow + overflow")
    for (prim, bits), plan in plans.items():
        diags = check_plan(plan)
        for d in diags:
            (errors if d.level == "error" else warnings).append(
                f"plan[{prim}/w{bits}] {d.message}")
        bounds = check_plan_overflow(plan)
        errs = overflow_errors(bounds)
        errors.extend(f"plan[{prim}/w{bits}] {e}" for e in errs)
        worst = min(b.headroom_bits for b in bounds)
        flags = sum(d.level == "error" for d in diags) + len(errs)
        print(f"{prim:>8s}/w{bits}: nodes={len(plan.nodes)} "
              f"bounds={len(bounds)} min_headroom={worst:.1f}b "
              f"{'FAIL' if flags else 'ok'}")


def plan_sigs(plan, batch: int):
    """``(name, dtype, sig)`` of every kernel call a plan makes at
    ``batch`` images: each qconv stage (the executor's signatures) and
    each pool."""
    from repro_torch import tune
    from repro_torch.graph.executor import _node_dtype, stage_sigs
    out = []
    for node in plan.nodes:
        if node.op == "maxpool":
            h, w = node.attrs["in_hw"]
            out.append((node.name, "int8", tune.sig_maxpool2d(
                batch, h, w, node.attrs["in_ch"], node.attrs["window"],
                node.attrs["stride"])))
        elif node.op == "qconv":
            h, w = node.attrs["in_hw"]
            sigs = stage_sigs(node, batch, h, w, node.spec.in_channels)
            out.extend((node.name, _node_dtype(node), sig)
                       for sig in sigs.values())
    return out


def run_schedules(plans, args, errors: List[str],
                  warnings: List[str]) -> None:
    from repro_torch import tune
    from repro_torch.check import check_schedule

    section(f"schedules (batch {args.batch}, {args.device})")
    seen, n_ok, n_warn, regs = set(), 0, 0, []
    for (prim, bits), plan in plans.items():
        for name, dt, sig in plan_sigs(plan, args.batch):
            cfg = tune.get_config(sig, dt, args.device)
            key = (sig, dt, tuple(sorted(cfg.items())))
            if key in seen:
                continue
            seen.add(key)
            v = check_schedule(sig, cfg, dt)
            if not v.ok:
                errors.append(f"schedule[{prim}/w{bits} {name}] "
                              f"{v.message()}")
            warnings.extend(f"schedule[{prim}/w{bits} {name}] {w}"
                            for w in v.warnings)
            n_ok += v.ok
            n_warn += bool(v.warnings)
            if v.registers is not None:
                regs.append(v.registers * v.footprint.threads)
    print(f"configs={len(seen)} ok={n_ok} with_warnings={n_warn} "
          f"registers_known={len(regs)} max_registers_x_threads="
          f"{max(regs) if regs else 'not known'}")


def run_serve(args, errors: List[str]) -> None:
    from repro_torch.check import check_cnn_serve_config, check_serve_config
    from repro_torch.configs.base import ModelConfig
    from repro_torch.serve.cnn import CNNServeConfig
    from repro_torch.serve.engine import ServeConfig

    section("serve configs")
    cfg = ModelConfig(name="check-tiny", family="dense", n_layers=2,
                      d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                      vocab=256)
    faulted = dict(deadline_s=5.0, max_queue=16, shed_policy="drop",
                   max_retries=3, retry_backoff_s=0.01)
    checks = [
        ("lm/default", check_serve_config(ServeConfig(), cfg,
                                          strict=args.strict)),
        ("lm/int8-kv", check_serve_config(
            ServeConfig(precision="int8", kv_cache="int8"), cfg,
            strict=args.strict)),
        ("lm/paged", check_serve_config(
            ServeConfig(kv_layout="paged"), cfg, strict=args.strict)),
        ("cnn/default", check_cnn_serve_config(CNNServeConfig())),
        ("lm/faulted", check_serve_config(ServeConfig(**faulted), cfg,
                                          strict=args.strict)),
        ("cnn/faulted", check_cnn_serve_config(CNNServeConfig(**faulted))),
    ]
    for name, errs in checks:
        print(f"{name}: {'FAIL' if errs else 'ok'}")
        errors.extend(f"serve[{name}]: {e}" for e in errs)


def run_lint(errors: List[str]) -> None:
    from repro_torch.check.astlint import lint_paths, port_paths

    section("ast lint")
    findings = lint_paths(port_paths(ROOT))
    print(f"findings={len(findings)}")
    errors.extend(f"lint: {f}" for f in findings)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--strict", action="store_true",
                    help="fail on warnings too, and run the submit-time "
                         "serve-config checks")
    ap.add_argument("--cache", default=None,
                    help="tune cache to audit (default: the file "
                         "REPRO_TORCH_TUNE_CACHE names)")
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"),
                    help="where the plans are lowered and whose configs "
                         "are resolved (default cpu)")
    ap.add_argument("--batch", type=int, default=256,
                    help="images a forward, for the schedules section")
    ap.add_argument("--skip-plans", action="store_true",
                    help="skip the plans and schedules sections")
    args = ap.parse_args(argv)

    errors: List[str] = []
    warnings: List[str] = []
    if args.device == "cuda":
        # load (and build, if its sources changed) the kernel library, so
        # the verdicts below hold this build's ptxas registers
        from repro_torch.kernels import _build
        _build.library()
    run_cache(args, errors, warnings)
    if not args.skip_plans:
        plans = lowered_plans(args.device)
        run_plans(plans, errors, warnings)
        run_schedules(plans, args, errors, warnings)
    run_serve(args, errors)
    run_lint(errors)

    section("summary")
    for w in warnings:
        print(f"warning: {w}")
    for e in errors:
        print(f"error: {e}")
    fail = bool(errors) or (args.strict and bool(warnings))
    print(f"{len(errors)} error(s), {len(warnings)} warning(s)"
          + (" [strict]" if args.strict else ""))
    return 1 if fail else 0


if __name__ == "__main__":
    sys.exit(main())
