"""Dry run of every (arch x shape x mesh) cell: per-device argument bytes
by the sharding rules, and the step's work counted at global shapes.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \
        --arch qwen2-0.5b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \
        [--multi-pod both] [--jobs 4]

Port of ``repro/launch/dryrun.py``, with its cell names
(``{arch}__{shape}__{16x16|2x16x16}__{tag}.json``), its rule choices
(:func:`arch_train_overrides`, :func:`needs_2d_serve_sharding`) and its
``REPRO_*`` knobs. JAX lowers and compiles each cell on 512 fake host
devices; here the meshes are ``DeviceMesh`` es over ``torch.distributed``'s
fake backend (:func:`fake_world`: 256 or 512 ranks, no peer), every
parameter, optimizer state, batch and cache is a meta tensor, and no byte
of device memory is touched.

Each record holds ``status`` (``ok``, or ``skipped`` with
``cell_supported``'s reason, or ``error`` with the exception: as in JAX,
one cell's failure is recorded and the sweep goes on), the ``rules``, the
first device's ``memory`` (``argument_bytes``: params, optimizer state,
batch and cache by the rules' local shapes; ``output_bytes``;
``alias_bytes``, the donated arguments), ``model_flops``
(``estimate_model_flops``), ``dot_flops_global`` and ``flops_by_kind``
(the cell's step run on meta tensors at the global shapes under
``roofline.count``, kernel calls as plain versions,
``kernels.ops.force_method("torch")``: at one and two layers, then
extrapolated to the full depth, :func:`cell_work`), ``n_chips`` and
``tokens``, and ``collectives``: the first device's collective bytes a
step (:func:`cell_collectives`: rank 0's step run at its local shapes
inside the cell's mesh, every ``psum``, ``all_gather``, ``psum_scatter``
and ``all_to_all`` counted by ``roofline.count`` with its operand bytes
and its group's axes, at the same depths and extrapolated the same way):
``bytes_in_pod``, ``bytes_cross_pod`` (a group that spans ``"pod"``:
JAX's ICI / DCN split), ``by_kind`` under JAX's HLO names, ``calls``, and
``step_rules``, the rules the counted step ran under: ``"cell"`` (a train
cell's own rules: the FSDP + TP step) or ``"spmd"`` (a prefill or decode
cell's ``spmd_rules`` of them, the rules the port's serve step is held
to: batch, cache and experts split, every other dim whole; decode
sequence-parallel over ``"model"``, as JAX's ``build_cell`` runs it). It
has no compile times or temp bytes: eager PyTorch has no compiler to ask,
and nothing stands in for them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs.base import (ARCH_IDS, SHAPES, cell_supported,
                                      get_config, torch_dtype)
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import api, mamba
from repro_torch.optim import OptConfig
from repro_torch.parallel.sharding import (ShardingRules, local_bytes,
                                           local_tree, make_rules,
                                           mesh_shape, prune_batch_axes,
                                           spmd_rules, tree_shardings,
                                           use_mesh, use_rules)
from repro_torch.roofline import count as roofline
from repro_torch.train.train_step import (TrainConfig, estimate_model_flops,
                                          make_train_step)
from repro_torch.tree import tree_map

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__),
                            "../../../artifacts/dryrun_torch")


def fake_world(n: int):
    """Make the process group ``torch.distributed``'s fake backend of ``n``
    ranks, this process rank 0 (a group of another size is destroyed
    first): meshes of ``n`` devices with no peer behind them."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _meta_like(t, dtype):
    return torch.empty(t.shape, dtype=dtype, device="meta")


def _serve_param_structs(cfg, dtype=torch.bfloat16):
    return tree_map(lambda s: _meta_like(s, dtype if s.is_floating_point()
                                         else s.dtype),
                    api.param_structs(cfg))


def _opt_structs(params, opt: OptConfig):
    sdt = torch_dtype(opt.state_dtype) if opt.state_dtype else None
    return {"m": tree_map(lambda s: _meta_like(s, sdt or s.dtype), params),
            "v": tree_map(lambda s: _meta_like(s, sdt or s.dtype), params),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def arch_train_overrides(arch: str) -> dict:
    """Per-arch memory knobs, JAX's:

    * arctic-480b cannot hold f32 AdamW on 256 chips -> params + m/v bf16.
    * microbatches: archs whose layer residuals exceed the memory budget
      accumulate gradients over microbatches."""
    mb = {"arctic-480b": 8, "qwen1.5-32b": 8, "granite-34b": 8,
          "jamba-v0.1-52b": 8, "falcon-mamba-7b": 4, "granite-3-2b": 4,
          "seamless-m4t-large-v2": 4}
    out = {"microbatches": mb.get(arch, 1)}
    if os.environ.get("REPRO_MICROBATCHES"):
        out["microbatches"] = int(os.environ["REPRO_MICROBATCHES"])
    if arch == "arctic-480b":
        out.update(param_dtype="bfloat16", opt_state_dtype="bfloat16")
    return out


def needs_2d_serve_sharding(cfg) -> bool:
    """bf16 weights must fit well under one device's memory after TP. Archs
    whose attention cannot TP over 16 heads keep those weights replicated
    across "model", so the threshold is on the unsharded bytes."""
    if cfg.n_heads % 16:
        return cfg.param_count() * 2 > 8e9
    return cfg.param_count() * 2 / 16 > 8e9


def _batch_shardings(batch_specs, mesh):
    return {k: tree_shardings(("batch",) + (None,) * (v.dim() - 1), mesh)
            for k, v in batch_specs.items() if isinstance(v, torch.Tensor)}


def build_cell(arch: str, shape_name: str, mesh, rules_override=None, *,
               cfg=None):
    """``(fn, args, in_sh, donate, rules, cfg, shape, out_sh)`` of the
    cell, as JAX's ``build_cell``: the step, its meta arguments, their
    shardings, the donated argument indices and the outputs' shardings.
    ``cfg`` replaces the arch's config (:func:`cell_work`'s cut depths)."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    over = arch_train_overrides(arch)
    if shape.kind == "train" and "param_dtype" in over:
        cfg = dataclasses.replace(cfg, param_dtype=over["param_dtype"])

    kind = shape.kind
    sp = kind in ("decode", "prefill")
    fsdp = kind == "train" or needs_2d_serve_sharding(cfg)
    shard_res = False
    sizes = mesh_shape(mesh)
    if kind == "train":
        dp = sizes.get("pod", 1) * sizes.get("data", 1)
        mb = over.get("microbatches", 1)
        b_loc = max(shape.global_batch // (dp * mb), 1)
        layers = cfg.n_layers if cfg.family != "encdec" \
            else cfg.n_layers + cfg.n_encoder_layers
        resid = layers * b_loc * shape.seq_len * cfg.d_model * 6  # f32+bf16
        shard_res = resid > 4 * 2 ** 30
        if os.environ.get("REPRO_SHARD_RESIDUALS") == "1":
            shard_res = True
    rules = rules_override or make_rules(mesh, cfg, kind, fsdp=fsdp, sp=sp,
                                         shard_residuals=shard_res)
    # the JAX package's hill-climb knobs (scripts/hillclimb.py)
    if os.environ.get("REPRO_SEQ_SHARD") == "1" and kind == "train":
        rules = dataclasses.replace(
            rules, seq="model", heads=None, kv_heads=None, ffn=None,
            d_model_act=None)
    if os.environ.get("REPRO_POD_LOCAL_FSDP") == "1" and rules.embed:
        rules = dataclasses.replace(rules, embed=("data",),
                                    embed_table=("data",))
    rules = prune_batch_axes(mesh, rules, shape.global_batch)

    with use_mesh(mesh), use_rules(rules):
        psh = tree_shardings(api.param_specs(cfg), mesh)
        batch_specs = api.input_specs(cfg, shape)
        replicated = tree_shardings((), mesh)
        if kind == "train":
            params = api.param_structs(cfg)
            opt = OptConfig(state_dtype=over.get("opt_state_dtype"))
            tcfg = TrainConfig(
                opt=opt,
                attn_impl=os.environ.get("REPRO_ATTN_IMPL", "flash"),
                remat=os.environ.get("REPRO_REMAT", "full"),
                microbatches=over.get("microbatches", 1))
            step = make_train_step(cfg, tcfg)
            osh = {"m": psh, "v": psh, "step": replicated}
            args = (params, _opt_structs(params, opt), batch_specs)
            in_sh = (psh, osh, _batch_shardings(batch_specs, mesh))
            out_sh = (psh, osh, replicated)
            return step, args, in_sh, (0, 1), rules, cfg, shape, out_sh

        params = _serve_param_structs(cfg)
        csh = tree_shardings(api.cache_specs(cfg), mesh)
        logits_sh = tree_shardings(("batch", None, "vocab"), mesh)
        if kind == "prefill":
            fn = api.prefill_fn(cfg, max_len=shape.seq_len)
            return fn, (params, batch_specs), \
                (psh, _batch_shardings(batch_specs, mesh)), (), rules, cfg, \
                shape, (logits_sh, csh)

        sp_axis = "model" if "model" in mesh.mesh_dim_names else None
        fn = api.decode_fn(cfg, sp_axis=sp_axis)
        tsh = tree_shardings(("batch", None), mesh)
        return fn, (params, batch_specs["token"], batch_specs["cache"]), \
            (psh, tsh, csh), (2,), rules, cfg, shape, (logits_sh, csh)


def argument_bytes(args, in_sh) -> int:
    """The first device's bytes of a cell's arguments under their
    shardings."""
    return sum(local_bytes(a, sh) for a, sh in zip(args, in_sh))


def _sharded_bytes(tree, sh) -> int:
    return sum(local_bytes(a, s) for a, s in zip(tree, sh)) \
        if isinstance(tree, tuple) else local_bytes(tree, sh)


def count_step(fn, args, *, flops: bool = True) -> tuple:
    """``(outputs, Count)`` of one run of a step on its meta arguments,
    kernel calls as plain versions and each Mamba scan as one chunk
    (``models.mamba.whole_sequence_scans``: the same matmuls);
    ``flops=False``: its collectives and kernel calls only."""
    with ops.force_method("torch"), mamba.whole_sequence_scans(), \
            roofline.counting(flops) as c:
        out = fn(*args)
    return out, c


def _depths(cfg) -> list:
    """The stack depths the count runs at, as ``dataclasses.replace``
    keyword sets: one and two layers (a hybrid model's super-blocks), and
    for encdec one and two of each stack, one varied at a time."""
    if cfg.family == "encdec":
        return [dict(n_layers=1, n_encoder_layers=1),
                dict(n_layers=1, n_encoder_layers=2),
                dict(n_layers=2, n_encoder_layers=1)]
    unit = cfg.attn_period if cfg.family == "hybrid" else 1
    return [dict(n_layers=unit), dict(n_layers=2 * unit)]


def _extrapolate(cfg, points: list) -> list:
    """Each number of ``points`` (one list of numbers a depth of
    :func:`_depths`) at the config's full depth: every layer of a stack
    does the same work on the same shapes, so each number is affine in
    each stack's depth."""
    if cfg.family == "encdec":
        base, enc, dec = points
        return [b + (cfg.n_encoder_layers - 1) * (e - b)
                + (cfg.n_layers - 1) * (d - b)
                for b, e, d in zip(base, enc, dec)]
    unit = cfg.attn_period if cfg.family == "hybrid" else 1
    one, two = points
    return [a + (cfg.n_layers // unit - 1) * (b - a)
            for a, b in zip(one, two)]


#: each step's outputs at the counted depths and its work at full depth:
#: the same global step on either mesh
_RUNS: dict = {}


def cell_work(arch: str, shape_name: str, mesh, rules) -> tuple:
    """``(output_bytes, flops by kind)`` of the cell's step at its full
    depth: the step of :func:`build_cell` (under the cell's ``rules``) at
    each depth of :func:`_depths`, run once on meta tensors under
    ``roofline.count``, its outputs' first-device bytes under the output
    shardings, each number extrapolated to the full depth
    (:func:`_extrapolate`). Running a few layers instead of all of them
    keeps the count to seconds: an eager step on meta tensors costs its
    Python, some 10-300 us an operation."""
    cfg = get_config(arch)
    depths = [dataclasses.replace(cfg, **d) for d in _depths(cfg)]
    key = (arch, shape_name, tuple(sorted(
        (k, v) for k, v in os.environ.items() if k.startswith("REPRO_"))))
    if key not in _RUNS:
        outs, points = [], []
        for small in depths:
            fn, args, *_ = build_cell(arch, shape_name, mesh, rules,
                                      cfg=small)
            out, c = count_step(fn, args)
            outs.append(out)
            points.append(c.flops)
        kinds = sorted(set().union(*points))
        full = _extrapolate(cfg, [[p.get(k, 0) for k in kinds]
                                  for p in points])
        _RUNS[key] = (outs, dict(zip(kinds, full)))
    outs, flops = _RUNS[key]
    out_bytes = _extrapolate(cfg, [
        [_sharded_bytes(out, build_cell(arch, shape_name, mesh, rules,
                                        cfg=small)[-1])]
        for out, small in zip(outs, depths)])[0]
    return int(out_bytes), flops


def cell_collectives(arch: str, shape_name: str, mesh, rules) -> dict:
    """The first device's collectives a step of the cell (module
    docstring): rank 0's step of :func:`build_cell` at each depth of
    :func:`_depths`, its arguments cut to rank 0's blocks under the step's
    rules (a train cell's ``rules``; a serve cell's ``spmd_rules`` of
    them), run once on meta tensors inside ``mesh`` (this process is rank
    0 of the fake world) under ``roofline.count``; bytes and calls
    extrapolated to the full depth (:func:`_extrapolate`)."""
    cfg = get_config(arch)
    train = SHAPES[shape_name].kind == "train"
    step_rules = rules if train else spmd_rules(rules)
    points = []
    for d in _depths(cfg):
        fn, args, in_sh, *_ = build_cell(arch, shape_name, mesh, step_rules,
                                         cfg=dataclasses.replace(cfg, **d))
        local = [local_tree(a, sh, copy=True) for a, sh in zip(args, in_sh)]
        with use_mesh(mesh), use_rules(step_rules):
            _, c = count_step(fn, local, flops=False)
        got = c.collective_bytes()
        points.append([got["bytes_in_pod"], got["bytes_cross_pod"],
                       got["calls"]] + [got["by_kind"].get(k, 0)
                                        for k in roofline.COLLECTIVE_KINDS])
    in_pod, cross, calls, *kinds = _extrapolate(cfg, points)
    return {"bytes_in_pod": int(in_pod), "bytes_cross_pod": int(cross),
            "by_kind": {k: int(v) for k, v in zip(
                roofline.COLLECTIVE_KINDS, kinds) if v},
            "calls": int(calls), "step_rules": "cell" if train else "spmd"}


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             tag: str = "baseline", rules_override=None) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    meshname = "2x16x16" if multi_pod else "16x16"
    cellname = f"{arch}__{shape_name}__{meshname}__{tag}"
    path = os.path.join(out_dir, cellname + ".json")
    ok, why = cell_supported(cfg, shape)
    rec = dict(arch=arch, shape=shape_name, mesh=meshname, tag=tag)
    if not ok:
        rec.update(status="skipped", reason=why)
        _write(path, rec)
        return rec

    try:
        n_chips = 512 if multi_pod else 256
        fake_world(n_chips)
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        fn, args, in_sh, donate, rules, cfg2, _, out_sh = build_cell(
            arch, shape_name, mesh, rules_override)
        t0 = time.perf_counter()
        out_bytes, flops = cell_work(arch, shape_name, mesh, rules)
        coll = cell_collectives(arch, shape_name, mesh, rules)
        t_count = time.perf_counter() - t0
        arg_bytes = argument_bytes(args, in_sh)
        alias = sum(local_bytes(args[i], in_sh[i]) for i in donate)
        tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                       else 1)
        rec.update(
            status="ok",
            count_s=round(t_count, 2),
            memory=dict(argument_bytes=arg_bytes, output_bytes=out_bytes,
                        alias_bytes=alias),
            model_flops=estimate_model_flops(
                cfg2, tokens, "train" if shape.kind == "train" else "serve"),
            dot_flops_global=sum(flops.values()),
            flops_by_kind=flops,
            n_chips=n_chips,
            tokens=tokens,
            rules=rules.as_dict(),
            collectives=coll,
        )
    except Exception as e:    # noqa: BLE001 — record it, keep sweeping
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2500:])
    _write(path, rec)
    return rec


def record_faults(recs) -> list:
    """What is wrong with a sweep's records (dicts as written), one line
    each: a cell that raised, an ok record without ``collectives``, a
    16x16 record with collective bytes across pods (that mesh has one), a
    2x16x16 train record whose FSDP axes (the rules' ``embed``) include
    ``"pod"`` and whose step's collectives cross no pod."""
    out = []
    for rec in recs:
        name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}"
        if rec["status"] == "error":
            out.append(f"{name}: {rec.get('error')}")
        if rec["status"] != "ok":
            continue
        coll = rec.get("collectives")
        if not coll:
            out.append(f"{name}: no collectives")
            continue
        embed = rec["rules"].get("embed") or ()
        fsdp = (embed,) if isinstance(embed, str) else tuple(embed)
        if rec["mesh"] == "16x16" and coll["bytes_cross_pod"]:
            out.append(f"{name}: {coll['bytes_cross_pod']} bytes across "
                       "pods on one pod")
        if rec["mesh"] == "2x16x16" and "pod" in fsdp \
                and SHAPES[rec["shape"]].kind == "train" \
                and not coll["bytes_cross_pod"] > 0:
            out.append(f"{name}: FSDP over {fsdp} and no bytes across pods")
    return out


def _write(path, rec):
    os.makedirs(os.path.dirname(path), exist_ok=True)

    def default(o):
        if isinstance(o, (tuple, list)):
            return list(o)
        return str(o)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=default)


def _train_units(arch: str) -> int:
    """A train cell's count cost, for the sweep's order: the layers of one
    depth unit (:func:`_depths`; an encdec model's two stacks) times the
    microbatches, each of which runs the unit again."""
    cfg = get_config(arch)
    unit = {"hybrid": cfg.attn_period, "encdec": 2}.get(cfg.family, 1)
    return unit * arch_train_overrides(arch)["microbatches"]


def _sweep(arch: str, shape: str, pods, out: str, tag: str,
           skip_done: bool) -> list:
    """Run (or skip) the cells of one (arch, shape) on the meshes of
    ``pods``; the line printed for each. One process counts the step at
    global shapes once for both meshes."""
    lines = []
    for mp in pods:
        meshname = "2x16x16" if mp else "16x16"
        cell = f"{arch}__{shape}__{meshname}__{tag}"
        path = os.path.join(out, cell + ".json")
        if skip_done and os.path.exists(path):
            with open(path) as f:
                if json.load(f).get("status") in ("ok", "skipped"):
                    lines.append(f"[skip-done] {cell}")
                    continue
        t0 = time.perf_counter()
        rec = run_cell(arch, shape, mp, out, tag)
        status = rec.get("status")
        extra = ""
        if status == "ok":
            extra = (f" count={rec['count_s']}s args="
                     f"{rec['memory']['argument_bytes'] / 2 ** 30:.2f}"
                     "GiB/dev")
        elif status == "error":
            extra = " " + rec.get("error", "")[:160]
        lines.append(f"[{status}] {cell} ({time.perf_counter() - t0:.0f}s)"
                     f"{extra}")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", default="both",
                    choices=["both", "single", "multi"])
    ap.add_argument("--out", default=os.path.abspath(ARTIFACT_DIR))
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--mem-limit-gb", type=float, default=26.0,
                    help="address-space rlimit: a too-big cell raises "
                         "MemoryError (recorded) instead of OOM-killing")
    ap.add_argument("--jobs", type=int, default=1,
                    help="processes sweeping (arch, shape) pairs at once")
    args = ap.parse_args(argv)

    if args.mem_limit_gb:
        import resource
        lim = int(args.mem_limit_gb * 2 ** 30)
        resource.setrlimit(resource.RLIMIT_AS, (lim, lim))

    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    pods = {"both": [False, True], "single": [False],
            "multi": [True]}[args.multi_pod]
    tasks = [(arch, shape, pods, args.out, args.tag, args.skip_done)
             for arch in archs for shape in shapes]
    if args.jobs <= 1:
        for task in tasks:
            for line in _sweep(*task):
                print(line, flush=True)
        return
    import concurrent.futures
    import multiprocessing
    # the longest sweeps (the train steps', the deepest unit first) first
    tasks.sort(key=lambda t: (SHAPES[t[1]].kind != "train",
                              -_train_units(t[0])))
    with concurrent.futures.ProcessPoolExecutor(
            args.jobs, mp_context=multiprocessing.get_context("spawn")) as ex:
        for fut in concurrent.futures.as_completed(
                [ex.submit(_sweep, *task) for task in tasks]):
            for line in fut.result():
                print(line, flush=True)


if __name__ == "__main__":
    main()
