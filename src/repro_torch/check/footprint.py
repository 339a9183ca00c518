"""The one home of the port's per-kernel launch-feasibility model on an
H100, and its hard verdicts (port of ``repro/check/footprint.py``, whose
VMEM terms become Hopper's).

* :func:`kernel_footprint` — what one block of a kernel holds under a
  config: its dynamic shared bytes term by term (from the launch
  arithmetic each CUDA source exports and ``kernels/*.py`` mirrors, via
  ``tune.space.tile_plan`` and its siblings), its threads, the blocks of
  its grid, and the template instantiation the launch runs, named as
  ``ptxas`` names it.
* :func:`check_schedule` — the verdict the tuner (``tune.space.
  launch_errors`` prunes its candidates with it, ``tune.check_config``
  raises on it), the dispatch layer (``kernels.ops``' explicit
  ``config=``) and the executor (``graph.executor.CompiledPlan``) share.
  Errors: an unknown knob; a launch the card cannot run (a knob value with
  no instantiation, the grid, threads a block, the integer matmul's
  cluster, shared bytes past 232,448 a block); shared bytes past the
  budget (:func:`smem_budget`); and, where this process loaded a built
  kernel library, ``ptxas``'s registers a thread past 255 or times the
  block's threads past 65,536. A spill is a warning. With no build loaded
  the register term is absent, and the verdict says so in ``notes``: it
  is never guessed.
* :func:`audit_cache` — every entry of a tune cache file re-verified.
* :func:`parse_ptxas` / :func:`ptxas_report` — ``nvcc -Xptxas -v``'s
  report (``build/repro_torch/build.log``) by instantiation.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import re
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

#: dynamic shared memory a block can use on an H100 (``kernels``'
#: ``MAX_DYNAMIC_SMEM``); ``REPRO_TORCH_SMEM_BUDGET`` lowers or raises the
#: budget the verdict holds a footprint to
SMEM_PER_BLOCK = 232448
BUDGET_ENV = "REPRO_TORCH_SMEM_BUDGET"
#: the register file a block can use, and a thread's most registers
REGS_PER_BLOCK = 65536
MAX_REGS_PER_THREAD = 255


def smem_budget() -> int:
    """The shared bytes a block may hold (``REPRO_TORCH_SMEM_BUDGET``
    wins), the counterpart of JAX's ``vmem_budget``."""
    env = os.environ.get(BUDGET_ENV)
    return int(env) if env else SMEM_PER_BLOCK


# --------------------------------------------------------------------------
# The register term: ptxas's report of the build
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KernelRegs:
    """``ptxas``'s report of one instantiation."""

    name: str                    # demangled, e.g. "igemm_kernel<true, 8, ...>"
    registers: int
    smem: int                    # static shared bytes
    spill_stores: int
    spill_loads: int


def _demangle_all(names: List[str]) -> List[str]:
    """Demangle ``names`` with one ``c++filt`` process; a name it cannot
    read, or every name where the machine has no ``c++filt``, is kept."""
    mangled = [n for n in names if n.startswith("_Z")]
    if not mangled:
        return list(names)
    try:
        r = subprocess.run(["c++filt"], input="\n".join(mangled),
                           capture_output=True, text=True, timeout=60)
        out = r.stdout.splitlines() if r.returncode == 0 else []
    except (OSError, subprocess.SubprocessError):
        out = []
    table = dict(zip(mangled, out)) if len(out) == len(mangled) else {}
    return [table.get(n, n) for n in names]


def _short(name: str) -> str:
    """``void ns::kern<A, B>(args)`` -> ``kern<A, B>``."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.split("(")[0].strip()
    if name.startswith("void "):
        name = name[len("void "):]
    return name


def parse_ptxas(log: str) -> Dict[str, KernelRegs]:
    """Every entry function of ``nvcc -Xptxas -v``'s output, by its
    demangled name without return type, namespace or arguments."""
    entries, name, props = [], None, {}

    def flush():
        if name is not None and "regs" in props:
            entries.append((name, dict(props)))
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            flush()
            name, props = m.group(1), {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and name is not None and "regs" not in props:
            props["st"], props["ld"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name is not None and "regs" not in props:
            props["regs"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", ln)
            props["smem"] = int(s.group(1)) if s else 0
    flush()
    names = [_short(n) for n in _demangle_all([n for n, _ in entries])]
    return {n: KernelRegs(n, p["regs"], p["smem"], p.get("st", 0),
                          p.get("ld", 0))
            for n, (_, p) in zip(names, entries)}


def ptxas_report(log: str, kernels) -> List[str]:
    """One line per instantiation of ``kernels`` (regular expressions of a
    name) in ``nvcc -Xptxas -v``'s output: its registers, static shared
    memory and spill bytes."""
    out = []
    for name, r in parse_ptxas(log).items():
        if any(re.search(rf"(?<!\w){k}<", name) for k in kernels):
            out.append(f"{name}: {r.registers} registers, {r.smem} bytes "
                       "static shared memory (its tiles: dynamic, sized per "
                       f"launch), spill stores {r.spill_stores} loads "
                       f"{r.spill_loads} bytes")
    return out


@functools.lru_cache(maxsize=4)
def _log_registers(path: str, mtime_ns: int, size: int):
    """One build log's table, parsed once per version of the file."""
    return parse_ptxas(Path(path).read_text())


def build_registers() -> Optional[Dict[str, KernelRegs]]:
    """The register table of the kernel library this process loaded
    (``kernels._build.library``): ``ptxas``'s report in the build log
    beside it, written by the build that made it. None where this process
    loaded no library (the CPU, or before the first launch)."""
    from repro_torch.kernels import _build
    if not _build.library.cache_info().currsize:
        return None
    log = _build.BUILD_DIR / "build.log"
    try:
        st = log.stat()
    except OSError:
        return None
    return _log_registers(str(log), st.st_mtime_ns, st.st_size)


# --------------------------------------------------------------------------
# The footprint
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Footprint:
    """One block of a kernel's launch under a config: its dynamic shared
    bytes term by term, its threads, the grid's blocks and the
    instantiation it runs (``ptxas``'s name)."""

    kernel: str
    terms: Tuple[Tuple[str, int], ...]
    threads: int
    blocks: int
    instance: str

    @property
    def total_bytes(self) -> int:
        return sum(v for _, v in self.terms)

    def breakdown(self) -> str:
        return " + ".join(f"{k}={v}" for k, v in self.terms) or "none"


def _ctype(dtype) -> str:
    """A float mode's element type as ``ptxas`` prints it."""
    return "__nv_bfloat16" if str(dtype) == "bfloat16" else "float"


def _w4(dtype) -> str:
    return "true" if str(dtype) == "w4a8" else "false"


def _split(plan: dict, first: str) -> Tuple[Tuple[str, int], ...]:
    """A plan's shared bytes as its window (or ``first``) and the rest."""
    if "window" in plan:
        return (("window", plan["window"]),
                ("staging", plan["smem"] - plan["window"]))
    return ((first, plan["smem"]),)


def _blocks(grid) -> int:
    out = 1
    for g in grid:
        out *= g
    return out


def kernel_footprint(sig, config: Optional[dict] = None,
                     dtype: str = "int8") -> Footprint:
    """The launch of ``sig.kernel`` under ``config`` (resolved through
    ``tune.space.effective_config`` first, so absent knobs take their
    default), on 16-byte aligned tensors as the tuner's jobs and the CNN
    plans give them. The config's knobs must be values the kernel takes
    (:func:`check_schedule` checks that first)."""
    from repro_torch.kernels.conv_dw import dw_plan
    from repro_torch.kernels.matmul_q8 import MMF_KNOBS, mmf_plan, mmq_plan
    from repro_torch.tune import space

    k = sig.kernel
    dt = space.dtype_key(dtype)
    eff = space.effective_config(sig, config or {}, dt)
    integer = space.integer(dt)

    if space.tiled(k, dt):
        bp, q = eff["bp"], eff["q"]
        plan = space.tile_plan(sig, bp, q, dt)
        if k == "shift_conv2d" and integer:
            inst = f"igemm_kernel<{_w4(dt)}, {q}, ShiftOffsets>"
        elif k == "shift_conv2d":
            inst = f"shift_conv2d_f_kernel<{_ctype(dt)}, {q}>"
        elif k == "conv2d" and integer:
            inst = f"igemm_kernel<{_w4(dt)}, {q}, TapOffsets>"
        else:
            mode = (f"IntAddMode<{_w4(dt)}>" if integer else
                    f"FloatMode<{_ctype(dt)}, "
                    f"{'NegL1' if k == 'add_conv2d' else 'MulAdd'}>")
            inst = f"fgemm_kernel<{mode}, {plan['pixels']}, {q}, TapOffsets>"
        return Footprint(k, _split(plan, "stages"), plan["threads"],
                         _blocks(plan["grid"]), inst)

    if k == "depthwise2d":
        hk = sig.get("k")
        plan = dw_plan(*space.dw_shape(sig), space.dw_esize(dt), eff["pt"],
                       eff["rows"])
        mode = "DwInt" if integer else f"DwFloat<{_ctype(dt)}>"
        hkt = 3 if hk == 3 else 0              # conv_dw.cu: HK 3, or any
        inst = f"depthwise2d_kernel<{mode}, {eff['pt']}, {hkt}>"
        return Footprint(k, _split(plan, "window"), plan["threads"],
                         _blocks(plan["grid"]), inst)

    if k == "matmul" and integer:
        m, kk, n = sig.get("m"), sig.get("k"), sig.get("n")
        bn, bm, c = eff["bn"], eff["bm"], eff["cluster"]
        plan = mmq_plan(m, kk, n, bn, bm, c, dt == "w4a8")
        inbox = (c - 1) * bm * bn * 4
        return Footprint(k, (("stages", plan["smem"] - inbox),
                             ("inbox", inbox)), plan["threads"],
                         _blocks(plan["grid"]),
                         f"matmul_q_kernel<{bn}, {bm}, {_w4(dt)}>")

    if k == "matmul":
        tile = tuple(eff[x] for x in MMF_KNOBS)
        esize = 2 if dt == "bfloat16" else 4
        plan = mmf_plan(sig.get("m"), sig.get("n"), tile, esize)
        bm, bn, tm, tn = tile
        return Footprint(k, (("stages", plan["smem"]),), plan["threads"],
                         _blocks(plan["grid"]),
                         f"matmul_f_kernel<{_ctype(dt)}, {bm}, {bn}, {tm}, "
                         f"{tn}>")

    if k == "maxpool2d":
        launch = space.pool_launch(sig, eff["threads"], dt)
        win = sig.get("k")
        r = "unsigned short" if dt == "bfloat16" else "float"
        if integer:
            inst = ("maxpool2d_s8_vec_kernel" if launch["vector"]
                    else "maxpool2d_s8_kernel")
        elif launch["vector"]:
            wt = win if win in (2, 3) else 0    # pool.cu: 2, 3, or any
            inst = f"maxpool2d_f_vec_kernel<{r}, {wt}>"
        else:
            inst = f"maxpool2d_f_kernel<{r}>"
        return Footprint(k, (), launch["threads"], launch["blocks"], inst)

    if k == "causal_conv1d":
        launch = space.c1d_launch(sig, eff, dt)
        t, kk = launch["threads"], sig.get("k")
        inst = (f"causal_conv1d_vec_kernel<{_ctype(dt)}, {kk}, "
                f"{launch['run']}, {t}>" if launch["vector"]
                else f"causal_conv1d_kernel<{_ctype(dt)}, {kk}, {t}>")
        return Footprint(k, (), t, _blocks(launch["grid"]), inst)

    raise ValueError(f"unknown kernel {k!r}")


def _launch_errors(sig, cfg: Dict[str, int], dtype: str) -> List[str]:
    """Why an effective config cannot launch on this shape on an H100: a
    knob value with no instantiation, the block size, the grid limits,
    the integer matmul's cluster (at most 8) and, for the kernels that
    stage tiles (conv2d, depthwise2d, shift_conv2d, add_conv2d, matmul),
    shared bytes a block (static at most 48 KB, dynamic at most 232,448)
    and threads a block. Empty if it can."""
    from repro_torch.kernels.conv1d_causal import MAX_BATCH, MAX_RUNS
    from repro_torch.kernels.conv1d_causal import RUNS as C1D_RUNS
    from repro_torch.kernels.conv1d_causal import THREADS as C1D_THREADS
    from repro_torch.kernels.conv_dw import (dw_knob_errors, dw_plan,
                                             dw_tile_errors)
    from repro_torch.kernels.conv_im2col import (CONV_MAX_THREADS,
                                                 knob_errors, tile_errors)
    from repro_torch.kernels.matmul_q8 import (MMF_KNOBS, mmf_tile_errors,
                                               mmq_config_errors)
    from repro_torch.tune import space

    k = sig.kernel
    errs: List[str] = []
    if space.tiled(k, dtype):
        bp, q = cfg["bp"], cfg["q"]
        errs = knob_errors(bp, q)
        if errs:
            return errs
        plan = space.tile_plan(sig, bp, q, dtype)
        errs.extend(tile_errors(plan))
        if plan["threads"] > CONV_MAX_THREADS:
            errs.append(f"{plan['threads']} threads a block exceed "
                        f"{CONV_MAX_THREADS}")
        if plan["grid"][0] > space.MAX_GRID_X:
            errs.append(f"{plan['grid'][0]} pixel blocks exceed the grid")
    elif k == "depthwise2d":
        pt, rows = cfg["pt"], cfg["rows"]
        errs = dw_knob_errors(pt, rows)
        if errs:
            return errs
        plan = dw_plan(*space.dw_shape(sig), space.dw_esize(dtype), pt, rows)
        errs.extend(dw_tile_errors(plan))
        if plan["grid"][0] > space.MAX_GRID_X:
            errs.append(f"{plan['grid'][0]} row blocks exceed the grid")
    elif k == "matmul" and not space.integer(dtype):
        esize = 2 if space.dtype_key(dtype) == "bfloat16" else 4
        errs.extend(mmf_tile_errors(sig.get("m"), sig.get("n"),
                                    tuple(cfg[x] for x in MMF_KNOBS), esize))
    elif k in space.THREADED:
        t = cfg["threads"]
        if not (isinstance(t, int) and 32 <= t <= 1024 and t % 32 == 0):
            errs.append(f"threads={t!r} is not a whole number of warps up "
                        "to 1024")
        elif space.pool_launch(sig, t, dtype)["blocks"] > space.MAX_GRID_X:
            errs.append(f"{space.pool_launch(sig, t, dtype)['blocks']} "
                        "blocks exceed the grid")
    elif k == "causal_conv1d":
        t, r = cfg["threads"], cfg["run"]
        if t not in C1D_THREADS:
            errs.append(f"threads={t!r} has no instantiation (one of "
                        f"{C1D_THREADS})")
        elif r not in C1D_RUNS:
            errs.append(f"run={r!r} has no instantiation (one of "
                        f"{C1D_RUNS})")
        else:
            _, gy, gz = space.c1d_launch(sig, cfg, dtype)["grid"]
            if gy > MAX_RUNS or gz > MAX_BATCH:
                errs.append(f"{gy} runs or batch {gz} exceed the grid's y "
                            "or z limit")
    elif k == "matmul":
        errs.extend(mmq_config_errors(sig.get("m"), sig.get("k"),
                                      sig.get("n"), cfg,
                                      space.dtype_key(dtype) == "w4a8"))
    return errs


# --------------------------------------------------------------------------
# Hard feasibility verdict
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Verdict:
    """Result of one :func:`check_schedule` call. ``registers`` is
    ``ptxas``'s count a thread of the instantiation the launch runs, or
    None where the register term is absent (``notes`` says why)."""

    ok: bool
    sig_key: str
    kernel: str
    dtype: str
    config: dict
    effective: dict
    footprint: Optional[Footprint]
    budget: int
    errors: List[str]
    warnings: List[str]
    notes: List[str] = dataclasses.field(default_factory=list)
    registers: Optional[int] = None

    def message(self) -> str:
        head = f"{self.kernel}/{self.sig_key} [{self.dtype}] {self.config}"
        if self.ok and not self.warnings:
            return f"{head}: ok" + (f" ({'; '.join(self.notes)})"
                                    if self.notes else "")
        return f"{head}: {'; '.join(self.errors + self.warnings)}"


def check_schedule(sig, config: Optional[dict], dtype: str = "int8", *,
                   budget: Optional[int] = None,
                   registers: Optional[Mapping[str, KernelRegs]] = None
                   ) -> Verdict:
    """Static feasibility verdict for one (kernel, shape, config, dtype)
    on an H100 (module docstring). ``registers`` is a register table
    (:func:`parse_ptxas`); None reads this process's build
    (:func:`build_registers`)."""
    from repro_torch.tune import space

    config = dict(config or {})
    dt = space.dtype_key(dtype)
    budget = smem_budget() if budget is None else int(budget)
    if registers is None:
        registers = build_registers()
    errors: List[str] = []
    warnings: List[str] = []
    notes: List[str] = []

    known = space.knobs(sig.kernel, dt)
    unknown = sorted(set(config) - set(known))
    if unknown:
        errors.append(f"unknown knob(s) {unknown}; {sig.kernel} takes "
                      f"{list(known)}")
        return Verdict(False, sig.key(), sig.kernel, dt, config, {}, None,
                       budget, errors, warnings, notes)

    eff = space.effective_config(sig, config, dt)
    errors.extend(_launch_errors(sig, eff, dt))
    fp: Optional[Footprint] = None
    regs: Optional[int] = None
    if not errors:
        fp = kernel_footprint(sig, eff, dt)
        if fp.total_bytes > budget and fp.total_bytes <= SMEM_PER_BLOCK:
            errors.append(f"shared-memory footprint {fp.total_bytes} B "
                          f"exceeds the {budget} B budget "
                          f"({fp.breakdown()}); take a smaller tile")
        if registers is None:
            notes.append("registers not known: this process loaded no "
                         "kernel library")
        elif fp.instance not in registers:
            notes.append(f"registers not known: {fp.instance} is not in "
                         "this build's ptxas report")
        else:
            r = registers[fp.instance]
            regs = r.registers
            if regs > MAX_REGS_PER_THREAD:
                errors.append(f"{fp.instance}: {regs} registers a thread "
                              f"exceed {MAX_REGS_PER_THREAD}")
            if regs * fp.threads > REGS_PER_BLOCK:
                errors.append(f"{fp.instance}: {regs} registers x "
                              f"{fp.threads} threads = {regs * fp.threads} "
                              f"exceed the {REGS_PER_BLOCK} a block has")
            if r.spill_stores or r.spill_loads:
                warnings.append(f"{fp.instance} spills: {r.spill_stores} "
                                f"bytes stored, {r.spill_loads} loaded")

    return Verdict(ok=not errors, sig_key=sig.key(), kernel=sig.kernel,
                   dtype=dt, config=config, effective=eff, footprint=fp,
                   budget=budget, errors=errors, warnings=warnings,
                   notes=notes, registers=regs)


# --------------------------------------------------------------------------
# Tune-cache audit
# --------------------------------------------------------------------------

_DIM_RE = re.compile(r"([a-z]+)(\d+)")


def parse_cache_key(key: str):
    """Invert ``tune.cache.cache_key``: ``kernel|shape|dtype|backend`` ->
    ``(ShapeSig, dtype, backend)``."""
    from repro_torch.tune.space import ShapeSig
    kernel, shape_key, dtype, backend = key.split("|")
    dims = tuple((m.group(1), int(m.group(2)))
                 for m in _DIM_RE.finditer(shape_key))
    sig = ShapeSig(kernel, dims)
    if sig.key() != shape_key:
        raise ValueError(f"unparseable shape key {shape_key!r} in {key!r}")
    return sig, dtype, backend


def audit_cache(cache=None, *, budget: Optional[int] = None,
                registers: Optional[Mapping[str, KernelRegs]] = None
                ) -> List[dict]:
    """Re-verify every entry of a tune cache; one row per entry. ``cache``
    is a ``tune.TuneCache``, a path, or None for the file
    ``REPRO_TORCH_TUNE_CACHE`` names (no rows where it names none). An
    entry the verdict refuses comes back with ``ok=False`` and its
    reasons: re-tune or drop it."""
    from repro_torch.tune import cache as _cache
    if cache is None or isinstance(cache, (str, os.PathLike)):
        path = cache or _cache.default_cache_path()
        if path is None:
            return []
        cache = _cache.TuneCache(str(path))
    rows = []
    for key in sorted(cache.entries):
        entry = cache.entries[key]
        sig, dtype, backend = parse_cache_key(key)
        v = check_schedule(sig, entry.get("config") or {}, dtype,
                           budget=budget, registers=registers)
        rows.append({
            "key": key, "ok": v.ok, "config": dict(entry.get("config") or {}),
            "effective": v.effective, "source": entry.get("source"),
            "smem_bytes": v.footprint.total_bytes if v.footprint else None,
            "threads": v.footprint.threads if v.footprint else None,
            "registers": v.registers, "budget_bytes": v.budget,
            "errors": v.errors, "warnings": v.warnings, "notes": v.notes,
        })
    return rows


def summarize_audit(rows: Iterable[dict]) -> dict:
    rows = list(rows)
    return {
        "entries": len(rows),
        "feasible": sum(r["ok"] for r in rows),
        "infeasible": [r["key"] for r in rows if not r["ok"]],
        "warnings": sum(bool(r["warnings"]) for r in rows),
        "notes": sum(bool(r.get("notes")) for r in rows),
    }
