"""The port's static checks (``repro_torch.check``) against the JAX
package's (``repro.check``) on the same plans, on the CPU.

JAX-lowered plans cross into the port as plain numpy data
(``weights.plan_from_numpy``). For the five primitives with int8 and W4
weights, the port's accumulator bounds and dataflow diagnostics equal
JAX's node by node; the tampered plans of ``tests/test_check.py`` give the
same message lists and are refused by ``CompiledPlan`` at build. Then the
Hopper footprint model and its verdicts (unknown knobs, non-positive
knobs, the budget override, registers read from a fixed ``ptxas`` report),
the tuner's candidate lists and defaults pinned to the ones recorded
before the verdict moved into ``check/footprint.py``
(``tests/data/torch_tune_space.json``), the cache audit, ``ops``'
explicit-config rejection, the lint and ``scripts/torch_check_plan.py``.
"""
import dataclasses
import importlib.util
import json
import os
import shutil
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.check import CheckError as JCheckError  # noqa: E402
from repro.check import validate_plan as j_validate_plan  # noqa: E402
from repro.check.dataflow import check_plan as j_check_plan  # noqa: E402
from repro.check.overflow import \
    check_plan_overflow as j_check_plan_overflow  # noqa: E402
from repro.check.overflow import \
    check_requant_shift as j_check_requant_shift  # noqa: E402
from repro.core.quantize import QTensor as JQTensor  # noqa: E402
from repro.core.quantize import QTensorW4 as JQTensorW4  # noqa: E402
from repro.graph import CompiledPlan as JCompiledPlan  # noqa: E402
from repro.graph import build_cnn_graph as j_build  # noqa: E402
from repro.graph import lower as j_lower  # noqa: E402
from repro.models.convnet import CNNConfig as JCNNConfig  # noqa: E402
from repro.models.convnet import init_cnn as j_init_cnn  # noqa: E402

from repro_torch import kernels, tune  # noqa: E402
from repro_torch.check import (CheckError, audit_cache,  # noqa: E402
                               check_plan, check_plan_overflow,
                               check_requant_shift, check_schedule,
                               kernel_footprint, overflow_errors,
                               parse_cache_key, smem_budget,
                               summarize_audit, validate_plan)
from repro_torch.check import footprint as fp_mod  # noqa: E402
from repro_torch.check.astlint import (lint_file, lint_paths,  # noqa: E402
                                       port_paths)
from repro_torch.graph import CompiledPlan  # noqa: E402
from repro_torch.weights import plan_from_numpy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PRIMS = ("standard", "grouped", "dws", "shift", "add")
BITS = (8, 4)


@pytest.fixture(autouse=True)
def _isolated_cache(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_TUNE_CACHE", raising=False)
    monkeypatch.delenv(fp_mod.BUDGET_ENV, raising=False)
    tune.set_default_cache(tune.TuneCache(None))
    yield
    tune.reset()


def _leaf(v):
    """One JAX qparams leaf as the plain data ``plan_from_numpy`` reads."""
    if isinstance(v, JQTensor):
        return np.asarray(v.q), v.frac_bits
    if isinstance(v, JQTensorW4):
        return dict(q=np.asarray(v.q), shifts=np.asarray(v.shifts),
                    frac_bits=v.frac_bits, size=v.size, axis=v.axis)
    if isinstance(v, int):
        return v
    return np.asarray(v)


def _port(jplan):
    """The port's copy of a JAX plan, on the host."""
    nodes = []
    for n in jplan.nodes:
        spec = None
        if n.spec is not None:
            spec = {k: v for k, v in dataclasses.asdict(n.spec).items()
                    if k != "dtype"}
        nodes.append(dict(name=n.name, op=n.op, spec=spec,
                          qparams=None if n.qparams is None
                          else {k: _leaf(v) for k, v in n.qparams.items()},
                          in_fb=n.in_fb, out_fb=n.out_fb, act=n.act,
                          attrs=dict(n.attrs)))
    return plan_from_numpy(nodes, jplan.in_fb, device="cpu")


def _copy(jplan):
    """A JAX plan whose nodes (and qparams dicts) can be tampered with."""
    return dataclasses.replace(jplan, nodes=tuple(
        dataclasses.replace(n, qparams=None if n.qparams is None
                            else dict(n.qparams), attrs=dict(n.attrs))
        for n in jplan.nodes))


@pytest.fixture(scope="module")
def jplans():
    """JAX-lowered plans of the five primitives, int8 and W4 weights, at
    ``tests/test_check.py``'s sizes, and an input batch."""
    out = {}
    rng = np.random.default_rng(2)
    calib = (rng.standard_normal((4, 16, 16, 3)) * 0.5).astype(np.float32)
    for prim in PRIMS:
        cfg = JCNNConfig(primitive=prim, widths=(8, 12), image_size=16)
        params = j_init_cnn(cfg, jax.random.PRNGKey(1))
        for bits in BITS:
            out[prim, bits] = j_lower(j_build(cfg), params, calib,
                                      weight_bits=bits)
    out["x"] = (rng.standard_normal((3, 16, 16, 3)) * 0.5).astype(np.float32)
    return out


def _bound_rows(bounds):
    return [(b.node, b.stage, b.primitive, b.acc_max, b.requant_shift, b.ok,
             list(b.messages)) for b in bounds]


def _diag_rows(diags):
    return [(d.node, d.level, d.message) for d in diags]


# ------------------------------------------------- bounds and dataflow ---

@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("prim", PRIMS)
def test_bounds_and_diagnostics_equal_jax(jplans, prim, bits):
    """Every NodeBound (node, stage, primitive, acc_max, requant_shift, ok,
    messages) and every dataflow diagnostic equals JAX's; the plan is
    clean and has headroom."""
    jplan = jplans[prim, bits]
    plan = _port(jplan)
    bounds = check_plan_overflow(plan)
    assert _bound_rows(bounds) == _bound_rows(j_check_plan_overflow(jplan))
    assert bounds and overflow_errors(bounds) == []
    assert all(b.headroom_bits > 0 for b in bounds)
    assert _diag_rows(check_plan(plan)) == _diag_rows(j_check_plan(jplan))
    validate_plan(plan)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("prim", PRIMS)
def test_clean_plan_builds_and_trunk_equals_jax(jplans, prim, bits):
    """A clean plan builds with validation on and its trunk is bitwise
    JAX's ``CompiledPlan(method="xla")`` one."""
    jplan, x = jplans[prim, bits], jplans["x"]
    ex = CompiledPlan(_port(jplan), method="cuda", device="cpu")
    want = JCompiledPlan(jplan, method="xla")
    got = ex.trunk(x)
    from repro.core.quantize import quantize
    h = quantize(jax.numpy.asarray(x), jplan.in_fb)
    for node in jplan.nodes:
        if node.op == "gap":
            break
        h = want._run_node(node, h)
    assert got.frac_bits == h.frac_bits
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(h.q))


def _shift_past_32(jp):
    node = next(n for n in jp.nodes if n.op == "qconv")
    node.out_fb = node.out_fb - 40


def _broken_chain(jp):
    node = next(n for n in jp.nodes if n.op == "qconv")
    node.in_fb = node.in_fb + 3


def _qbn_budget(jp):
    node = next(n for n in jp.nodes if n.op == "qbn")
    node.qparams["a"] = np.asarray(node.qparams["a"], np.int64) * 0 \
        + (1 << 20)


def _every_in_fb(jp):
    for n in jp.nodes:
        if n.op == "qconv":
            n.in_fb = n.in_fb + 3


TAMPERS = {"shift-past-32": ("standard", _shift_past_32),
           "broken-scale-chain": ("standard", _broken_chain),
           "qbn-multiplier-budget": ("add", _qbn_budget),
           "every-in-fb": ("standard", _every_in_fb)}


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("case", sorted(TAMPERS))
def test_tampered_plan_refused_with_jax_messages(jplans, case, bits):
    """The tampered plans of tests/test_check.py: the port's CheckError
    lists JAX's messages, CompiledPlan raises it at build before any
    kernel launches, and validate=False builds."""
    prim, tamper = TAMPERS[case]
    jp = _copy(jplans[prim, bits])
    tamper(jp)
    with pytest.raises(JCheckError) as want:
        j_validate_plan(jp)
    plan = _port(jp)
    with pytest.raises(CheckError) as got:
        validate_plan(plan)
    assert got.value.messages == want.value.messages
    assert str(got.value).count("  - ") == len(want.value.messages) >= 1
    kernels.reset_launches()
    with pytest.raises(CheckError, match="static verification") as built:
        CompiledPlan(plan, method="cuda", device="cpu")
    assert built.value.messages == want.value.messages
    assert isinstance(built.value, ValueError)
    assert all(k.launches == 0 for k in kernels.KERNELS)
    CompiledPlan(plan, method="cuda", device="cpu", validate=False)


def test_tampered_messages_name_their_failure(jplans):
    jp = _copy(jplans["add", 8])
    _qbn_budget(jp)
    with pytest.raises(CheckError) as e:
        validate_plan(_port(jp))
    assert any("int16-range budget" in m for m in e.value.messages)
    jp = _copy(jplans["standard", 4])
    _broken_chain(jp)
    with pytest.raises(CheckError, match="scale chain broken"):
        validate_plan(_port(jp))


@pytest.mark.parametrize("acc,shift", [
    (1 << 20, 4), (2 ** 31, 4), (1 << 20, 40), (1 << 20, -40), (1 << 20, 2.5),
    (2 ** 31 - 3, 3), (1 << 28, -8), (1 << 28, -2), (0, 31), (2 ** 31 - 1, 0)])
def test_check_requant_shift_equals_jax(acc, shift):
    got = check_requant_shift(acc, shift)
    assert got == j_check_requant_shift(acc, shift)
    assert bool(got) == ((acc, shift) not in
                         ((1 << 20, 4), (1 << 28, -2), (0, 31),
                          (2 ** 31 - 1, 0)))


# ------------------------------------------------------- the footprint ---

CONV = tune.sig_conv2d(1, 32, 32, 16, 64, 3)
PTXAS = textwrap.dedent("""\
    ptxas info    : 0 bytes gmem
    ptxas info    : Compiling entry function '{igemm}' for 'sm_90a'
    ptxas info    : Function properties for {igemm}
        0 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
    ptxas info    : Used {regs} registers, used 1 barriers, 400 bytes cmem[0]
    ptxas info    : Compiling entry function 'void (anonymous namespace)::depthwise2d_kernel<(anonymous namespace)::DwInt, 2, 3>((anonymous namespace)::DwArgs, (anonymous namespace)::DwGeo)' for 'sm_90a'
    ptxas info    : Function properties for x
        0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
    ptxas info    : Used 256 registers, used 1 barriers, 16 bytes smem, 400 bytes cmem[0]
    """)


def _igemm_name(fp):
    return ("void (anonymous namespace)::" + fp.instance.replace(
        "TapOffsets", "(anonymous namespace)::TapOffsets")
        + "((anonymous namespace)::GemmArgs)")


@pytest.mark.parametrize("sig,bad", [
    (CONV, {"block_co": 8}), (CONV, {"bp": 64, "q": 4, "threads": 256}),
    (tune.sig_maxpool2d(2, 8, 8, 16, 2, 2), {"pt": 2}),
    (tune.sig_matmul(8, 64, 64), {"splits": 2})])
def test_unknown_knobs_are_errors(sig, bad):
    v = check_schedule(sig, bad, "int8")
    assert not v.ok and v.footprint is None
    assert any("unknown" in e for e in v.errors)


@pytest.mark.parametrize("sig,dtype,bad", [
    (CONV, "int8", {"bp": 0}), (CONV, "float32", {"q": -4}),
    (CONV, "int8", {"bp": "64"}),
    (tune.sig_depthwise2d(2, 8, 8, 16, 3), "int8", {"pt": 0}),
    (tune.sig_maxpool2d(2, 8, 8, 16, 2, 2), "int8", {"threads": 0}),
    (tune.sig_causal_conv1d(1, 16, 64, 4), "float32", {"run": 0}),
    (tune.sig_matmul(8, 64, 64), "int8", {"bn": 0, "bm": 8, "cluster": 1}),
    (tune.sig_matmul(8, 64, 64), "float32", {"bm": -16})])
def test_non_positive_knobs_are_errors(sig, dtype, bad):
    v = check_schedule(sig, bad, dtype)
    assert not v.ok and v.errors and v.footprint is None


def test_footprint_terms_and_default_verdict():
    """The default config's footprint is the tile plan's shared bytes,
    window and staging; on the host its register term is absent and the
    verdict says so."""
    cfg = tune.default_config("conv2d", CONV, "int8")
    fp = kernel_footprint(CONV, cfg, "int8")
    plan = tune.space.tile_plan(CONV, cfg["bp"], cfg["q"], "int8")
    assert dict(fp.terms)["window"] == plan["window"]
    assert fp.total_bytes == plan["smem"] and fp.threads == plan["threads"]
    assert fp.instance == f"igemm_kernel<false, {cfg['q']}, TapOffsets>"
    v = check_schedule(CONV, cfg, "int8")
    assert v.ok and v.registers is None and not v.warnings
    assert any("loaded no kernel library" in n for n in v.notes)
    assert v.message().endswith("loaded no kernel library)")
    assert smem_budget() == fp_mod.SMEM_PER_BLOCK == 232448
    from repro_torch.kernels.conv_im2col import MAX_DYNAMIC_SMEM
    assert fp_mod.SMEM_PER_BLOCK == MAX_DYNAMIC_SMEM


def test_smem_budget_override(monkeypatch):
    monkeypatch.setenv(fp_mod.BUDGET_ENV, "4096")
    assert smem_budget() == 4096
    cfg = tune.default_config("conv2d", CONV, "int8")
    v = check_schedule(CONV, cfg, "int8")
    assert not v.ok and any("4096 B budget" in e for e in v.errors)
    assert check_schedule(CONV, cfg, "int8", budget=1 << 20).ok
    # the pool stages nothing: no budget binds it
    assert check_schedule(tune.sig_maxpool2d(2, 8, 8, 16, 2, 2), {},
                          "int8").ok


def test_register_verdicts_from_a_fixed_ptxas_report():
    """Registers x threads past 65,536 and registers past 255 are errors,
    a spill a warning, an instantiation the report lacks a note; the
    registers come from the report, never from a guess."""
    cfg = {"bp": 256, "q": 4}
    fp = kernel_footprint(CONV, cfg, "int8")
    over = fp_mod.REGS_PER_BLOCK // fp.threads + 1
    table = fp_mod.parse_ptxas(PTXAS.format(igemm=_igemm_name(fp),
                                            regs=over))
    assert table[fp.instance].registers == over
    assert table[fp.instance].spill_stores == 12
    v = check_schedule(CONV, cfg, "int8", registers=table)
    assert not v.ok and v.registers == over
    assert any("a block has" in e for e in v.errors)
    assert any("spills" in w for w in v.warnings)
    ok = fp_mod.parse_ptxas(PTXAS.format(igemm=_igemm_name(fp), regs=64))
    v = check_schedule(CONV, cfg, "int8", registers=ok)
    assert v.ok and v.registers == 64 and v.warnings and not v.notes
    dw = tune.sig_depthwise2d(2, 8, 8, 16, 3)
    v = check_schedule(dw, {"pt": 2, "rows": 1}, "w4a8", registers=ok)
    assert v.footprint.instance == "depthwise2d_kernel<DwInt, 2, 3>"
    assert not v.ok and any("exceed 255" in e for e in v.errors)
    v = check_schedule(dw, {"pt": 4, "rows": 1}, "int8", registers=ok)
    assert v.ok and v.registers is None
    assert any("not in this build's ptxas report" in n for n in v.notes)
    lines = fp_mod.ptxas_report(PTXAS.format(igemm=_igemm_name(fp), regs=64),
                                ("igemm_kernel",))
    assert lines == [f"{fp.instance}: 64 registers, 0 bytes static shared "
                     "memory (its tiles: dynamic, sized per launch), spill "
                     "stores 12 loads 16 bytes"]
    mangled = ("_ZN12_GLOBAL__N_112igemm_kernelILb1ELi8ENS_10TapOffsetsEEEvPKa"
               "NS_8IgemmGeoET1_")
    if shutil.which("c++filt"):
        table = fp_mod.parse_ptxas(PTXAS.format(igemm=mangled, regs=70))
        assert table["igemm_kernel<true, 8, TapOffsets>"].registers == 70


@pytest.mark.parametrize("sig,dtype,cfg,inst", [
    (tune.sig_conv2d(1, 10, 10, 16, 16, 3), "bfloat16", {"bp": 64, "q": 8},
     "fgemm_kernel<FloatMode<__nv_bfloat16, MulAdd>, 2, 8, TapOffsets>"),
    (tune.sig_add_conv2d(1, 10, 10, 16, 16, 3), "w4a8", {"bp": 32, "q": 4},
     "fgemm_kernel<IntAddMode<true>, 1, 4, TapOffsets>"),
    (tune.sig_add_conv2d(1, 10, 10, 16, 16, 3), "float32",
     {"bp": 128, "q": 16}, "fgemm_kernel<FloatMode<float, NegL1>, 2, 16, "
     "TapOffsets>"),
    (tune.sig_shift_conv2d(2, 8, 8, 16, 32, 2), "int8", {"bp": 64, "q": 8},
     "igemm_kernel<false, 8, ShiftOffsets>"),
    (tune.sig_shift_conv2d(1, 32, 32, 64, 64), "float32", {"bp": 32, "q": 4},
     "shift_conv2d_f_kernel<float, 4>"),
    (tune.sig_depthwise2d(1, 32, 32, 64, 5), "float32", {"pt": 1, "rows": 2},
     "depthwise2d_kernel<DwFloat<float>, 1, 0>"),
    (tune.sig_matmul(8, 896, 4864), "w4a8", {"bn": 64, "bm": 8,
                                             "cluster": 1},
     "matmul_q_kernel<64, 8, true>"),
    (tune.sig_matmul(256, 512, 256), "bfloat16",
     {"bm": 32, "bn": 64, "tm": 2, "tn": 4},
     "matmul_f_kernel<__nv_bfloat16, 32, 64, 2, 4>"),
    (tune.sig_maxpool2d(8, 32, 32, 64, 2, 2), "int8", {"threads": 128},
     "maxpool2d_s8_vec_kernel"),
    (tune.sig_maxpool2d(8, 32, 32, 6, 3, 2), "int8", {"threads": 128},
     "maxpool2d_s8_kernel"),
    (tune.sig_maxpool2d(8, 32, 32, 64, 3, 2), "bfloat16", {"threads": 64},
     "maxpool2d_f_vec_kernel<unsigned short, 3>"),
    (tune.sig_maxpool2d(8, 32, 32, 3, 2, 2), "float32", {"threads": 64},
     "maxpool2d_f_kernel<float>"),
    (tune.sig_causal_conv1d(1, 96, 8192, 4), "bfloat16",
     {"run": 4, "threads": 128},
     "causal_conv1d_vec_kernel<__nv_bfloat16, 4, 4, 128>"),
    (tune.sig_causal_conv1d(1, 96, 100, 4), "bfloat16",
     {"run": 1, "threads": 64}, "causal_conv1d_kernel<__nv_bfloat16, 4, 64>")])
def test_footprint_names_the_instantiation(sig, dtype, cfg, inst):
    """Each launch maps to the template instantiation its source dispatches
    to, as ptxas names it (csrc/*.cu launch functions)."""
    v = check_schedule(sig, cfg, dtype)
    assert v.ok, v.errors
    assert v.footprint.instance == inst
    assert v.footprint.threads > 0 and v.footprint.blocks > 0


def test_launch_errors_are_the_verdicts():
    """tune.space.launch_errors is check_schedule's error list."""
    for sig, dtype, cfg in (
            (tune.sig_conv2d(1, 16, 16, 512, 64, 3), "int8",
             {"bp": 256, "q": 16}),
            (tune.sig_matmul(64, 896, 4864), "int8",
             {"bn": 128, "bm": 32, "cluster": 8}),
            (tune.sig_causal_conv1d(1, 70000, 64, 4), "float32",
             {"run": 1, "threads": 64}),
            (CONV, "int8", {"bp": 64, "q": 8})):
        errs = tune.space.launch_errors(sig, cfg, dtype)
        assert errs == check_schedule(sig, cfg, dtype).errors
    assert tune.space.launch_errors(CONV, {"bp": 64, "q": 8}, "int8") == []


SPACE = json.loads((ROOT / "tests" / "data" /
                    "torch_tune_space.json").read_text())


@pytest.mark.parametrize("kernel", tune.KERNELS)
def test_candidates_and_defaults_unchanged(kernel):
    """At every job of the tuner (Table-2 and smoke jobs, the five CNN
    plans' at batches 1, 8 and 256) in every dtype, candidates() and
    default_config() give the lists recorded before the verdict moved into
    check/footprint.py, and every candidate's verdict is ok."""
    keys = [k for k in SPACE if k.startswith(kernel + "|")]
    assert keys
    for key in keys:
        sig, dtype, _ = parse_cache_key(key + "|cpu")
        want = SPACE[key]
        knobs = want["knobs"]
        got = [[c[k] for k in knobs] for c in tune.candidates(sig, dtype)]
        assert got == want["candidates"], key
        default = tune.default_config(kernel, sig, dtype)
        assert [default[k] for k in knobs] == want["default"], key
        for c in got[1:]:
            assert check_schedule(sig, dict(zip(knobs, c)), dtype).ok, key


# ------------------------------------------------ cache and dispatch ---

def test_parse_cache_key_roundtrip():
    for sig in (tune.sig_conv2d(4, 32, 32, 16, 64, 3, groups=4),
                tune.sig_shift_conv2d(2, 8, 8, 16, 32, 2),
                tune.sig_causal_conv1d(1, 96, 8192, 4)):
        key = tune.cache_key(sig.kernel, sig.key(), "w4a8", "cuda")
        assert parse_cache_key(key) == (sig, "w4a8", "cuda")
    with pytest.raises(ValueError):
        parse_cache_key("conv2d|bogus-shape|int8|cuda")


def test_audit_cache_reads_the_port_cache_only(tmp_path, monkeypatch):
    """An entry that cannot launch comes back ok=False with its reasons;
    with no REPRO_TORCH_TUNE_CACHE there is nothing to audit (the JAX
    package's artifacts/tune_cache.json is never read)."""
    good = tune.default_config("conv2d", CONV, "int8")
    c = tune.TuneCache(None)
    c.put(tune.cache_key("conv2d", CONV.key(), "int8", "cuda"), good)
    c.put(tune.cache_key("conv2d", CONV.key(), "w4a8", "cuda"),
          {"bp": 512, "q": 16})
    path = tmp_path / "c.json"
    c.save(str(path))
    rows = audit_cache(str(path))
    assert [r["ok"] for r in rows] == [True, False]
    assert rows[0]["smem_bytes"] > 0 and rows[0]["registers"] is None
    assert any("bp must be" in e for e in rows[1]["errors"])
    summ = summarize_audit(rows)
    assert summ["entries"] == 2 and summ["feasible"] == 1
    assert summ["infeasible"] == [rows[1]["key"]]
    assert audit_cache(None) == []
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(path))
    assert audit_cache() == rows


def test_ops_rejects_an_explicit_infeasible_config(monkeypatch):
    from repro_torch.kernels import ops
    x = torch.zeros((1, 8, 8, 8), dtype=torch.int8)
    w = torch.zeros((3, 3, 8, 8), dtype=torch.int8)
    with pytest.raises(CheckError, match="infeasible schedule") as e:
        ops.conv2d(x, w, requant_shift=5, config={"block_zz": 4})
    assert any("unknown" in m for m in e.value.messages)
    with pytest.raises(CheckError, match="cannot launch"):
        ops.conv2d(x, w, requant_shift=5, config={"bp": 512, "q": 16})
    sig = tune.sig_conv2d(1, 8, 8, 8, 8, 3)
    cfg = dict(tune.default_config("conv2d", sig, "int8"))
    ops.conv2d(x, w, requant_shift=5, config=cfg)
    monkeypatch.setenv(fp_mod.BUDGET_ENV, "1024")
    with pytest.raises(CheckError, match="budget"):
        ops.conv2d(x, w, requant_shift=5, config=cfg)


def test_executor_refuses_a_cached_config_naming_node_and_stage(jplans):
    """A cache entry the verdict refuses raises CheckError at the node's
    first resolution, naming the node, its stage and its signature."""
    plan = _port(jplans["dws", 8])
    node = next(n for n in plan.nodes if n.op == "qconv"
                and n.spec.primitive == "dws")
    h, w = node.attrs["in_hw"]
    sig = tune.sig_depthwise2d(4, h, w, node.spec.in_channels,
                               node.spec.kernel_size)
    c = tune.TuneCache(None)
    c.put(tune.cache_key("depthwise2d", sig.key(), "int8", "cpu"),
          {"pt": 3, "rows": 2})
    tune.set_default_cache(c)
    x = jplans["x"]
    with pytest.raises(CheckError, match="infeasible kernel schedule") as e:
        CompiledPlan(plan, method="cuda", device="cpu").forward_batch(x)
    assert e.value.messages == (
        f"node {node.name!r}, stage 'dw' [depthwise2d/{sig.key()}] "
        "{'pt': 3, 'rows': 2}: pt must be one of (1, 2, 4), got 3",)


# ------------------------------------------------------------ the lint ---

def _lint(tmp_path, src, where=("fixture.py",)):
    p = tmp_path.joinpath(*where)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(src))
    return [f.rule for f in lint_file(str(p))]


def test_lint_flags_sync_in_graph_capture(tmp_path):
    assert _lint(tmp_path, """
        import torch
        def cap(fn, x, g):
            with torch.cuda.graph(g):
                y = fn(x)
                n = int(y.sum().item())
            return y, n
    """) == ["sync-in-graph-capture"]


def test_lint_flags_hidden_fallback(tmp_path):
    src = """
        from . import ref
        def conv(x, w):
            try:
                return conv_kernel(x, w)
            except RuntimeError:
                return conv2d_q8_plain(x, w)
        def pool(x):
            try:
                return pool_kernel(x)
            except RuntimeError:
                return ref.maxpool2d_ref(x)
    """
    where = ("src", "repro_torch", "kernels", "fixture.py")
    assert _lint(tmp_path, src, where) == ["hidden-fallback"] * 2
    assert _lint(tmp_path, src, ("src", "repro_torch", "graph", "f.py")) \
        == ["hidden-fallback"] * 2
    # outside kernels/ and graph/ (a test, a script) a handler may compare
    assert _lint(tmp_path, src, ("scripts", "fixture.py")) == []


def test_lint_flags_wall_clock_elapsed(tmp_path):
    assert _lint(tmp_path, """
        import time
        def f():
            t0 = time.time()
            work()
            return time.time() - t0
    """) == ["wall-clock-elapsed"]


def test_lint_flags_stop_before_sync(tmp_path):
    assert _lint(tmp_path, """
        import time, torch
        def f(x):
            t0 = time.perf_counter()
            y = g(x)
            el = time.perf_counter() - t0
            torch.cuda.synchronize()
            return el, y
    """) == ["timer-stop-before-sync"]
    assert _lint(tmp_path, """
        import time
        def f(x, ev):
            t0 = time.perf_counter()
            y = g(x)
            el = time.perf_counter() - t0
            ev.synchronize()
            return el, y.sum().item()
    """) == ["timer-stop-before-sync"] * 2


def test_lint_clean_patterns_not_flagged(tmp_path):
    assert _lint(tmp_path, """
        import time, torch
        def f(x, g):
            t0 = time.perf_counter()
            y = work(x)
            torch.cuda.synchronize()
            el = time.perf_counter() - t0
            wall = time.time()           # a stamp, not an interval
            with torch.cuda.graph(g):
                z = work(x)
            total = float(z.sum().item())    # after the capture
            return el, wall, total
        def host_only():
            t0 = time.perf_counter()
            wait_for_thread()
            return time.perf_counter() - t0
        def fallback_in_a_test():
            try:
                run()
            except RuntimeError:
                return conv2d_q8_plain()
    """, ("src", "repro_torch", "serve", "fixture.py")) == []


def test_lint_clean_on_the_port():
    """Zero findings over src/repro_torch, chip_smoke.py and
    scripts/torch_*.py."""
    paths = port_paths(ROOT)
    assert ROOT / "scripts" / "torch_check_plan.py" in paths
    assert [str(f) for f in lint_paths(paths)] == []


def test_check_plan_script_strict_on_the_host(capsys):
    """scripts/torch_check_plan.py --strict: every section clean on the
    CPU."""
    spec = importlib.util.spec_from_file_location(
        "torch_check_plan", ROOT / "scripts" / "torch_check_plan.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(["--strict", "--batch", "8"]) == 0
    out = capsys.readouterr().out
    assert "0 error(s), 0 warning(s) [strict]" in out
    assert out.count("min_headroom=") == len(PRIMS) * len(BITS)
    assert "findings=0" in out
    assert os.environ.get("REPRO_TORCH_TUNE_CACHE") is None
