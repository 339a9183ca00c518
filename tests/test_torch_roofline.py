"""The port's roofline count and the card's model on the CPU: each
kernel's work (``roofline.count.kernel_work``) against the bound column of
PERF.md §6, a kernel call counting the same work under ``"cuda"`` and
``"torch"`` with none of its plain version's aten operations, the dot
FLOPs of a tiny dense step against JAX's ``analyze_hlo`` of the same
jitted step, ``H100.roofline_terms``' arithmetic, the dry run's depth
extrapolation against a count at full depth, and a dry run of two small
cells on the fake backend writing the JAX package's record schema.

Tolerances: the §6 bounds are compared at the digits PERF.md prints; the
dot FLOPs within 1% of JAX's (they agree exactly on these steps); every
other number exactly.

Run here with ``PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q
tests/test_torch_roofline.py``."""
import dataclasses
import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.models import api as j_api  # noqa: E402
from repro.roofline.hlo import analyze_hlo  # noqa: E402
from repro.train.train_step import \
    estimate_model_flops as j_model_flops  # noqa: E402

from repro_torch import tune  # noqa: E402
from repro_torch.configs import base as B  # noqa: E402
from repro_torch.core.energy import (H100, H100_PCIE, H100_SXM,  # noqa: E402
                                     h100_for)
from repro_torch.core.quantize import pack_w4  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.models import api, mamba  # noqa: E402
from repro_torch.roofline import count as R  # noqa: E402
from repro_torch.train.train_step import value_and_grad  # noqa: E402

from test_torch_launch import _pair  # noqa: E402

I8, I32, F32, BF16 = torch.int8, torch.int32, torch.float32, torch.bfloat16
BATCH = 256


@pytest.fixture(autouse=True)
def _no_tune_cache():
    tune.set_default_cache(tune.TuneCache(None))
    yield
    tune.reset()


def _t(*shape, dtype=I8):
    return torch.empty(shape, dtype=dtype, device="meta")


def _w4(shape, axis):
    """(packed weights, group shifts) of W4 codes of ``shape`` packed along
    ``axis``, as meta tensors."""
    s = list(shape)
    n, s[axis] = s[axis], -(-s[axis] // 2)
    return _t(*s), _t(n)


def _cnn(kernel, w4=False):
    """Each call of ``kernel`` in the B=256 forward PERF.md §6 times it at
    (the dws plan's convs and pools, the shift and add plans' layers)."""
    calls = []
    if kernel == "conv2d":
        shapes = ((32, 3, 16, 3), (16, 16, 32, 1), (8, 32, 64, 1))
    else:
        shapes = ((32, 3, 16, 3), (16, 16, 32, 3), (8, 32, 64, 3))
    for hw, cx, cy, hk in shapes:
        x, b = _t(BATCH, hw, hw, cx), _t(cy, dtype=I32)
        if w4:
            wp, ws = _w4((hk, hk, cx, cy), 2)
            calls.append((1, (x, wp, b), dict(w_shifts=ws)))
        else:
            calls.append((1, (x, _t(hk, hk, cx, cy), b), {}))
    return calls


def _dw(w4=False):
    calls = []
    for hw, c in ((16, 16), (8, 32)):
        if w4:
            wp, ws = _w4((3, 3, c, 1), 0)
            calls.append((1, (_t(BATCH, hw, hw, c), wp), dict(w_shifts=ws)))
        else:
            calls.append((1, (_t(BATCH, hw, hw, c), _t(3, 3, c, 1)), {}))
    return calls


def _shift(w4=False):
    calls = []
    for hw, c, cy in ((16, 16, 32), (8, 32, 64)):
        args = [_t(BATCH, hw, hw, c), _t(c, 2, dtype=I32)]
        if w4:
            wp, ws = _w4((c, cy), 0)
            calls.append((1, (*args, wp, _t(cy, dtype=I32)),
                          dict(w_shifts=ws)))
        else:
            calls.append((1, (*args, _t(c, cy), _t(cy, dtype=I32)), {}))
    return calls


def _mm(steps, w4=False):
    calls = []
    for n, m, k, nn in steps:
        if w4:
            wp, ws = _w4((k, nn), 0)
            calls.append((n, (_t(m, k), wp), dict(w_shifts=ws)))
        else:
            calls.append((n, (_t(m, k), _t(k, nn)), {}))
    return calls


QWEN2_STEP = ((48, 8, 896, 4864), (24, 8, 4864, 896))
GRANITE_STEP = ((80, 8, 2048, 8192), (40, 8, 8192, 2048))
T2_CONV = ((1, 10, 10, 128, 64, 3, 1), (1, 10, 10, 128, 64, 3, 4),
           (1, 32, 32, 16, 16, 3, 1), (1, 32, 32, 16, 16, 7, 1),
           (1, 8, 8, 16, 16, 3, 1), (1, 32, 32, 32, 32, 3, 1))

#: PERF.md §6's rows: (kernel, its summed calls (count, args, kwargs), the
#: bound column's ms, what binds it, the digits printed)
ROWS = {
    "1": ("conv2d_q8", _cnn("conv2d"), 0.0029, "bytes", 4),
    "1-W4": ("conv2d_w4", _cnn("conv2d", True), 0.0029, "bytes", 4),
    "1-F": ("conv2d_f", [(1, (_t(n, h, w, cx, dtype=F32),
                              _t(hk, hk, cx // g, cy, dtype=F32),
                              _t(cy, dtype=F32)), dict(groups=g))
                         for n, h, w, cx, cy, hk, g in T2_CONV],
            0.00102, "operations", 5),
    "2": ("depthwise2d_q8", _dw(), 0.0009, "bytes", 4),
    "2-W4": ("depthwise2d_w4", _dw(True), 0.0009, "bytes", 4),
    "2-F": ("depthwise2d_f", [(1, (_t(1, 32, 32, 64, dtype=F32),
                                   _t(3, 3, 64, dtype=F32)), {})],
            0.00016, "bytes", 5),
    "3": ("maxpool2d_s8", [(1, (_t(BATCH, hw, hw, c),), {})
                           for hw, c in ((32, 16), (16, 32), (8, 64))],
          0.0027, "bytes", 4),
    "3-F": ("maxpool2d_f", [(1, (_t(8, 32, 32, 64, dtype=F32),), {})],
            0.00078, "bytes", 5),
    "4": ("shift_conv2d_q8", _shift(), 0.0014, "bytes", 4),
    "4-W4": ("shift_conv2d_w4", _shift(True), 0.0014, "bytes", 4),
    "4-F": ("shift_conv2d_f", [(1, (_t(1, 32, 32, 64, dtype=F32),
                                    _t(64, 2, dtype=I32),
                                    _t(64, 64, dtype=F32)), {})],
            0.00016, "bytes", 5),
    "5": ("add_conv2d_q8", _cnn("add_conv2d"), 0.0429, "operations", 4),
    "5-W4": ("add_conv2d_w4", _cnn("add_conv2d", True), 0.0429,
             "operations", 4),
    "5-F": ("add_conv2d_f", [(1, (_t(1, 10, 10, 16, dtype=F32),
                                  _t(3, 3, 16, 16, dtype=F32)), {})],
            0.000014, "operations", 6),
    "6": ("matmul_q8", _mm(QWEN2_STEP), 0.0947, "bytes", 4),
    "6 granite-3-2b": ("matmul_q8", _mm(GRANITE_STEP), 0.6039, "bytes", 4),
    "6-W4": ("matmul_w4", _mm(QWEN2_STEP, True), 0.0479, "bytes", 4),
    "6-W4 granite-3-2b": ("matmul_w4", _mm(GRANITE_STEP, True), 0.3036,
                          "bytes", 4),
    "6-F": ("matmul_f", [(1, (_t(256, 512, dtype=F32),
                              _t(512, 256, dtype=F32)), {}),
                         (1, (_t(512, 512, dtype=F32),
                              _t(512, 512, dtype=F32)), {})],
            0.00501, "operations", 5),
    "7": ("causal_conv1d", [(64, (_t(1, 96, 8192, dtype=BF16),
                                  _t(4, 8192, dtype=BF16)), {})],
          0.0613, "bytes", 4),
}


@pytest.mark.parametrize("row", list(ROWS))
def test_kernel_work_gives_perf_bound_column(row):
    """Each call's bound is the larger of its bytes at 3.35 TB/s and its
    operations at their peak, summed over the row's calls (phase 3's
    arithmetic)."""
    kernel, calls, want, by, digits = ROWS[row]
    card = H100_SXM
    bytes_ms = ops_ms = total = 0.0
    for n, args, kwargs in calls:
        work = R.kernel_work(kernel, *args, **kwargs)
        b = 1e3 * work.nbytes / card.hbm_bps
        o = max(1e3 * v / card.peak(k) for k, v in work.ops.items())
        bytes_ms, ops_ms, total = bytes_ms + n * b, ops_ms + n * o, \
            total + n * max(b, o)
    assert round(total, digits) == want
    assert ("bytes" if bytes_ms >= ops_ms else "operations") == by


def _operands(kernel, rng):
    """Host operands of one small call of ``kernel``'s entry point:
    ``(entry, args, kwargs)``."""
    def i8(*s):
        return torch.from_numpy(rng.integers(-8, 8, s).astype(np.int8))

    def f(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32))

    def packed(shape, axis):
        return pack_w4(i8(*shape), axis), torch.from_numpy(
            rng.integers(0, 5, shape[axis]).astype(np.int8))
    table = torch.from_numpy(np.array([[i % 3 - 1, (i // 3) % 3 - 1]
                                       for i in range(6)], np.int32))
    base, mode = kernel.rsplit("_", 1) if kernel != "causal_conv1d" \
        else (kernel, "f")
    mode = {"s8": "q8"}.get(mode, mode)
    q = dict(requant_shift=4) if mode in ("q8", "w4") else {}
    x = i8(2, 5, 6, 6) if mode != "f" else f(2, 5, 6, 6)
    bias = torch.from_numpy(rng.integers(-50, 50, 4).astype(np.int32)) \
        if mode != "f" else None
    if base == "conv2d":
        if mode == "w4":
            wp, ws = packed((3, 3, 6, 4), 2)
            return base, (x, wp, bias), dict(w_shifts=ws, **q)
        w = i8(3, 3, 6, 4) if mode == "q8" else f(3, 3, 6, 4)
        return base, (x, w, bias), q
    if base == "depthwise2d":
        if mode == "w4":
            wp, ws = packed((3, 3, 6), 0)
            return base, (x, wp), dict(w_shifts=ws, **q)
        return base, (x, i8(3, 3, 6) if mode == "q8" else f(3, 3, 6)), q
    if base == "maxpool2d":
        return base, (x,), dict(window=2)
    if base == "shift_conv2d":
        kw = dict(max_shift=1, **q)
        if mode == "w4":
            wp, ws = packed((6, 4), 0)
            return base, (x, table, wp, bias), dict(w_shifts=ws, **kw)
        return base, (x, table, i8(6, 4) if mode == "q8" else f(6, 4),
                      bias), kw
    if base == "add_conv2d":
        if mode == "w4":
            wp, ws = packed((3, 3, 6, 4), 2)
            return base, (x, wp, bias), dict(w_shifts=ws, **q)
        return base, (x, i8(3, 3, 6, 4) if mode == "q8" else f(3, 3, 6, 4),
                      bias), q
    if base == "matmul":
        a = i8(5, 12) if mode != "f" else f(5, 12)
        if mode == "w4":
            wp, ws = packed((12, 7), 0)
            return base, (a, wp), dict(w_shifts=ws, **q)
        return base, (a, i8(12, 7) if mode == "q8" else f(12, 7)), q
    return base, (f(2, 9, 8), f(4, 8)), {}


@pytest.mark.parametrize("kernel", R.KERNELS)
def test_a_call_counts_its_kernel_work_under_either_method(kernel):
    """The same work under "cuda" (on host tensors: the wrapper's plain
    version) and "torch" (the JAX-facing oracle), exactly the kernel's:
    no aten FLOP of either plain version leaks into the count."""
    entry, args, kwargs = _operands(kernel, np.random.default_rng(0))
    want = R.kernel_work(kernel, *args, **kwargs)
    seen = []
    for method in ("cuda", "torch"):
        with R.counting() as c:
            getattr(ops, entry)(*args, method=method, **kwargs)
        assert dict(c.calls) == {kernel: 1}
        assert c.flops == want.ops and c.kernel_bytes == want.nbytes
        seen.append(c.flops)
    assert seen[0] == seen[1]


def test_causal_conv1d_backward_counts_its_dx_call():
    x = torch.randn(2, 9, 8, requires_grad=True)
    w = torch.randn(4, 8, requires_grad=True)
    for method in ("cuda", "torch"):
        with R.counting() as c:
            ops.causal_conv1d(x, w, method=method).sum().backward()
        assert c.calls == {"causal_conv1d": 2}    # forward and dx
        assert c.flops["f32"] >= 2 * R.kernel_work(
            "causal_conv1d", x, w).ops["f32"]


def test_force_method_runs_plain_versions_on_meta():
    x, w = _t(1, 32, 8, dtype=BF16), _t(4, 8, dtype=BF16)
    with pytest.raises(Exception):
        ops.causal_conv1d(x, w, method="cuda")
    with ops.force_method("torch"), R.counting() as c:
        y = ops.causal_conv1d(x, w, method="cuda")
    assert y.shape == x.shape and y.device.type == "meta"
    assert c.flops == R.kernel_work("causal_conv1d", x, w).ops
    with pytest.raises(ValueError):
        with ops.force_method("xla"):
            pass


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "granite-moe-1b-a400m"])
@pytest.mark.parametrize("grad", [False, True], ids=["loss", "grad"])
def test_dense_step_dot_flops_match_jax_analyze_hlo(arch, grad):
    jcfg, cfg = _pair(arch)
    b, s = 2, 32
    jf = j_api.loss_fn(jcfg, attn_impl="full", remat="none")
    jfn = jax.value_and_grad(jf) if grad else jf
    want = analyze_hlo(jax.jit(jfn).lower(
        j_api.param_structs(jcfg),
        {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}
    ).compile().as_text())["dot_flops"]
    fn = api.loss_fn(cfg, attn_impl="full", remat="none")
    with R.counting() as c:
        (value_and_grad(fn) if grad else fn)(
            api.param_structs(cfg),
            {"tokens": torch.empty((b, s), dtype=I32, device="meta")})
    assert c.total == pytest.approx(want, rel=0.01)


def test_h100_roofline_terms_and_energy():
    card = H100()
    assert card == H100_SXM and h100_for("NVIDIA H100 80GB HBM3") is H100_SXM
    assert h100_for("NVIDIA H100 PCIe") is H100_PCIE
    assert card.f32_fma_flops == 2 * 132 * 128 * 1.98e9
    assert card.int32_ops == 132 * 64 * 1.98e9
    terms = card.roofline_terms({"bf16": 989e12, "int8": 1979e12 / 2,
                                 "f32": card.f32_fma_flops * 3}, 3.35e12 * 2)
    assert terms == {"memory_s": 2.0, "bf16_s": 1.0, "int8_s": 0.5,
                     "f32_s": 3.0}
    with pytest.raises(KeyError):
        card.peak("fp8")
    assert card.energy_j(0.5, 700.0) == 350.0
    rep = R.report({"bf16": 989e12 * 0.2}, 3.35e12 * 0.1, device_s=0.4)
    assert rep["binding"] == "bf16_s" and rep["share"] == pytest.approx(0.5)


def test_step_report_bytes_floor():
    a, w = torch.randn(4, 8), torch.randn(8, 3)
    rep = R.step_report(lambda x, y: (x @ y, x), a, w, device="cpu")
    # the arguments, then the outputs (the product and a again)
    assert rep["bytes_floor"] == 4 * (32 + 24) + 4 * (12 + 32)
    assert rep["flops"] == {"f32": 2 * 4 * 8 * 3}


def test_whole_sequence_scan_counts_the_same_matmuls():
    g = torch.Generator().manual_seed(0)
    args = [torch.randn(s, generator=g) for s in
            ((2, 64, 8), (2, 64, 8), (8, 4), (2, 64, 4), (2, 64, 4))]
    args[1] = torch.nn.functional.softplus(args[1])
    args[2] = -torch.exp(args[2])
    with R.counting() as c1:
        y1, h1 = mamba.mamba_scan(*args, chunk=16)
    with mamba.whole_sequence_scans(), R.counting() as c2:
        y2, h2 = mamba.mamba_scan(*args, chunk=16)
    assert c1.flops == c2.flops
    torch.testing.assert_close(y1, y2, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h1, h2, rtol=1e-5, atol=1e-5)


@pytest.fixture
def tiny_shapes(monkeypatch):
    """Small shapes of every kind beside the production ones."""
    shapes = dict(B.SHAPES, **{
        "tiny_train": B.ShapeConfig("tiny_train", 64, 8, "train"),
        # encdec prefills a 128-token prompt
        "tiny_prefill": B.ShapeConfig("tiny_prefill", 256, 2, "prefill"),
        "tiny_decode": B.ShapeConfig("tiny_decode", 64, 8, "decode")})
    monkeypatch.setattr(D, "SHAPES", shapes)
    monkeypatch.setenv("REPRO_MICROBATCHES", "1")
    import torch.distributed as dist
    D.fake_world(256)
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "jamba-v0.1-52b",
                                  "seamless-m4t-large-v2"])
def test_depth_extrapolation_equals_a_full_count(tiny_shapes, arch):
    """The dry run counts one and two layers (super-blocks; encdec: of each
    stack) and extrapolates: equal to counting every layer."""
    mesh = D.make_production_mesh(device_type="cpu")
    cfg = dataclasses.replace(_pair(arch)[1], name=arch)
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, n_layers=24)
    elif cfg.family == "encdec":
        cfg = dataclasses.replace(cfg, n_layers=4, n_encoder_layers=3)
    else:
        cfg = dataclasses.replace(cfg, n_layers=5)
    for shape in ("tiny_train", "tiny_prefill", "tiny_decode"):
        points = []
        for d in D._depths(cfg):
            small = dataclasses.replace(cfg, **d)
            fn, args, *_ = D.build_cell(arch, shape, mesh, cfg=small)
            points.append(D.count_step(fn, args)[1].flops)
        kinds = sorted(points[0])
        got = D._extrapolate(cfg, [[p[k] for k in kinds] for p in points])
        fn, args, *_ = D.build_cell(arch, shape, mesh, cfg=cfg)
        full = D.count_step(fn, args)[1].flops
        assert dict(zip(kinds, got)) == full, shape


def test_dry_run_writes_jax_schema_records(tmp_path, monkeypatch):
    for k in [k for k in os.environ if k.startswith("REPRO_")]:
        monkeypatch.delenv(k)
    import torch.distributed as dist
    try:
        D.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                "--out", str(tmp_path), "--mem-limit-gb", "0"])
        D.main(["--arch", "qwen2-0.5b", "--shape", "long_500k",
                "--out", str(tmp_path), "--multi-pod", "single",
                "--mem-limit-gb", "0"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["qwen2-0.5b__decode_32k__16x16__baseline.json",
                     "qwen2-0.5b__decode_32k__2x16x16__baseline.json",
                     "qwen2-0.5b__long_500k__16x16__baseline.json"]
    skipped = json.loads((tmp_path / names[2]).read_text())
    assert skipped["status"] == "skipped" and "long_500k" in skipped["reason"]
    jcfg = __import__("repro.configs.base", fromlist=["get_config"]) \
        .get_config("qwen2-0.5b")
    for name, chips in zip(names[:2], (256, 512)):
        rec = json.loads((tmp_path / name).read_text())
        assert rec["status"] == "ok", rec.get("error")
        assert {"arch", "shape", "mesh", "tag", "status", "memory",
                "model_flops", "n_chips", "tokens", "rules",
                "dot_flops_global", "flops_by_kind"} <= set(rec)
        assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                      "alias_bytes"}
        assert rec["n_chips"] == chips and rec["tokens"] == 128
        assert rec["model_flops"] == j_model_flops(jcfg, 128, "serve")
        assert 0 < rec["memory"]["alias_bytes"] \
            < rec["memory"]["argument_bytes"]
        assert math.isclose(rec["dot_flops_global"],
                            sum(rec["flops_by_kind"].values()))
        assert rec["dot_flops_global"] > rec["model_flops"] / 2
