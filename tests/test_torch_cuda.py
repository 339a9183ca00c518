"""The CUDA kernels against their plain PyTorch versions, bit for bit, on
the card. Marked ``cuda``: they skip on a host with no card. They import
no JAX, so they run on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _i8(rng, shape, dev):
    return torch.from_numpy(rng.integers(-128, 128, shape)
                            .astype(np.int8)).to(dev)


@pytest.mark.parametrize("case", [
    (4, 32, 32, 3, 16, 3, 1, True, "relu", 7),
    (4, 16, 16, 16, 32, 1, 1, True, "relu", 9),
    (3, 9, 9, 8, 12, 3, 2, False, None, -2),
    (2, 15, 13, 3, 8, 3, 1, True, None, 0),
    (2, 6, 7, 4, 8, 2, 1, False, "relu", 1),
], ids=str)
def test_conv2d_q8_kernel_equals_plain(dev, case):
    from repro_torch.kernels import conv2d_q8, conv2d_q8_plain
    n, h, w, cx, cy, hk, g, with_bias, act, shift = case
    rng = np.random.default_rng(0)
    x, wt = _i8(rng, (n, h, w, cx), dev), _i8(rng, (hk, hk, cx // g, cy), dev)
    b = (torch.from_numpy(rng.integers(-5000, 5000, cy).astype(np.int32))
         .to(dev) if with_bias else None)
    before = conv2d_q8.launches
    got = conv2d_q8(x, wt, b, groups=g, requant_shift=shift, act=act)
    torch.cuda.synchronize()
    assert conv2d_q8.launches == before + 1
    want = conv2d_q8_plain(x, wt, b, groups=g, requant_shift=shift, act=act)
    assert torch.equal(got, want)


@pytest.mark.parametrize("layout4", [False, True])
@pytest.mark.parametrize("shift,act", [(-2, None), (0, "relu"), (1, None),
                                       (7, "relu")])
def test_depthwise2d_q8_kernel_equals_plain(dev, shift, act, layout4):
    from repro_torch.kernels import depthwise2d_q8, depthwise2d_q8_plain
    rng = np.random.default_rng(1)
    x, wt = _i8(rng, (4, 16, 15, 16), dev), _i8(rng, (3, 3, 16), dev)
    if layout4:
        wt = wt[..., None].contiguous()
    got = depthwise2d_q8(x, wt, requant_shift=shift, act=act)
    torch.cuda.synchronize()
    assert torch.equal(got, depthwise2d_q8_plain(x, wt, requant_shift=shift,
                                                 act=act))


@pytest.mark.parametrize("window,stride", [(2, 2), (3, 1), (3, 2)])
def test_maxpool2d_s8_kernel_equals_plain(dev, window, stride):
    from repro_torch.kernels import maxpool2d_plain, maxpool2d_s8
    x = _i8(np.random.default_rng(2), (4, 17, 16, 32), dev)
    got = maxpool2d_s8(x, window=window, stride=stride)
    torch.cuda.synchronize()
    assert torch.equal(got, maxpool2d_plain(x, window=window, stride=stride))


@pytest.mark.parametrize("c", [16, 32, 64, 19])
@pytest.mark.parametrize("window,stride", [(2, 2), (3, 2), (2, 1)])
@pytest.mark.parametrize("offset", [0, 16, 1])
def test_maxpool2d_s8_vector_and_scalar_paths(dev, c, window, stride,
                                              offset):
    """The 16-channel vector path (C a multiple of 16, x aligned; an
    offset of 16 bytes keeps it) and the scalar path (C = 19, or x at an
    odd address) equal the plain version, -128 and 127 included."""
    from repro_torch.kernels import maxpool2d_plain, maxpool2d_s8
    rng = np.random.default_rng(30)
    x = _i8(rng, (3, 11, 10, c), dev)
    x.view(-1)[::7] = -128
    x.view(-1)[3::11] = 127
    if offset:
        buf = torch.zeros(x.numel() + offset, dtype=torch.int8, device=dev)
        view = buf[offset:].view(x.shape)
        view.copy_(x)
        x = view
    before = maxpool2d_s8.launches
    got = maxpool2d_s8(x, window=window, stride=stride)
    torch.cuda.synchronize()
    assert maxpool2d_s8.launches == before + 1
    assert torch.equal(got, maxpool2d_plain(x, window=window, stride=stride))


def test_pool_plan_equals_the_source(dev):
    """pool_plan's vector/scalar choice and grid equal the source's."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels.pool import pool_plan
    lib = _build.library()
    for n, ho, wo, c in [(256, 16, 16, 16), (256, 8, 8, 32), (256, 4, 4, 64),
                         (2, 7, 6, 19), (3, 5, 4, 33), (1, 1, 1, 16)]:
        for aligned in (0, 1):
            for threads in (64, 256, 1024):
                out = (ctypes.c_int * 3)()
                assert lib.repro_maxpool2d_s8_plan(out, n, ho, wo, c, aligned,
                                                   threads) == 0
                p = pool_plan(n, ho, wo, c, aligned, threads)
                assert list(out) == [p["blocks"], p["threads"],
                                     int(p["vector"])]
    out = (ctypes.c_int * 3)()
    assert lib.repro_maxpool2d_s8_plan(out, 1, 2, 2, 16, 1, 48) != 0


def _grid(c, d):
    grid = [(a, b) for a in range(-d, d + 1) for b in range(-d, d + 1)]
    return np.array([grid[i % len(grid)] for i in range(c)], np.int32)


@pytest.mark.parametrize("case", [
    (4, 16, 16, 16, 32, 1, True, "relu", 7),
    (3, 9, 7, 12, 8, 2, False, None, -2),
    (2, 8, 8, 32, 64, 1, True, None, 0),
], ids=str)
def test_shift_conv2d_q8_kernel_equals_plain(dev, case):
    from repro_torch.kernels import shift_conv2d_q8, shift_conv2d_q8_plain
    n, h, w, c, cy, d, with_bias, act, shift = case
    rng = np.random.default_rng(3)
    x, wt = _i8(rng, (n, h, w, c), dev), _i8(rng, (c, cy), dev)
    table = torch.from_numpy(_grid(c, d)).to(dev)
    b = (torch.from_numpy(rng.integers(-5000, 5000, cy).astype(np.int32))
         .to(dev) if with_bias else None)
    kw = dict(requant_shift=shift, act=act, max_shift=d)
    before = shift_conv2d_q8.launches
    got = shift_conv2d_q8(x, table, wt, b, **kw)
    torch.cuda.synchronize()
    assert shift_conv2d_q8.launches == before + 1
    assert torch.equal(got, shift_conv2d_q8_plain(x, table, wt, b, **kw))


@pytest.mark.parametrize("case", [
    (4, 16, 16, 3, 16, 3, 0, 0, True, "relu", 7),
    (3, 9, 7, 16, 8, 3, 0, 3, False, None, 9),
    (2, 8, 8, 8, 16, 3, 2, 0, True, None, 1),
    (2, 6, 7, 4, 8, 2, 0, 0, False, "relu", -2),
    (2, 5, 5, 8, 8, 3, 28, 20, True, None, 24),
], ids=str)
def test_add_conv2d_q8_kernel_equals_plain(dev, case):
    from repro_torch.kernels import add_conv2d_q8, add_conv2d_q8_plain
    n, h, w, cx, cy, hk, xp, wp, with_bias, act, shift = case
    rng = np.random.default_rng(4)
    x, wt = _i8(rng, (n, h, w, cx), dev), _i8(rng, (hk, hk, cx, cy), dev)
    b = (torch.from_numpy(rng.integers(-5000, 5000, cy).astype(np.int32))
         .to(dev) if with_bias else None)
    kw = dict(requant_shift=shift, x_preshift=xp, w_preshift=wp, act=act)
    before = add_conv2d_q8.launches
    got = add_conv2d_q8(x, wt, b, **kw)
    torch.cuda.synchronize()
    assert add_conv2d_q8.launches == before + 1
    assert torch.equal(got, add_conv2d_q8_plain(x, wt, b, **kw))


def _w4(rng, shape, axis, dev, all_max=False):
    """Random packed int4 codes (-8 and +7 included) along ``axis`` and
    group shifts in [0, 4] (all 4 with ``all_max``), on the card."""
    from repro_torch.core.quantize import pack_w4
    q = rng.integers(-8, 8, shape).astype(np.int8)
    q.flat[0], q.flat[-1] = -8, 7
    n = shape[axis]
    ws = (np.full(n, 4) if all_max else rng.integers(0, 5, n)).astype(np.int8)
    return (pack_w4(torch.from_numpy(q), axis).contiguous().to(dev),
            torch.from_numpy(ws).to(dev))


@pytest.mark.parametrize("case", [
    (4, 32, 32, 3, 16, 3, 1, True, "relu", 7, False),
    (4, 16, 16, 16, 32, 1, 1, True, "relu", 9, True),
    (3, 9, 9, 12, 12, 3, 3, False, None, -2, False),
    (2, 6, 7, 5, 8, 2, 1, False, "relu", 1, False),
], ids=str)
def test_conv2d_w4_kernel_equals_plain(dev, case):
    from repro_torch.kernels import conv2d_w4, conv2d_w4_plain
    n, h, w, cx, cy, hk, g, with_bias, act, shift, all_max = case
    rng = np.random.default_rng(5)
    x = _i8(rng, (n, h, w, cx), dev)
    wp, ws = _w4(rng, (hk, hk, cx // g, cy), 2, dev, all_max)
    b = (torch.from_numpy(rng.integers(-5000, 5000, cy).astype(np.int32))
         .to(dev) if with_bias else None)
    kw = dict(groups=g, requant_shift=shift, act=act)
    before = conv2d_w4.launches
    got = conv2d_w4(x, wp, ws, b, **kw)
    torch.cuda.synchronize()
    assert conv2d_w4.launches == before + 1
    assert torch.equal(got, conv2d_w4_plain(x, wp, ws, b, **kw))


@pytest.mark.parametrize("hk", [1, 2, 3, 5])
def test_depthwise2d_w4_kernel_equals_plain(dev, hk):
    from repro_torch.kernels import depthwise2d_w4, depthwise2d_w4_plain
    rng = np.random.default_rng(6)
    x = _i8(rng, (4, 16, 15, 16), dev)
    wp, ws = _w4(rng, (hk, hk, 16), 0, dev, all_max=hk == 5)
    got = depthwise2d_w4(x, wp, ws, requant_shift=5, act="relu")
    torch.cuda.synchronize()
    assert torch.equal(got, depthwise2d_w4_plain(x, wp, ws, requant_shift=5,
                                                 act="relu"))


@pytest.mark.parametrize("c,cy,d", [(16, 32, 1), (7, 8, 2), (32, 64, 1)])
def test_shift_conv2d_w4_kernel_equals_plain(dev, c, cy, d):
    from repro_torch.kernels import shift_conv2d_w4, shift_conv2d_w4_plain
    rng = np.random.default_rng(7)
    x = _i8(rng, (3, 9, 8, c), dev)
    wp, ws = _w4(rng, (c, cy), 0, dev, all_max=c == 7)
    table = torch.from_numpy(_grid(c, d)).to(dev)
    b = torch.from_numpy(rng.integers(-5000, 5000, cy).astype(np.int32)) \
        .to(dev)
    kw = dict(requant_shift=7, act="relu", max_shift=d)
    got = shift_conv2d_w4(x, table, wp, ws, b, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, shift_conv2d_w4_plain(x, table, wp, ws, b, **kw))


@pytest.mark.parametrize("case", [
    (4, 16, 16, 3, 16, 3, 0, 3, True, "relu", 9, False),
    (3, 9, 7, 16, 8, 3, 2, 0, False, None, 9, True),
    (2, 5, 5, 5, 8, 3, 28, 20, True, None, 24, False),
    (2, 6, 7, 4, 8, 2, 0, 0, False, "relu", -2, True),
], ids=str)
def test_add_conv2d_w4_kernel_equals_plain(dev, case):
    from repro_torch.kernels import add_conv2d_w4, add_conv2d_w4_plain
    n, h, w, cx, cy, hk, xp, wp_, with_bias, act, shift, all_max = case
    rng = np.random.default_rng(8)
    x = _i8(rng, (n, h, w, cx), dev)
    wp, ws = _w4(rng, (hk, hk, cx, cy), 2, dev, all_max)
    b = (torch.from_numpy(rng.integers(-5000, 5000, cy).astype(np.int32))
         .to(dev) if with_bias else None)
    kw = dict(requant_shift=shift, x_preshift=xp, w_preshift=wp_, act=act)
    before = add_conv2d_w4.launches
    got = add_conv2d_w4(x, wp, ws, b, **kw)
    torch.cuda.synchronize()
    assert add_conv2d_w4.launches == before + 1
    assert torch.equal(got, add_conv2d_w4_plain(x, wp, ws, b, **kw))


@pytest.mark.parametrize("prim", ["dws", "add"])
def test_w4_plan_cuda_trunk_equals_torch_trunk(dev, prim):
    """A W4 plan lowered on the card: the cuda trunk equals the torch trunk
    bit for bit, and its forward launches W4 kernels only."""
    from repro_torch import kernels
    from repro_torch.graph import CompiledPlan, build_cnn_graph, lower
    from repro_torch.models import CNNConfig, init_cnn
    cfg = CNNConfig(primitive=prim, widths=(8, 12), image_size=16)
    params = init_cnn(cfg, torch.Generator().manual_seed(0), device=dev)
    rng = np.random.default_rng(9)
    calib = torch.from_numpy((rng.standard_normal((8, 16, 16, 3)) * 0.5)
                             .astype(np.float32)).to(dev)
    plan = lower(build_cnn_graph(cfg), params, calib, weight_bits=4,
                 group_size=8)
    x = (rng.standard_normal((6, 16, 16, 3)) * 0.5).astype(np.float32)
    kernels.reset_launches()
    tc = CompiledPlan(plan, method="cuda", device=dev).trunk(x)
    launched = {k.__name__ for k in kernels.KERNELS if k.launches}
    tt = CompiledPlan(plan, method="torch", device=dev).trunk(x)
    assert torch.equal(tc.q, tt.q)
    assert not any(name.endswith("_q8") for name in launched), launched
    assert any(name.endswith("_w4") for name in launched), launched


MATMUL_SHAPES = [(8, 896, 4864), (8, 4864, 896), (64, 896, 4864),
                 (1, 896, 4864), (16, 896, 4864), (17, 896, 100),
                 (32, 896, 4864), (128, 896, 4864), (64, 4864, 896),
                 (5, 45, 37), (13, 33, 37), (70, 128, 64), (1, 1, 1)]


@pytest.mark.parametrize("shape", MATMUL_SHAPES, ids=str)
@pytest.mark.parametrize("shift,act", [(-2, None), (7, "relu"),
                                       (12, None)])
def test_matmul_q8_kernel_equals_plain(dev, shape, shift, act):
    from repro_torch.kernels import matmul_q8, matmul_q8_plain
    m, k, n = shape
    rng = np.random.default_rng(10)
    a, b = _i8(rng, (m, k), dev), _i8(rng, (k, n), dev)
    before = matmul_q8.launches
    got = matmul_q8(a, b, requant_shift=shift, act=act)
    torch.cuda.synchronize()
    assert matmul_q8.launches == before + 1
    assert torch.equal(got, matmul_q8_plain(a, b, requant_shift=shift,
                                            act=act))


@pytest.mark.parametrize("shape", MATMUL_SHAPES, ids=str)
@pytest.mark.parametrize("all_max", [False, True])
def test_matmul_w4_kernel_equals_plain(dev, shape, all_max):
    from repro_torch.kernels import matmul_w4, matmul_w4_plain
    m, k, n = shape
    rng = np.random.default_rng(11)
    a = _i8(rng, (m, k), dev)
    wp, ws = _w4(rng, (k, n), 0, dev, all_max)
    before = matmul_w4.launches
    got = matmul_w4(a, wp, ws, requant_shift=9, act="relu")
    torch.cuda.synchronize()
    assert matmul_w4.launches == before + 1
    assert torch.equal(got, matmul_w4_plain(a, wp, ws, requant_shift=9,
                                            act="relu"))


@pytest.mark.parametrize("w4", [False, True], ids=["q8", "w4"])
@pytest.mark.parametrize("m,k,n", [(8, 896, 4864), (8, 4864, 896),
                                   (20, 100, 48), (9, 45, 37)], ids=str)
@pytest.mark.parametrize("offset", [1, 4, 16])
def test_matmul_operands_at_an_offset(dev, w4, m, k, n, offset):
    """a, b (and W4's shifts) at an offset from a 16-byte boundary are
    staged byte by byte (16: the copies stay), with the same result."""
    from repro_torch.kernels import (matmul_q8, matmul_q8_plain, matmul_w4,
                                     matmul_w4_plain)
    rng = np.random.default_rng(31)

    def at(t):
        buf = torch.zeros(t.numel() + offset, dtype=t.dtype, device=dev)
        view = buf[offset:].view(t.shape)
        view.copy_(t)
        return view
    a = at(_i8(rng, (m, k), dev))
    if w4:
        wp, ws = (at(t) for t in _w4(rng, (k, n), 0, dev))
        got = matmul_w4(a, wp, ws, requant_shift=10, act="relu")
        want = matmul_w4_plain(a, wp, ws, requant_shift=10, act="relu")
    else:
        b = at(_i8(rng, (k, n), dev))
        got = matmul_q8(a, b, requant_shift=12)
        want = matmul_q8_plain(a, b, requant_shift=12)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("w4", [False, True], ids=["q8", "w4"])
@pytest.mark.parametrize("shape", [(8, 896, 4864), (8, 4864, 896)], ids=str)
def test_matmul_decode_candidates_equal_the_default(dev, w4, shape):
    """Every tuner candidate of Qwen2-0.5B's decode shapes (every tile and
    cluster size) is bitwise equal to the default config's output, at
    requant shifts -2 and 16 (W4: every group shift at 4, nibbles -8 and
    +7)."""
    from repro_torch import tune
    from repro_torch.kernels import matmul_q8, matmul_w4
    m, k, n = shape
    rng = np.random.default_rng(32)
    a = _i8(rng, (m, k), dev)
    if w4:
        wp, ws = _w4(rng, (k, n), 0, dev, all_max=True)
        call = lambda **c: matmul_w4(a, wp, ws, **c)      # noqa: E731
    else:
        b = _i8(rng, (k, n), dev)
        call = lambda **c: matmul_q8(a, b, **c)           # noqa: E731
    sig, dt = tune.sig_matmul(*shape), "w4a8" if w4 else "int8"
    cands = list(tune.candidates(sig, dt))
    assert len(cands) >= 2, cands
    for shift in (-2, 16):
        want = call(requant_shift=shift,
                    **tune.default_config("matmul", sig, dt))
        for cfg in cands:
            got = call(requant_shift=shift, **cfg)
            torch.cuda.synchronize()
            assert torch.equal(got, want), cfg


def test_matmul_launch_arithmetic_equals_the_source(dev):
    """mmq_plan, which the tuner's footprint check reads, equals the
    integer source's launch arithmetic at every tile and cluster size."""
    import ctypes
    import importlib
    from repro_torch.kernels import _build
    mq = importlib.import_module("repro_torch.kernels.matmul_q8")
    lib = _build.library()
    for m, k, n in [(8, 896, 4864), (8, 4864, 896), (128, 896, 4864),
                    (64, 4864, 896), (5, 45, 37), (1, 1, 1)]:
        for bn, bm in mq.MMQ_TILES:
            for cs in mq.MMQ_CLUSTERS:
                for w4 in (0, 1):
                    c = (ctypes.c_int * 7)()
                    assert lib.repro_matmul_q8_plan(c, m, k, n, bn, bm, cs,
                                                    w4) == 0
                    p = mq.mmq_plan(m, k, n, bn, bm, cs, bool(w4))
                    assert list(c) == [*p["grid"], p["cluster"],
                                       p["threads"], p["smem"],
                                       p["stages"], p["ring"]], \
                        (bn, bm, cs, w4)
    c = (ctypes.c_int * 7)()
    assert lib.repro_matmul_q8_plan(c, 8, 64, 64, 48, 8, 1, 0) != 0
    assert lib.repro_matmul_q8_plan(c, 8, 64, 64, 32, 8, 16, 0) != 0


def test_matmul_q8_unaligned_a_takes_the_bytewise_path(dev):
    """A contiguous ``a`` that starts off a 4-byte boundary is read byte by
    byte, with the same result."""
    from repro_torch.kernels import matmul_q8, matmul_q8_plain
    rng = np.random.default_rng(12)
    buf = _i8(rng, (8 * 64 + 1,), dev)
    a = buf[1:].view(8, 64)
    b = _i8(rng, (64, 96), dev)
    got = matmul_q8(a, b, requant_shift=8)
    torch.cuda.synchronize()
    assert torch.equal(got, matmul_q8_plain(a, b, requant_shift=8))


@pytest.mark.parametrize("precision", ["int8", "w4a8"])
def test_engine_kernel_streams_equal_plain_streams(dev, precision):
    """A tiny Qwen2 served on the card: the kernel precision's greedy
    token streams equal the plain versions', and the FFN launched only
    its own matmul kernel."""
    import dataclasses
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serve import Engine, Request, ServeConfig
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), n_layers=2,
                              d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
                              vocab=96)
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, 96, (n,)).astype(np.int32)
               for n in (5, 19, 9, 3)]
    streams = {}
    for prec in (precision, precision + "-torch"):
        eng = Engine(cfg, params, ServeConfig(max_batch=2, max_len=48,
                                              precision=prec))
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=6))
        kernels.reset_launches()
        done = sorted(eng.run_until_drained(), key=lambda r: r.uid)
        assert [r.status for r in done] == ["ok"] * 4
        streams[prec] = [r.out_tokens for r in done]
        launched = {k.__name__: k.launches for k in kernels.KERNELS
                    if k.launches}
        st = eng.stats
        calls = 3 * cfg.n_layers * (st["prefills"] + st["decode_steps"])
        want = {} if prec.endswith("-torch") else {
            "matmul_q8" if precision == "int8" else "matmul_w4": calls}
        assert launched == want
    assert streams[precision] == streams[precision + "-torch"]


def _bits(t):
    """A float tensor's bit pattern, for bitwise comparison."""
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _f(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) \
        .to(dev).to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 16, 8192), (1, 33, 8192),
                                   (2, 70, 100), (1, 2, 100), (3, 1, 64)],
                         ids=str)
@pytest.mark.parametrize("k,act", [(1, None), (2, "relu"), (4, None),
                                   (4, "relu")])
def test_causal_conv1d_kernel_equals_plain(dev, dtype, shape, k, act):
    from repro_torch.kernels import causal_conv1d, causal_conv1d_plain
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(14)
    x = _f(rng, shape, dt, dev)
    w = _f(rng, (k, shape[2]), dt, dev)
    before = causal_conv1d.launches
    got = causal_conv1d(x, w, act=act)
    torch.cuda.synchronize()
    assert causal_conv1d.launches == before + 1
    assert got.dtype == dt and got.shape == x.shape
    assert torch.equal(_bits(got), _bits(causal_conv1d_plain(x, w, act=act)))


def test_causal_conv1d_takes_k1d_weights_and_rejects_bad_operands(dev):
    from repro_torch.kernels import causal_conv1d, causal_conv1d_plain
    rng = np.random.default_rng(15)
    x = _f(rng, (2, 40, 96), torch.bfloat16, dev)
    w = _f(rng, (4, 1, 96), torch.bfloat16, dev)
    got = causal_conv1d(x, w)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(causal_conv1d_plain(x, w)))
    # x's rows may lie apart, but not its channels, and its batch rows
    # must follow its rows; w must be contiguous
    with pytest.raises(ValueError, match="rows end to end"):
        causal_conv1d(x.transpose(0, 1).contiguous().transpose(0, 1), w)
    with pytest.raises(ValueError, match="channel stride"):
        causal_conv1d(_f(rng, (2, 40, 192), torch.bfloat16, dev)[..., ::2],
                      w)
    with pytest.raises(ValueError, match="contiguous"):
        causal_conv1d(x, _f(rng, (96, 4), torch.bfloat16, dev).t())
    with pytest.raises(TypeError):
        causal_conv1d(x, w.float())
    with pytest.raises(TypeError):
        causal_conv1d(x.half(), w.half())
    with pytest.raises(ValueError, match="K <= 8"):
        causal_conv1d(x, _f(rng, (9, 96), torch.bfloat16, dev))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv1d_backward_on_the_card(dev, dtype):
    """dx is the kernel on the flipped gradient, bitwise equal to
    flip-plain-flip; dw the plain float32 reduction; both within 1e-5
    (float32) of autograd through the plain version."""
    from repro_torch.kernels import causal_conv1d, causal_conv1d_plain, ops
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(16)
    x = _f(rng, (2, 50, 256), dt, dev).requires_grad_()
    w = _f(rng, (4, 256), dt, dev).requires_grad_()
    g = _f(rng, (2, 50, 256), dt, dev)
    before = causal_conv1d.launches
    gx, gw = torch.autograd.grad(ops.causal_conv1d(x, w), (x, w), g)
    torch.cuda.synchronize()
    assert causal_conv1d.launches == before + 2
    want_dx = torch.flip(causal_conv1d_plain(torch.flip(g, [1]), w.detach()),
                         [1])
    assert torch.equal(_bits(gx), _bits(want_dx))
    px, pw = torch.autograd.grad(ops.causal_conv1d(x, w, method="torch"),
                                 (x, w), g)
    assert torch.equal(_bits(gx), _bits(px))
    assert torch.equal(_bits(gw), _bits(pw))
    if dt == torch.float32:
        ax, aw = torch.autograd.grad(causal_conv1d_plain(x, w), (x, w), g)
        for got, want in ((gx, ax), (gw, aw)):
            scale = max(1.0, float(want.abs().max()))
            assert float((got - want).abs().max()) <= 1e-5 * scale


def _c1d_x(rng, shape, dtype, dev, layout):
    """x of ``shape`` laid out as ``layout``: "contiguous", "in_proj" (the
    x half of a (B, L, 2D) product, read in place), or "offset" (x at an
    address one element past a 16-byte boundary)."""
    b, l, d = shape
    if layout == "in_proj":
        return _f(rng, (b, l, 2 * d), dtype, dev).chunk(2, dim=-1)[0]
    x = _f(rng, shape, dtype, dev)
    if layout == "offset":
        buf = torch.zeros(x.numel() + 1, dtype=dtype, device=dev)
        view = buf[1:].view(shape)
        view.copy_(x)
        return view
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,layout,vector", [
    ((1, 96, 8192), "contiguous", True),
    ((1, 96, 8192), "in_proj", True),
    ((2, 37, 256), "in_proj", True),
    ((1, 96, 8192), "offset", False),
    ((2, 3, 64), "contiguous", True),        # L < K
    ((3, 45, 100), "in_proj", None),         # bf16: 200 bytes, scalar
    ((1, 20, 8196), "contiguous", None),     # bf16: 16,392 bytes, scalar
], ids=str)
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_causal_conv1d_vector_and_scalar_paths(dev, dtype, shape, layout,
                                               vector, k):
    """Both paths of the kernel bitwise equal to the plain version, on a
    contiguous x, the in_proj view and x at an odd address, K = 1, 2, 4
    and 8, L < K, relu on; the path taken is the plan's (vector None: by
    D * elsize)."""
    from repro_torch.kernels import causal_conv1d, causal_conv1d_plain
    from repro_torch.kernels.conv1d_causal import c1d_plan, row_stride
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(40 + k)
    x = _c1d_x(rng, shape, dt, dev, layout)
    w = _f(rng, (k, shape[2]), dt, dev)
    es = x.element_size()
    aligned = x.data_ptr() % 16 == 0 and row_stride("t", x) * es % 16 == 0
    plan = c1d_plan(*shape, es, aligned, 2, 64)
    assert plan["vector"] == (shape[2] * es % 16 == 0 if vector is None
                              else vector)
    before = causal_conv1d.launches
    for cfg in ({}, {"run": 8, "threads": 256}):
        got = causal_conv1d(x, w, act="relu", **cfg)
        torch.cuda.synchronize()
        assert got.is_contiguous() and got.shape == x.shape
        assert torch.equal(_bits(got),
                           _bits(causal_conv1d_plain(x, w, act="relu")))
    assert causal_conv1d.launches == before + 2


def test_causal_conv1d_plan_equals_the_source(dev):
    """c1d_plan's vector/scalar choice and grid equal the source's."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels.conv1d_causal import RUNS, THREADS, c1d_plan
    lib = _build.library()
    for b, l, d in [(1, 16, 8192), (1, 33, 8192), (1, 96, 8192),
                    (1, 256, 8192), (8, 64, 8192), (3, 45, 100),
                    (1, 20, 8196), (2, 2, 100), (1, 1, 8)]:
        for es in (2, 4):
            for aligned in (0, 1):
                for run in RUNS:
                    for threads in THREADS:
                        out = (ctypes.c_int * 6)()
                        assert lib.repro_causal_conv1d_plan(
                            out, b, l, d, es, aligned, run, threads) == 0
                        p = c1d_plan(b, l, d, es, aligned, run, threads)
                        assert list(out) == [*p["grid"], p["threads"],
                                             p["run"], int(p["vector"])]
    out = (ctypes.c_int * 6)()
    assert lib.repro_causal_conv1d_plan(out, 1, 8, 8, 2, 1, 3, 64) != 0
    assert lib.repro_causal_conv1d_plan(out, 1, 8, 8, 2, 1, 2, 96) != 0


#: quiet NaNs of several bit patterns (+NaN, a payload, -NaN), as int16
#: (bfloat16) and int32 (float32)
NAN_BITS = {torch.bfloat16: (0x7FC0, 0x7FC5, 0xFFC0 - 0x10000),
            torch.float32: (0x7FC00000, 0x7FC00005, 0xFFC00000 - 2 ** 32)}


def _plant_nans(t, rng, share=0.15):
    """Set about ``share`` of float tensor ``t``'s elements, in place, to
    NaNs drawn from NAN_BITS: windows with several NaN taps of different
    bits."""
    flat = _bits(t).view(-1)
    hit = torch.from_numpy(rng.random(t.numel()) < share).to(t.device)
    pick = torch.from_numpy(rng.integers(0, 3, t.numel())).to(t.device)
    bits = torch.tensor(NAN_BITS[t.dtype], dtype=flat.dtype,
                        device=t.device)[pick]
    flat[hit] = bits[hit]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [4, 8, 12, 64])
@pytest.mark.parametrize("window,stride", [(2, 2), (3, 2), (2, 1), (4, 3)])
@pytest.mark.parametrize("offset", [0, 1])
def test_maxpool2d_f_vector_and_scalar_paths(dev, dtype, c, window, stride,
                                             offset):
    """The float pool's 16-byte vector path (C * elsize a multiple of 16,
    x aligned) and its scalar path (else, or x at an odd address) bitwise
    equal to the plain version on the bit pattern, NaN taps of several
    payloads included (the first NaN tap of a window wins)."""
    from repro_torch.kernels import maxpool2d_f, maxpool2d_plain
    from repro_torch.kernels.pool import pool_f_plan, pool_out
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(60 + c)
    x = _f(rng, (3, 11, 10, c), dt, dev)
    _plant_nans(x, rng)
    if offset:
        buf = torch.zeros(x.numel() + offset, dtype=dt, device=dev)
        view = buf[offset:].view(x.shape)
        view.copy_(x)
        x = view
    es = x.element_size()
    ho, wo = pool_out(11, window, stride), pool_out(10, window, stride)
    plan = pool_f_plan(3, ho, wo, c, es, x.data_ptr() % 16 == 0)
    assert plan["vector"] == (c * es % 16 == 0 and not offset)
    before = maxpool2d_f.launches
    got = maxpool2d_f(x, window=window, stride=stride)
    torch.cuda.synchronize()
    assert maxpool2d_f.launches == before + 1
    want = maxpool2d_plain(x, window=window, stride=stride)
    assert torch.isnan(want).any()
    assert torch.equal(_bits(got), _bits(want))


def test_pool_f_plan_equals_the_source(dev):
    """pool_f_plan's vector/scalar choice and grid equal the source's."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels.pool import pool_f_plan
    lib = _build.library()
    for n, ho, wo, c in [(8, 16, 16, 64), (2, 7, 6, 19), (3, 5, 4, 4),
                         (3, 5, 4, 8), (3, 5, 4, 12), (1, 1, 1, 2)]:
        for es in (2, 4):
            for aligned in (0, 1):
                for threads in (64, 256, 1024):
                    out = (ctypes.c_int * 3)()
                    assert lib.repro_maxpool2d_f_plan(
                        out, n, ho, wo, c, es, aligned, threads) == 0
                    p = pool_f_plan(n, ho, wo, c, es, aligned, threads)
                    assert list(out) == [p["blocks"], p["threads"],
                                         int(p["vector"])]
    out = (ctypes.c_int * 3)()
    assert lib.repro_maxpool2d_f_plan(out, 1, 2, 2, 16, 4, 1, 48) != 0
    assert lib.repro_maxpool2d_f_plan(out, 1, 2, 2, 16, 1, 1, 64) != 0


def test_ssm_engine_on_the_card_launches_conv_once_per_layer(dev):
    """A tiny Falcon-Mamba served on the card: every prefill launches
    causal_conv1d once per layer, a decode step none, and no other kernel
    runs; the block with the kernel equals the block with its plain
    version bit for bit."""
    import dataclasses
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import api, mamba
    from repro_torch.models import transformer as T
    from repro_torch.serve import Engine, Request, ServeConfig
    cfg = dataclasses.replace(get_config("falcon-mamba-7b"), n_layers=3,
                              d_model=64, vocab=96)
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    eng = Engine(cfg, params, ServeConfig(max_batch=2, max_len=48))
    rng = np.random.default_rng(17)
    for i, n in enumerate((5, 19, 9, 3)):
        eng.submit(Request(uid=i, prompt=rng.integers(0, 96, (n,))
                           .astype(np.int32), max_new_tokens=6))
    kernels.reset_launches()
    done = eng.run_until_drained()
    assert [r.status for r in done] == ["ok"] * 4
    launched = {k.__name__: k.launches for k in kernels.KERNELS
                if k.launches}
    assert launched == {"causal_conv1d": cfg.n_layers * eng.stats["prefills"]}
    lp = T._take(eng.params["layers"], 0)
    x = _f(rng, (1, 19, 64), torch.bfloat16, dev)
    y_cuda = mamba.mamba_forward(lp["mamba"], x, cfg.mamba, torch.bfloat16)
    y_torch = mamba.mamba_forward(lp["mamba"], x, cfg.mamba, torch.bfloat16,
                                  conv_method="torch")
    assert torch.equal(_bits(y_cuda), _bits(y_torch))


# ------------------------------------------------- float modes, tuner knobs

def _float_case(kernel, shape, dtype, dev, rng, act="relu"):
    """(kernel call taking **config, plain call) of one float-mode case."""
    from repro_torch import kernels as K
    dt = getattr(torch, dtype)

    def f(s):
        return _f(rng, s, dt, dev)
    if kernel == "conv2d_f":
        n, h, w, cx, cy, hk, g = shape
        x, wt, b = f((n, h, w, cx)), f((hk, hk, cx // g, cy)), f((cy,))
        return (lambda **c: K.conv2d_f(x, wt, b, groups=g, act=act, **c),
                lambda: K.conv2d_f_plain(x, wt, b, groups=g, act=act))
    if kernel == "depthwise2d_f":
        n, h, w, c, hk = shape
        x, wt = f((n, h, w, c)), f((hk, hk, c))
        return (lambda **c: K.depthwise2d_f(x, wt, act=act, **c),
                lambda: K.depthwise2d_f_plain(x, wt, act=act))
    if kernel == "maxpool2d_f":
        n, h, w, c, win, s = shape
        x = f((n, h, w, c))
        return (lambda **c: K.maxpool2d_f(x, window=win, stride=s, **c),
                lambda: K.maxpool2d_plain(x, window=win, stride=s))
    if kernel == "shift_conv2d_f":
        n, h, w, c, cy, d = shape
        x, wt = f((n, h, w, c)), f((c, cy))
        s = torch.from_numpy(_grid(c, d)).to(dev)
        return (lambda **cf: K.shift_conv2d_f(x, s, wt, max_shift=d,
                                              act=act, **cf),
                lambda: K.shift_conv2d_f_plain(x, s, wt, max_shift=d,
                                               act=act))
    if kernel == "add_conv2d_f":
        n, h, w, cx, cy, hk = shape
        x, wt = f((n, h, w, cx)), f((hk, hk, cx, cy))
        return (lambda **c: K.add_conv2d_f(x, wt, act=act, **c),
                lambda: K.add_conv2d_f_plain(x, wt, act=act))
    m, k, n = shape
    a, b = f((m, k)), f((k, n))
    return (lambda **c: K.matmul_f(a, b, act=act, **c),
            lambda: K.matmul_f_plain(a, b, act=act))


FLOAT_CASES = [
    ("conv2d_f", (1, 10, 10, 128, 64, 3, 1)),
    ("conv2d_f", (1, 10, 10, 128, 64, 3, 4)),
    ("conv2d_f", (1, 32, 32, 16, 16, 7, 1)),
    ("conv2d_f", (2, 15, 13, 3, 8, 3, 1)),
    ("conv2d_f", (2, 6, 7, 4, 8, 2, 1)),
    ("conv2d_f", (2, 8, 8, 5, 7, 1, 1)),
    ("depthwise2d_f", (1, 32, 32, 64, 3)),
    ("depthwise2d_f", (2, 15, 13, 19, 5)),
    ("depthwise2d_f", (2, 8, 8, 7, 1)),
    ("maxpool2d_f", (8, 32, 32, 64, 2, 2)),
    ("maxpool2d_f", (2, 15, 13, 19, 3, 2)),
    ("shift_conv2d_f", (1, 32, 32, 64, 64, 1)),
    ("shift_conv2d_f", (2, 15, 13, 19, 8, 2)),
    ("add_conv2d_f", (1, 10, 10, 16, 16, 3)),
    ("add_conv2d_f", (2, 15, 13, 3, 8, 3)),
    ("matmul_f", (256, 512, 256)),
    ("matmul_f", (1, 45, 37)),
    ("matmul_f", (70, 33, 300)),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel,shape", FLOAT_CASES, ids=str)
def test_float_kernel_equals_plain(dev, kernel, shape, dtype):
    """Each float mode bitwise equal to its plain version (which sums in
    the kernel's order), and one launch counted."""
    from repro_torch import kernels as K
    run, plain = _float_case(kernel, shape, dtype, dev,
                             np.random.default_rng(hash(shape) % 2 ** 32))
    wrapper = getattr(K, kernel)
    before = wrapper.launches
    got = run()
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    want = plain()
    assert got.dtype == want.dtype == getattr(torch, dtype)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("op,kernel", [
    ("conv2d", "conv2d_f"), ("depthwise2d", "depthwise2d_f"),
    ("maxpool2d", "maxpool2d_f"), ("shift_conv2d", "shift_conv2d_f"),
    ("add_conv2d", "add_conv2d_f"), ("matmul", "matmul_f")])
def test_float_ops_launch_their_kernel(dev, op, kernel):
    """ops.<op> on float32 card tensors under "cuda" launches the float
    kernel (no plain version, no NotImplementedError)."""
    from repro_torch import kernels as K
    from repro_torch.kernels import ops
    rng = np.random.default_rng(21)
    x = _f(rng, (2, 8, 8, 8), torch.float32, dev)
    args = {"conv2d": (x, _f(rng, (3, 3, 8, 4), torch.float32, dev)),
            "depthwise2d": (x, _f(rng, (3, 3, 8), torch.float32, dev)),
            "maxpool2d": (x,),
            "shift_conv2d": (x, torch.from_numpy(_grid(8, 1)).to(dev),
                             _f(rng, (8, 4), torch.float32, dev)),
            "add_conv2d": (x, _f(rng, (3, 3, 8, 4), torch.float32, dev)),
            "matmul": (x.reshape(16, 64)[:, :8].contiguous(),
                       _f(rng, (8, 4), torch.float32, dev))}[op]
    kw = {"max_shift": 1} if op == "shift_conv2d" else {}
    wrapper = getattr(K, kernel)
    before = wrapper.launches
    got = getattr(ops, op)(*args, method="cuda", **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert torch.isfinite(got).all()


def _entry(name, dev, rng):
    """(sig, dtype, call(**config)) of one kernel entry point at one
    shape, for the candidate-invariance check."""
    from repro_torch import kernels as K
    from repro_torch import tune
    from repro_torch.core.quantize import pack_w4

    def w4(shape, axis):
        q = torch.from_numpy(rng.integers(-8, 8, shape).astype(np.int8))
        ws = torch.from_numpy(rng.integers(0, 5, shape[axis])
                              .astype(np.int8)).to(dev)
        return pack_w4(q, axis).contiguous().to(dev), ws
    x8 = _i8(rng, (4, 12, 10, 16), dev)
    kw = dict(requant_shift=7, act="relu")
    if name.endswith("_f"):
        shape = {"conv2d_f": (4, 12, 10, 16, 24, 3, 2),
                 "depthwise2d_f": (4, 12, 10, 16, 3),
                 "maxpool2d_f": (4, 12, 10, 16, 3, 2),
                 "shift_conv2d_f": (4, 12, 10, 16, 24, 1),
                 "add_conv2d_f": (4, 12, 10, 16, 24, 3),
                 "matmul_f": (40, 300, 520)}[name]
        run, _ = _float_case(name, shape, "float32", dev, rng)
        sig = {"conv2d_f": lambda: tune.sig_conv2d(*shape),
               "depthwise2d_f": lambda: tune.sig_depthwise2d(*shape),
               "maxpool2d_f": lambda: tune.sig_maxpool2d(*shape),
               "shift_conv2d_f": lambda: tune.sig_shift_conv2d(*shape[:5]),
               "add_conv2d_f": lambda: tune.sig_add_conv2d(*shape),
               "matmul_f": lambda: tune.sig_matmul(*shape)}[name]()
        return sig, "float32", run
    if name == "causal_conv1d":
        x, w = (_f(rng, (2, 70, 320), torch.bfloat16, dev),
                _f(rng, (4, 320), torch.bfloat16, dev))
        return (tune.sig_causal_conv1d(2, 70, 320, 4), "bfloat16",
                lambda **c: K.causal_conv1d(x, w, **c))
    if name in ("matmul_q8", "matmul_w4"):
        a = _i8(rng, (8, 896), dev)
        sig = tune.sig_matmul(8, 896, 600)
        if name == "matmul_q8":
            b = _i8(rng, (896, 600), dev)
            return sig, "int8", lambda **c: K.matmul_q8(a, b, **kw, **c)
        bp, bs = w4((896, 600), 0)
        return sig, "w4a8", lambda **c: K.matmul_w4(a, bp, bs, **kw, **c)
    dt = "w4a8" if name.endswith("_w4") else "int8"
    base = name[:-3]
    b = torch.from_numpy(rng.integers(-4000, 4000, 24).astype(np.int32)) \
        .to(dev)
    if base == "conv2d":
        sig = tune.sig_conv2d(4, 12, 10, 16, 24, 3, 1)
        if dt == "int8":
            w = _i8(rng, (3, 3, 16, 24), dev)
            return sig, dt, lambda **c: K.conv2d_q8(x8, w, b, **kw, **c)
        wp, ws = w4((3, 3, 16, 24), 2)
        return sig, dt, lambda **c: K.conv2d_w4(x8, wp, ws, b, **kw, **c)
    if base == "depthwise2d":
        sig = tune.sig_depthwise2d(4, 12, 10, 16, 3)
        if dt == "int8":
            w = _i8(rng, (3, 3, 16), dev)
            return sig, dt, lambda **c: K.depthwise2d_q8(x8, w, **kw, **c)
        wp, ws = w4((3, 3, 16), 0)
        return sig, dt, lambda **c: K.depthwise2d_w4(x8, wp, ws, **kw, **c)
    if base == "maxpool2d":
        return (tune.sig_maxpool2d(4, 12, 10, 16, 3, 2), dt,
                lambda **c: K.maxpool2d_s8(x8, window=3, stride=2, **c))
    if base == "shift_conv2d":
        sig = tune.sig_shift_conv2d(4, 12, 10, 16, 24)
        s = torch.from_numpy(_grid(16, 1)).to(dev)
        if dt == "int8":
            w = _i8(rng, (16, 24), dev)
            return sig, dt, lambda **c: K.shift_conv2d_q8(
                x8, s, w, b, max_shift=1, **kw, **c)
        wp, ws = w4((16, 24), 0)
        return sig, dt, lambda **c: K.shift_conv2d_w4(
            x8, s, wp, ws, b, max_shift=1, **kw, **c)
    sig = tune.sig_add_conv2d(4, 12, 10, 16, 24, 3)
    akw = dict(requant_shift=9, x_preshift=2, w_preshift=0)
    if dt == "int8":
        w = _i8(rng, (3, 3, 16, 24), dev)
        return sig, dt, lambda **c: K.add_conv2d_q8(x8, w, b, **akw, **c)
    wp, ws = w4((3, 3, 16, 24), 2)
    return sig, dt, lambda **c: K.add_conv2d_w4(x8, wp, ws, b, **akw, **c)


ENTRY_POINTS = ["conv2d_q8", "depthwise2d_q8", "maxpool2d_s8",
                "shift_conv2d_q8", "add_conv2d_q8", "conv2d_w4",
                "depthwise2d_w4", "shift_conv2d_w4", "add_conv2d_w4",
                "matmul_q8", "matmul_w4", "causal_conv1d", "conv2d_f",
                "depthwise2d_f", "maxpool2d_f", "shift_conv2d_f",
                "add_conv2d_f", "matmul_f"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_every_candidate_equals_the_default(dev, name):
    """Every config in the tuner's space gives output bitwise equal to the
    default config's: the knobs change only the launch shape."""
    from repro_torch import tune
    sig, dtype, call = _entry(name, dev, np.random.default_rng(22))
    cands = list(tune.candidates(sig, dtype))
    assert len(cands) >= 2, cands
    want = call(**tune.default_config(sig.kernel, sig, dtype))
    for cfg in cands:
        got = call(**cfg)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (name, cfg)


def test_tuned_plan_on_the_card_equals_the_untuned_plan(dev, tmp_path):
    """autotune_plan on the card, its cache installed: the plan's trunk is
    bitwise the trunk without a cache, and every node resolved a config
    from the cache."""
    from repro_torch import tune
    from repro_torch.graph import CompiledPlan, build_cnn_graph, lower
    from repro_torch.models import CNNConfig, init_cnn
    cfg = CNNConfig(primitive="dws", widths=(8, 12), image_size=16)
    params = init_cnn(cfg, torch.Generator().manual_seed(0), device=dev)
    rng = np.random.default_rng(23)
    calib = torch.from_numpy((rng.standard_normal((8, 16, 16, 3)) * 0.5)
                             .astype(np.float32)).to(dev)
    plan = lower(build_cnn_graph(cfg), params, calib)
    x = (rng.standard_normal((8, 16, 16, 3)) * 0.5).astype(np.float32)
    try:
        tune.set_default_cache(tune.TuneCache(None))
        want = CompiledPlan(plan, method="cuda", device=dev).trunk(x)
        cache = tune.TuneCache(None)
        tune.autotune_plan(cache, plan, batch=8, reps=2)
        cache.save(str(tmp_path / "c.json"))
        tune.set_default_cache(tune.TuneCache(str(tmp_path / "c.json")))
        got = CompiledPlan(plan, method="cuda", device=dev).trunk(x)
        assert torch.equal(got.q, want.q)
        assert all(e["source"] == "measured" for e in cache.entries.values())
        assert all(k.endswith(tune.backend_tag(dev)) for k in cache.entries)
    finally:
        tune.reset()


# ----------------------------------------- the two tiled kernels' edges --

@pytest.mark.parametrize("w4", [False, True], ids=["q8", "w4"])
@pytest.mark.parametrize("shape", [
    (1, 10, 10, 128, 64, 3, 1), (1, 10, 10, 128, 64, 3, 4),
    (2, 15, 13, 19, 37, 5, 1), (1, 12, 11, 8, 12, 7, 2),
    (2, 6, 7, 12, 8, 2, 2), (2, 9, 9, 10, 8, 3, 2), (3, 5, 40, 8, 20, 3, 1),
    (8, 32, 32, 3, 16, 3, 1)], ids=str)
def test_integer_conv_tiles_equal_plain(dev, shape, w4):
    """Every tile of the implicit GEMM (bp 32, 96, 256; q 4, 8, 16) at K
    chunks (Cx = 128), HK 2, 5 and 7, groups, odd Cx/g (a W4 pad nibble)
    and Cy off a multiple of q: bitwise the plain version."""
    from repro_torch.kernels import (conv2d_q8, conv2d_q8_plain, conv2d_w4,
                                     conv2d_w4_plain)
    n, h, w, cx, cy, hk, g = shape
    rng = np.random.default_rng(31)
    x = _i8(rng, (n, h, w, cx), dev)
    b = torch.from_numpy(rng.integers(-5000, 5000, cy).astype(np.int32)) \
        .to(dev)
    kw = dict(groups=g, requant_shift=9, act="relu")
    if w4:
        wts = _w4(rng, (hk, hk, cx // g, cy), 2, dev, False)
        fn, plain = conv2d_w4, conv2d_w4_plain
    else:
        wts = (_i8(rng, (hk, hk, cx // g, cy), dev),)
        fn, plain = conv2d_q8, conv2d_q8_plain
    want = plain(x, *wts, b, **kw)
    for bp in (32, 96, 256):
        for q in (4, 8, 16):
            got = fn(x, *wts, b, bp=bp, q=q, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (bp, q)


def test_integer_conv_unaligned_x_takes_the_bytewise_window(dev):
    from repro_torch.kernels import conv2d_q8, conv2d_q8_plain
    rng = np.random.default_rng(32)
    x = _i8(rng, (2, 16, 16, 16), dev)
    buf = torch.zeros(x.numel() + 1, dtype=torch.int8, device=dev)
    xo = buf[1:].view(x.shape)
    xo.copy_(x)
    w = _i8(rng, (3, 3, 16, 32), dev)
    got = conv2d_q8(xo, w, requant_shift=8)
    torch.cuda.synchronize()
    assert torch.equal(got, conv2d_q8_plain(x, w, requant_shift=8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,off", [((37, 45, 33), 0), ((257, 513, 255), 0),
                                       ((70, 33, 100), 1), ((13, 33, 300), 3),
                                       ((1, 896, 37), 0)], ids=str)
def test_matmul_f_tiles_equal_plain(dev, dtype, shape, off):
    """Every tile of the float GEMM, M, N and K off every tile, operands at
    unaligned addresses (the plainly loaded stages), relu: bitwise the
    plain version."""
    import importlib
    mq = importlib.import_module("repro_torch.kernels.matmul_q8")
    dt = getattr(torch, dtype)
    m, k, n = shape
    rng = np.random.default_rng(33)

    def f(s):
        t = torch.from_numpy(rng.standard_normal(s).astype(np.float32)) \
            .to(dev).to(dt)
        if not off:
            return t
        buf = torch.zeros(t.numel() + off, dtype=dt, device=dev)
        v = buf[off:].view(s)
        v.copy_(t)
        return v
    a, b = f((m, k)), f((k, n))
    bits = torch.int32 if dt == torch.float32 else torch.int16
    want = mq.matmul_f_plain(a, b, act="relu").view(bits)
    for tile in mq.MMF_TILES:
        got = mq.matmul_f(a, b, act="relu", **dict(zip(mq.MMF_KNOBS, tile)))
        torch.cuda.synchronize()
        assert torch.equal(got.view(bits), want), tile


def test_tiled_launch_arithmetic_equals_the_sources(dev):
    """conv_plan and mmf_plan, which the tuner's footprint check reads,
    equal the arithmetic the CUDA sources launch with."""
    import ctypes
    import importlib
    from repro_torch.kernels import _build
    ci = importlib.import_module("repro_torch.kernels.conv_im2col")
    mq = importlib.import_module("repro_torch.kernels.matmul_q8")
    lib = _build.library()
    for s in [(256, 32, 32, 3, 16, 3, 1), (256, 16, 16, 16, 32, 1, 1),
              (1, 10, 10, 128, 64, 3, 4), (2, 15, 13, 5, 8, 3, 1),
              (1, 64, 64, 512, 64, 3, 1)]:
        for bp in (32, 96, 256):
            for q in ci.CONV_Q:
                c = (ctypes.c_int * 6)()
                rc = lib.repro_conv2d_i8_plan(c, *s, bp, q)
                p = ci.conv_plan(*s, bp, q)
                assert list(c) == [*p["grid"], p["threads"], p["smem"],
                                   p["k_words"], p["window"]]
                assert (rc == 0) == (not ci.tile_errors(p))
    for tile in mq.MMF_TILES:
        for code, es in ((0, 4), (1, 2)):
            c = (ctypes.c_int * 4)()
            assert lib.repro_matmul_f_plan(c, 257, 513, *tile, code) == 0
            p = mq.mmf_plan(257, 513, tile, es)
            assert list(c) == [*p["grid"], p["threads"], p["smem"]]


# --------------------------------------------- the shift conv's tiles --

SHIFT_TILES = [(bp, q) for bp in (32, 64, 96, 128, 256) for q in (4, 8, 16)]


@pytest.mark.parametrize("w4", [False, True], ids=["q8", "w4"])
@pytest.mark.parametrize("shape", [
    (4, 16, 16, 16, 32, 1), (2, 8, 8, 32, 64, 1), (2, 15, 13, 19, 8, 2),
    (1, 12, 11, 9, 24, 3), (1, 10, 10, 130, 16, 1), (2, 9, 7, 12, 20, 2)],
    ids=str)
def test_integer_shift_tiles_equal_plain(dev, shape, w4):
    """Every tile of the integer shift conv's implicit GEMM at d = 1, 2
    and 3, C off a multiple of 4 (the bytewise window), K chunks (C =
    130), Cy off a multiple of q, W4 with every group shift at 4: bitwise
    the plain version, with and without bias and relu."""
    from repro_torch.kernels import (shift_conv2d_q8, shift_conv2d_q8_plain,
                                     shift_conv2d_w4, shift_conv2d_w4_plain)
    n, h, w, c, cy, d = shape
    rng = np.random.default_rng(41)
    x = _i8(rng, (n, h, w, c), dev)
    table = torch.from_numpy(_grid(c, d)).to(dev)
    b = torch.from_numpy(rng.integers(-5000, 5000, cy).astype(np.int32)) \
        .to(dev)
    if w4:
        wts = _w4(rng, (c, cy), 0, dev, True)
        fn, plain = shift_conv2d_w4, shift_conv2d_w4_plain
    else:
        wts = (_i8(rng, (c, cy), dev),)
        fn, plain = shift_conv2d_q8, shift_conv2d_q8_plain
    for bias, act, rs in ((b, "relu", 9), (None, None, -2)):
        kw = dict(requant_shift=rs, act=act, max_shift=d)
        want = plain(x, table, *wts, bias, **kw)
        for bp, q in SHIFT_TILES:
            got = fn(x, table, *wts, bias, bp=bp, q=q, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (bp, q, bias is None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,off", [
    ((1, 32, 32, 64, 64, 1), 0), ((2, 15, 13, 19, 8, 2), 0),
    ((2, 9, 7, 5, 37, 3), 0), ((2, 8, 8, 130, 12, 1), 1)], ids=str)
def test_float_shift_tiles_equal_plain(dev, dtype, shape, off):
    """Every tile of the float shift conv, d = 1 to 3, C off a multiple of
    4 and past two chunks of 64, Cy off a multiple of q, x at an unaligned
    address, relu on and off: bitwise the plain version."""
    from repro_torch.kernels import shift_conv2d_f, shift_conv2d_f_plain
    n, h, w, c, cy, d = shape
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(42)
    x = _f(rng, (n, h, w, c), dt, dev)
    if off:
        buf = torch.zeros(x.numel() + off, dtype=dt, device=dev)
        xo = buf[off:].view(x.shape)
        xo.copy_(x)
        x = xo
    wt = _f(rng, (c, cy), dt, dev)
    table = torch.from_numpy(_grid(c, d)).to(dev)
    for act in ("relu", None):
        want = _bits(shift_conv2d_f_plain(x, table, wt, max_shift=d,
                                          act=act))
        for bp, q in SHIFT_TILES:
            got = shift_conv2d_f(x, table, wt, max_shift=d, act=act, bp=bp,
                                 q=q)
            torch.cuda.synchronize()
            assert torch.equal(_bits(got), want), (bp, q, act)


def test_shift_unaligned_x_and_max_shift_required(dev):
    """x at an odd address takes the bytewise window; a card call with no
    max_shift raises in every mode (the window depends on it)."""
    from repro_torch.kernels import (shift_conv2d_f, shift_conv2d_q8,
                                     shift_conv2d_q8_plain, shift_conv2d_w4)
    rng = np.random.default_rng(43)
    x = _i8(rng, (2, 16, 16, 16), dev)
    buf = torch.zeros(x.numel() + 1, dtype=torch.int8, device=dev)
    xo = buf[1:].view(x.shape)
    xo.copy_(x)
    w = _i8(rng, (16, 32), dev)
    table = torch.from_numpy(_grid(16, 1)).to(dev)
    got = shift_conv2d_q8(xo, table, w, requant_shift=8, max_shift=1)
    torch.cuda.synchronize()
    assert torch.equal(got, shift_conv2d_q8_plain(x, table, w,
                                                  requant_shift=8))
    wp, ws = _w4(rng, (16, 32), 0, dev, False)
    before = (shift_conv2d_q8.launches, shift_conv2d_w4.launches,
              shift_conv2d_f.launches)
    with pytest.raises(ValueError, match="max_shift"):
        shift_conv2d_q8(x, table, w, requant_shift=8)
    with pytest.raises(ValueError, match="max_shift"):
        shift_conv2d_w4(x, table, wp, ws, requant_shift=8)
    with pytest.raises(ValueError, match="max_shift"):
        shift_conv2d_f(_f(rng, (2, 16, 16, 16), torch.float32, dev), table,
                       _f(rng, (16, 32), torch.float32, dev))
    assert (shift_conv2d_q8.launches, shift_conv2d_w4.launches,
            shift_conv2d_f.launches) == before


def test_shift_launch_arithmetic_equals_the_source(dev):
    """shift_plan and shift_f_plan, which the tuner's footprint check
    reads, equal the arithmetic the CUDA source launches with."""
    import ctypes
    import importlib
    from repro_torch.kernels import _build
    ci = importlib.import_module("repro_torch.kernels.conv_im2col")
    cs = importlib.import_module("repro_torch.kernels.conv_shift")
    lib = _build.library()
    for s in [(256, 16, 16, 16, 32, 1), (256, 8, 8, 32, 64, 1),
              (1, 32, 32, 64, 64, 2), (2, 15, 13, 19, 8, 3),
              (1, 64, 64, 512, 64, 3)]:
        for bp, q in SHIFT_TILES:
            c = (ctypes.c_int * 6)()
            rc = lib.repro_shift_conv2d_i8_plan(c, *s, bp, q)
            p = cs.shift_plan(*s, bp, q)
            assert list(c) == [*p["grid"], p["threads"], p["smem"],
                               p["k_words"], p["window"]]
            assert (rc == 0) == (not ci.tile_errors(p))
            c = (ctypes.c_int * 4)()
            rc = lib.repro_shift_conv2d_f_plan(c, *s[:5], bp, q)
            p = cs.shift_f_plan(*s[:5], bp, q)
            assert list(c) == [*p["grid"], p["threads"], p["smem"]]
            assert (rc == 0) == (not ci.tile_errors(p))


# ------------------------- the float conv's and float add conv's tiles --

def _offset(t, off):
    """A contiguous copy of ``t`` whose data starts ``off`` elements into a
    larger buffer: an operand at an unaligned address."""
    if not off:
        return t
    buf = torch.zeros(t.numel() + off, dtype=t.dtype, device=t.device)
    v = buf[off:].view(t.shape)
    v.copy_(t)
    return v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,off", [
    ((4, 12, 10, 16, 24, 3, 2), 0), ((4, 12, 10, 16, 24, 3, 2), 1),
    ((1, 10, 10, 130, 20, 3, 2), 3), ((2, 6, 7, 4, 8, 2, 1), 0),
    ((1, 12, 11, 8, 12, 7, 2), 0), ((2, 8, 8, 5, 7, 1, 1), 0),
    ((1, 10, 10, 128, 64, 3, 4), 0), ((1, 6, 5, 512, 20, 5, 1), 1)],
    ids=str)
def test_float_conv_tiles_equal_plain(dev, dtype, shape, off):
    """Every tile of the float conv (bp 32 to 256 and 96, q 4, 8, 16) at
    the candidate check's shape (Cy/g = 12, off every q but 4), with x at
    an unaligned address, ci = 130 with g = 2, even HK, HK = 7, HK = 1,
    Table-2's g = 4 job and K = 12,800 (weights staged chunk by chunk, not
    resident), bias and relu on and off: bitwise the plain version."""
    from repro_torch.kernels import conv2d_f, conv2d_f_plain
    n, h, w, cx, cy, hk, g = shape
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(51)
    x = _offset(_f(rng, (n, h, w, cx), dt, dev), off)
    wt = _f(rng, (hk, hk, cx // g, cy), dt, dev)
    b = _f(rng, (cy,), dt, dev)
    for bias, act in ((b, "relu"), (None, None)):
        want = _bits(conv2d_f_plain(x, wt, bias, groups=g, act=act))
        for bp, q in SHIFT_TILES:
            got = conv2d_f(x, wt, bias, groups=g, act=act, bp=bp, q=q)
            torch.cuda.synchronize()
            assert torch.equal(_bits(got), want), (bp, q, act)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,off", [
    ((4, 12, 10, 16, 24, 3), 0), ((4, 12, 10, 16, 24, 3), 1),
    ((2, 9, 11, 19, 20, 5), 3), ((1, 10, 10, 16, 16, 3), 0),
    ((2, 8, 8, 19, 8, 1), 0), ((2, 6, 7, 4, 8, 2), 0),
    ((1, 6, 5, 513, 20, 5), 0)], ids=str)
def test_float_add_tiles_equal_plain(dev, dtype, shape, off):
    """Every tile of the float add conv at the candidate check's shape (Cy
    = 24, off q = 16), with x at an unaligned address, HK = 5 with Cx = 19
    and Cy = 20, Table-2's job, HK = 1, even HK and K = 12,825 (chunked
    weights, Cx off a multiple of 4), relu on and off: bitwise the plain
    version (a tap outside the image adds |0 - w|)."""
    from repro_torch.kernels import add_conv2d_f, add_conv2d_f_plain
    n, h, w, cx, cy, hk = shape
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(52)
    x = _offset(_f(rng, (n, h, w, cx), dt, dev), off)
    wt = _f(rng, (hk, hk, cx, cy), dt, dev)
    for act in ("relu", None):
        want = _bits(add_conv2d_f_plain(x, wt, act=act))
        for bp, q in SHIFT_TILES:
            got = add_conv2d_f(x, wt, act=act, bp=bp, q=q)
            torch.cuda.synchronize()
            assert torch.equal(_bits(got), want), (bp, q, act)


def test_float_gemm_launch_arithmetic_equals_the_sources(dev):
    """conv_f_plan and add_f_plan, which the tuner's footprint check
    reads, equal the arithmetic the CUDA sources launch with, at Table-2's
    float jobs, the B=256 layers, edges and a window too large for some
    tiles."""
    import ctypes
    import importlib
    from repro_torch.kernels import _build
    ci = importlib.import_module("repro_torch.kernels.conv_im2col")
    ca = importlib.import_module("repro_torch.kernels.conv_add")
    lib = _build.library()
    for s in [(1, 10, 10, 128, 64, 3, 1), (1, 10, 10, 128, 64, 3, 4),
              (1, 32, 32, 16, 16, 7, 1), (1, 8, 8, 16, 16, 3, 1),
              (256, 32, 32, 3, 16, 3, 1), (256, 16, 16, 16, 32, 3, 1),
              (256, 8, 8, 32, 64, 3, 1), (256, 16, 16, 16, 32, 1, 1),
              (2, 15, 13, 5, 8, 3, 1), (1, 10, 10, 130, 20, 3, 2),
              (1, 12, 11, 8, 12, 7, 2), (1, 64, 64, 512, 64, 3, 1)]:
        for bp, q in SHIFT_TILES:
            c = (ctypes.c_int * 5)()
            rc = lib.repro_conv2d_f_plan(c, *s, bp, q)
            p = ci.conv_f_plan(*s, bp, q)
            assert list(c) == [*p["grid"], p["threads"], p["smem"],
                               p["window"]]
            assert (rc == 0) == (not ci.tile_errors(p))
            if s[6] != 1:
                continue
            c = (ctypes.c_int * 5)()
            rc = lib.repro_add_conv2d_f_plan(c, *s[:6], bp, q)
            p = ca.add_f_plan(*s[:6], bp, q)
            assert list(c) == [*p["grid"], p["threads"], p["smem"],
                               p["window"]]
            assert (rc == 0) == (not ci.tile_errors(p))


# ------------------- the depthwise conv's and the integer add's tiles --

DW_TILES = [(pt, rows) for pt in (1, 2, 4) for rows in (1, 2, 4, 8)]


@pytest.mark.parametrize("mode", ["q8", "w4", "float32", "bfloat16"])
@pytest.mark.parametrize("shape,off", [
    ((256, 16, 16, 16, 3), 0), ((256, 8, 8, 32, 3), 0),
    ((1, 32, 32, 64, 3), 0), ((4, 12, 10, 16, 3), 1),
    ((2, 15, 13, 19, 5), 0), ((2, 5, 13, 7, 2), 3), ((2, 8, 8, 12, 1), 0),
    ((1, 12, 11, 8, 7), 0), ((1, 3, 300, 8, 3), 0)], ids=str)
def test_depthwise_tiles_equal_plain(dev, mode, shape, off):
    """Every tile of the staged-row depthwise kernel (pt 1, 2, 4 x rows 1,
    2, 4, 8) at the dws plan's B=256 rows, Table-2's job, x at an unaligned
    address (element loads), C off a multiple of 4, HK 1, 2, 5 and 7, a row
    cut into runs of columns, relu and requant shifts on and off, W4 with
    every group shift at 4 at HK = 5: bitwise the plain version, one launch
    counted each."""
    from repro_torch import kernels as K
    n, h, w, c, hk = shape
    rng = np.random.default_rng(61)
    if mode in ("float32", "bfloat16"):
        dt = getattr(torch, mode)
        x = _offset(_f(rng, (n, h, w, c), dt, dev), off)
        wt = _f(rng, (hk, hk, c), dt, dev)
        cases = [(lambda a, **t: K.depthwise2d_f(x, wt, act=a, **t),
                  lambda a: K.depthwise2d_f_plain(x, wt, act=a), a)
                 for a in ("relu", None)]
        wrapper = K.depthwise2d_f
    else:
        x = _offset(_i8(rng, (n, h, w, c), dev), off)
        if mode == "w4":
            wp, ws = _w4(rng, (hk, hk, c), 0, dev, all_max=hk == 5)
            wrapper = K.depthwise2d_w4
            cases = [(lambda a, s=s, **t: K.depthwise2d_w4(
                          x, wp, ws, requant_shift=s, act=a, **t),
                      lambda a, s=s: K.depthwise2d_w4_plain(
                          x, wp, ws, requant_shift=s, act=a), a)
                     for s, a in ((9, "relu"), (-2, None))]
        else:
            wt = _i8(rng, (hk, hk, c), dev)
            wrapper = K.depthwise2d_q8
            cases = [(lambda a, s=s, **t: K.depthwise2d_q8(
                          x, wt, requant_shift=s, act=a, **t),
                      lambda a, s=s: K.depthwise2d_q8_plain(
                          x, wt, requant_shift=s, act=a), a)
                     for s, a in ((7, "relu"), (0, None))]
    for run, plain, act in cases:
        want = plain(act)
        for pt, rows in DW_TILES:
            before = wrapper.launches
            got = run(act, pt=pt, rows=rows)
            torch.cuda.synchronize()
            assert wrapper.launches == before + 1
            assert torch.equal(_bits(got) if got.is_floating_point() else got,
                               _bits(want) if want.is_floating_point()
                               else want), (mode, pt, rows, act)


@pytest.mark.parametrize("w4", [False, True], ids=["q8", "w4"])
@pytest.mark.parametrize("shape,xp,wp,off", [
    ((256, 32, 32, 3, 16, 3), 0, 3, 0), ((256, 16, 16, 16, 32, 3), 2, 0, 0),
    ((256, 8, 8, 32, 64, 3), 28, 20, 0), ((1, 10, 10, 16, 16, 3), 2, 0, 0),
    ((4, 12, 10, 16, 24, 3), 2, 0, 1), ((2, 9, 9, 7, 20, 5), 31, 0, 0),
    ((2, 8, 8, 19, 8, 1), 0, 31, 3), ((2, 6, 7, 4, 8, 2), 28, 20, 0),
    ((1, 12, 11, 5, 12, 7), 0, 3, 0)], ids=str)
def test_int_add_tiles_equal_plain(dev, w4, shape, xp, wp, off):
    """Every tile of the integer add conv on the float implicit GEMM's
    body (bp 32 to 256 and 96, q 4, 8, 16) at the add plan's B=256 layers,
    Table-2's int8 job, x at an unaligned address, Cx off a multiple of 4
    (W4: a pad nibble, every group shift at 4 where Cx = 7), Cy off q, HK
    1, 2, 5 and 7, pre-shifts that wrap int32 ((28, 20), (31, 0), (0,
    31)), bias and relu on and off: bitwise the plain version."""
    from repro_torch import kernels as K
    n, h, w, cx, cy, hk = shape
    rng = np.random.default_rng(62)
    x = _offset(_i8(rng, (n, h, w, cx), dev), off)
    b = torch.from_numpy(rng.integers(-5000, 5000, cy).astype(np.int32)) \
        .to(dev)
    if w4:
        wpk, ws = _w4(rng, (hk, hk, cx, cy), 2, dev, all_max=cx == 7)
        wrapper, args = K.add_conv2d_w4, (x, wpk, ws)
        plain = K.add_conv2d_w4_plain
    else:
        wrapper, args = K.add_conv2d_q8, (x, _i8(rng, (hk, hk, cx, cy),
                                                 dev))
        plain = K.add_conv2d_q8_plain
    for bias, act, rs in ((b, "relu", 9 if max(xp, wp) < 20 else 24),
                          (None, None, 0)):
        kw = dict(requant_shift=rs, x_preshift=xp, w_preshift=wp, act=act)
        want = plain(*args, bias, **kw)
        for bp, q in SHIFT_TILES:
            before = wrapper.launches
            got = wrapper(*args, bias, **kw, bp=bp, q=q)
            torch.cuda.synchronize()
            assert wrapper.launches == before + 1
            assert torch.equal(got, want), (bp, q, act)


def test_depthwise_launch_arithmetic_equals_the_source(dev):
    """dw_plan, which the tuner's footprint check reads, equals the
    arithmetic repro_depthwise2d_plan launches with, at every tile and
    element size of the dws rows, Table-2's job and edges (C off 4, HK 1,
    2, 5, 7, a row cut into runs, HK = 181 over the shared memory)."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels import conv_dw as D
    lib = _build.library()
    for s in [(256, 16, 16, 16, 3), (256, 8, 8, 32, 3), (1, 32, 32, 64, 3),
              (2, 15, 13, 19, 5), (2, 5, 13, 7, 2), (2, 8, 8, 12, 1),
              (1, 12, 11, 8, 7), (1, 3, 300, 8, 3), (1, 4, 4, 4, 181)]:
        for es in (1, 2, 4):
            for pt, rows in DW_TILES:
                c = (ctypes.c_int * 5)()
                rc = lib.repro_depthwise2d_plan(c, *s, es, pt, rows)
                p = D.dw_plan(*s, es, pt, rows)
                assert list(c) == [*p["grid"], p["threads"], p["smem"],
                                   p["window"]], (s, es, pt, rows)
                assert (rc == 0) == (not D.dw_tile_errors(p))


# ------------------------------------------- the plan captured as a graph --

def _card_plan(dev, prim, bits, widths=(16, 32, 64), size=32):
    """A plan lowered on the card from seeded weights, int8 or W4."""
    from repro_torch.graph import build_cnn_graph, lower
    from repro_torch.models import CNNConfig, init_cnn
    cfg = CNNConfig(primitive=prim, widths=widths, image_size=size)
    params = init_cnn(cfg, torch.Generator().manual_seed(0), device=dev)
    rng = np.random.default_rng(31)
    calib = torch.from_numpy((rng.standard_normal((16, size, size, 3)) * .5)
                             .astype(np.float32)).to(dev)
    x = torch.from_numpy((rng.standard_normal((256, size, size, 3)) * .5)
                         .astype(np.float32)).to(dev)
    return lower(build_cnn_graph(cfg), params, calib, weight_bits=bits), x


@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "w4"])
@pytest.mark.parametrize("prim", ["standard", "grouped", "dws", "shift",
                                  "add"])
def test_captured_trunk_equals_eager_at_every_bucket(dev, prim, bits):
    """jit=True captures one graph per batch size: at every pow2 bucket
    from 1 to 256 the captured trunk (its capture call and a replay) is
    bitwise the jit=False trunk, and a ragged forward_batch (one image
    short of the bucket) replays that bucket's graph, logits within
    1e-5."""
    from repro_torch.graph import CompiledPlan
    from repro_torch.obs import metrics
    plan, x = _card_plan(dev, prim, bits)
    ex = CompiledPlan(plan, method="cuda", device=dev)
    eager = CompiledPlan(plan, method="cuda", device=dev, jit=False)
    buckets = [1 << i for i in range(9)]
    compiles = metrics.counter("graph.compiles").value
    for b in buckets:
        want = eager.trunk(x[:b])
        for _ in range(2):
            got = ex.trunk(x[:b])
            assert got.frac_bits == want.frac_bits
            assert torch.equal(got.q, want.q), (prim, bits, b)
        if b > 1:
            n = b - 1
            err = (ex.forward_batch(x[:n]) - eager.forward_batch(x[:n]))
            assert err.abs().max() <= 1e-5
    assert ex.traces == len(buckets) and eager.traces == 0
    assert metrics.counter("graph.compiles").value == compiles + len(buckets)
    assert metrics.counter("graph.compiles.n256").value >= 1


def test_replays_count_exact_launches(dev):
    """The first call of a bucket launches one eager forward (the capture's
    wrapper calls execute nothing and are not counted) and one replay;
    every later call one replay's launches, the same as an eager
    forward's."""
    from repro_torch import kernels
    from repro_torch.graph import CompiledPlan
    plan, x = _card_plan(dev, "dws", 8)
    eager = CompiledPlan(plan, method="cuda", device=dev, jit=False)
    kernels.reset_launches()
    eager.trunk(x)
    one = {k.__name__: k.launches for k in kernels.KERNELS}
    assert one["conv2d_q8"] == 3 and one["depthwise2d_q8"] == 2
    assert one["maxpool2d_s8"] == 3
    ex = CompiledPlan(plan, method="cuda", device=dev)
    kernels.reset_launches()
    ex.forward_batch(x)
    assert {k.__name__: k.launches for k in kernels.KERNELS} == \
        {k: 2 * v for k, v in one.items()}
    kernels.reset_launches()
    for _ in range(5):
        ex.forward_batch(x[:200])        # bucket 256: a replay each
    torch.cuda.synchronize()
    assert {k.__name__: k.launches for k in kernels.KERNELS} == \
        {k: 5 * v for k, v in one.items()}
    assert ex.traces == 1


def test_failed_capture_raises_and_never_runs_eager(dev, monkeypatch):
    """A host sync inside the forward breaks the capture: the call raises,
    no graph is kept, and the next call raises again rather than running
    the plan node by node."""
    from repro_torch.graph import CompiledPlan
    from repro_torch.kernels import ops
    plan, x = _card_plan(dev, "standard", 8, widths=(8, 12), size=16)
    pool = ops.maxpool2d

    def syncing_pool(h, **kw):
        if torch.cuda.is_current_stream_capturing():
            h.cpu()
        return pool(h, **kw)
    monkeypatch.setattr(ops, "maxpool2d", syncing_pool)
    ex = CompiledPlan(plan, method="cuda", device=dev)
    for _ in range(2):
        with pytest.raises(RuntimeError):
            ex.trunk(x[:4])
        assert ex.traces == 0 and not ex._graphs
    torch.cuda.synchronize()


@pytest.mark.parametrize("prim", ["shift", "add"])
def test_plain_plan_captures(dev, prim):
    """The plain versions hold no host sync either (the shift table's
    bound is checked on the card, never read back): a method="torch" plan
    captures, and its trunk equals the cuda plan's bit for bit."""
    from repro_torch.graph import CompiledPlan
    plan, x = _card_plan(dev, prim, 8, widths=(8, 12), size=16)
    want = CompiledPlan(plan, method="cuda", device=dev, jit=False).trunk(x)
    ex = CompiledPlan(plan, method="torch", device=dev)
    for _ in range(2):
        assert torch.equal(ex.trunk(x).q, want.q)
    assert ex.traces == 1


def test_shift_table_beyond_max_shift_fails_on_card(dev):
    """shift_channels checks a table on the card against max_shift with a
    device-side assert (no host sync): a table within the bound gathers as
    on the host, one beyond it fails the process. The failing case runs in
    a child process, since a device-side assert ends its CUDA context."""
    import os
    import subprocess
    import sys
    from repro_torch.core.primitives import shift_channels
    x = torch.arange(32, dtype=torch.float32).reshape(1, 4, 4, 2)
    table = torch.tensor([[0, 2], [1, -1]], dtype=torch.int32)
    got = shift_channels(x.to(dev), table.to(dev), max_shift=2)
    assert torch.equal(got.cpu(), shift_channels(x, table, max_shift=2))
    code = ("import torch\n"
            "from repro_torch.core.primitives import shift_channels\n"
            "x = torch.zeros((1, 4, 4, 2), device='cuda')\n"
            "t = torch.tensor([[0, 2], [1, -1]], dtype=torch.int32, "
            "device='cuda')\n"
            "shift_channels(x, t, max_shift=1)\n"
            "torch.cuda.synchronize()\n")
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src)
    run = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode != 0
    assert "assert" in run.stderr.lower(), run.stderr[-2000:]


@pytest.mark.parametrize("prim", ["standard", "grouped", "dws", "shift",
                                  "add"])
def test_training_step_on_card_matches_host(dev, prim):
    """One training step on the card with TF32 off against the same step
    on the host: the loss and every gradient within rtol 1e-4 / atol 1e-5
    (float32 sums in another order), and the AdamW update of the host's
    gradients on each side within the same tolerance (Adam's first step
    is about lr * sign(g), so gradients that are float noise, such as a
    conv bias ahead of batch-statistics BN, are fed the same on both
    sides)."""
    from repro_torch.device import exact_float32
    from repro_torch.models import CNNConfig, cnn_value_and_grad, init_cnn
    from repro_torch.optim import OptConfig, apply_updates, init_opt_state
    from repro_torch.tree import leaves, tree_map
    cfg = CNNConfig(primitive=prim, widths=(16, 32), image_size=16)
    opt = OptConfig(lr=2e-3, warmup_steps=0, total_steps=10)
    params = init_cnn(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(4)
    batch = {"images": torch.from_numpy(rng.standard_normal((8, 16, 16, 3))
                                        .astype(np.float32)),
             "labels": torch.from_numpy(rng.integers(0, 10, 8)
                                        .astype(np.int32))}
    out, host_grads = {}, None
    for where in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(where), params)
        b = {k: v.to(where) for k, v in batch.items()}
        with exact_float32():
            (loss, _), grads = cnn_value_and_grad(p, b, cfg)
            host_grads = host_grads or grads
            new, _, _ = apply_updates(
                p, tree_map(lambda t: t.to(where), host_grads),
                init_opt_state(p, opt), opt)
        out[where] = (float(loss), leaves(grads), leaves(new))
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-4)
    for i in (1, 2):
        for c, h in zip(out["cuda"][i], out["cpu"][i]):
            np.testing.assert_allclose(c.cpu().float().numpy(),
                                       h.float().numpy(), rtol=1e-4,
                                       atol=1e-5)


# ------------------------------------ the LM engine's captured decode step

def _tiny_lm(dev, family):
    """A tiny Qwen2 or Falcon-Mamba with seeded weights made on the card."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import api
    if family == "ssm":
        cfg = dataclasses.replace(get_config("falcon-mamba-7b"), n_layers=3,
                                  d_model=64, vocab=96)
    else:
        cfg = dataclasses.replace(get_config("qwen2-0.5b"), n_layers=2,
                                  d_model=64, n_heads=4, n_kv_heads=2,
                                  d_ff=160, vocab=96)
    return cfg, api.init_params(cfg, torch.Generator(device=dev)
                                .manual_seed(0), device=dev)


LM_MODES = [("dense", p, kv) for p in ("float", "int8", "int8-torch", "w4a8",
                                       "w4a8-torch")
            for kv in ("float", "int8")] + [("ssm", "float", "float")]


@pytest.mark.parametrize("family,precision,kv", LM_MODES,
                         ids=["-".join(m) for m in LM_MODES])
def test_captured_decode_equals_eager_bitwise(dev, family, precision, kv):
    """The engine's prefill and decode paths with jit=True (the dense
    prefill replayed per bucket, the decode step captured at its first
    round and replayed) and jit=False, driven over their own arenas: the
    prefill and every decode round's logits bitwise equal, and the arena
    (K/V or state, int8 scales, lengths) bitwise equal after 5 rounds.
    The first round launches one eager pass (the capture counts nothing),
    each later round one replay's launches, the same as an eager step's;
    the engine holds one decode graph and one graph per prefill bucket."""
    from repro_torch import kernels
    from repro_torch.models import api
    from repro_torch.serve import Engine, ServeConfig
    cfg, params = _tiny_lm(dev, family)
    scfg = ServeConfig(max_batch=3, max_len=48, precision=precision,
                       kv_cache=kv)
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, 96, (n,)).astype(np.int32) for n in (5, 19)]
    kernel = {"int8": kernels.matmul_q8, "w4a8": kernels.matmul_w4}.get(
        precision)
    out = {}
    for jit in (True, False):
        eng = Engine(cfg, params, scfg, jit=jit)
        arena = api.init_slot_cache(cfg, 3, 48, kv=kv, device=dev)
        tok = torch.zeros((3, 1), dtype=torch.int64).pin_memory()
        lens = torch.zeros((3,), dtype=torch.int32).pin_memory()
        logits = []
        for rep in range(2):                 # a bucket's capture, a replay
            for slot, p in enumerate(prompts):
                b = eng._bucket_len(len(p))
                toks = np.zeros((1, b), np.int64)
                toks[0, :len(p)] = p
                lg, fresh = eng._prefill_slot(toks, len(p))
                api.cache_write_slot(cfg, arena, fresh, slot)
                logits.append(lg.clone())
                tok[slot, 0] = int(lg[0, -1].argmax())
                lens[slot] = len(p)
        calls = []
        for r in range(5):
            kernels.reset_launches()
            lg = eng._decode_logits(arena, tok)
            torch.cuda.synchronize()
            calls.append(kernel.launches if kernel else 0)
            logits.append(lg.clone())
            tok[:, 0] = lg[:, -1].argmax(-1).cpu()
            lens[:len(prompts)] += 1          # the empty slot stays at 0
            arena["len"].copy_(lens)
        if kernel is not None:
            assert calls == [3 * cfg.n_layers] * 5, calls
        out[jit] = (logits, {k: v.clone() for k, v in arena.items()})
        buckets = {eng._bucket_len(len(p)) for p in prompts}
        if jit:
            want = {("decode", 3)} | ({("prefill", b) for b in buckets}
                                      if family == "dense" else set())
            assert set(eng._graphs) == want and eng.traces == len(want)
        else:
            assert eng.traces == 0 and not eng._graphs
    for i, (a, b) in enumerate(zip(out[True][0], out[False][0])):
        assert torch.equal(a, b), i
    for key, t in out[False][1].items():
        assert torch.equal(out[True][1][key], t), key


@pytest.mark.parametrize("precision,kv", [("int8", "float"),
                                          ("int8", "int8"),
                                          ("float", "float")])
def test_captured_engine_streams_traces_and_launches(dev, precision, kv):
    """Served captured (the default) and with jit=False: equal token
    streams over two drains; one decode graph per engine and one per
    prefill bucket (16 and 32 here), counted in traces and in
    graph.compiles; the second drain captures nothing; the kernel's
    launches are exactly 3 per layer per prefill and decode step."""
    from repro_torch import kernels
    from repro_torch.obs import metrics
    from repro_torch.serve import Engine, Request, ServeConfig
    cfg, params = _tiny_lm(dev, "dense")
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, 96, (n,)).astype(np.int32)
               for n in (5, 19, 9, 3, 30)]
    streams = {}
    for jit in (True, False):
        eng = Engine(cfg, params, ServeConfig(max_batch=2, max_len=64,
                                              precision=precision,
                                              kv_cache=kv), jit=jit)
        compiles = metrics.counter("graph.compiles").value
        runs = []
        for _ in range(2):
            for i, p in enumerate(prompts):
                eng.submit(Request(uid=i, prompt=p, max_new_tokens=6))
            kernels.reset_launches()
            done = sorted(eng.run_until_drained(), key=lambda r: r.uid)
            assert [r.status for r in done] == ["ok"] * len(prompts)
            runs.append([r.out_tokens for r in done])
            st = eng.stats
            if precision == "int8":
                assert kernels.matmul_q8.launches == 3 * cfg.n_layers * (
                    st["prefills"] + st["decode_steps"])
            if jit:
                assert eng.traces == 3
            eng.reset_stats()
        assert runs[0] == runs[1]
        assert metrics.counter("graph.compiles").value - compiles == \
            (3 if jit else 0)
        streams[jit] = runs[0]
    assert streams[True] == streams[False]


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_arena_rebuilt_in_place_and_the_graph_replays(dev, family):
    """An unrecoverable decode round (an injected fault outliving
    max_retries) retires the active set and clears the arena in place:
    the arena keeps its tensors, the next rounds replay the same decode
    graph (no new capture), and the survivors' streams equal a jit=False
    engine's under the same fault."""
    from repro_torch.faults import FaultPlan, FaultSpec
    from repro_torch.serve import Engine, Request, ServeConfig
    cfg, params = _tiny_lm(dev, family)
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, 96, (n,)).astype(np.int32)
               for n in (5, 9, 7, 4, 6)]
    results = {}
    for jit in (True, False):
        eng = Engine(cfg, params, ServeConfig(max_batch=2, max_len=48),
                     jit=jit)
        eng.submit(Request(uid=-1, prompt=prompts[0], max_new_tokens=3))
        eng.run_until_drained()                  # captures, if jit
        graphs = dict(eng._graphs)
        ptrs = {k: v.data_ptr() for k, v in eng._arena.items()}
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=5))
        with FaultPlan([FaultSpec(site="engine.decode_round", kind="raise",
                                  nth=2, times=3)]):
            done = sorted(eng.run_until_drained(), key=lambda r: r.uid)
        status = [r.status for r in done]
        assert status.count("error") == 2 and status.count("ok") == 3
        assert eng.stats["arena_rebuilds"] == 1
        assert {k: v.data_ptr() for k, v in eng._arena.items()} == ptrs
        assert eng._graphs.keys() == graphs.keys()
        assert all(eng._graphs[k] is g for k, g in graphs.items())
        if jit:
            assert ("decode", 2) in graphs
        results[jit] = [(r.status, r.out_tokens) for r in done]
    assert results[True] == results[False]


def test_failed_decode_capture_raises_and_never_runs_eager(dev,
                                                           monkeypatch):
    """A host sync inside the decode step breaks its capture: the round
    fails (the requests retire as "error" after their prefill token, the
    arena is cleared), no decode graph is kept, and no round ever falls
    back to the eager step."""
    from repro_torch.models import transformer as T
    from repro_torch.serve import Engine, Request, ServeConfig
    cfg, params = _tiny_lm(dev, "dense")
    attn = T.attn_decode

    def syncing(*a, **kw):
        if torch.cuda.is_current_stream_capturing():
            a[1].cpu()
        return attn(*a, **kw)
    monkeypatch.setattr(T, "attn_decode", syncing)
    eng = Engine(cfg, params, ServeConfig(max_batch=2, max_len=48))
    rng = np.random.default_rng(29)
    for i, n in enumerate((5, 9, 7)):
        eng.submit(Request(uid=i, prompt=rng.integers(0, 96, (n,))
                           .astype(np.int32), max_new_tokens=4))
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    assert [r.status for r in done] == ["error"] * 3
    assert all(len(r.out_tokens) == 1 for r in done)
    assert eng.stats["decode_steps"] == 0
    assert eng.stats["arena_rebuilds"] == 2
    assert ("decode", 2) not in eng._graphs
    assert eng.traces == len(eng._graphs) == 1       # the prefill bucket
