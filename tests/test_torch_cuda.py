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
    with pytest.raises(ValueError, match="contiguous"):
        causal_conv1d(x.transpose(0, 1).contiguous().transpose(0, 1), w)
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
