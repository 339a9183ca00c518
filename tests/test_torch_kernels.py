"""Each ported kernel's plain PyTorch version against the JAX oracle
(``repro.kernels.ref``) and the Pallas kernel (``repro.kernels.ops``,
method="pallas", in interpret mode on the CPU), bit for bit, on the same
seeded numpy inputs. The CUDA kernels themselves are held against the
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels import ops as JK  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402

from repro_torch.kernels import ops as K  # noqa: E402


def _i8(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


def _t(a):
    return None if a is None else torch.from_numpy(a)


# (N, H, W, Cx, Cy, HK, groups, bias, act, shift): every value of each axis
# appears, odd H/W included
CONV_CASES = [
    (2, 8, 8, 8, 8, 3, 1, True, "relu", 7),
    (2, 8, 8, 8, 8, 1, 1, False, None, 0),
    (2, 8, 8, 8, 8, 3, 2, True, None, 1),
    (2, 8, 8, 8, 8, 1, 2, False, "relu", -2),
    (2, 7, 5, 3, 8, 3, 1, True, "relu", 1),
    (2, 8, 8, 8, 8, 3, 1, False, None, -2),
    # the Table-2 jobs' width: Cx = 128 at 10^2, n = 1, groups 4 and 1
    (1, 10, 10, 128, 64, 3, 4, True, "relu", 9),
    (1, 10, 10, 128, 64, 3, 1, False, None, 12),
]


@pytest.mark.parametrize("case", CONV_CASES, ids=str)
def test_conv2d_q8_plain_equals_ref_and_pallas(case):
    n, h, w, cx, cy, hk, g, with_bias, act, shift = case
    rng = np.random.default_rng(CONV_CASES.index(case))
    x = _i8(rng, (n, h, w, cx))
    wt = _i8(rng, (hk, hk, cx // g, cy))
    b = rng.integers(-3000, 3000, cy).astype(np.int32) if with_bias else None
    got = K.conv2d(_t(x), _t(wt), _t(b), groups=g, method="torch",
                   requant_shift=shift, act=act)
    assert got.dtype == torch.int8 and got.shape == (n, h, w, cy)
    jb = None if b is None else jnp.asarray(b)
    want = JR.conv2d_q8_ref(jnp.asarray(x), jnp.asarray(wt), jb, groups=g,
                            requant_shift=shift, act=act)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pallas = JK.conv2d(jnp.asarray(x), jnp.asarray(wt), jb, groups=g,
                       method="pallas", requant_shift=shift, act=act)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


def test_conv2d_q8_even_hk_pads_as_the_tpu_kernel():
    """For even HK the TPU kernel pads (HK//2, (HK-1)//2) — the other way
    round from XLA's SAME, which the JAX oracle uses — and the port keeps
    the kernel's padding: held against the Pallas kernel only."""
    rng = np.random.default_rng(5)
    x, wt = _i8(rng, (2, 6, 7, 4)), _i8(rng, (2, 2, 4, 8))
    got = K.conv2d(_t(x), _t(wt), method="torch", requant_shift=3)
    pallas = JK.conv2d(jnp.asarray(x), jnp.asarray(wt), method="pallas",
                       requant_shift=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


@pytest.mark.parametrize("layout4", [False, True], ids=["HKxHKxC",
                                                        "HKxHKxCx1"])
@pytest.mark.parametrize("shape,act,shift", [
    ((2, 8, 8, 8), "relu", 5), ((2, 7, 9, 8), None, -2),
    ((2, 8, 8, 8), None, 0)], ids=str)
def test_depthwise2d_q8_plain_equals_ref_and_pallas(shape, act, shift,
                                                    layout4):
    rng = np.random.default_rng(shape[1] * 31 + shift)
    x = _i8(rng, shape)
    wt = _i8(rng, (3, 3, shape[-1]))
    if layout4:
        wt = wt[..., None]
    got = K.depthwise2d(_t(x), _t(wt), method="torch", requant_shift=shift,
                        act=act)
    want = JR.depthwise2d_q8_ref(jnp.asarray(x), jnp.asarray(wt),
                                 requant_shift=shift, act=act)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pallas = JK.depthwise2d(jnp.asarray(x), jnp.asarray(wt), method="pallas",
                            requant_shift=shift, act=act)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


@pytest.mark.parametrize("dtype", ["int8", "float32"])
@pytest.mark.parametrize("window,stride", [(2, 2), (3, 1), (2, 1), (3, 2)])
def test_maxpool2d_plain_equals_ref_and_pallas(dtype, window, stride):
    rng = np.random.default_rng(window * 10 + stride)
    if dtype == "int8":
        x = _i8(rng, (2, 8, 9, 8))
    else:
        x = rng.standard_normal((2, 8, 9, 8)).astype(np.float32)
    got = K.maxpool2d(_t(x), window=window, stride=stride, method="torch")
    assert str(got.dtype) == f"torch.{dtype}"
    want = JR.maxpool2d_ref(jnp.asarray(x), window=window, stride=stride)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pallas = JK.maxpool2d(jnp.asarray(x), window=window, stride=stride,
                          method="pallas")
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


def _shift_table(kind, c, rng):
    """(C,2) int32 shift tables: the paper's HK x HK grid assignment, every
    channel on one displacement, or random within max_shift=2."""
    if kind in ("grid3", "grid5"):
        d = int(kind[-1]) // 2
        grid = [(a, b) for a in range(-d, d + 1) for b in range(-d, d + 1)]
        return np.array([grid[i % len(grid)] for i in range(c)], np.int32)
    if kind == "one":
        return np.tile(np.array([[1, -1]], np.int32), (c, 1))
    return rng.integers(-2, 3, (c, 2)).astype(np.int32)


# (N, H, W, C, Cy, table, max_shift, bias, act, shift)
SHIFT_CASES = [
    (2, 8, 8, 8, 8, "grid3", 1, True, "relu", 7),
    (2, 7, 5, 9, 8, "grid5", 2, False, None, 0),
    (2, 8, 8, 8, 16, "one", 1, True, None, -2),
    (2, 9, 7, 12, 8, "random", 2, True, "relu", 1),
]


@pytest.mark.parametrize("case", SHIFT_CASES, ids=str)
def test_shift_conv2d_q8_plain_equals_ref_and_pallas(case):
    n, h, w, c, cy, kind, max_shift, with_bias, act, shift = case
    rng = np.random.default_rng(100 + SHIFT_CASES.index(case))
    x = _i8(rng, (n, h, w, c))
    table = _shift_table(kind, c, rng)
    wt = _i8(rng, (c, cy))
    b = rng.integers(-3000, 3000, cy).astype(np.int32) if with_bias else None
    kw = dict(requant_shift=shift, act=act, max_shift=max_shift)
    got = K.shift_conv2d(_t(x), _t(table), _t(wt), _t(b), method="torch",
                         **kw)
    assert got.dtype == torch.int8 and got.shape == (n, h, w, cy)
    jb = None if b is None else jnp.asarray(b)
    want = JR.shift_conv2d_q8_ref(jnp.asarray(x), jnp.asarray(table),
                                  jnp.asarray(wt), jb, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pallas = JK.shift_conv2d(jnp.asarray(x), jnp.asarray(table),
                             jnp.asarray(wt), jb, method="pallas", **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    # the (1,1,C,Cy) weight layout is the same bytes
    got4 = K.shift_conv2d(_t(x), _t(table), _t(wt[None, None]), _t(b),
                          method="torch", **kw)
    assert torch.equal(got4, got)


# (N, H, W, Cx, Cy, HK, x_preshift, w_preshift, bias, act, shift); the
# last case pre-shifts far enough that the int32 sum wraps
ADD_CASES = [
    (2, 8, 8, 4, 8, 3, 0, 0, True, "relu", 7),
    (2, 7, 5, 3, 8, 3, 0, 3, False, None, 9),
    (2, 6, 6, 4, 8, 3, 2, 0, True, None, 10),
    (2, 6, 7, 4, 8, 2, 0, 0, True, None, 6),
    (2, 5, 5, 4, 4, 3, 28, 20, True, None, 24),
]


@pytest.mark.parametrize("case", ADD_CASES, ids=str)
def test_add_conv2d_q8_plain_equals_ref_and_pallas(case):
    n, h, w, cx, cy, hk, xp, wp, with_bias, act, shift = case
    rng = np.random.default_rng(200 + ADD_CASES.index(case))
    x = _i8(rng, (n, h, w, cx))
    wt = _i8(rng, (hk, hk, cx, cy))
    b = rng.integers(-3000, 3000, cy).astype(np.int32) if with_bias else None
    kw = dict(requant_shift=shift, x_preshift=xp, w_preshift=wp, act=act)
    got = K.add_conv2d(_t(x), _t(wt), _t(b), method="torch", **kw)
    assert got.dtype == torch.int8 and got.shape == (n, h, w, cy)
    jb = None if b is None else jnp.asarray(b)
    pallas = JK.add_conv2d(jnp.asarray(x), jnp.asarray(wt), jb,
                           method="pallas", **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    if hk % 2:    # for even HK the JAX oracle pads the XLA way round
        want = JR.add_conv2d_q8_ref(jnp.asarray(x), jnp.asarray(wt), jb,
                                    **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if xp >= 24:  # the exact sum leaves int32: the result is its wrap
        exact = -np.abs((x.astype(np.int64) << xp)[..., None]
                        - (wt[1, 1].astype(np.int64) << wp)).sum(axis=-2)
        assert np.abs(exact).max() > 2 ** 31
        assert len(np.unique(got.numpy())) > 50


def test_float_shift_and_add_follow_the_oracles():
    """The float modes: plain versions on the host, against the JAX oracles
    (float32 sums in another order: rtol=atol=1e-5)."""
    rng = np.random.default_rng(300)
    x = rng.standard_normal((2, 7, 6, 8)).astype(np.float32)
    table = _shift_table("grid3", 8, rng)
    w_pw = rng.standard_normal((8, 4)).astype(np.float32)
    w = rng.standard_normal((3, 3, 8, 4)).astype(np.float32)
    got = K.shift_conv2d(_t(x), _t(table), _t(w_pw), max_shift=1,
                         act="relu")
    want = JR.shift_conv2d_ref(jnp.asarray(x), jnp.asarray(table),
                               jnp.asarray(w_pw), max_shift=1, act="relu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    got = K.add_conv2d(_t(x), _t(w))
    want = JR.add_conv2d_ref(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="quantized path"):
        K.add_conv2d(_t(x), _t(w), x_preshift=1)


def test_cuda_method_on_host_tensors_runs_plain_without_launch():
    """A CPU tensor always runs the plain version, whatever the method, and
    launches nothing."""
    from repro_torch import kernels
    rng = np.random.default_rng(9)
    x, wt = _t(_i8(rng, (1, 5, 5, 4))), _t(_i8(rng, (3, 3, 4, 4)))
    kernels.reset_launches()
    from repro_torch.obs import metrics
    dispatch = {m: metrics.counter(f"kernels.dispatch.conv2d.{m}")
                for m in ("cuda", "torch")}
    before = {m: c.value for m, c in dispatch.items()}
    a = K.conv2d(x, wt, method="cuda", requant_shift=4)
    b = K.conv2d(x, wt, method="torch", requant_shift=4)
    assert torch.equal(a, b)
    assert K.maxpool2d(a, method="cuda").shape == (1, 2, 2, 4)
    assert all(k.launches == 0 for k in kernels.KERNELS)
    # dispatches are counted per kernel and method, launches only on a card
    assert {m: c.value - before[m] for m, c in dispatch.items()} == \
        {"cuda": 1, "torch": 1}


def test_default_device_raises_without_a_card():
    """Entry points default to device='cuda'; with no card they raise
    instead of quietly running on the host."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the default device is usable")
    from repro_torch.graph import CompiledPlan, Plan
    from repro_torch.models import CNNConfig, init_cnn, quantize_cnn
    cfg = CNNConfig(primitive="dws", widths=(8, 12), image_size=16)
    with pytest.raises(RuntimeError, match="CUDA card"):
        CompiledPlan(Plan((), 7), method="cuda")
    with pytest.raises(RuntimeError, match="CUDA card"):
        init_cnn(cfg, torch.Generator())
    params = init_cnn(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA card"):
        quantize_cnn(params, cfg, np.zeros((2, 16, 16, 3), np.float32))


def test_wrappers_reject_bad_arguments():
    from repro_torch.kernels import (add_conv2d_q8, conv2d_q8, depthwise2d_q8,
                                     maxpool2d_s8, shift_conv2d_q8)
    x = torch.zeros((1, 4, 4, 4), dtype=torch.int8)
    table = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="shift table"):
        shift_conv2d_q8(x, table[:3], torch.zeros((4, 8), dtype=torch.int8))
    with pytest.raises(ValueError, match="does not fit"):
        shift_conv2d_q8(x, table, torch.zeros((5, 8), dtype=torch.int8))
    with pytest.raises(ValueError, match="x_preshift"):
        add_conv2d_q8(x, torch.zeros((3, 3, 4, 8), dtype=torch.int8),
                      x_preshift=32)
    with pytest.raises(ValueError, match="does not fit"):
        add_conv2d_q8(x, torch.zeros((3, 3, 3, 8), dtype=torch.int8))
    with pytest.raises(ValueError, match="requant_shift"):
        conv2d_q8(x, torch.zeros((3, 3, 4, 4), dtype=torch.int8),
                  requant_shift=32)
    with pytest.raises(ValueError, match="does not fit"):
        conv2d_q8(x, torch.zeros((3, 3, 3, 4), dtype=torch.int8))
    with pytest.raises(ValueError, match="act"):
        depthwise2d_q8(x, torch.zeros((3, 3, 4), dtype=torch.int8),
                       act="gelu")
    with pytest.raises(TypeError, match="int8"):
        maxpool2d_s8(x.float())
    with pytest.raises(ValueError, match="method"):
        K.maxpool2d(x, method="pallas")
