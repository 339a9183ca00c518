"""The float32 / bfloat16 modes of the port's conv, depthwise, pool,
shift, add and matmul kernels against the JAX package, on the same seeded
numpy inputs.

Each float mode's plain version (``kernels.*_f_plain``, which sums in its
CUDA kernel's order, one float32 multiply and one add at a time, then
rounds once) is held against JAX's Pallas kernel (``ops.<kernel>(...,
method="pallas")``, interpret mode on the CPU) and JAX's oracle
(``kernels.ref``) at ``tests/test_kernels.py``'s tolerances: rtol = atol
= 2e-5 in float32 and 2e-2 in bfloat16; for the matmul 1e-4, and in
bfloat16 rtol 3e-2 and atol 3e-1. Both JAX paths sum in other orders (the
Pallas kernel per tap on its matrix unit, the oracle through XLA), so no
float sum is compared bitwise against JAX; the max-pool rounds nothing
and is compared bitwise. The kernels themselves are held bitwise against
these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import tune as jtune  # noqa: E402
from repro.kernels import ops as JK  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import ops as K  # noqa: E402

DTYPES = ("float32", "bfloat16")


@pytest.fixture(autouse=True)
def _no_jax_tune_cache():
    """The Pallas calls must not read or write the JAX tuner's cache."""
    jtune.set_default_cache(jtune.TuneCache(None))
    yield
    jtune.reset()


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else \
        dict(rtol=2e-5, atol=2e-5)


def _rnd(rng, shape, dtype, scale=1.0):
    """Seeded standard-normal values, rounded to ``dtype`` once, as a
    float32 numpy array (exact in both frameworks)."""
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return torch.from_numpy(a).to(getattr(torch, dtype)).float().numpy()


def _pair(a, dtype):
    """(port tensor, JAX array) of one numpy array in ``dtype``."""
    return (torch.from_numpy(a).to(getattr(torch, dtype)),
            jnp.asarray(a).astype(getattr(jnp, dtype)))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32), **tol)


# (N, H, W, Cx, Cy, HK, groups): tests/test_kernels.py's conv shapes
CONV_SHAPES = [(1, 8, 8, 4, 8, 3, 1), (2, 12, 12, 16, 16, 5, 1),
               (1, 9, 9, 6, 9, 3, 3), (2, 16, 16, 8, 12, 1, 2),
               (1, 7, 5, 3, 4, 3, 1)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", CONV_SHAPES, ids=str)
def test_conv2d_f_plain_vs_pallas_and_ref(shape, dtype):
    n, h, w, cx, cy, hk, g = shape
    rng = np.random.default_rng(CONV_SHAPES.index(shape))
    x, jx = _pair(_rnd(rng, (n, h, w, cx), dtype), dtype)
    wt, jw = _pair(_rnd(rng, (hk, hk, cx // g, cy), dtype), dtype)
    got = kernels.conv2d_f(x, wt, groups=g)
    assert got.dtype == x.dtype and got.shape == (n, h, w, cy)
    _close(got, JK.conv2d(jx, jw, groups=g, method="pallas"), **_tol(dtype))
    _close(got, JR.conv2d_ref(jx, jw, groups=g), **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", [None, "relu"])
def test_conv2d_f_bias_then_relu_then_one_rounding(dtype, act):
    """The Pallas body's epilogue order: the float32 sum, + bias (a bf16
    bias added in float32), relu, one cast to x's dtype."""
    rng = np.random.default_rng(40)
    x, jx = _pair(_rnd(rng, (2, 8, 8, 8), dtype), dtype)
    wt, jw = _pair(_rnd(rng, (3, 3, 8, 16), dtype), dtype)
    b, jb = _pair(_rnd(rng, (16,), dtype, scale=4.0), dtype)
    got = kernels.conv2d_f(x, wt, b, act=act)
    _close(got, JK.conv2d(jx, jw, jb, act=act, method="pallas"),
           **_tol(dtype))
    # the same float32 sum, then bias, relu and one rounding by hand
    acc = kernels.conv2d_f_plain(x.float(), wt.float())
    want = acc + b.float()
    if act == "relu":
        want = torch.clamp(want, min=0)
    assert torch.equal(got, want.to(x.dtype))


def test_conv2d_f_even_hk_pads_as_the_tpu_kernel():
    """Even HK pads (HK//2, (HK-1)//2), as the Pallas kernel does (XLA's
    SAME pads the other way round): held against the Pallas kernel."""
    rng = np.random.default_rng(41)
    x, jx = _pair(_rnd(rng, (2, 6, 7, 4), "float32"), "float32")
    wt, jw = _pair(_rnd(rng, (2, 2, 4, 8), "float32"), "float32")
    _close(kernels.conv2d_f(x, wt), JK.conv2d(jx, jw, method="pallas"),
           **_tol("float32"))


DW_SHAPES = [(1, 8, 8, 16, 3), (2, 9, 7, 8, 5), (2, 8, 8, 5, 1)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", DW_SHAPES, ids=str)
def test_depthwise2d_f_plain_vs_pallas_and_ref(shape, dtype):
    n, h, w, c, hk = shape
    rng = np.random.default_rng(50 + DW_SHAPES.index(shape))
    x, jx = _pair(_rnd(rng, (n, h, w, c), dtype), dtype)
    wt, jw = _pair(_rnd(rng, (hk, hk, c), dtype), dtype)
    got = kernels.depthwise2d_f(x, wt, act="relu")
    assert got.dtype == x.dtype and got.shape == x.shape
    _close(got, JK.depthwise2d(jx, jw, act="relu", method="pallas"),
           **_tol(dtype))
    _close(got, JR.depthwise2d_ref(jx, jw, act="relu"), **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window,stride", [(2, 2), (3, 1), (3, 2)])
def test_maxpool2d_f_bitwise_vs_pallas_and_ref(window, stride, dtype):
    """A max rounds nothing: bitwise against both JAX paths."""
    rng = np.random.default_rng(60 + window * 3 + stride)
    x, jx = _pair(_rnd(rng, (2, 9, 8, 16), dtype), dtype)
    got = kernels.maxpool2d_f(x, window=window, stride=stride)
    assert got.dtype == x.dtype
    for want in (JK.maxpool2d(jx, window=window, stride=stride,
                              method="pallas"),
                 JR.maxpool2d_ref(jx, window=window, stride=stride)):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want).astype(np.float32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", [4, 8, 12, 64])
def test_maxpool2d_f_vector_widths_bitwise_vs_ref_with_nans(c, dtype):
    """The channel counts whose pixels are whole 16-byte vectors on the
    card (C = 4, 8, 12, 64: a vector path in float32, and at 8 and 64 in
    bf16), with a share of NaN taps: bitwise against JAX's oracle, NaN
    where a window holds one."""
    rng = np.random.default_rng(70 + c)
    a = _rnd(rng, (2, 9, 8, c), dtype)
    a[rng.random(a.shape) < 0.1] = np.nan
    x, jx = _pair(a, dtype)
    got = kernels.maxpool2d_f(x, window=2, stride=2)
    want = np.asarray(JR.maxpool2d_ref(jx, window=2, stride=2)
                      .astype(jnp.float32))
    assert np.isnan(want).any() and not np.isnan(want).all()
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_maxpool2d_f_propagates_nan_as_jnp_max():
    x = torch.zeros((1, 4, 4, 2))
    x[0, 1, 1, 0] = float("nan")
    x[0, 2, 3, 1] = -float("inf")
    got = kernels.maxpool2d_f(x, window=2)
    want = JR.maxpool2d_ref(jnp.asarray(x.numpy()), window=2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.isnan(got[0, 0, 0, 0]) and not torch.isnan(got[0, 1, 1, 1])


def _grid(c, d):
    grid = [(a, b) for a in range(-d, d + 1) for b in range(-d, d + 1)]
    return np.array([grid[i % len(grid)] for i in range(c)], np.int32)


SHIFT_CASES = [(2, 8, 8, 9, 8, 1), (1, 9, 7, 12, 16, 2), (2, 6, 6, 4, 4, 1)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", SHIFT_CASES, ids=str)
def test_shift_conv2d_f_plain_vs_pallas_and_ref(case, dtype):
    """The kernel sums channels in index order; the Pallas kernel per shift
    group: a tolerance (float shift is not bitwise even inside JAX)."""
    n, h, w, c, cy, d = case
    rng = np.random.default_rng(70 + SHIFT_CASES.index(case))
    x, jx = _pair(_rnd(rng, (n, h, w, c), dtype), dtype)
    wt, jw = _pair(_rnd(rng, (c, cy), dtype), dtype)
    table = _grid(c, d)
    got = kernels.shift_conv2d_f(x, torch.from_numpy(table), wt,
                                 max_shift=d, act="relu")
    assert got.dtype == x.dtype and got.shape == (n, h, w, cy)
    _close(got, JK.shift_conv2d(jx, table, jw, act="relu", method="pallas"),
           **_tol(dtype))
    _close(got, JR.shift_conv2d_ref(jx, table, jw, max_shift=d, act="relu"),
           **_tol(dtype))


ADD_CASES = [(1, 10, 10, 16, 16, 3), (2, 7, 5, 3, 8, 3), (1, 6, 6, 4, 4, 1)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ADD_CASES, ids=str)
def test_add_conv2d_f_plain_vs_pallas_and_ref(case, dtype):
    """-sum |x - w| in float32: the kernel subtracts tap by tap, channel by
    channel; the Pallas kernel sums each tap's channels first."""
    n, h, w, cx, cy, hk = case
    rng = np.random.default_rng(80 + ADD_CASES.index(case))
    x, jx = _pair(_rnd(rng, (n, h, w, cx), dtype), dtype)
    wt, jw = _pair(_rnd(rng, (hk, hk, cx, cy), dtype), dtype)
    got = kernels.add_conv2d_f(x, wt)
    assert got.dtype == x.dtype and got.shape == (n, h, w, cy)
    # bf16 outputs here are large (about -hk^2 cx): 2e-2 relative
    _close(got, JK.add_conv2d(jx, jw, method="pallas"), **_tol(dtype))
    _close(got, JR.add_conv2d_ref(jx, jw), **_tol(dtype))


MM_SHAPES = [(32, 64, 16), (128, 128, 128), (8, 16, 8), (1, 45, 37),
             (37, 45, 33)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", MM_SHAPES, ids=str)
def test_matmul_f_plain_vs_pallas_and_ref(shape, dtype):
    m, k, n = shape
    rng = np.random.default_rng(90 + MM_SHAPES.index(shape))
    a, ja = _pair(_rnd(rng, (m, k), dtype, scale=0.3), dtype)
    b, jb = _pair(_rnd(rng, (k, n), dtype, scale=0.3), dtype)
    got = kernels.matmul_f(a, b)
    assert got.dtype == a.dtype and got.shape == (m, n)
    tol = dict(rtol=3e-2, atol=3e-1) if dtype == "bfloat16" else \
        dict(rtol=1e-4, atol=1e-4)
    _close(got, JK.matmul(ja, jb, method="pallas"), **tol)
    _close(got, JR.matmul_ref(ja, jb), **tol)


def test_matmul_f_sums_k_in_order_from_zero():
    """The plain version is the kernel's arithmetic: a float32 left fold
    over K of separate products, equal to a numpy fold bit for bit."""
    rng = np.random.default_rng(95)
    a = rng.standard_normal((5, 33)).astype(np.float32)
    b = rng.standard_normal((33, 7)).astype(np.float32)
    acc = np.zeros((5, 7), np.float32)
    for kk in range(33):
        acc = acc + a[:, kk:kk + 1] * b[kk]
    got = kernels.matmul_f(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), acc)


@pytest.mark.parametrize("op", ["conv2d", "depthwise2d", "maxpool2d",
                                "shift_conv2d", "add_conv2d", "matmul"])
def test_ops_float_cuda_runs_the_plain_version_torch_the_oracle(op):
    """ops on host float tensors: "cuda" runs the float kernel's plain
    version (no launch), "torch" the JAX-facing oracle; the two agree to
    2e-5, and a 3-D matmul operand folds into M."""
    rng = np.random.default_rng(99)
    x = torch.from_numpy(rng.standard_normal((2, 7, 6, 8))
                         .astype(np.float32))
    args = {"conv2d": (x, torch.randn(3, 3, 8, 4)),
            "depthwise2d": (x, torch.randn(3, 3, 8)),
            "maxpool2d": (x,),
            "shift_conv2d": (x, torch.from_numpy(_grid(8, 1)),
                             torch.randn(8, 4)),
            "add_conv2d": (x, torch.randn(3, 3, 8, 4)),
            "matmul": (x.reshape(2, 42, 8), torch.randn(8, 5))}[op]
    fn = getattr(K, op)
    kernels.reset_launches()
    got = fn(*args, method="cuda")
    assert all(k.launches == 0 for k in kernels.KERNELS)
    plain = {"conv2d": kernels.conv2d_f_plain,
             "depthwise2d": kernels.depthwise2d_f_plain,
             "maxpool2d": kernels.maxpool2d_plain,
             "shift_conv2d": kernels.shift_conv2d_f_plain,
             "add_conv2d": kernels.add_conv2d_f_plain,
             "matmul": kernels.matmul_f_plain}[op]
    if op == "matmul":
        want = plain(args[0].reshape(84, 8), args[1]).reshape(2, 42, 5)
    else:
        want = plain(*args)
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(),
                               fn(*args, method="torch").numpy(),
                               rtol=2e-5, atol=2e-5)


def test_float_wrappers_check_their_operands():
    x = torch.zeros((1, 4, 4, 4))
    with pytest.raises(ValueError, match="bp must be"):
        kernels.conv2d_f(x, torch.zeros((3, 3, 4, 4)), bp=100)
    with pytest.raises(ValueError, match="does not fit"):
        kernels.add_conv2d_f(x, torch.zeros((3, 3, 3, 4)))
    with pytest.raises(ValueError, match="bm"):      # no such tile
        kernels.matmul_f(torch.zeros((4, 4)), torch.zeros((4, 4)), bm=48)
    with pytest.raises(ValueError, match="contract"):
        kernels.matmul_f(torch.zeros((4, 4)), torch.zeros((5, 4)))
    with pytest.raises(ValueError, match="act"):
        kernels.depthwise2d_f(x, torch.zeros((3, 3, 4)), act="gelu")
