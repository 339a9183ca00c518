"""The port's core layer against ``repro.core`` on the same seeded numpy
inputs: ConvSpec counts, the float primitives and BN (float tolerance),
BN folding, and the integer ``qconv_apply`` inside and outside the
kernels' stride-1 / SAME envelope (bitwise)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import primitives as JP  # noqa: E402
from repro.core.folding import fold as j_fold  # noqa: E402
from repro.core.qconv import qconv_apply as j_qconv_apply  # noqa: E402
from repro.core.qconv import quantize_conv_params as j_qparams  # noqa: E402
from repro.core.quantize import quantize as j_quantize  # noqa: E402

from repro_torch.core import primitives as P  # noqa: E402
from repro_torch.core.folding import fold  # noqa: E402
from repro_torch.core.qconv import qconv_apply, quantize_conv_params  # noqa: E402
from repro_torch.core.quantize import QTensor, quantize  # noqa: E402

# float32 convolutions sum in another order than XLA's
FLOAT_TOL = dict(rtol=1e-5, atol=1e-5)


def _spec(prim, stride=1, padding="SAME", cx=8, cy=12, hk=3):
    groups = 2 if prim == "grouped" else 1
    kw = dict(primitive=prim, in_channels=cx, out_channels=cy,
              kernel_size=hk, groups=groups, stride=stride, padding=padding)
    return P.ConvSpec(**kw), JP.ConvSpec(**kw)


def _params(spec, seed):
    """Float params in the JAX layout, from numpy."""
    rng = np.random.default_rng(seed)
    hk, cx, cy = spec.kernel_size, spec.in_channels, spec.out_channels
    if spec.primitive == "dws":
        p = {"w_dw": rng.standard_normal((hk, hk, cx, 1)) * 0.3,
             "w_pw": rng.standard_normal((1, 1, cx, cy)) * 0.3}
    elif spec.primitive == "shift":
        p = {"w_pw": rng.standard_normal((1, 1, cx, cy)) * 0.3}
    else:
        p = {"w": rng.standard_normal((hk, hk, cx // spec.groups, cy)) * 0.2}
    p["b"] = rng.standard_normal(cy) * 0.1
    p = {k: v.astype(np.float32) for k, v in p.items()}
    if spec.primitive == "shift":    # a random table within max_shift
        d = hk // 2
        p["shifts"] = rng.integers(-d, d + 1, (cx, 2)).astype(np.int32)
    return p


def _both(p):
    return ({k: torch.from_numpy(v) for k, v in p.items()},
            {k: jnp.asarray(v) for k, v in p.items()})


@pytest.mark.parametrize("prim", ["standard", "grouped", "dws", "shift",
                                  "add"])
def test_convspec_counts(prim):
    s, js = _spec(prim)
    assert s.param_count() == js.param_count()
    assert s.mac_count(16) == js.mac_count(16)


@pytest.mark.parametrize("prim,stride,padding", [
    ("standard", 1, "SAME"), ("standard", 2, "VALID"), ("grouped", 2, "SAME"),
    ("dws", 1, "SAME"), ("dws", 2, "SAME"), ("shift", 1, "SAME"),
    ("shift", 2, "SAME")])
def test_float_apply_and_batchnorm(prim, stride, padding):
    s, js = _spec(prim, stride, padding)
    tp, jp = _both(_params(s, 1))
    x = np.random.default_rng(2).standard_normal((2, 9, 11, 8)) \
        .astype(np.float32)
    got = P.apply(tp, torch.from_numpy(x), s)
    want = JP.apply(jp, jnp.asarray(x), js)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FLOAT_TOL)
    rng = np.random.default_rng(3)
    bn = {"gamma": rng.standard_normal(12), "beta": rng.standard_normal(12),
          "mean": rng.standard_normal(12), "var": rng.random(12) + 0.5}
    tbn, jbn = _both({k: v.astype(np.float32) for k, v in bn.items()})
    np.testing.assert_allclose(
        P.batchnorm_apply(tbn, got).numpy(),
        np.asarray(JP.batchnorm_apply(jbn, jnp.asarray(got.numpy()))),
        **FLOAT_TOL)
    f = fold(tp, tbn, s)
    jf = j_fold(jp, jbn, js)
    for k in f:
        np.testing.assert_allclose(f[k].numpy(), np.asarray(jf[k]),
                                   **FLOAT_TOL)


@pytest.mark.parametrize("stride,padding,hk", [
    (1, "SAME", 3), (1, "VALID", 3), (2, "SAME", 3), (1, "SAME", 2)])
def test_float_add_conv_apply(stride, padding, hk):
    """The float AdderNet layer, accumulated tap by tap, against JAX's
    patch-extraction form; both ignore the stride, as the JAX package
    does. A sum of Cx*HK^2 float32 terms in another order: FLOAT_TOL."""
    s, js = _spec("add", stride, padding, hk=hk)
    tp, jp = _both(_params(s, 11))
    x = np.random.default_rng(12).standard_normal((2, 9, 11, 8)) \
        .astype(np.float32)
    got = P.apply(tp, torch.from_numpy(x), s)
    want = JP.apply(jp, jnp.asarray(x), js)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FLOAT_TOL)
    with pytest.raises(ValueError, match="add-conv keeps explicit BN"):
        fold(tp, {}, s)


def test_init_shift_and_add_match_jax():
    """Shifts are assigned from the HK x HK displacement grid (the same
    table as the JAX package's); the weights are He-normal draws of the
    JAX shapes."""
    for hk in (3, 5):
        s, js = _spec("shift", cx=30, hk=hk)
        p = P.init(torch.Generator().manual_seed(0), s)
        jp = JP.init(jax.random.PRNGKey(0), js)
        assert p["shifts"].dtype == torch.int32
        np.testing.assert_array_equal(p["shifts"].numpy(),
                                      np.asarray(jp["shifts"]))
        assert p["w_pw"].shape == jp["w_pw"].shape
    s, js = _spec("add")
    p = P.init(torch.Generator().manual_seed(0), s)
    jp = JP.init(jax.random.PRNGKey(0), js)
    assert set(p) == set(jp) and p["w"].shape == jp["w"].shape


def test_shift_table_beyond_max_shift_raises():
    x = torch.zeros((1, 4, 4, 2))
    table = torch.tensor([[0, 2], [1, -1]], dtype=torch.int32)
    assert P.shift_channels(x, table, max_shift=2).shape == x.shape
    with pytest.raises(ValueError, match="exceeding the declared max_shift"):
        P.shift_channels(x, table, max_shift=1)


def _qlayer(prim, stride, padding, seed):
    s, js = _spec(prim, stride, padding)
    p = _params(s, seed)
    jq = j_qparams({k: jnp.asarray(v) for k, v in p.items()}, js)
    q = {k: torch.tensor(np.asarray(v)) if k == "shifts"
         else QTensor(torch.tensor(np.asarray(v.q)), v.frac_bits)
         for k, v in jq.items()}
    x = (np.random.default_rng(seed + 1).standard_normal((2, 9, 11, 8))
         .astype(np.float32))
    return s, js, q, jq, x


@pytest.mark.parametrize("prim,stride,padding,act,mid", [
    ("standard", 1, "SAME", "relu", None), ("grouped", 1, "SAME", None, None),
    ("dws", 1, "SAME", "relu", None), ("dws", 1, "SAME", None, 3),
    ("standard", 2, "VALID", "relu", None), ("grouped", 2, "SAME", None, None),
    ("dws", 2, "SAME", "relu", None), ("shift", 1, "SAME", "relu", None),
    ("shift", 1, "SAME", None, None), ("shift", 2, "SAME", "relu", None)])
def test_qconv_apply_bitwise(prim, stride, padding, act, mid):
    """In the kernels' envelope the port's plain kernels, outside it the
    lax-path counterpart: both bitwise equal to JAX's xla method."""
    s, js, q, jq, x = _qlayer(prim, stride, padding, 5)
    if mid is not None:
        q["mid_frac_bits"] = jq["mid_frac_bits"] = mid
    xq = quantize(torch.from_numpy(x), 5)
    jxq = j_quantize(jnp.asarray(x), 5)
    got = qconv_apply(q, xq, s, 4, method="torch", act=act)
    want = j_qconv_apply(jq, jxq, js, 4, method="xla", act=act)
    assert got.frac_bits == want.frac_bits == 4
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    if stride != 1:
        with pytest.raises(NotImplementedError, match="stride=1 SAME"):
            qconv_apply(q, xq, s, 4, method="cuda", act=act)


@pytest.mark.parametrize("stride,padding,act,dfb,with_bias", [
    (1, "SAME", "relu", -2, True), (1, "SAME", None, 0, True),
    (1, "SAME", None, 3, False), (2, "SAME", "relu", 3, True),
    (1, "VALID", None, -2, True)])
def test_qconv_apply_add_bitwise(stride, padding, act, dfb, with_bias):
    """The add primitive with the input on a coarser (dfb < 0), the same
    (0) or a finer (dfb > 0) scale than the weights, so each pre-shift
    branch runs: the port's plain kernel (stride 1 SAME) or its lax-path
    counterpart (else) bitwise equal to JAX's xla method."""
    s, js, q, jq, x = _qlayer("add", stride, padding, 21)
    if not with_bias:
        del q["b"], jq["b"]
    x_fb = q["w"].frac_bits + dfb
    acc_fb = max(x_fb, q["w"].frac_bits)
    out_fb = acc_fb - 7                   # -sum|x - w| is ~2^12 codes
    got = qconv_apply(q, quantize(torch.from_numpy(x), x_fb), s, out_fb,
                      method="torch", act=act)
    want = j_qconv_apply(jq, j_quantize(jnp.asarray(x), x_fb), js, out_fb,
                         method="xla", act=act)
    assert got.frac_bits == want.frac_bits == out_fb
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    if act is None:          # (relu zeroes the all-negative outputs)
        assert len(np.unique(got.q.numpy())) > 10      # not clipped flat
    if stride != 1 or padding != "SAME":
        with pytest.raises(NotImplementedError, match="stride=1 SAME"):
            qconv_apply(q, quantize(torch.from_numpy(x), x_fb), s, out_fb,
                        method="cuda", act=act)


@pytest.mark.parametrize("prim", ["dws", "shift", "add"])
def test_quantize_conv_params_matches_jax(prim):
    s, js = _spec(prim)
    p = _params(s, 7)
    got = quantize_conv_params({k: torch.from_numpy(v) for k, v in p.items()},
                               s)
    want = j_qparams({k: jnp.asarray(v) for k, v in p.items()}, js)
    assert set(got) == set(want)
    for k in want:
        if k == "shifts":                # the table is kept as it is
            np.testing.assert_array_equal(got[k].numpy(), p[k])
            continue
        assert got[k].frac_bits == want[k].frac_bits
        np.testing.assert_array_equal(got[k].q.numpy(), np.asarray(want[k].q))
    # bits=4: the weights become QTensorW4 equal to JAX's bit for bit (the
    # same float weights, no fold), biases stay int8
    got4 = quantize_conv_params({k: torch.from_numpy(v)
                                 for k, v in p.items()}, s, bits=4,
                                group_size=4)
    want4 = j_qparams({k: jnp.asarray(v) for k, v in p.items()}, js, bits=4,
                      group_size=4)
    for k in ("w", "w_dw", "w_pw", "b"):
        if k not in want4:
            continue
        assert type(got4[k]).__name__ == type(want4[k]).__name__, k
        assert got4[k].frac_bits == want4[k].frac_bits, k
        np.testing.assert_array_equal(got4[k].q.numpy(),
                                      np.asarray(want4[k].q))
        if k != "b":
            assert (got4[k].size, got4[k].axis) == (want4[k].size,
                                                    want4[k].axis)
            np.testing.assert_array_equal(got4[k].shifts.numpy(),
                                          np.asarray(want4[k].shifts))
    with pytest.raises(ValueError, match="bits"):
        quantize_conv_params({k: torch.from_numpy(v) for k, v in p.items()},
                             s, bits=2)


@pytest.mark.parametrize("prim", ["dws", "shift", "add"])
def test_cnn_forward_float_matches_jax(prim):
    """The float eval path through the port's graph interpreter, on the
    JAX package's parameters converted leaf by leaf."""
    from repro.models.convnet import CNNConfig as JCNNConfig
    from repro.models.convnet import cnn_forward as j_cnn_forward
    from repro.models.convnet import init_cnn as j_init_cnn
    from repro_torch.models import CNNConfig, cnn_forward
    from repro_torch.weights import params_from_numpy
    jcfg = JCNNConfig(primitive=prim, widths=(8, 12), image_size=16)
    cfg = CNNConfig(**dataclasses.asdict(jcfg))
    jparams = j_init_cnn(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    x = np.random.default_rng(4).standard_normal((3, 16, 16, 3)) \
        .astype(np.float32)
    np.testing.assert_allclose(
        cnn_forward(params, torch.from_numpy(x), cfg).numpy(),
        np.asarray(j_cnn_forward(jparams, jnp.asarray(x), jcfg)), **FLOAT_TOL)
