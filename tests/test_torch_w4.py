"""The port's W4A8 mode against the JAX package, bit for bit, on the same
seeded numpy inputs: nibble packing, ``quantize_w4``, the four W4 plain
kernel versions (against JAX's ``*_w4_ref`` oracles and the Pallas W4
kernels in interpret mode), ``qconv_apply`` on W4 leaves, and whole W4
plans carried across by ``weights.plan_from_numpy``.

Every integer result is compared exactly (tolerance 0); the float head's
logits sum in another order than XLA's and agree to atol=1e-5."""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import tune  # noqa: E402
from repro.core.qconv import qconv_apply as j_qconv_apply  # noqa: E402
from repro.core.qconv import quantize_conv_params as j_qparams  # noqa: E402
from repro.core.quantize import QTensorW4 as JQTensorW4  # noqa: E402
from repro.core.quantize import expand_w4 as j_expand_w4  # noqa: E402
from repro.core.quantize import pack_w4 as j_pack_w4  # noqa: E402
from repro.core.quantize import quantize as j_quantize  # noqa: E402
from repro.core.quantize import quantize_w4 as j_quantize_w4  # noqa: E402
from repro.core.quantize import unpack_w4 as j_unpack_w4  # noqa: E402
from repro.graph import CompiledPlan as JCompiledPlan  # noqa: E402
from repro.graph import build_cnn_graph as j_build  # noqa: E402
from repro.graph import lower as j_lower  # noqa: E402
from repro.kernels import ops as JK  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro.models.convnet import CNNConfig as JCNNConfig  # noqa: E402
from repro.models.convnet import init_cnn as j_init_cnn  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.core import primitives as P  # noqa: E402
from repro_torch.core.qconv import qconv_apply, quantize_conv_params  # noqa: E402
from repro_torch.core.quantize import (QTensor, QTensorW4, expand_w4,  # noqa: E402
                                       pack_w4, quantize, quantize_w4,
                                       unpack_w4)
from repro_torch.graph import CompiledPlan, build_cnn_graph, lower  # noqa: E402
from repro_torch.kernels import ops as K  # noqa: E402
from repro_torch.models import CNNConfig  # noqa: E402
from repro_torch.weights import params_from_numpy, plan_from_numpy  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_graph import _jax_trunk, plan_to_numpy  # noqa: E402

PRIMS = ("standard", "grouped", "dws", "shift", "add")


@pytest.fixture(autouse=True)
def _no_tune_cache():
    """The Pallas calls must not read or write the tuner's cache."""
    tune.set_default_cache(tune.TuneCache(None))
    yield
    tune.reset()


def _codes(rng, shape):
    """int4 codes in [-8, 7], the two corners always present."""
    q = rng.integers(-8, 8, shape).astype(np.int8)
    q.flat[0], q.flat[-1] = -8, 7
    return q


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


# ------------------------------------------------------------ pack/unpack --

@pytest.mark.parametrize("n", [1, 2, 3, 7, 8])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_pack_unpack_expand_equal_jax(n, axis):
    """Bitwise against the JAX package on odd and even extents along every
    axis; the packed extent is ceil(n/2) and the round trip is exact."""
    rng = np.random.default_rng(10 * n + axis)
    shape = [3, 4, 5]
    shape[axis] = n
    q = _codes(rng, shape)
    p = pack_w4(_t(q), axis)
    assert p.dtype == torch.int8 and p.shape[axis] == (n + 1) // 2
    np.testing.assert_array_equal(p.numpy(), np.asarray(j_pack_w4(q, axis)))
    np.testing.assert_array_equal(unpack_w4(p, n, axis).numpy(), q)
    np.testing.assert_array_equal(
        unpack_w4(p, n, axis).numpy(),
        np.asarray(j_unpack_w4(jnp.asarray(p.numpy()), n, axis)))
    shifts = rng.integers(0, 5, n).astype(np.int8)
    got = expand_w4(p, _t(shifts), n, axis)
    want = j_expand_w4(jnp.asarray(p.numpy()), jnp.asarray(shifts), n, axis)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pack_corners_shift4_and_pad_nibble():
    """-8 and +7 survive packing; at group shift 4 they expand to -128 and
    112 (still int8); the pad nibble of an odd extent is 0."""
    q = np.array([-8, 7, -8], np.int8)
    p = pack_w4(_t(q), 0)
    assert int(p[1]) & 0xF0 == 0
    np.testing.assert_array_equal(p.numpy(), np.asarray(j_pack_w4(q, 0)))
    got = expand_w4(p, torch.full((3,), 4, dtype=torch.int8), 3, 0)
    assert got.tolist() == [-128, 112, -128]


# ------------------------------------------------------------ quantize_w4 --

@pytest.mark.parametrize("shape,axis,group", [
    ((32, 6), 0, 8), ((17, 4), 0, 4), ((5, 3), 0, 32), ((3, 3, 7, 5), 2, 2),
    ((2, 3, 8), 0, 32), ((4, 9), 1, 4)], ids=str)
def test_quantize_w4_equals_jax(shape, axis, group):
    """The same float32 weights, spread over eight octaves so the group
    shifts clamp at 4, give the same bytes, shifts and base scale."""
    rng = np.random.default_rng(sum(shape) + group)
    w = (rng.standard_normal(shape)
         * 2.0 ** rng.integers(-5, 3, shape)).astype(np.float32)
    got = quantize_w4(_t(w), axis=axis, group_size=group)
    want = j_quantize_w4(jnp.asarray(w), axis=axis, group_size=group)
    assert (got.frac_bits, got.size, got.axis) == \
        (want.frac_bits, want.size, want.axis)
    assert got.q.is_contiguous()          # the layout the kernels read
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.shifts.numpy(), np.asarray(want.shifts))
    np.testing.assert_array_equal(got.expand().numpy(),
                                  np.asarray(want.expand()))


def test_quantize_w4_zero_group_and_shift_clamp():
    """A zero group takes the sentinel and sits at the base scale; a group
    eight octaves below the largest clamps at shift 4."""
    w = np.zeros((12, 3), np.float32)
    w[:4] = 3.0
    w[8:] = 3.0 / 256
    got = quantize_w4(_t(w), axis=0, group_size=4)
    want = j_quantize_w4(jnp.asarray(w), axis=0, group_size=4)
    assert got.frac_bits == want.frac_bits
    assert got.shifts.tolist() == np.asarray(want.shifts).tolist()
    assert int(got.shifts.max()) == 4
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    assert not got.expand()[4:8].any()


# ------------------------------------------------- W4 kernel plain versions --

def _spread(w, axis, group):
    """Scale ``w`` down an octave per group of ``group`` elements along
    ``axis`` (cycling over four octaves), so that W4 quantization gives
    several distinct group shifts."""
    octave = (np.arange(w.shape[axis]) // group) % 4
    shape = [1] * w.ndim
    shape[axis] = -1
    return (w * 2.0 ** -octave.reshape(shape)).astype(np.float32)


def _w4(rng, shape, axis, group=4):
    """Float weights spread over the groups of the packed axis -> JAX
    QTensorW4."""
    w = _spread(rng.standard_normal(shape), axis, group)
    return j_quantize_w4(jnp.asarray(w), axis=axis, group_size=group)


def _both(qt):
    return (_t(np.asarray(qt.q)), _t(np.asarray(qt.shifts)),
            qt.q, qt.shifts)


@pytest.mark.parametrize("case", [
    # (N, H, W, Cx, Cy, HK, groups, bias, act, requant shift)
    (2, 8, 8, 8, 8, 3, 1, True, "relu", 7),
    (2, 7, 5, 6, 9, 3, 3, False, None, 5),
    (1, 6, 6, 5, 4, 1, 1, True, None, 0),
    (2, 7, 5, 3, 8, 3, 1, False, "relu", -2),
    (1, 10, 10, 128, 64, 3, 4, True, "relu", 9),
], ids=str)
def test_conv2d_w4_plain_equals_ref_and_pallas(case):
    """Odd Cx and Cx/g carry a pad nibble; tolerance 0."""
    n, h, w, cx, cy, hk, g, with_bias, act, rs = case
    rng = np.random.default_rng(cx * 7 + g)
    x = rng.integers(-128, 128, (n, h, w, cx)).astype(np.int8)
    wp, ws, jwp, jws = _both(_w4(rng, (hk, hk, cx // g, cy), 2))
    assert cx // g <= 4 or len(set(ws.tolist())) > 1
    b = rng.integers(-3000, 3000, cy).astype(np.int32) if with_bias else None
    got = K.conv2d(_t(x), wp, _t(b), groups=g, method="torch",
                   requant_shift=rs, act=act, w_shifts=ws)
    jb = None if b is None else jnp.asarray(b)
    want = JR.conv2d_w4_ref(jnp.asarray(x), jwp, jws, jb, groups=g,
                            requant_shift=rs, act=act)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pallas = JK.conv2d(jnp.asarray(x), jwp, jb, groups=g, method="pallas",
                       requant_shift=rs, act=act, w_shifts=jws)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    # method="cuda" on host tensors runs the same plain version
    np.testing.assert_array_equal(
        K.conv2d(_t(x), wp, _t(b), groups=g, requant_shift=rs, act=act,
                 w_shifts=ws).numpy(), got.numpy())


@pytest.mark.parametrize("hk", [1, 3, 5])
@pytest.mark.parametrize("layout4", [False, True])
def test_depthwise2d_w4_plain_equals_ref_and_pallas(hk, layout4):
    """Packed along the tap rows: ceil(HK/2) byte rows, odd and even."""
    rng = np.random.default_rng(hk)
    x = rng.integers(-128, 128, (2, 8, 7, 8)).astype(np.int8)
    shape = (hk, hk, 8, 1) if layout4 else (hk, hk, 8)
    wp, ws, jwp, jws = _both(_w4(rng, shape, 0, group=2))
    assert wp.shape[0] == (hk + 1) // 2
    assert hk <= 2 or len(set(ws.tolist())) > 1
    got = K.depthwise2d(_t(x), wp, method="torch", requant_shift=4,
                        act="relu", w_shifts=ws)
    want = JR.depthwise2d_w4_ref(jnp.asarray(x), jwp, jws, requant_shift=4,
                                 act="relu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pallas = JK.depthwise2d(jnp.asarray(x), jwp, method="pallas",
                            requant_shift=4, act="relu", w_shifts=jws)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


@pytest.mark.parametrize("c,layout4", [(6, False), (7, True)])
def test_shift_conv2d_w4_plain_equals_ref_and_pallas(c, layout4):
    rng = np.random.default_rng(c)
    cy = 8
    x = rng.integers(-128, 128, (2, 7, 5, c)).astype(np.int8)
    table = np.array([[(i % 3) - 1, ((i * 2) % 3) - 1] for i in range(c)],
                     np.int32)
    shape = (1, 1, c, cy) if layout4 else (c, cy)
    wp, ws, jwp, jws = _both(_w4(rng, shape, len(shape) - 2, group=2))
    b = rng.integers(-3000, 3000, cy).astype(np.int32)
    kw = dict(requant_shift=5, act="relu", max_shift=1)
    got = K.shift_conv2d(_t(x), _t(table), wp, _t(b), method="torch",
                         w_shifts=ws, **kw)
    want = JR.shift_conv2d_w4_ref(jnp.asarray(x), table, jwp, jws,
                                  jnp.asarray(b), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pallas = JK.shift_conv2d(jnp.asarray(x), table, jwp, jnp.asarray(b),
                             method="pallas", w_shifts=jws, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


@pytest.mark.parametrize("cx,xp,wp_,rs", [(4, 0, 1, 3), (5, 0, 3, 9),
                                          (3, 2, 0, 9), (5, 28, 20, 24)],
                         ids=str)
def test_add_conv2d_w4_plain_equals_ref_and_pallas(cx, xp, wp_, rs):
    """Odd Cx: the pad nibble is never summed. Pre-shifts (28, 20) wrap
    int32 after the group shift, as JAX's int32 does."""
    rng = np.random.default_rng(cx + xp)
    x = rng.integers(-128, 128, (1, 6, 6, cx)).astype(np.int8)
    wp, ws, jwp, jws = _both(_w4(rng, (3, 3, cx, 6), 2))
    b = rng.integers(-3000, 3000, 6).astype(np.int32)
    kw = dict(requant_shift=rs, x_preshift=xp, w_preshift=wp_)
    got = K.add_conv2d(_t(x), wp, _t(b), method="torch", w_shifts=ws, **kw)
    want = JR.add_conv2d_w4_ref(jnp.asarray(x), jwp, jws, jnp.asarray(b),
                                **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pallas = JK.add_conv2d(jnp.asarray(x), jwp, jnp.asarray(b),
                           method="pallas", w_shifts=jws, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


def test_w4_wrappers_reject_bad_arguments():
    """Packed extent, shift length and dtype, and the missing
    requant_shift (W4 has no float mode) are refused."""
    x = torch.zeros((1, 4, 4, 5), dtype=torch.int8)
    wp = torch.zeros((3, 3, 3, 8), dtype=torch.int8)
    ws = torch.zeros((5,), dtype=torch.int8)
    with pytest.raises(ValueError, match="packed extent"):
        kernels.conv2d_w4(x, torch.zeros((3, 3, 5, 8), dtype=torch.int8),
                          ws, requant_shift=1)
    with pytest.raises(ValueError, match="shifts"):
        kernels.add_conv2d_w4(x, wp, ws[:4], requant_shift=1)
    with pytest.raises(TypeError, match="int8"):
        kernels.conv2d_w4(x, wp, ws.to(torch.int32), requant_shift=1)
    with pytest.raises(ValueError, match="requant_shift"):
        kernels.shift_conv2d_w4(x, torch.zeros((5, 2), dtype=torch.int32),
                                torch.zeros((3, 8), dtype=torch.int8), ws)
    with pytest.raises(ValueError, match="packed extent"):
        kernels.depthwise2d_w4(x, torch.zeros((3, 3, 5), dtype=torch.int8),
                               torch.zeros((3,), dtype=torch.int8),
                               requant_shift=1)
    with pytest.raises(ValueError, match="float W4"):
        K.conv2d(x, wp, w_shifts=ws, method="torch")
    with pytest.raises(ValueError, match="int8 activations"):
        K.add_conv2d(x.float(), wp, w_shifts=ws, requant_shift=1,
                     method="torch")


# ------------------------------------------------------------------ qconv --

# stride 2 runs the plain integer path outside the kernels' envelope; the
# add primitive computes at stride 1 in both packages (ROADMAP.md, C)
@pytest.mark.parametrize("prim,stride", [(p, 1) for p in PRIMS]
                         + [(p, 2) for p in PRIMS if p != "add"], ids=str)
def test_qconv_w4_equals_expanded_int8_and_jax(prim, stride):
    """quantize_conv_params(bits=4) through qconv_apply equals the same
    layer with its W4 leaves expanded to int8 QTensors (the packing moves
    data, never arithmetic), and equals JAX's W4 layer; stride 2 runs the
    plain integer path, which expands first. Tolerance 0."""
    from repro.core import primitives as JP
    groups = 2 if prim == "grouped" else 1
    kw = dict(primitive=prim, in_channels=8, out_channels=12, kernel_size=3,
              groups=groups, stride=stride)
    spec, jspec = P.ConvSpec(**kw), JP.ConvSpec(**kw)
    jp = JP.init(jax.random.PRNGKey(3), jspec)
    for k in ("w", "w_dw", "w_pw"):       # several group shifts per weight
        if k in jp:
            axis = 0 if k == "w_dw" else jp[k].ndim - 2
            jp[k] = jnp.asarray(_spread(np.asarray(jp[k]), axis,
                                        1 if k == "w_dw" else 2))
    p = {k: _t(np.asarray(v)) for k, v in jp.items()}
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 10, 10, 8)) * 0.5).astype(np.float32)
    xq, jxq = quantize(_t(x)), j_quantize(jnp.asarray(x))
    qp4 = quantize_conv_params(p, spec, bits=4, group_size=2)
    assert any(isinstance(v, QTensorW4) for v in qp4.values())
    qp8 = {k: QTensor(v.expand(), v.frac_bits) if isinstance(v, QTensorW4)
           else v for k, v in qp4.items()}
    assert max(len(set(v.shifts.tolist())) for v in qp4.values()
               if isinstance(v, QTensorW4)) > 1
    jqp4 = j_qparams(jp, jspec, bits=4, group_size=2)
    y4 = qconv_apply(qp4, xq, spec, 4, method="torch", act="relu")
    y8 = qconv_apply(qp8, xq, spec, 4, method="torch", act="relu")
    np.testing.assert_array_equal(y4.q.numpy(), y8.q.numpy())
    want = j_qconv_apply(jqp4, jxq, jspec, 4, method="xla", act="relu")
    np.testing.assert_array_equal(y4.q.numpy(), np.asarray(want.q))


# ------------------------------------------------------------------- plans --

# group_size 8 (one group per layer at these widths) for every primitive,
# and 4 (several distinct group shifts per layer) for two of them
@pytest.fixture(scope="module", params=[(p, 8) for p in PRIMS]
                + [("standard", 4), ("add", 4)], ids=str)
def w4_lowered(request):
    prim, group = request.param
    jcfg = JCNNConfig(primitive=prim, widths=(8, 12), image_size=16)
    jparams = j_init_cnn(jcfg, jax.random.PRNGKey(1))
    for blk in jparams["blocks"]:         # several group shifts per layer
        for k in ("w", "w_pw"):
            if k in blk["conv"]:
                w = np.asarray(blk["conv"][k])
                blk["conv"][k] = jnp.asarray(_spread(w, w.ndim - 2, group))
    rng = np.random.default_rng(2)
    calib = (rng.standard_normal((4, 16, 16, 3)) * 0.5).astype(np.float32)
    x = (rng.standard_normal((6, 16, 16, 3)) * 0.5).astype(np.float32)
    tune.set_default_cache(tune.TuneCache(None))
    jplan = j_lower(j_build(jcfg), jparams, calib, weight_bits=4,
                    group_size=group)
    return dict(prim=prim, group=group, jparams=jparams, jplan=jplan,
                calib=calib, x=x)


def test_w4_plan_trunk_bitwise_and_logits(w4_lowered):
    """A JAX W4 plan carried across by plan_from_numpy: the port's plain
    trunk equals JAX's xla trunk bit for bit, the logits agree to
    atol=1e-5; method="cuda" on the host runs the same plain versions and
    launches no kernel."""
    jplan, x = w4_lowered["jplan"], w4_lowered["x"]
    nodes = plan_to_numpy(jplan)
    leaves = [v for nd in nodes if nd["qparams"]
              for v in nd["qparams"].values() if isinstance(v, dict)]
    distinct = max(len(set(v["shifts"].tolist())) for v in leaves)
    assert distinct > 1 or w4_lowered["group"] == 8
    plan = plan_from_numpy(nodes, jplan.in_fb, device="cpu")
    ex = CompiledPlan(plan, method="torch", device="cpu")
    jt = _jax_trunk(jplan, x)
    t = ex.trunk(x)
    assert t.frac_bits == jt.frac_bits
    np.testing.assert_array_equal(t.q.numpy(), np.asarray(jt.q))
    want = np.asarray(JCompiledPlan(jplan, method="xla")(x))
    np.testing.assert_allclose(ex(x).numpy(), want, rtol=0, atol=1e-5)
    kernels.reset_launches()
    tc = CompiledPlan(plan, method="cuda", device="cpu").trunk(x)
    np.testing.assert_array_equal(tc.q.numpy(), t.q.numpy())
    assert all(k.launches == 0 for k in kernels.KERNELS)


def test_port_lower_w4_matches_jax_structure(w4_lowered):
    """The port's own lower(weight_bits=4) on the same float params: a
    QTensorW4 at every conv weight with JAX's frac bits, axis, size and
    group shifts; for add, whose weights are not folded, the W4 leaves
    equal JAX's bit for bit."""
    jplan = w4_lowered["jplan"]
    cfg = CNNConfig(primitive=w4_lowered["prim"], widths=(8, 12),
                    image_size=16)
    params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, w4_lowered["jparams"]),
        device="cpu")
    plan = lower(build_cnn_graph(cfg), params,
                 torch.from_numpy(w4_lowered["calib"]), weight_bits=4,
                 group_size=w4_lowered["group"])
    n_w4 = 0
    for n, jn in zip(plan.nodes, jplan.nodes):
        assert (n.name, n.op, n.in_fb, n.out_fb) == \
            (jn.name, jn.op, jn.in_fb, jn.out_fb)
        if n.op != "qconv":
            continue
        for k, jv in jn.qparams.items():
            if not isinstance(jv, JQTensorW4):
                continue
            v = n.qparams[k]
            assert isinstance(v, QTensorW4), (n.name, k)
            assert (v.frac_bits, v.axis, v.size) == \
                (jv.frac_bits, jv.axis, jv.size), (n.name, k)
            np.testing.assert_array_equal(v.shifts.numpy(),
                                          np.asarray(jv.shifts))
            if n.spec.primitive == "add":
                np.testing.assert_array_equal(v.q.numpy(), np.asarray(jv.q))
            n_w4 += 1
    assert n_w4 >= 2


def test_plan_from_numpy_checks_w4_leaves():
    """A W4 leaf crosses as plain data and is checked once on the host:
    packed extent, shift length, dtypes and the group-shift range."""
    spec = dict(primitive="standard", in_channels=3, out_channels=4,
                kernel_size=3)

    def node(**over):
        leaf = dict(q=np.zeros((3, 3, 2, 4), np.int8),
                    shifts=np.array([0, 4, 2], np.int8), frac_bits=5,
                    size=3, axis=2)
        leaf.update(over)
        return [dict(name="conv0", op="qconv", spec=spec, in_fb=5, out_fb=2,
                     qparams={"w": leaf})]
    w = plan_from_numpy(node(), 5, device="cpu").nodes[0].qparams["w"]
    assert isinstance(w, QTensorW4) and (w.frac_bits, w.size, w.axis) == \
        (5, 3, 2)
    assert w.q.dtype == w.shifts.dtype == torch.int8
    with pytest.raises(ValueError, match="do not fit"):
        plan_from_numpy(node(q=np.zeros((3, 3, 3, 4), np.int8)), 5,
                        device="cpu")
    with pytest.raises(ValueError, match="group shifts"):
        plan_from_numpy(node(shifts=np.array([0, 5, 0], np.int8)), 5,
                        device="cpu")
    with pytest.raises(TypeError, match="int8"):
        plan_from_numpy(node(shifts=np.array([0, 1, 0], np.int32)), 5,
                        device="cpu")
