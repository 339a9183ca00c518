"""The port's graph layer against the JAX package: plan parity on the int8
trunk, lowering parity, and ragged forward_batch.

Both packages get the same seeded numpy inputs; JAX plans cross into the
port as plain numpy data (``repro_torch.weights``)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core.quantize import QTensor as JQTensor  # noqa: E402
from repro.core.quantize import QTensorW4 as JQTensorW4  # noqa: E402
from repro.graph import CompiledPlan as JCompiledPlan  # noqa: E402
from repro.graph import build_cnn_graph as j_build  # noqa: E402
from repro.graph import lower as j_lower  # noqa: E402
from repro.models.convnet import CNNConfig as JCNNConfig  # noqa: E402
from repro.models.convnet import init_cnn as j_init_cnn  # noqa: E402

from repro_torch.graph import CompiledPlan, build_cnn_graph, lower  # noqa: E402
from repro_torch.models import CNNConfig  # noqa: E402
from repro_torch.weights import params_from_numpy, plan_from_numpy  # noqa: E402

PRIMS = ("standard", "grouped", "dws", "shift", "add")


def _leaf(v):
    """One qparams leaf as plain data: QTensor -> (codes, frac_bits),
    QTensorW4 -> {"q", "shifts", "frac_bits", "size", "axis"}, integer
    scalars stay Python ints, arrays become numpy."""
    if isinstance(v, JQTensor):
        return np.asarray(v.q), v.frac_bits
    if isinstance(v, JQTensorW4):
        return dict(q=np.asarray(v.q), shifts=np.asarray(v.shifts),
                    frac_bits=v.frac_bits, size=v.size, axis=v.axis)
    if isinstance(v, int):
        return v
    return np.asarray(v)


def plan_to_numpy(plan):
    """Flatten a JAX Plan into the plain dicts ``plan_from_numpy`` reads."""
    nodes = []
    for n in plan.nodes:
        spec = None
        if n.spec is not None:
            spec = {k: v for k, v in dataclasses.asdict(n.spec).items()
                    if k != "dtype"}
        qp = None
        if n.qparams is not None:
            qp = {k: _leaf(v) for k, v in n.qparams.items()}
        nodes.append(dict(name=n.name, op=n.op, spec=spec, qparams=qp,
                          in_fb=n.in_fb, out_fb=n.out_fb, act=n.act,
                          attrs=dict(n.attrs)))
    return nodes


@pytest.fixture(scope="module", params=PRIMS)
def lowered(request):
    prim = request.param
    jcfg = JCNNConfig(primitive=prim, widths=(8, 12), image_size=16)
    jparams = j_init_cnn(jcfg, jax.random.PRNGKey(1))
    rng = np.random.default_rng(2)
    calib = (rng.standard_normal((4, 16, 16, 3)) * 0.5).astype(np.float32)
    x = (rng.standard_normal((6, 16, 16, 3)) * 0.5).astype(np.float32)
    jplan = j_lower(j_build(jcfg), jparams, calib)
    return dict(prim=prim, jparams=jparams, jplan=jplan, calib=calib, x=x)


def _jax_trunk(jplan, x):
    """The JAX plan's int8 activation fed into gap, run node by node under
    the xla oracle."""
    ex = JCompiledPlan(jplan, method="xla", jit=False)
    from repro.core.quantize import quantize
    h = quantize(jax.numpy.asarray(x), jplan.in_fb)
    for node in jplan.nodes:
        if node.op == "gap":
            return h
        h = ex._run_node(node, h)
    raise AssertionError("plan has no gap node")


def test_plan_trunk_bitwise_and_logits(lowered):
    """plan_from_numpy(JAX plan) through the port's plain path gives the
    JAX xla trunk bit for bit; the float head sums in another order, so
    logits agree to atol=1e-5."""
    jplan, x = lowered["jplan"], lowered["x"]
    plan = plan_from_numpy(plan_to_numpy(jplan), jplan.in_fb, device="cpu")
    ex = CompiledPlan(plan, method="torch", device="cpu")
    jt = _jax_trunk(jplan, x)
    t = ex.trunk(x)
    assert t.q.dtype == torch.int8 and t.frac_bits == jt.frac_bits
    np.testing.assert_array_equal(t.q.numpy(), np.asarray(jt.q))
    want = np.asarray(JCompiledPlan(jplan, method="xla")(x))
    np.testing.assert_allclose(ex(x).numpy(), want, rtol=0, atol=1e-5)


def test_port_lower_matches_jax_lower(lowered):
    """The port's own lower on the same params gives the same frac bits in
    every node and the same shift tables. Float calibration (conv, BN
    mean/var, fold) sums in another order than XLA, so a weight code, or a
    qbn node's multiplier or bias, may sit one rounding step away: at most
    1 apart, and weight codes in at most 0.1% of the entries."""
    jplan = lowered["jplan"]
    cfg = CNNConfig(primitive=lowered["prim"], widths=(8, 12), image_size=16)
    params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, lowered["jparams"]), device="cpu")
    plan = lower(build_cnn_graph(cfg), params,
                 torch.from_numpy(lowered["calib"]))
    assert plan.in_fb == jplan.in_fb
    assert [n.name for n in plan.nodes] == [n.name for n in jplan.nodes]
    n_diff = n_all = 0
    for n, jn in zip(plan.nodes, jplan.nodes):
        assert (n.op, n.in_fb, n.out_fb, n.act) == \
            (jn.op, jn.in_fb, jn.out_fb, jn.act), n.name
        if n.op == "qbn":
            assert n.qparams["a_frac_bits"] == jn.qparams["a_frac_bits"]
            for k in ("a", "b"):
                d = np.abs(n.qparams[k].numpy().astype(np.int64)
                           - np.asarray(jn.qparams[k]).astype(np.int64))
                assert d.max() <= 1, (n.name, k)
            continue
        if n.op != "qconv":
            continue
        assert set(n.qparams) == set(jn.qparams), n.name
        for k, v in n.qparams.items():
            jv = jn.qparams[k]
            if k == "shifts":
                np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
                continue
            assert v.frac_bits == jv.frac_bits, (n.name, k)
            d = np.abs(v.q.numpy().astype(np.int32)
                       - np.asarray(jv.q).astype(np.int32))
            assert d.max() <= 1, (n.name, k)
            n_diff += int((d > 0).sum())
            n_all += d.size
    assert n_diff <= 0.001 * n_all, (n_diff, n_all)


def test_forward_batch_ragged_equals_per_image(lowered):
    """A ragged batch of 5 (padded to bucket 8 and cropped) equals the
    per-image loop: the int8 trunk bit for bit, the logits to 1e-5."""
    jplan, x = lowered["jplan"], lowered["x"][:5]
    plan = plan_from_numpy(plan_to_numpy(jplan), jplan.in_fb, device="cpu")
    ex = CompiledPlan(plan, method="torch", device="cpu")
    assert ex.batch_bucket(5) == 8
    batched = ex.forward_batch(x)
    assert batched.shape == (5, 10)
    trunk = ex.trunk(x).q
    for i in range(5):
        np.testing.assert_array_equal(ex.trunk(x[i:i + 1]).q.numpy(),
                                      trunk[i:i + 1].numpy())
        np.testing.assert_allclose(batched[i:i + 1].numpy(),
                                   ex(x[i:i + 1]).numpy(), rtol=0, atol=1e-5)


def test_cuda_method_on_cpu_runs_plain(lowered):
    """On host tensors method='cuda' runs the plain versions: the same
    trunk as method='torch', and no kernel launch."""
    from repro_torch import kernels
    jplan, x = lowered["jplan"], lowered["x"]
    plan = plan_from_numpy(plan_to_numpy(jplan), jplan.in_fb, device="cpu")
    kernels.reset_launches()
    a = CompiledPlan(plan, method="cuda", device="cpu").trunk(x)
    b = CompiledPlan(plan, method="torch", device="cpu").trunk(x)
    np.testing.assert_array_equal(a.q.numpy(), b.q.numpy())
    assert all(k.launches == 0 for k in kernels.KERNELS)


def test_plan_from_numpy_keeps_ints_and_checks_the_shift_table():
    """Integer scalars stay Python ints (a 0-d array too, so requantize
    never gets a tensor shift), integer tables stay int32 tensors, and a
    shift table beyond kernel_size // 2 is refused once, on the host."""
    spec = dict(primitive="shift", in_channels=2, out_channels=3,
                kernel_size=3)
    w_pw = (np.ones((1, 1, 2, 3), np.int8), 6)
    qbn = dict(name="bn0", op="qbn", in_fb=2, out_fb=4, act="relu",
               qparams={"a": np.array([3, 4, 5], np.int32),
                        "b": np.array([0, -1, 1], np.int32),
                        "a_frac_bits": np.asarray(9)})

    def conv(table):
        return dict(name="conv0", op="qconv", spec=spec, in_fb=5, out_fb=2,
                    qparams={"shifts": np.array(table, np.int32),
                             "w_pw": w_pw})
    plan = plan_from_numpy([conv([[1, -1], [0, 0]]), qbn], 5, device="cpu")
    shifts = plan.nodes[0].qparams["shifts"]
    assert shifts.dtype == torch.int32 and shifts.tolist() == [[1, -1],
                                                               [0, 0]]
    bn = plan.nodes[1].qparams
    assert type(bn["a_frac_bits"]) is int and bn["a_frac_bits"] == 9
    assert bn["a"].dtype == bn["b"].dtype == torch.int32
    with pytest.raises(ValueError, match="exceeding the declared max_shift"):
        plan_from_numpy([conv([[2, 0], [0, 0]]), qbn], 5, device="cpu")


@pytest.mark.parametrize("beta_scale,gamma_scale,in_fb", [
    (0.1, 1.0, -3), (3e4, 1.0, 2), (0.1, 0.0, 0), (1.0, 40.0, 6)],
    ids=["plain", "large-offset-cap", "zero-multiplier", "large-gamma"])
def test_qbn_affine_and_apply_match_jax(beta_scale, gamma_scale, in_fb):
    """The integer BN node on its own: the lowering of the affine and the
    int32 apply, bitwise on the same qparams. The frac bits agree exactly.
    PyTorch's float32 (var + eps) ** -0.5 differs from XLA's by one ulp in
    about a quarter of the entries, so a (|a| <= 2^15 after scaling) may
    sit one rounding step away, and b, scaled towards 2^30, by up to two
    float32 ulps of its own magnitude."""
    from repro.core.quantize import QTensor as JQ
    from repro.graph.executor import _qbn_apply as j_qbn_apply
    from repro.graph.lower import _quantize_bn_affine as j_affine
    from repro_torch.core.quantize import QTensor
    from repro_torch.graph.executor import _qbn_apply
    from repro_torch.graph.lower import _quantize_bn_affine
    rng = np.random.default_rng(7)
    bn = {"gamma": gamma_scale * (1 + 0.2 * rng.standard_normal(16)),
          "beta": beta_scale * rng.standard_normal(16),
          "mean": 50 * rng.standard_normal(16),
          "var": 100 * rng.random(16) + 1}
    bn = {k: v.astype(np.float32) for k, v in bn.items()}
    got = _quantize_bn_affine({k: torch.from_numpy(v) for k, v in bn.items()},
                              in_fb)
    want = j_affine({k: jax.numpy.asarray(v) for k, v in bn.items()}, in_fb)
    assert got["a_frac_bits"] == want["a_frac_bits"]
    for k in ("a", "b"):
        assert got[k].dtype == torch.int32
        g = got[k].numpy().astype(np.int64)
        w = np.asarray(want[k]).astype(np.int64)
        assert (np.abs(g - w) <= 1 + np.abs(w) * 2.0 ** -22).all(), k
    qp = {k: np.array(want[k]) for k in ("a", "b")}
    x = rng.integers(-128, 128, (2, 5, 5, 16)).astype(np.int8)
    for act in (None, "relu"):
        t = _qbn_apply({**{k: torch.from_numpy(v) for k, v in qp.items()},
                        "a_frac_bits": want["a_frac_bits"]},
                       QTensor(torch.from_numpy(x), in_fb), 3, act)
        j = j_qbn_apply({**{k: jax.numpy.asarray(v) for k, v in qp.items()},
                         "a_frac_bits": want["a_frac_bits"]},
                        JQ(jax.numpy.asarray(x), in_fb), 3, act)
        assert t.frac_bits == j.frac_bits == 3
        np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))


# -------------------------------- unfused_forward, profile, stride 2 ---

def _trunk_nodes(plan):
    """The plan cut before its head: running it returns the int8 trunk."""
    return dataclasses.replace(plan, nodes=tuple(
        n for n in plan.nodes if n.op not in ("gap", "dense")))


@pytest.mark.parametrize("bits", [8, 4])
def test_unfused_forward_matches_jax_and_the_fused_trunk(lowered, bits):
    """The float-bounce regime: its int8 trunk bitwise equal to JAX's
    unfused_forward(method="xla") and to the port's fused trunk, and its
    logits bitwise equal to the fused plan's (the same float head), in
    int8 and W4."""
    from repro.graph import unfused_forward as j_unfused
    from repro_torch.graph import unfused_forward
    jplan, x = lowered["jplan"], lowered["x"]
    if bits == 4:
        jplan = j_lower(j_build(JCNNConfig(primitive=lowered["prim"],
                                           widths=(8, 12), image_size=16)),
                        lowered["jparams"], lowered["calib"], weight_bits=4,
                        group_size=4)
    plan = plan_from_numpy(plan_to_numpy(jplan), jplan.in_fb, device="cpu")
    got = unfused_forward(_trunk_nodes(plan), x)
    want = j_unfused(_trunk_nodes(jplan), x, method="xla")
    assert got.frac_bits == want.frac_bits
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    fused = CompiledPlan(plan, method="torch", device="cpu")
    np.testing.assert_array_equal(got.q.numpy(), fused.trunk(x).q.numpy())
    assert torch.equal(unfused_forward(plan, x), fused(x))


def test_profile_matches_jax_rows(lowered):
    """profile: JAX's row names, ops and primitives, the same MACs, the MCU
    columns within rel 1e-12, a measured time on every row; the
    throughput mode's keys; an unknown mode raises."""
    jplan, x = lowered["jplan"], lowered["x"]
    plan = plan_from_numpy(plan_to_numpy(jplan), jplan.in_fb, device="cpu")
    ex = CompiledPlan(plan, method="torch", device="cpu")
    want = JCompiledPlan(jplan, method="xla").profile(x, reps=1)
    got = ex.profile(x, reps=1)
    assert [(r["name"], r["op"], r["primitive"]) for r in got] == \
        [(r["name"], r["op"], r["primitive"]) for r in want]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert g["macs"] == w["macs"] and g["us"] > 0
        for k in g:
            if k.startswith("mcu_"):
                assert g[k] == pytest.approx(w[k], rel=1e-12, abs=0)
    rows = ex.profile(x, reps=1, mode="throughput")
    assert all(r["images_per_s"] > 0 and r["us_per_image"] ==
               r["us"] / x.shape[0] for r in rows)
    with pytest.raises(ValueError, match="mode"):
        ex.profile(x, mode="bogus")


def test_profile_emits_one_layer_span_per_row(lowered):
    from repro_torch.obs import trace
    jplan, x = lowered["jplan"], lowered["x"]
    plan = plan_from_numpy(plan_to_numpy(jplan), jplan.in_fb, device="cpu")
    trace.clear()
    trace.enable()
    try:
        rows = CompiledPlan(plan, method="torch", device="cpu").profile(
            x, reps=1)
    finally:
        trace.disable()
    ends = [e for e in trace.TRACER.events()
            if e["ph"] == "E" and e["name"].startswith("layer.")]
    trace.clear()
    assert [e["name"] for e in ends] == [f"layer.{r['name']}" for r in rows]
    assert [e["args"]["us"] for e in ends] == [r["us"] for r in rows]


def test_stride2_plan_runs_plain_under_torch_and_raises_under_cuda():
    """A stride-2 conv lies outside the kernels' envelope: method="torch"
    runs it through the plain version, its trunk bitwise JAX's "xla" and
    its logits within 1e-5; method="cuda" raises on it rather than
    running it plain."""
    from repro.core import init as j_init
    from repro.graph import Graph as JGraph
    from repro.graph import Node as JNode
    from repro.core import ConvSpec as JConvSpec
    from repro.core.quantize import quantize as j_quantize
    spec = JConvSpec("standard", 3, 8, 3, stride=2)
    g = JGraph((JNode("conv0", "conv", ("x",), spec=spec),
                JNode("gap", "gap", ("conv0",)),
                JNode("head", "dense", ("gap",))))
    params = {"blocks": [{"conv": j_init(jax.random.PRNGKey(0), spec)}],
              "head": jax.random.normal(jax.random.PRNGKey(1), (8, 10)) * .3}
    calib = np.array(jax.random.normal(jax.random.PRNGKey(2),
                                       (2, 16, 16, 3)) * 0.5)
    jplan = j_lower(g, params, calib)
    plan = plan_from_numpy(plan_to_numpy(jplan), jplan.in_fb, device="cpu")
    ex = CompiledPlan(plan, method="torch", device="cpu")
    want = JCompiledPlan(jplan, method="xla", jit=False)
    jt = want._run_node(jplan.nodes[0], j_quantize(jax.numpy.asarray(calib),
                                                    jplan.in_fb))
    got = ex.trunk(calib)
    assert got.q.shape == (2, 8, 8, 8)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(jt.q))
    np.testing.assert_allclose(ex(calib).numpy(),
                               np.asarray(want(calib)), rtol=0, atol=1e-5)
    with pytest.raises(NotImplementedError, match="stride"):
        CompiledPlan(plan, method="cuda", device="cpu")(calib)


def test_jit_on_a_cpu_plan_captures_nothing(lowered):
    """jit is the CUDA-graph capture: on the host it has no effect, traces
    stays 0, and jit=False gives the same trunk and logits."""
    jplan, x = lowered["jplan"], lowered["x"]
    plan = plan_from_numpy(plan_to_numpy(jplan), jplan.in_fb, device="cpu")
    a = CompiledPlan(plan, method="cuda", device="cpu")
    b = CompiledPlan(plan, method="cuda", device="cpu", jit=False)
    assert a.jit and not b.jit
    np.testing.assert_array_equal(a.trunk(x).q.numpy(),
                                  b.trunk(x).q.numpy())
    assert torch.equal(a.forward_batch(x[:3]), b.forward_batch(x[:3]))
    assert a.traces == b.traces == 0


@pytest.mark.parametrize("method", ["pallas", "auto"])
def test_plan_rejects_an_unknown_method(lowered, method):
    """The plan takes the kernel layer's two methods only: there is no
    per-node "auto" that would run a node plain on the card."""
    jplan = lowered["jplan"]
    plan = plan_from_numpy(plan_to_numpy(jplan), jplan.in_fb, device="cpu")
    with pytest.raises(ValueError, match="method"):
        CompiledPlan(plan, method=method, device="cpu")
