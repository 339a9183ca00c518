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
from repro.graph import CompiledPlan as JCompiledPlan  # noqa: E402
from repro.graph import build_cnn_graph as j_build  # noqa: E402
from repro.graph import lower as j_lower  # noqa: E402
from repro.models.convnet import CNNConfig as JCNNConfig  # noqa: E402
from repro.models.convnet import init_cnn as j_init_cnn  # noqa: E402

from repro_torch.graph import CompiledPlan, build_cnn_graph, lower  # noqa: E402
from repro_torch.models import CNNConfig  # noqa: E402
from repro_torch.weights import params_from_numpy, plan_from_numpy  # noqa: E402

PRIMS = ("standard", "grouped", "dws")


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
            qp = {k: (np.asarray(v.q), v.frac_bits)
                  if isinstance(v, JQTensor) else np.asarray(v)
                  for k, v in n.qparams.items()}
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
    every node. Float calibration (conv, BN mean/var, fold) sums in another
    order than XLA, so a weight code may sit one floor step away: at most
    1 apart in at most 0.1% of the entries."""
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
        if n.op != "qconv":
            continue
        for k, v in n.qparams.items():
            jv = jn.qparams[k]
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
