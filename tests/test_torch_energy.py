"""The port's analytic models and Algorithm 1's reference loops against the
JAX package: ``core.energy`` (memory accesses, Fig 3's reuse ratio, the
MCU latency / power / energy model) and ``core.quantize``'s ``mac_inner``,
``addmac_inner``, ``calibrate`` and ``quantize_params``, on the same
inputs."""
import importlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import energy as JE  # noqa: E402
from repro.core.primitives import ConvSpec as JConvSpec  # noqa: E402
from repro.models.convnet import CNNConfig as JCNNConfig  # noqa: E402
from repro.models.convnet import init_cnn as j_init_cnn  # noqa: E402

from repro_torch.core import energy as E  # noqa: E402
from repro_torch.core.primitives import ConvSpec  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402

# the modules themselves: each package's core re-exports a function
# named ``quantize``
JQ = importlib.import_module("repro.core.quantize")
Q = importlib.import_module("repro_torch.core.quantize")

#: (primitive, groups): the five primitives, grouped with g = 2 and 4
PRIMS = [("standard", 1), ("grouped", 2), ("grouped", 4), ("dws", 1),
         ("shift", 1), ("add", 1)]
WIDTHS = (8, 16, 32)


def _close(a, b):
    """Integers equal; floats within rel 1e-12."""
    if isinstance(b, int) and not isinstance(b, bool):
        assert isinstance(a, int) and a == b, (a, b)
    else:
        assert math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0), (a, b)


@pytest.mark.parametrize("hk", [1, 3, 5])
@pytest.mark.parametrize("prim,groups", PRIMS)
def test_energy_model_matches_jax(prim, groups, hk):
    """patch_len, both access counts, reuse_ratio and the MCU model (simd
    on and off, opt "Os" and "O0", two clocks) at every width."""
    mcu, jmcu = E.MCUModel(), JE.MCUModel()
    assert E.MCUModel.__dataclass_fields__.keys() == \
        JE.MCUModel.__dataclass_fields__.keys()
    for w in WIDTHS:
        cx, cy = w, 2 * w
        spec = ConvSpec(prim, cx, cy, hk, groups=groups)
        jspec = JConvSpec(prim, cx, cy, hk, groups=groups)
        _close(E.patch_len(spec), JE.patch_len(jspec))
        _close(E.accesses_direct(spec, w), JE.accesses_direct(jspec, w))
        _close(E.accesses_im2col(spec, w), JE.accesses_im2col(jspec, w))
        _close(E.reuse_ratio(spec, w), JE.reuse_ratio(jspec, w))
        for simd in (False, True):
            for f in (10.0, 84.0):
                _close(mcu.power_mw(simd=simd, f_mhz=f),
                       jmcu.power_mw(simd=simd, f_mhz=f))
                for opt in ("Os", "O0"):
                    kw = dict(simd=simd, f_mhz=f, opt=opt)
                    _close(mcu.latency_s(spec, w, **kw),
                           jmcu.latency_s(jspec, w, **kw))
                    _close(mcu.energy_mj(spec, w, **kw),
                           jmcu.energy_mj(jspec, w, **kw))


def test_energy_reads_the_paper_shape():
    """The model's own readings (paper Fig 2/3): SIMD cuts latency for
    every multiplicative primitive, add-conv has no SIMD path, and the
    blocked path reuses data (ratio > 1)."""
    mcu = E.MCUModel()
    for prim in ("standard", "dws", "shift"):
        spec = ConvSpec(prim, 16, 32, 3)
        assert mcu.latency_s(spec, 16, simd=True) < \
            mcu.latency_s(spec, 16, simd=False)
        assert E.reuse_ratio(spec, 16) > 1.0
    add = ConvSpec("add", 16, 32, 3)
    assert E.reuse_ratio(add, 16) == 1.0
    assert mcu.latency_s(add, 16, simd=True) == \
        mcu.latency_s(add, 16, simd=False)


@pytest.mark.parametrize("fb_y", [0, 4])
@pytest.mark.parametrize("fb_w", [0, 3, 7])
@pytest.mark.parametrize("fb_x", [0, 3, 7])
def test_inner_loops_bitwise(fb_x, fb_w, fb_y):
    """mac_inner and addmac_inner on random int8 codes (-128 and 127
    included) give JAX's int8 codes bit for bit."""
    rng = np.random.default_rng(fb_x * 100 + fb_w * 10 + fb_y)
    x = rng.integers(-128, 128, 4096).astype(np.int8)
    w = rng.integers(-128, 128, 4096).astype(np.int8)
    x[:4], w[:4] = [-128, 127, -128, 127], [-128, -128, 127, 127]
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    for fn, jfn in ((Q.mac_inner, JQ.mac_inner),
                    (Q.addmac_inner, JQ.addmac_inner)):
        got = fn(tx, tw, fb_x, fb_w, fb_y)
        want = np.asarray(jfn(x, w, fb_x, fb_w, fb_y))
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("scale", [0.01, 1.0, 37.0])
def test_calibrate_matches_jax(scale):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((4, 8, 8, 3)) * scale).astype(np.float32)
    assert Q.calibrate(lambda v: torch.relu(v) * 2.0, torch.from_numpy(x)) \
        == JQ.calibrate(lambda v: jax.nn.relu(v) * 2.0, x)


@pytest.mark.parametrize("prim", ["standard", "dws", "shift", "add"])
def test_quantize_params_on_a_cnn_tree(prim):
    """Every float leaf of a CNN tree quantized per tensor as JAX does it;
    the shift table kept as it is."""
    jparams = j_init_cnn(JCNNConfig(primitive=prim, widths=(8, 12)),
                         jax.random.PRNGKey(0))
    nparams = jax.tree_util.tree_map(np.asarray, jparams)
    got = Q.quantize_params(params_from_numpy(nparams, device="cpu"))
    want = JQ.quantize_params(jparams)
    jleaves = jax.tree_util.tree_leaves(
        want, is_leaf=lambda v: isinstance(v, JQ.QTensor))
    tleaves = leaves(got)
    assert len(tleaves) == len(jleaves)
    for t, j in zip(tleaves, jleaves):
        if isinstance(j, JQ.QTensor):
            assert isinstance(t, Q.QTensor) and t.frac_bits == j.frac_bits
            np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
        else:
            assert not t.is_floating_point()
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
