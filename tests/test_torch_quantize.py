"""The port's quantization arithmetic against ``repro.core.quantize``,
bit for bit, on the same seeded numpy inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

import importlib  # noqa: E402

# the packages' __init__ re-export a function named ``quantize``, which
# shadows the submodule as an attribute
JQ = importlib.import_module("repro.core.quantize")
Q = importlib.import_module("repro_torch.core.quantize")

RNG = np.random.default_rng(0)
FLOATS = (RNG.standard_normal((4, 9, 7)) * 3.0).astype(np.float32)
# int32 accumulators across the whole range, negative ones and the
# wrap-around corners included
ACC = np.concatenate([
    RNG.integers(-2 ** 31, 2 ** 31, 2000, dtype=np.int64),
    RNG.integers(-5000, 5000, 2000),
    [-2 ** 31, 2 ** 31 - 1, -1, 0, 1, -2, 2, 127, -128, 255, -255]]
).astype(np.int32)


@pytest.mark.parametrize("scale", [0.0, 1e-3, 0.5, 1.0, 3.0, 200.0])
def test_frac_bits_for(scale):
    x = FLOATS * scale
    assert Q.frac_bits_for(torch.from_numpy(x)) == \
        JQ.frac_bits_for(jnp.asarray(x))
    assert Q.frac_bits_for(float(x.max())) == JQ.frac_bits_for(float(x.max()))


@pytest.mark.parametrize("fb", [None, -2, 0, 3, 7, 12])
def test_quantize_floor_and_clip(fb):
    got = Q.quantize(torch.from_numpy(FLOATS), fb)
    want = JQ.quantize(jnp.asarray(FLOATS), fb)
    assert got.frac_bits == want.frac_bits
    assert got.q.dtype == torch.int8
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.dequantize().numpy(),
                                  np.asarray(want.dequantize()))


@pytest.mark.parametrize("shift", list(range(-3, 32)))
def test_rshift_round(shift):
    got = Q.rshift_round(torch.from_numpy(ACC), shift)
    want = JQ.rshift_round(jnp.asarray(ACC), shift)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("acc_fb,out_fb", [(10, 3), (7, 7), (3, 6), (20, 0)])
def test_requantize(acc_fb, out_fb):
    got = Q.requantize(torch.from_numpy(ACC), acc_fb, out_fb)
    want = JQ.requantize(jnp.asarray(ACC), acc_fb, out_fb)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fb_x,fb_w", [(5, 5), (7, 4), (3, 9), (0, 31)])
def test_addmac_align(fb_x, fb_w):
    """Algorithm 1 (right): the coarser int8 operand shifted onto the finer
    scale in int32 (wrapping at the largest shifts), the same accumulator
    frac bits, and the same static pre-shifts as the JAX package's
    ``qconv._add_preshifts``."""
    codes = np.arange(-128, 128, dtype=np.int8)
    x, w = codes, codes[::-1].copy()
    xi, wi, fb = Q.addmac_align(torch.from_numpy(x), torch.from_numpy(w),
                                fb_x, fb_w)
    jxi, jwi, jfb = JQ.addmac_align(jnp.asarray(x), jnp.asarray(w), fb_x,
                                    fb_w)
    assert fb == jfb == max(fb_x, fb_w)
    from repro.core.qconv import _add_preshifts
    assert Q.add_preshifts(fb_x, fb_w) == _add_preshifts(fb_x, fb_w)
    assert xi.dtype == wi.dtype == torch.int32
    np.testing.assert_array_equal(xi.numpy(), np.asarray(jxi))
    np.testing.assert_array_equal(wi.numpy(), np.asarray(jwi))
