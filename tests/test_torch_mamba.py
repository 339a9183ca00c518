"""The port's ssm serve path against the JAX package on the CPU: the
``causal_conv1d`` plain version, oracle and gradient, the Mamba block
(scan, forward, state, decode step), Falcon-Mamba's config, parameters,
prefill and decode, the slot cache and the continuous-batching ``Engine``,
on the same seeded numpy inputs and JAX's own parameters carried across by
``weights.lm_params_from_numpy``. The model is Falcon-Mamba-7B cut to 2
layers, d_model 32 and a 64-token vocabulary on both sides.

Tolerances, each with its reason:

* ``causal_conv1d`` against the Pallas kernel in interpret mode: bitwise
  at bfloat16 and at K=1; at float32 with K >= 2, XLA's CPU backend
  contracts the kernel's multiply-adds into FMAs, each of which rounds
  once where the port rounds twice, so the two differ by at most one
  float32 ulp of sum_k |x w| per contracted multiply-add (K-1 of them);
* ``causal_conv1d`` against JAX's oracle at float32: bitwise (both sum in
  float32, uncontracted, in the same order);
* gradients, ``mamba_scan``, and the Mamba block, prefill and decode at
  float32: the two frameworks sum matmuls, einsums and the scan in another
  order (``lax.associative_scan`` against a doubling scan), rtol 1e-5
  (logits: rtol 1e-3, atol 1e-4, since the bf16 conv state of the cache
  can round a value of the two sides to neighbouring bf16 values);
* the Mamba block at bfloat16: both sides round every matmul and
  elementwise result to bfloat16, at different places (XLA keeps excess
  precision inside a fusion): atol and rtol 0.03, four bf16 ulps at 1;
* greedy token streams, configs, parameter trees and slot writes are
  compared exactly.

Run here with ``PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q
tests/test_torch_mamba.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.base import get_config as j_get_config  # noqa: E402
from repro.check.config import \
    check_serve_config as j_check_serve_config  # noqa: E402
from repro.kernels import ops as JK  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro.kernels.conv1d_causal import \
    causal_conv1d as j_pallas_c1d  # noqa: E402
from repro.models import api as j_api  # noqa: E402
from repro.models import mamba as j_mamba  # noqa: E402
from repro.models import transformer as j_T  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402

from repro_torch.check import check_serve_config  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import (causal_conv1d,  # noqa: E402
                                 causal_conv1d_plain, ops)
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.models import api, mamba  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402
from repro_torch.serve import Engine, Request, ServeConfig  # noqa: E402
from repro_torch.weights import lm_params_from_numpy  # noqa: E402

TINY = dict(n_layers=2, d_model=32, vocab=64)
F32 = dict(compute_dtype="float32")


def tiny_cfg(**kw):
    return dataclasses.replace(get_config("falcon-mamba-7b"), **TINY, **kw)


def j_tiny_cfg(**kw):
    return dataclasses.replace(j_get_config("falcon-mamba-7b"), **TINY, **kw)


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def ssm():
    """JAX's tiny Falcon-Mamba parameters and the port's copy of them."""
    jparams = j_api.init_params(j_tiny_cfg(), jax.random.PRNGKey(1))
    return jparams, lm_params_from_numpy(to_numpy(jparams), device="cpu")


def _f32(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _tt(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


def _jt(a, dtype="float32"):
    return jnp.asarray(a).astype(dtype)


# -------------------------------------------------------- causal_conv1d --

# (B, L, D, Pallas block_l, block_c, act, (K,1,D) weights): ragged L inside
# the Pallas grid, channel blocks that cut D, relu, the 3-D weight layout.
# Every L block of the Pallas kernel holds at least K-1 rows: below that it
# reads a short halo (ROADMAP.md, section C), so L < K-1 is held against
# JAX's oracle instead.
C1D_CASES = [(2, 13, 24, 512, 512, None, False),
             (1, 12, 40, 4, 8, "relu", False),
             (3, 5, 100, 512, 512, "relu", True)]


@pytest.mark.parametrize("case", C1D_CASES, ids=str)
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv1d_plain_matches_pallas_kernel(dtype, k, case):
    b, l, d, bl, bc, act, k1d = case
    rng = np.random.default_rng(100 * k + l)
    x, w = _f32(rng, (b, l, d)), _f32(rng, (k, d))
    wk = w[:, None] if k1d else w
    tdt = getattr(torch, dtype)
    got = causal_conv1d(_tt(x, tdt), _tt(wk, tdt), act=act)
    assert got.dtype == tdt and tuple(got.shape) == (b, l, d)
    want = j_pallas_c1d(_jt(x, dtype), _jt(wk, dtype), block_l=bl,
                        block_c=bc, act=act, interpret=True)
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "bfloat16" or k == 1:
        np.testing.assert_array_equal(got, want)
        return
    # XLA contracts the multiply-adds (module docstring)
    xs = _tt(x, tdt).float().numpy()
    xp = np.pad(xs, ((0, 0), (k - 1, 0), (0, 0)))
    mag = sum(np.abs(xp[:, kk:kk + l] * w[kk]) for kk in range(k))
    assert np.all(np.abs(got - want) <= (k - 1) * np.spacing(mag))


@pytest.mark.parametrize("k,l", [(1, 7), (2, 9), (4, 13), (4, 2), (4, 1)])
def test_causal_conv1d_plain_equals_jax_oracle_at_f32(k, l):
    rng = np.random.default_rng(k * 10 + l)
    x, w = _f32(rng, (2, l, 24)), _f32(rng, (k, 24))
    want = np.asarray(JR.causal_conv1d_ref(jnp.asarray(x), jnp.asarray(w)))
    got = causal_conv1d_plain(_tt(x), _tt(w))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(R.causal_conv1d_ref(_tt(x), _tt(w))
                                  .numpy(), want)
    np.testing.assert_array_equal(R.causal_conv1d_f32(_tt(x), _tt(w))
                                  .numpy(), want)


def test_the_oracle_sums_in_bf16_and_the_plain_version_in_f32():
    """At bfloat16 JAX's oracle (and its port) round after every product
    and sum; the kernel and its plain version round once. The port's oracle
    equals JAX's bit for bit."""
    rng = np.random.default_rng(7)
    x, w = _f32(rng, (2, 33, 64)), _f32(rng, (4, 64))
    tx, tw = _tt(x, torch.bfloat16), _tt(w, torch.bfloat16)
    oracle = R.causal_conv1d_ref(tx, tw)
    plain = causal_conv1d_plain(tx, tw)
    assert oracle.dtype == plain.dtype == torch.bfloat16
    assert not torch.equal(oracle, plain)
    want = np.asarray(JR.causal_conv1d_ref(_jt(x, "bfloat16"),
                                           _jt(w, "bfloat16"))
                      .astype(jnp.float32))
    np.testing.assert_array_equal(oracle.float().numpy(), want)


@pytest.mark.parametrize("k1d", [False, True])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_causal_conv1d_gradients_match_jax(k, k1d):
    rng = np.random.default_rng(20 + k)
    x, w, g = _f32(rng, (2, 11, 24)), _f32(rng, (k, 24)), _f32(rng,
                                                               (2, 11, 24))
    wk = w[:, None] if k1d else w
    # JAX's custom VJP returns a (K, D) dw whatever w's layout, which JAX
    # rejects for a (K, 1, D) w (ROADMAP.md, section C): its reference is
    # the same function with (K, D) taps
    _, vjp = jax.vjp(lambda a, b: JK.causal_conv1d(a, b, method="pallas"),
                     jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))
    for method in ("cuda", "torch"):
        tx, tw = _tt(x).requires_grad_(), _tt(wk).requires_grad_()
        dx, dw = torch.autograd.grad(ops.causal_conv1d(tx, tw, method=method),
                                     (tx, tw), _tt(g))
        assert dw.shape == tw.shape and dw.dtype == tw.dtype
        np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(dw.reshape(w.shape).numpy(),
                                   np.asarray(jdw), rtol=1e-5, atol=1e-5)


def test_causal_conv1d_backward_is_flip_plain_flip_and_plain_reduction():
    rng = np.random.default_rng(30)
    x = _tt(_f32(rng, (2, 9, 16)), torch.bfloat16).requires_grad_()
    w = _tt(_f32(rng, (4, 16)), torch.bfloat16).requires_grad_()
    g = _tt(_f32(rng, (2, 9, 16)), torch.bfloat16)
    dx, dw = torch.autograd.grad(ops.causal_conv1d(x, w), (x, w), g)
    assert torch.equal(dx, torch.flip(causal_conv1d_plain(
        torch.flip(g, [1]), w.detach()), [1]))
    xp = torch.nn.functional.pad(x.detach().float(), (0, 0, 3, 0))
    want = torch.stack([(g.float() * xp[:, kk:kk + 9]).sum((0, 1))
                        for kk in range(4)])
    assert dw.dtype == torch.bfloat16
    torch.testing.assert_close(dw.float(), want.to(torch.bfloat16).float(),
                               rtol=0, atol=0)


def test_ops_causal_conv1d_dispatch_and_arguments():
    rng = np.random.default_rng(31)
    x, w = _tt(_f32(rng, (1, 6, 8))), _tt(_f32(rng, (4, 8)))
    c = metrics.counter("kernels.dispatch.causal_conv1d.torch")
    before = c.value
    got = ops.causal_conv1d(x, w, method="torch")
    assert c.value == before + 1
    assert torch.equal(got, ops.causal_conv1d(x, w))
    with pytest.raises(TypeError):
        ops.causal_conv1d(x, w, act="relu")       # as in JAX: no act
    with pytest.raises(ValueError, match="method"):
        ops.causal_conv1d(x, w, method="pallas")
    with pytest.raises(ValueError, match="does not fit"):
        causal_conv1d(x, w[:, :5])
    with pytest.raises(ValueError, match=r"\(K, 1, D\)"):
        causal_conv1d(x, w.reshape(4, 2, 4))
    with pytest.raises(ValueError, match="act"):
        causal_conv1d(x, w, act="gelu")
    with pytest.raises(ValueError, match=r"\(B, L, D\)"):
        causal_conv1d(x[0], w)


def test_causal_conv1d_reads_the_in_proj_view_and_refuses_other_layouts():
    """The wrapper takes the x half of a (B, L, 2D) in_proj product as it
    lies (row stride 2D), equal to JAX's oracle on the same values (float32:
    bitwise, as for a contiguous x);
    it refuses x with strided channels, or batch rows that do not follow
    its rows, on the host as on the card."""
    from repro_torch.kernels.conv1d_causal import row_stride
    rng = np.random.default_rng(32)
    xz, w = _f32(rng, (2, 9, 48)), _f32(rng, (4, 24))
    x_in = _tt(xz).chunk(2, dim=-1)[0]
    assert not x_in.is_contiguous() and row_stride("t", x_in) == 48
    got = causal_conv1d(x_in, _tt(w), act="relu")
    assert got.is_contiguous()
    assert torch.equal(got, causal_conv1d_plain(x_in.contiguous(), _tt(w),
                                                act="relu"))
    want = JR.causal_conv1d_ref(jnp.asarray(xz[..., :24]), jnp.asarray(w))
    np.testing.assert_array_equal(causal_conv1d(x_in, _tt(w)).numpy(),
                                  np.asarray(want))
    x = _tt(_f32(rng, (2, 9, 48)))
    with pytest.raises(ValueError, match="channel stride"):
        causal_conv1d(x[..., ::2], _tt(w))
    with pytest.raises(ValueError, match="rows end to end"):
        causal_conv1d(x[..., :24].transpose(0, 1).contiguous()
                      .transpose(0, 1), _tt(w))
    # one batch row: its stride is never read; one position a batch row:
    # the batch rows are the rows
    assert row_stride("t", x[:1, :, :24]) == 48
    assert row_stride("t", x[:, :1, :24]) == 432


def test_the_mixer_hands_the_conv_its_in_proj_view(monkeypatch):
    """_mixer no longer copies x_in: the conv gets the view (row stride
    2 d_inner), and the block and its state still track JAX's (float32,
    rtol 1e-5)."""
    cfg, jp, tp, x, _ = _block_inputs(6, "float32")
    m = cfg.mamba
    seen = []
    real = mamba.K.causal_conv1d

    def spy(xv, wv, **kw):
        seen.append((xv.is_contiguous(), xv.stride()))
        return real(xv, wv, **kw)
    monkeypatch.setattr(mamba.K, "causal_conv1d", spy)
    ty, tst = mamba.mamba_forward_with_state(tp, _tt(x), m, torch.float32)
    di = m.expand * cfg.d_model
    b, l, _ = x.shape
    assert seen == [(False, (l * 2 * di, 2 * di, 1))]
    jy, jst = j_T._mamba_forward_with_state(jp, jnp.asarray(x), m,
                                            jnp.dtype("float32"))
    for got, want in ((ty, jy), (tst["conv"], jst["conv"]),
                      (tst["ssm"], jst["ssm"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


# ------------------------------------------------------------ mamba_scan --

@pytest.mark.parametrize("l,chunk", [(10, 4), (13, 4), (10, 256), (1, 4)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_mamba_scan_matches_jax(l, chunk, with_h0):
    rng = np.random.default_rng(l * 100 + chunk)
    b, di, n = 2, 12, 5
    x = _f32(rng, (b, l, di))
    dt = np.abs(_f32(rng, (b, l, di), 0.5))
    a = -np.exp(_f32(rng, (di, n)))
    bt, ct = _f32(rng, (b, l, n)), _f32(rng, (b, l, n))
    h0 = _f32(rng, (b, di, n)) if with_h0 else None
    jy, jh = j_mamba.mamba_scan(*map(jnp.asarray, (x, dt, a, bt, ct)),
                                chunk=chunk,
                                h0=None if h0 is None else jnp.asarray(h0))
    ty, th = mamba.mamba_scan(*map(_tt, (x, dt, a, bt, ct)), chunk=chunk,
                              h0=None if h0 is None else _tt(h0))
    assert th.dtype == torch.float32 and tuple(th.shape) == (b, di, n)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-6)


def test_chunk_size_is_jax_search():
    for l, chunk, want in [(10, 4, 2), (13, 4, 1), (96, 256, 96),
                           (512, 256, 256), (300, 256, 150), (7, 7, 7)]:
        assert mamba.chunk_size(l, chunk) == want


# ----------------------------------------------------------- Mamba block --

def _block_inputs(seed, dtype):
    cfg = j_tiny_cfg()
    p = j_mamba.init_mamba(jax.random.PRNGKey(seed), cfg.d_model, cfg.mamba,
                           jnp.float32)
    rng = np.random.default_rng(seed)
    x = _f32(rng, (2, 9, cfg.d_model))
    return cfg, p, lm_params_from_numpy(to_numpy(p), device="cpu"), x, rng


#: bf16 tolerance of the Mamba block (module docstring)
BF16_TOL = 0.03


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_forward_state_and_decode_match_jax(dtype):
    cfg, jp, tp, x, rng = _block_inputs(3, dtype)
    m, tdt = cfg.mamba, getattr(torch, dtype)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else \
        dict(rtol=BF16_TOL, atol=BF16_TOL)

    def close(got, want):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   **tol)
    jy = j_mamba.mamba_forward(jp, _jt(x, dtype), m, jnp.dtype(dtype),
                               conv_method="pallas")
    ty = mamba.mamba_forward(tp, _tt(x, tdt), m, tdt)
    assert ty.dtype == tdt
    close(ty, jy)
    jy2, jst = j_T._mamba_forward_with_state(jp, _jt(x, dtype), m,
                                             jnp.dtype(dtype))
    ty2, tst = mamba.mamba_forward_with_state(tp, _tt(x, tdt), m, tdt)
    assert torch.equal(ty2, ty)
    close(tst["conv"], jst["conv"])
    close(tst["ssm"], jst["ssm"])
    assert tst["ssm"].dtype == torch.float32
    # one decode step from a random state
    di = m.expand * cfg.d_model
    conv, ssm_ = _f32(rng, (2, m.d_conv - 1, di)), _f32(rng, (2, di,
                                                              m.d_state))
    xt = _f32(rng, (2, 1, cfg.d_model))
    jo, jns = j_mamba.mamba_decode_step(
        jp, _jt(xt, dtype), {"conv": jnp.asarray(conv),
                             "ssm": jnp.asarray(ssm_)}, m, jnp.dtype(dtype))
    to, tns = mamba.mamba_decode_step(
        tp, _tt(xt, tdt), {"conv": _tt(conv), "ssm": _tt(ssm_)}, m, tdt)
    close(to, jo)
    close(tns["conv"], jns["conv"])
    close(tns["ssm"], jns["ssm"])


def test_forward_with_state_is_the_decode_steps_state():
    """The prefill state of a prompt equals the state that decoding the
    same tokens one by one from zero reaches (float32)."""
    cfg, _, tp, x, _ = _block_inputs(4, "float32")
    m = cfg.mamba
    _, st = mamba.mamba_forward_with_state(tp, _tt(x), m, torch.float32)
    state = mamba.mamba_init_state(cfg.d_model, m, 2, device="cpu")
    for t in range(x.shape[1]):
        _, state = mamba.mamba_decode_step(tp, _tt(x[:, t:t + 1]), state, m,
                                           torch.float32)
    torch.testing.assert_close(st["conv"], state["conv"])
    torch.testing.assert_close(st["ssm"], state["ssm"], rtol=1e-5,
                               atol=1e-5)


def test_forward_with_state_pads_a_prompt_shorter_than_the_window():
    cfg, _, tp, x, _ = _block_inputs(5, "float32")
    _, st = mamba.mamba_forward_with_state(tp, _tt(x[:, :2]), cfg.mamba,
                                           torch.float32)
    assert tuple(st["conv"].shape) == (2, 3, 64)
    assert not st["conv"][:, 0].any() and st["conv"][:, 1:].any()


# ------------------------------------------------------- model and engine --

def test_config_and_param_count_match_jax():
    jcfg, cfg = j_get_config("falcon-mamba-7b"), get_config("falcon-mamba-7b")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_count() == jcfg.param_count() == 7_272_660_992
    assert cfg.mamba.rank(cfg.d_model) == 256
    assert tiny_cfg().param_count() == j_tiny_cfg().param_count()


def test_init_lm_layout_and_scales_match_jax(ssm):
    jparams, _ = ssm
    cfg = tiny_cfg()
    params = T.init_lm(cfg, torch.Generator().manual_seed(0))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jparams)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), params) == shapes
    leaves = jax.tree_util.tree_leaves(params)
    assert all(t.dtype == torch.float32 and t.is_contiguous()
               for t in leaves)
    assert sum(t.numel() for t in leaves) == cfg.param_count() + cfg.d_model
    mp, jm = params["layers"]["mamba"], jparams["layers"]["mamba"]
    for k in ("A_log", "D", "conv_b"):
        np.testing.assert_allclose(mp[k].numpy(), np.asarray(jm[k]),
                                   rtol=1e-6)
    d, di = cfg.d_model, 2 * cfg.d_model
    assert abs(float(mp["in_proj"].std()) - d ** -0.5) < 0.1 * d ** -0.5
    assert abs(float(mp["out_proj"].std()) - di ** -0.5) < 0.1 * di ** -0.5
    dt = torch.nn.functional.softplus(mp["dt_bias"])
    assert float(dt.min()) >= 1e-4 - 1e-7 and float(dt.max()) <= 0.1 + 1e-6


def test_lm_params_from_numpy_carries_the_jax_ssm_tree(ssm):
    jparams, params = ssm
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert set(params["layers"]) == {"ln", "mamba"}
    for path, leaf in flat_j:
        t = params
        for key in path:
            t = t[key.key]
        assert t.dtype == torch.float32 and t.is_contiguous()
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))


def test_cast_params_keeps_a_log_float32(ssm):
    _, params = ssm
    cast = T.cast_params(params, tiny_cfg())       # compute bfloat16
    mp = cast["layers"]["mamba"]
    assert mp["A_log"].dtype == torch.float32
    assert mp["A_log"] is params["layers"]["mamba"]["A_log"]
    for k in ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias",
              "D", "out_proj"):
        assert mp[k].dtype == torch.bfloat16, k
    assert cast["layers"]["ln"].dtype == torch.float32
    assert cast["embed"].dtype == torch.float32
    assert params["layers"]["mamba"]["in_proj"].dtype == torch.float32


@pytest.mark.parametrize("with_lens", [False, True])
def test_prefill_and_decode_logits_track_jax(ssm, with_lens):
    jparams, params = ssm
    jcfg, cfg = j_tiny_cfg(**F32), tiny_cfg(**F32)
    rng = np.random.default_rng(40)
    toks = rng.integers(0, 64, (2, 7)).astype(np.int32)
    batch_j = {"tokens": jnp.asarray(toks)}
    batch_t = {"tokens": torch.from_numpy(toks).long()}
    if with_lens:
        batch_j["prompt_lens"] = jnp.asarray([7, 7], jnp.int32)
        batch_t["prompt_lens"] = torch.tensor([7, 7], dtype=torch.int32)
    jl, jc = j_api.prefill_fn(jcfg, 16)(jparams, batch_j)
    tl, tc = api.prefill_fn(cfg, 16)(params, batch_t)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-3,
                               atol=1e-4)
    assert set(tc) == set(jc) == {"conv", "ssm", "len"}
    assert tc["conv"].dtype == torch.bfloat16
    assert tc["ssm"].dtype == torch.float32
    assert tuple(tc["conv"].shape) == tuple(jc["conv"].shape)
    assert tuple(tc["ssm"].shape) == tuple(jc["ssm"].shape)
    np.testing.assert_allclose(tc["ssm"].numpy(), np.asarray(jc["ssm"]),
                               rtol=1e-4, atol=1e-5)
    jdec, tdec = j_api.decode_fn(jcfg), api.decode_fn(cfg)
    cur = np.argmax(np.asarray(jl)[:, -1], axis=-1)[:, None].astype(np.int32)
    for _ in range(4):
        jl, jc = jdec(jparams, jnp.asarray(cur), jc)
        tl, tc = tdec(params, torch.from_numpy(cur).long(), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-3,
                                   atol=1e-4)
        cur = np.argmax(np.asarray(jl)[:, -1], axis=-1)[:, None] \
            .astype(np.int32)
    np.testing.assert_allclose(tc["ssm"].numpy(), np.asarray(jc["ssm"]),
                               rtol=1e-3, atol=1e-4)
    assert np.asarray(tc["len"]).tolist() == np.asarray(jc["len"]).tolist()


def _make_req(cls, uid, plen=5, max_new=6):
    """``tests/test_serve.py``'s ``make_req``."""
    rng = np.random.default_rng(uid)
    return cls(uid=uid, prompt=rng.integers(0, 64, (plen,)).astype(np.int32),
               max_new_tokens=max_new)


#: test_serve.py's ssm traffic, and a mix with mid-decode refill, a prompt
#: of 17 tokens, one of K-1 = 3 (the whole conv window; JAX cannot store
#: a shorter one) and one at max_new=1
TRAFFIC = {"test_serve": [(5, 4)] * 3,
           "refill": [(5, 6), (9, 3), (17, 5), (3, 1), (7, 7)]}


def _drain(engine, reqs):
    for r in reqs:
        engine.submit(r)
    return sorted(engine.run_until_drained(), key=lambda r: r.uid)


@pytest.mark.parametrize("traffic", sorted(TRAFFIC))
def test_engine_streams_equal_jax(ssm, traffic):
    jparams, params = ssm
    specs = TRAFFIC[traffic]
    jeng = JEngine(j_tiny_cfg(**F32), jparams, JServeConfig(max_batch=2,
                                                            max_len=32))
    jdone = _drain(jeng, [_make_req(JRequest, i, p, n)
                          for i, (p, n) in enumerate(specs)])
    eng = Engine(tiny_cfg(**F32), params, ServeConfig(max_batch=2,
                                                      max_len=32))
    done = _drain(eng, [_make_req(Request, i, p, n)
                        for i, (p, n) in enumerate(specs)])
    assert [r.status for r in done] == ["ok"] * len(specs)
    assert [r.out_tokens for r in done] == [r.out_tokens for r in jdone]
    assert [len(r.out_tokens) for r in done] == [n for _, n in specs]
    assert eng.stats["prefills"] == jeng.stats["prefills"] == len(specs)
    assert eng.stats["decode_steps"] == jeng.stats["decode_steps"]
    assert set(eng.stats) == set(jeng.stats)


def test_engine_prefills_each_prompt_at_its_exact_length(ssm):
    """Exact lengths, a 2-token prompt (shorter than the conv window)
    included."""
    _, params = ssm
    eng = Engine(tiny_cfg(**F32), params, ServeConfig(max_batch=2,
                                                      max_len=32))
    assert [eng._bucket_len(n) for n in (1, 5, 17, 32)] == [1, 5, 17, 32]
    seen = []
    prefill = eng.prefill
    eng.prefill = lambda p, batch: (seen.append(batch["tokens"].shape[1])
                                    or prefill(p, batch))
    _drain(eng, [_make_req(Request, i, p, 2)
                 for i, p in enumerate((2, 5, 17))])
    assert sorted(seen) == [2, 5, 17]


def test_slot_cache_write_and_free(ssm):
    _, params = ssm
    cfg = tiny_cfg(**F32)
    assert api.slot_batch_axes(cfg) == j_api.slot_batch_axes(j_tiny_cfg())
    for name in ("qwen2-0.5b", "jamba-v0.1-52b"):
        assert api.slot_batch_axes(j_get_config(name)) == \
            j_api.slot_batch_axes(j_get_config(name))
    with pytest.raises(NotImplementedError, match="encdec"):
        api.slot_batch_axes(j_get_config("seamless-m4t-large-v2"))
    live = api.init_slot_cache(cfg, 3, 16, device="cpu")
    assert tuple(live["conv"].shape) == (2, 3, 3, 64)
    assert tuple(live["ssm"].shape) == (2, 3, 64, 16)
    assert live["conv"].dtype == torch.bfloat16
    assert live["ssm"].dtype == torch.float32
    conv, ssm_ = live["conv"], live["ssm"]
    _, fresh = T.prefill(params, torch.tensor([[4, 5, 6, 7]]), cfg, 16,
                         prompt_lens=[4])
    out = api.cache_write_slot(cfg, live, fresh, 1)
    assert out["conv"] is conv and out["ssm"] is ssm_       # in place
    assert live["len"].tolist() == [0, 4, 0]
    assert torch.equal(live["conv"][:, 1], fresh["conv"][:, 0])
    assert torch.equal(live["ssm"][:, 1], fresh["ssm"][:, 0])
    assert not live["ssm"][:, 0].any() and not live["ssm"][:, 2].any()
    live = api.cache_free_slot(live, 1)
    assert live["len"].tolist() == [0, 0, 0]
    assert torch.equal(live["ssm"][:, 1], fresh["ssm"][:, 0])


# ----------------------------------------------------------------- gates --

@pytest.mark.parametrize("kw,match", [
    (dict(precision="int8"), "quantizes dense FFN"),
    (dict(precision="w4a8-torch"), "quantizes dense FFN"),
    (dict(kv_cache="int8"), "kv_cache='int8'"),
    (dict(kv_layout="paged"), "kv_layout='paged'")])
def test_engine_family_gates_match_jax(ssm, kw, match):
    jparams, params = ssm
    jkw = dict(kw, precision="int8") if "precision" in kw else kw
    with pytest.raises(NotImplementedError, match=match):
        JEngine(j_tiny_cfg(), jparams, JServeConfig(**jkw))
    with pytest.raises(NotImplementedError, match=match):
        Engine(tiny_cfg(), params, ServeConfig(**kw))


def test_serve_config_checks_match_jax_for_ssm():
    cfg, jcfg = tiny_cfg(), j_tiny_cfg()
    for kw in (dict(precision="int8"), dict(kv_cache="int8"),
               dict(kv_layout="paged", kv_num_blocks=64),
               dict(prefill_bucket=64, max_len=32)):
        want = j_check_serve_config(JServeConfig(**kw), jcfg)
        got = check_serve_config(ServeConfig(**kw), cfg)
        assert got == want, kw
    assert check_serve_config(ServeConfig(), cfg) == []


def test_model_entry_points_gate_the_integer_ffn(ssm):
    _, params = ssm
    cfg = tiny_cfg()
    for fn in (lambda: api.prefill_fn(cfg, 16, precision="int8"),
               lambda: api.decode_fn(cfg, precision="int8-torch"),
               lambda: T.prefill(params, torch.zeros((1, 4), dtype=torch.long),
                                 cfg, 16, precision="int8")):
        with pytest.raises(NotImplementedError, match="integer-FFN"):
            fn()
    with pytest.raises(NotImplementedError, match="int8 KV slot cache"):
        api.init_slot_cache(cfg, 2, 16, kv="int8", device="cpu")
