"""The port's int8 KV cache against the JAX package on the CPU:
``quantize_kv`` / ``dequantize_kv`` / ``decode_attention_q8``, the int8
slot cache (``init_slot_cache(kv="int8")``, ``cache_write_slot``),
``decode_step`` over it and ``Engine(kv_cache="int8")``, on the same
seeded numpy inputs and JAX's own parameters carried across.

Tolerances, each with its reason:

* codes and scales are compared bitwise: both packages divide by the same
  float32 scale (amax / 127) and round half to even;
* ``dequantize_kv`` is one float32 multiply and one rounding to the target
  dtype in both packages: bitwise;
* ``decode_attention_q8`` and decode logits: the float decode's tolerance
  (``tests/test_torch_lm.py``: atol 1e-4, rtol 1e-3; the frameworks sum in
  another order);
* greedy token streams are compared exactly.

Run here with ``PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q
tests/test_torch_kv8.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.base import get_config as j_get_config  # noqa: E402
from repro.models import api as j_api  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402

from repro_torch.check import check_serve_config  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import Engine, Request, ServeConfig  # noqa: E402
from repro_torch.weights import lm_params_from_numpy  # noqa: E402

#: the tiny Qwen2 of tests/test_torch_lm.py (float32 compute) and of
#: tests/test_serve.py (the config's bfloat16 compute)
TINY = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
            vocab=64)
COMPUTE = {"f32": dict(compute_dtype="float32"), "bf16": {}}


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _lm(compute):
    kw = dict(TINY, **COMPUTE[compute])
    jcfg = dataclasses.replace(j_get_config("qwen2-0.5b"), **kw)
    jparams = j_api.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), **kw)
    return jcfg, jparams, cfg, lm_params_from_numpy(_np(jparams),
                                                    device="cpu")


@pytest.fixture(scope="module")
def lm():
    """JAX's tiny Qwen2 parameters and the port's copy, float32 compute:
    the stack whose logits and streams tests/test_torch_lm.py holds
    against JAX's."""
    return _lm("f32")


@pytest.fixture(scope="module", params=sorted(COMPUTE))
def lm_any(request):
    """The same, in float32 and in the config's bfloat16 compute (where
    the two frameworks' bf16 matmuls can round a K/V element or an FFN
    activation code apart, so only bitwise-by-construction results and
    the port's own streams are compared)."""
    return _lm(request.param)


def _t(a, dtype=None):
    """A numpy (or JAX) array as a torch tensor; bfloat16 goes through
    float32, which holds it exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _kv_rows(dtype):
    """(4, 3, 2, 16) K/V rows: seeded normals, an all-zero head, a head at
    another scale, and a head whose amax is 127 so that x / scale is x:
    halves (+-0.5, 1.5, 2.5, 3.5, -126.5) that round to even."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 3, 2, 16)).astype(np.float32)
    x[0, 1, 0] = 0.0
    x[1, 2] *= 1e-3
    x[2, 0, 1] = [127.0, 0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 3.5, -126.5,
                  0.25, -0.75, 6.5, 0.0, -127.0, 5.5, -4.5]
    if dtype == "bfloat16":
        return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(
            torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bitwise_equal_to_jax(dtype):
    jx, tx = _kv_rows(dtype)
    jq, js = JA.quantize_kv(jx)
    tq, ts = A.quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == (4, 3, 2)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[0, 1, 0] == 1.0 and not tq[0, 1, 0].any()  # all-zero head
    # the halves rounded to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -126.5 -> -126
    assert tq[2, 0, 1, :9].tolist() == [127, 0, 0, 2, -2, 2, -2, 4, -126]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_kv_and_decode_attention_q8_track_jax(dtype):
    rng = np.random.default_rng(2)
    b, s, hkv, hq, d = 3, 12, 2, 4, 16
    codes = [rng.integers(-127, 128, (b, s, hkv, d)).astype(np.int8)
             for _ in range(2)]
    scales = [(rng.random((b, s, hkv)) * 0.05 + 1e-3).astype(np.float32)
              for _ in range(2)]
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    deq = A.dequantize_kv(_t(codes[0]), _t(scales[0]), tdt)
    want = JA.dequantize_kv(jnp.asarray(codes[0]), jnp.asarray(scales[0]),
                            jdt)
    assert deq.dtype == tdt
    np.testing.assert_array_equal(deq.float().numpy(),
                                  np.asarray(want, np.float32))
    q = rng.standard_normal((b, 1, hq, d)).astype(np.float32)
    lens = np.array([0, 5, 12], np.int32)
    got = A.decode_attention_q8(_t(q).to(tdt), _t(codes[0]), _t(codes[1]),
                                _t(scales[0]), _t(scales[1]), _t(lens))
    want = JA.decode_attention_q8(jnp.asarray(q, jdt), jnp.asarray(codes[0]),
                                  jnp.asarray(codes[1]),
                                  jnp.asarray(scales[0]),
                                  jnp.asarray(scales[1]), jnp.asarray(lens))
    tol = dict(rtol=1e-3, atol=1e-4) if dtype == "float32" else \
        dict(rtol=1e-2, atol=1e-2)      # one bfloat16 ulp
    np.testing.assert_allclose(got.float().numpy()[1:],
                               np.asarray(want, np.float32)[1:], **tol)


def _prefill_jax(jcfg, jparams, max_len, plen, bucket, seed):
    rng = np.random.default_rng(seed)
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :plen] = rng.integers(0, 64, (plen,))
    logits, fresh = j_api.prefill_fn(jcfg, max_len)(
        jparams, {"tokens": jnp.asarray(toks),
                  "prompt_lens": jnp.asarray([plen], jnp.int32)})
    return toks, logits, fresh


def _fresh_to_torch(fresh):
    return {"k": _t(fresh["k"]), "v": _t(fresh["v"]),
            "len": _t(fresh["len"], torch.int32)}


def test_int8_slot_cache_layout_and_write_bitwise_equal_to_jax(lm_any):
    jcfg, jparams, cfg, _ = lm_any
    live = api.init_slot_cache(cfg, 3, 16, kv="int8", device="cpu")
    jlive = j_api.init_slot_cache(jcfg, 3, 16, kv="int8")
    assert set(live) == set(jlive) == {"k", "v", "k_scale", "v_scale",
                                       "len"}
    for key in jlive:
        assert tuple(live[key].shape) == jlive[key].shape, key
        assert str(live[key].dtype).split(".")[1] == str(jlive[key].dtype)
        np.testing.assert_array_equal(live[key].numpy(),
                                      np.asarray(jlive[key]))
    assert tuple(live["k_scale"].shape) == (2, 3, 16, 2)
    # the same prefilled float rows (JAX's) written by both packages
    for slot, (plen, seed) in ((1, (5, 3)), (0, (11, 4))):
        _, _, fresh = _prefill_jax(jcfg, jparams, 16, plen, 16, seed)
        live = api.cache_write_slot(cfg, live, _fresh_to_torch(fresh), slot)
        jlive = j_api.cache_write_slot(jcfg, jlive, fresh, slot)
    for key in jlive:
        np.testing.assert_array_equal(live[key].numpy(),
                                      np.asarray(jlive[key]), err_msg=key)
    assert live["len"].tolist() == [11, 5, 0]
    assert live["k"][:, 1].any() and not live["k"][:, 2].any()
    live = api.cache_free_slot(live, 1)
    assert live["len"].tolist() == [11, 0, 0] and live["k"][:, 1].any()


def test_cache_clear_restores_the_initial_state(lm_any):
    jcfg, jparams, cfg, _ = lm_any
    _, _, fresh = _prefill_jax(jcfg, jparams, 16, 5, 8, 5)
    for kv in ("float", "int8"):
        live = api.init_slot_cache(cfg, 2, 16, kv=kv, device="cpu")
        tensors = {k: v.data_ptr() for k, v in live.items()}
        api.cache_write_slot(cfg, live, _fresh_to_torch(fresh), 1)
        cleared = api.cache_clear(live)
        want = api.init_slot_cache(cfg, 2, 16, kv=kv, device="cpu")
        assert {k: v.data_ptr() for k, v in cleared.items()} == tensors
        for key in want:
            assert torch.equal(cleared[key], want[key]), (kv, key)


def test_decode_step_int8_kv_logits_track_jax(lm):
    """Both packages decode five tokens over an int8 cache built from the
    same prefilled rows: logits within the float decode's tolerance, and
    the codes each step wrote within one code of JAX's."""
    jcfg, jparams, cfg, params = lm
    live = api.init_slot_cache(cfg, 2, 16, kv="int8", device="cpu")
    jlive = j_api.init_slot_cache(jcfg, 2, 16, kv="int8")
    cur = np.zeros((2, 1), np.int32)
    for slot, (plen, seed) in enumerate(((5, 6), (9, 7))):
        _, logits, fresh = _prefill_jax(jcfg, jparams, 16, plen, 16, seed)
        live = api.cache_write_slot(cfg, live, _fresh_to_torch(fresh), slot)
        jlive = j_api.cache_write_slot(jcfg, jlive, fresh, slot)
        cur[slot, 0] = int(np.argmax(np.asarray(logits)[0, -1]))
    jdec, tdec = j_api.decode_fn(jcfg), api.decode_fn(cfg)
    tol = dict(rtol=1e-3, atol=1e-4)
    for _ in range(5):
        jl, jlive = jdec(jparams, jnp.asarray(cur), jlive)
        tl, out = tdec(params, torch.from_numpy(cur).long(), live)
        assert out["k"] is live["k"] and out["k_scale"] is live["k_scale"]
        live["len"] = out["len"]
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
        cur = np.argmax(np.asarray(jl)[:, -1], axis=-1)[:, None] \
            .astype(np.int32)
    assert live["len"].tolist() == [10, 14]
    for key in ("k", "v"):
        diff = np.abs(live[key].numpy().astype(np.int32)
                      - np.asarray(jlive[key]).astype(np.int32))
        assert diff.max() <= 1, key
    for key in ("k_scale", "v_scale"):
        np.testing.assert_allclose(live[key].numpy(),
                                   np.asarray(jlive[key]), rtol=2e-2)


def _requests(cls, specs, seed=14):
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(0, 64, (plen,)).astype(np.int32),
                max_new_tokens=new) for i, (plen, new) in enumerate(specs)]


#: tests/test_torch_lm.py's workload: more requests than slots, a prompt
#: past the first bucket, mid-decode refill and retirement
SPECS = [(5, 6), (9, 3), (17, 5), (4, 1), (7, 7)]


def _drain(engine, reqs):
    for r in reqs:
        engine.submit(r)
    return sorted(engine.run_until_drained(), key=lambda r: r.uid)


@pytest.mark.parametrize("port,ref", [
    ("float", "float"), ("int8-torch", "int8-xla"), ("int8", "int8-xla")])
def test_engine_int8_kv_streams_equal_jax(lm, port, ref):
    jcfg, jparams, cfg, params = lm
    jdone = _drain(JEngine(jcfg, jparams, JServeConfig(
        max_batch=2, max_len=32, precision=ref, kv_cache="int8")),
        _requests(JRequest, SPECS))
    eng = Engine(cfg, params, ServeConfig(max_batch=2, max_len=32,
                                          precision=port, kv_cache="int8"))
    done = _drain(eng, _requests(Request, SPECS))
    assert [r.status for r in done] == ["ok"] * len(SPECS)
    assert [r.out_tokens for r in done] == [r.out_tokens for r in jdone]
    assert any(r.admit_round > 0 for r in done)       # refilled mid-decode
    assert eng._arena["k"].dtype == torch.int8


def test_int8_kv_streams_equal_float_kv_on_the_serve_workload(lm_any):
    """tests/test_serve.py::test_int8_kv_token_stream_identical_to_float_kv
    in the port: its workload (mid-decode refill, skewed lengths) gives
    the same streams over the int8 and the float cache, and JAX's int8
    streams."""
    jcfg, jparams, cfg, params = lm_any

    def reqs(cls):
        out = []
        for uid, plen, new in ((0, 5, 3), (1, 5, 12), (2, 7, 6), (3, 5, 5)):
            rng = np.random.default_rng(uid)
            out.append(cls(uid=uid, prompt=rng.integers(0, 64, (plen,))
                           .astype(np.int32), max_new_tokens=new))
        return out
    streams = {}
    for kv in ("float", "int8"):
        done = _drain(Engine(cfg, params, ServeConfig(
            max_batch=2, max_len=32, kv_cache=kv)), reqs(Request))
        assert any(r.admit_round > 0 for r in done)
        streams[kv] = [r.out_tokens for r in done]
    jdone = _drain(JEngine(jcfg, jparams, JServeConfig(
        max_batch=2, max_len=32, kv_cache="int8")), reqs(JRequest))
    assert streams["int8"] == streams["float"]
    assert streams["int8"] == [r.out_tokens for r in jdone]


def test_int8_kv_gates_keep_jax_messages(lm):
    _, _, cfg, params = lm
    ssm = dataclasses.replace(get_config("falcon-mamba-7b"), n_layers=2,
                              d_model=32, vocab=64)
    with pytest.raises(NotImplementedError,
                       match="kv_cache='int8' covers attention-family"):
        Engine(ssm, params, ServeConfig(kv_cache="int8"))
    with pytest.raises(NotImplementedError, match="int8 KV slot cache"):
        api.init_slot_cache(ssm, 2, 16, kv="int8", device="cpu")
    cache = api.init_slot_cache(ssm, 2, 16, device="cpu")
    cache["k_scale"] = torch.ones(1)
    with pytest.raises(NotImplementedError, match="int8 KV decode"):
        T.decode_step({}, torch.zeros((2, 1), dtype=torch.long), cache, ssm)
    static = ServeConfig(kv_cache="int8", scheduler="static")
    with pytest.raises(NotImplementedError,
                       match="use scheduler='continuous'"):
        Engine(cfg, params, static)
    assert any("continuous" in m for m in check_serve_config(static, cfg))
    with pytest.raises(ValueError, match="kv must be"):
        api.init_slot_cache(cfg, 2, 16, kv="int4", device="cpu")
