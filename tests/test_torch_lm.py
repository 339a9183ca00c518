"""The port's LM serve path against the JAX package on the CPU: the
``matmul_q8`` / ``matmul_w4`` plain versions, ``quantize_mlp_params``,
``qmlp``, float prefill and decode, and the continuous-batching ``Engine``
in its float and integer precisions, on the same seeded numpy inputs and
JAX's own parameters carried across by ``weights.lm_params_from_numpy``.

Tolerances, each with its reason:

* integer results (matmul codes, quantized weights, ``qmlp``'s int8
  activations and matmul outputs) are compared exactly;
* ``qmlp``'s float output: PyTorch's ``silu`` can differ from XLA's by an
  ulp, which can move a ``floor`` in the second activation quantization by
  one code; the outputs then differ by one code's worth of ``w_down``
  (atol 2^-4 * 128 * 2^-fb) in at most 2% of the entries;
* float logits of prefill and decode: the two frameworks sum in another
  order (float32 rounding), and the bf16 KV cache can round a K/V element
  of the two sides to neighbouring bf16 values: atol 1e-4, rtol 1e-3;
* greedy token streams are compared exactly.

Run here with ``PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q
tests/test_torch_lm.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.base import get_config as j_get_config  # noqa: E402
from repro.core.quantize import QTensorW4 as JQTensorW4  # noqa: E402
from repro.core.quantize import pack_w4 as j_pack_w4  # noqa: E402
from repro.core.quantize import quantize as j_quantize  # noqa: E402
from repro.kernels import ops as JK  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro.kernels.matmul_q8 import matmul as j_pallas_matmul  # noqa: E402
from repro.models import api as j_api  # noqa: E402
from repro.models import blocks as j_blocks  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402

from repro_torch.check import check_serve_config  # noqa: E402
from repro_torch.configs import MoEConfig, get_config  # noqa: E402
from repro_torch.core.quantize import QTensor, QTensorW4, quantize  # noqa: E402
from repro_torch.faults import FaultPlan, FaultSpec  # noqa: E402
from repro_torch.kernels import matmul_q8, matmul_w4, ops  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402
from repro_torch.serve import (Engine, QueueFullError, Request,  # noqa: E402
                               ServeConfig)
from repro_torch.weights import lm_params_from_numpy  # noqa: E402

TINY = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
            vocab=64, compute_dtype="float32")


def tiny_cfg():
    return dataclasses.replace(get_config("qwen2-0.5b"), **TINY)


def j_tiny_cfg():
    return dataclasses.replace(j_get_config("qwen2-0.5b"), **TINY)


def to_numpy(tree):
    """A JAX tree (params, a qmlp tree) as plain numpy data."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, JQTensorW4):
        return {"q": np.asarray(tree.q), "shifts": np.asarray(tree.shifts),
                "frac_bits": tree.frac_bits, "size": tree.size,
                "axis": tree.axis}
    if hasattr(tree, "frac_bits"):                 # JAX QTensor
        return (np.asarray(tree.q), int(tree.frac_bits))
    return np.asarray(tree)


@pytest.fixture(scope="module")
def lm():
    """JAX's tiny Qwen2 parameters and the port's copy of them."""
    jcfg = j_tiny_cfg()
    jparams = j_api.init_params(jcfg, jax.random.PRNGKey(0))
    params = lm_params_from_numpy(to_numpy(jparams), device="cpu")
    return jcfg, jparams, tiny_cfg(), params


def _i8(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


def _w4(rng, k, n):
    q = rng.integers(-8, 8, (k, n)).astype(np.int8)
    q.flat[0], q.flat[-1] = -8, 7
    packed = np.array(j_pack_w4(jnp.asarray(q), 0))
    return packed, rng.integers(0, 5, k).astype(np.int8)


# ------------------------------------------------------------ matmul_q8 --

# (M, K, N, requant_shift, act, Pallas blocks): ragged M and N inside the
# Pallas grid, odd and ragged K, negative and positive shifts, relu on and
# off. The Pallas int8 kernel sums unmasked K tails, so its K block divides
# K or spans it (ROADMAP.md, section C).
MM_CASES = [
    (5, 45, 37, 7, None, (8, 16, 512)),
    (13, 45, 37, -2, "relu", (8, 16, 512)),
    (8, 33, 96, 0, "relu", (8, 32, 512)),
    (17, 96, 70, 9, None, (8, 16, 32)),
    (3, 64, 37, 12, "relu", (16, 16, 16)),
    (1, 1, 1, 0, None, (8, 16, 512)),
]


@pytest.mark.parametrize("case", MM_CASES, ids=str)
def test_matmul_q8_plain_equals_jax_ref_and_pallas(case):
    m, k, n, shift, act, (bm, bn, bk) = case
    rng = np.random.default_rng(m * 1000 + k)
    a, b = _i8(rng, (m, k)), _i8(rng, (k, n))
    got = matmul_q8(torch.from_numpy(a), torch.from_numpy(b),
                    requant_shift=shift, act=act)
    assert got.dtype == torch.int8 and tuple(got.shape) == (m, n)
    want = np.asarray(JR.matmul_ref(jnp.asarray(a), jnp.asarray(b),
                                    requant_shift=shift, act=act))
    np.testing.assert_array_equal(got.numpy(), want)
    pallas = np.asarray(j_pallas_matmul(
        jnp.asarray(a), jnp.asarray(b), bm=bm, bn=bn, bk=bk,
        requant_shift=shift, act=act, interpret=True))
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(
        R.matmul_ref(torch.from_numpy(a), torch.from_numpy(b),
                     requant_shift=shift, act=act).numpy(), want)


# W4: the Pallas kernel forces an even K block and its ragged K tail is
# right, so its blocks may cut K anywhere here
W4_CASES = [
    (5, 45, 37, 7, None, (8, 16, 16)),
    (13, 45, 37, -2, "relu", (8, 16, 512)),
    (8, 33, 96, 0, "relu", (8, 32, 10)),
    (17, 96, 70, 9, None, (8, 16, 32)),
    (4, 1, 5, 0, None, (8, 16, 512)),
]


@pytest.mark.parametrize("case", W4_CASES, ids=str)
def test_matmul_w4_plain_equals_jax_ref_and_pallas(case):
    m, k, n, shift, act, (bm, bn, bk) = case
    rng = np.random.default_rng(m * 1000 + k + 1)
    a = _i8(rng, (m, k))
    bp, ws = _w4(rng, k, n)
    got = matmul_w4(torch.from_numpy(a), torch.from_numpy(bp),
                    torch.from_numpy(ws), requant_shift=shift, act=act)
    want = np.asarray(JR.matmul_w4_ref(jnp.asarray(a), jnp.asarray(bp),
                                       jnp.asarray(ws), requant_shift=shift,
                                       act=act))
    np.testing.assert_array_equal(got.numpy(), want)
    pallas = np.asarray(j_pallas_matmul(
        jnp.asarray(a), jnp.asarray(bp), bm=bm, bn=bn, bk=bk,
        requant_shift=shift, act=act, interpret=True,
        w_shifts=jnp.asarray(ws)))
    np.testing.assert_array_equal(got.numpy(), pallas)


def test_matmul_w4_pad_nibble_is_never_read():
    """An odd K leaves a pad nibble in the last packed row; garbage there
    changes nothing."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(_i8(rng, (6, 33)))
    bp, ws = (torch.from_numpy(t) for t in _w4(rng, 33, 20))
    clean = matmul_w4(a, bp, ws, requant_shift=4)
    dirty = bp.clone()
    dirty[-1] = (dirty[-1].to(torch.int32) | 0x70).to(torch.int8)
    assert torch.equal(matmul_w4(a, dirty, ws, requant_shift=4), clean)


def test_ops_matmul_folds_batch_and_counts_one_dispatch():
    rng = np.random.default_rng(6)
    a = torch.from_numpy(_i8(rng, (3, 5, 40)))
    b = torch.from_numpy(_i8(rng, (40, 24)))
    c = metrics.counter("kernels.dispatch.matmul.cuda")
    before = c.value
    got = ops.matmul(a, b, requant_shift=8, act="relu")
    assert c.value == before + 1
    assert tuple(got.shape) == (3, 5, 24)
    flat = ops.matmul(a.reshape(15, 40), b, method="torch", requant_shift=8,
                      act="relu")
    assert torch.equal(got.reshape(15, 24), flat)
    want = np.asarray(JK.matmul(jnp.asarray(a.numpy()), jnp.asarray(
        b.numpy()), method="xla", requant_shift=8, act="relu"))
    np.testing.assert_array_equal(got.numpy(), want)


def test_ops_matmul_float_mode_runs_plain_on_the_host():
    rng = np.random.default_rng(7)
    a = rng.standard_normal((4, 16)).astype(np.float32)
    b = rng.standard_normal((16, 8)).astype(np.float32)
    got = ops.matmul(torch.from_numpy(a), torch.from_numpy(b), act="relu")
    want = np.asarray(JR.matmul_ref(jnp.asarray(a), jnp.asarray(b),
                                    act="relu"))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bad", [
    dict(requant_shift=40), dict(act="gelu"), dict(b_rows=44)])
def test_matmul_wrappers_reject_bad_inputs(bad):
    rng = np.random.default_rng(8)
    a = torch.from_numpy(_i8(rng, (4, 45)))
    b = torch.from_numpy(_i8(rng, (bad.get("b_rows", 45), 8)))
    kw = {k: v for k, v in bad.items() if k != "b_rows"}
    with pytest.raises(ValueError):
        matmul_q8(a, b, **{"requant_shift": 3, **kw})


def test_matmul_w4_rejects_a_wrong_packed_extent():
    rng = np.random.default_rng(9)
    a = torch.from_numpy(_i8(rng, (4, 45)))
    bp, ws = (torch.from_numpy(t) for t in _w4(rng, 45, 8))
    with pytest.raises(ValueError, match="packed extent"):
        matmul_w4(a, bp[:-1], ws, requant_shift=3)
    with pytest.raises(ValueError, match="requant_shift"):
        ops.matmul(a, bp, w_shifts=ws)


def test_split_plan_covers_k_with_non_empty_splits():
    """The integer matmul's K split: the 64-deep K stages dealt round-robin
    to the cluster's warps cover K once, and the default config leaves
    no warp without a stage, at the served shapes and ragged ones."""
    from repro_torch.kernels.matmul_q8 import (MMQ_BK, default_mmq_config,
                                               mmq_plan, mmq_warps)
    for m, k, n in [(8, 896, 4864), (8, 4864, 896), (128, 896, 4864),
                    (3, 45, 37), (8, 0, 16), (300, 4096, 4096)]:
        cfg = default_mmq_config(m, k, n, 132)
        block = mmq_warps(cfg["bm"])
        warps = block * cfg["cluster"]
        stages = -(-k // MMQ_BK)
        dealt = [[s for s in range(stages) if s % warps == q]
                 for q in range(warps)]
        assert sorted(s for d in dealt for s in d) == list(range(stages))
        assert max(map(len, dealt)) == \
            mmq_plan(m, k, n, cfg["bn"], cfg["bm"], cfg["cluster"])["stages"]
        if stages >= block:
            assert min(map(len, dealt)) >= 1
    # decode gate/up: 14 stages over 8 warps (1 or 2 each); down: 76 over
    # 4 x 8; prefill gate/up 4 warps a block, down at M = 64 4 x 4
    assert default_mmq_config(8, 896, 4864) == dict(bn=64, bm=8, cluster=1)
    assert default_mmq_config(8, 4864, 896) == dict(bn=32, bm=8, cluster=4)
    assert default_mmq_config(32, 896, 4864)["cluster"] == 1
    assert default_mmq_config(128, 896, 4864)["cluster"] == 1
    assert default_mmq_config(64, 4864, 896)["cluster"] == 4


# --------------------------------------------------- quantized FFN params --

def _stacked_mlp(rng, n_layers=3, d=32, ff=64):
    """Float FFN weights whose layers sit an octave apart, so the W4 base
    frac_bits differ per layer and get pinned across the stack."""
    def w(shape, fan_in):
        x = rng.standard_normal((n_layers,) + shape) * fan_in ** -0.5
        return (x * 2.0 ** -np.arange(n_layers)[:, None, None]) \
            .astype(np.float32)
    return {"w_gate": w((d, ff), d), "w_up": w((d, ff), d),
            "w_down": w((ff, d), ff)}


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_mlp_params_bitwise_equal_to_jax(bits):
    p = _stacked_mlp(np.random.default_rng(10))
    jq = j_blocks.quantize_mlp_params({k: jnp.asarray(v) for k, v in
                                       p.items()}, bits=bits)
    tq = blocks.quantize_mlp_params({k: torch.from_numpy(v) for k, v in
                                     p.items()}, bits=bits)
    for k in p:
        assert tq[k].frac_bits == jq[k].frac_bits, k
        np.testing.assert_array_equal(tq[k].q.numpy(), np.asarray(jq[k].q))
        assert tq[k].q.is_contiguous()
        if bits == 4:
            assert isinstance(tq[k], QTensorW4)
            assert (tq[k].size, tq[k].axis) == (jq[k].size, jq[k].axis)
            np.testing.assert_array_equal(tq[k].shifts.numpy(),
                                          np.asarray(jq[k].shifts))
        else:
            assert isinstance(tq[k], QTensor)
    if bits == 4:      # the octave spread really pinned the base scale
        per_layer = {blocks.quantize_mlp_params(
            {"w": torch.from_numpy(p["w_up"][l])}, bits=4)["w"].frac_bits
            for l in range(3)}
        assert len(per_layer) > 1


@pytest.mark.parametrize("bits", [8, 4])
def test_jax_qmlp_tree_carries_across(bits):
    """A quantized tree made by the JAX package, carried across as numpy,
    equals the port's own quantization of the same weights."""
    p = _stacked_mlp(np.random.default_rng(11))
    jq = j_blocks.quantize_mlp_params({k: jnp.asarray(v) for k, v in
                                       p.items()}, bits=bits)
    got = lm_params_from_numpy({"qmlp": to_numpy(jq)}, device="cpu")["qmlp"]
    want = blocks.quantize_mlp_params({k: torch.from_numpy(v) for k, v in
                                       p.items()}, bits=bits)
    for k in p:
        assert type(got[k]) is type(want[k])
        assert got[k].frac_bits == want[k].frac_bits
        assert torch.equal(got[k].q, want[k].q)
        if bits == 4:
            assert torch.equal(got[k].shifts, want[k].shifts)


def test_lm_params_from_numpy_checks_w4_leaves():
    leaf = {"q": np.zeros((2, 3, 4), np.int8),
            "shifts": np.zeros((2, 5), np.int8), "frac_bits": 3, "size": 5,
            "axis": 0}
    got = lm_params_from_numpy({"w": leaf}, device="cpu")["w"]
    assert isinstance(got, QTensorW4) and tuple(got.q.shape) == (2, 3, 4)
    with pytest.raises(ValueError, match="do not fit"):
        lm_params_from_numpy({"w": dict(leaf, size=7)}, device="cpu")
    with pytest.raises(ValueError, match="group shifts"):
        bad = dict(leaf, shifts=np.full((2, 5), 5, np.int8))
        lm_params_from_numpy({"w": bad}, device="cpu")


@pytest.mark.parametrize("bits", [8, 4])
def test_qmlp_matmuls_bitwise_and_output_within_tolerance(bits):
    rng = np.random.default_rng(12 + bits)
    p = {k: v[0] for k, v in _stacked_mlp(rng, n_layers=1).items()}
    h = (rng.standard_normal((2, 5, 32)) * 1.5).astype(np.float32)
    jq = j_blocks.quantize_mlp_params({k: jnp.asarray(v) for k, v in
                                       p.items()}, bits=bits)
    tq = blocks.quantize_mlp_params({k: torch.from_numpy(v) for k, v in
                                     p.items()}, bits=bits)
    # the int8 activations and the integer matmul outputs: bitwise
    a_fb = blocks.ACT_FRAC_BITS
    xq = quantize(torch.from_numpy(h.reshape(10, 32)), frac_bits=a_fb)
    jxq = j_quantize(jnp.asarray(h.reshape(10, 32)), frac_bits=a_fb)
    np.testing.assert_array_equal(xq.q.numpy(), np.asarray(jxq.q))
    for name in ("w_gate", "w_up"):
        w, jw = tq[name], jq[name]
        kw = dict(requant_shift=w.frac_bits)
        if bits == 4:
            got = ops.matmul(xq.q, w.q, w_shifts=w.shifts, **kw)
            want = JK.matmul(jxq.q, jw.q, method="xla", w_shifts=jw.shifts,
                             **kw)
        else:
            got = ops.matmul(xq.q, w.q, **kw)
            want = JK.matmul(jxq.q, jw.q, method="xla", **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the whole FFN: one ulp of silu may move one code of the second
    # quantization (module docstring)
    got = blocks.qmlp(torch.from_numpy(h), tq, "silu", torch.float32,
                      method="torch").numpy()
    want = np.asarray(j_blocks.qmlp(jnp.asarray(h), jq, "silu",
                                    jnp.float32, method="xla"))
    one_code = 2.0 ** -a_fb * 128 * 2.0 ** -tq["w_down"].frac_bits
    assert np.abs(got - want).max() <= one_code
    assert np.mean(got != want) <= 0.02
    cuda_method = blocks.qmlp(torch.from_numpy(h), tq, "silu", torch.float32,
                              method="cuda").numpy()
    np.testing.assert_array_equal(cuda_method, got)


# ------------------------------------------------------ prefill / decode --

def _prompts(rng, lens, vocab=64):
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lens]


@pytest.mark.parametrize("impl", ["flash", "full"])
def test_prefill_and_decode_logits_track_jax(lm, impl):
    jcfg, jparams, cfg, params = lm
    rng = np.random.default_rng(13)
    max_len, lens = 24, [5, 8]
    toks = np.zeros((2, 8), np.int32)
    for i, p in enumerate(_prompts(rng, lens)):
        toks[i, :len(p)] = p
    jl, jc = j_api.prefill_fn(jcfg, max_len, attn_impl=impl)(
        jparams, {"tokens": jnp.asarray(toks),
                  "prompt_lens": jnp.asarray(lens, jnp.int32)})
    tl, tc = api.prefill_fn(cfg, max_len, attn_impl=impl)(
        params, {"tokens": torch.from_numpy(toks).long(),
                 "prompt_lens": torch.tensor(lens, dtype=torch.int32)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-3,
                               atol=1e-4)
    assert tc["k"].dtype == torch.bfloat16 and tc["len"].tolist() == lens
    jdec, tdec = j_api.decode_fn(jcfg), api.decode_fn(cfg)
    cur = np.argmax(np.asarray(jl)[:, -1], axis=-1)[:, None].astype(np.int32)
    for _ in range(4):
        jl, jc = jdec(jparams, jnp.asarray(cur), jc)
        tl, tc = tdec(params, torch.from_numpy(cur).long(), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-3,
                                   atol=1e-4)
        cur = np.argmax(np.asarray(jl)[:, -1], axis=-1)[:, None] \
            .astype(np.int32)
    assert tc["len"].tolist() == [n + 4 for n in lens]
    np.testing.assert_allclose(tc["k"].float().numpy(),
                               np.asarray(jc["k"], np.float32),
                               rtol=1e-2, atol=1e-2)


def test_take_gives_views_of_one_layer():
    q = torch.arange(3 * 4 * 5, dtype=torch.int8).reshape(3, 4, 5)
    shifts = torch.arange(3 * 8, dtype=torch.int8).reshape(3, 8)
    tree = {"a": torch.zeros(3, 6), "q8": QTensor(q, 5),
            "w4": QTensorW4(q, shifts, 7, 8, 0)}
    got = T._take(tree, 1)
    assert got["a"].data_ptr() == tree["a"][1].data_ptr()
    assert got["q8"].frac_bits == 5 and torch.equal(got["q8"].q, q[1])
    assert got["q8"].q.data_ptr() == q[1].data_ptr()
    w4 = got["w4"]
    assert (w4.frac_bits, w4.size, w4.axis) == (7, 8, 0)
    assert torch.equal(w4.q, q[1]) and torch.equal(w4.shifts, shifts[1])
    assert w4.shifts.data_ptr() == shifts[1].data_ptr()


def test_cast_params_casts_once_and_keeps_the_embedding(lm):
    _, _, cfg, params = lm
    bf = dataclasses.replace(cfg, compute_dtype="bfloat16")
    cast = T.cast_params(params, bf)
    assert cast["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert cast["layers"]["mlp"]["w_up"].dtype == torch.bfloat16
    assert cast["embed"].dtype == torch.float32
    assert params["layers"]["attn"]["wq"].dtype == torch.float32
    kept = T.cast_params(params, bf, mlp_too=False)
    assert kept["layers"]["mlp"]["w_up"] is params["layers"]["mlp"]["w_up"]


# ---------------------------------------------------------------- engine --

def _requests(cls, specs):
    rng = np.random.default_rng(14)
    return [cls(uid=i, prompt=rng.integers(0, 64, (plen,)).astype(np.int32),
                max_new_tokens=new) for i, (plen, new) in enumerate(specs)]


#: more requests than slots, skewed lengths: mid-decode refill and
#: retirement, a prompt past the first bucket (16) and one at max_new=1
SPECS = [(5, 6), (9, 3), (17, 5), (4, 1), (7, 7)]


def _drain(engine, reqs):
    for r in reqs:
        engine.submit(r)
    return sorted(engine.run_until_drained(), key=lambda r: r.uid)


@pytest.mark.parametrize("port,ref", [
    ("float", "float"), ("int8-torch", "int8-xla"), ("int8", "int8-xla"),
    ("w4a8-torch", "w4a8"), ("w4a8", "w4a8")])
def test_engine_streams_equal_jax(lm, port, ref):
    jcfg, jparams, cfg, params = lm
    jdone = _drain(JEngine(jcfg, jparams, JServeConfig(
        max_batch=2, max_len=32, precision=ref)), _requests(JRequest, SPECS))
    eng = Engine(cfg, params, ServeConfig(max_batch=2, max_len=32,
                                          precision=port))
    done = _drain(eng, _requests(Request, SPECS))
    assert [r.status for r in done] == ["ok"] * len(SPECS)
    assert [r.out_tokens for r in done] == [r.out_tokens for r in jdone]
    assert [len(r.out_tokens) for r in done] == [n for _, n in SPECS]
    assert any(r.admit_round > 0 for r in done)       # refilled mid-decode
    assert "qmlp" not in params["layers"]             # caller's tree intact


def test_engine_stats_keys_equal_jax(lm):
    jcfg, jparams, cfg, params = lm
    jeng = JEngine(jcfg, jparams, JServeConfig(max_batch=2, max_len=32))
    eng = Engine(cfg, params, ServeConfig(max_batch=2, max_len=32))
    _drain(eng, _requests(Request, SPECS[:2]))
    assert set(eng.stats) == set(jeng.stats)
    st = eng.stats
    assert st["requests_done"] == 2 and st["prefills"] == 2
    assert st["tokens_out"] == 9 and st["decode_steps"] == 5
    assert st["blocks_in_use"] == st["blocks_free"] == 0
    assert st["decode_tok_s"] > 0


def test_engine_temperature_sampling_is_seeded(lm):
    _, _, cfg, params = lm
    streams = []
    for _ in range(2):
        eng = Engine(cfg, params, ServeConfig(max_batch=2, max_len=32,
                                              greedy=False, temperature=1.0,
                                              seed=3))
        streams.append([r.out_tokens for r in
                        _drain(eng, _requests(Request, SPECS))])
    assert streams[0] == streams[1]


def test_engine_eos_and_max_len_retire(lm):
    _, _, cfg, params = lm
    eng = Engine(cfg, params, ServeConfig(max_batch=2, max_len=32))
    ref = _drain(eng, _requests(Request, [(5, 6)]))[0].out_tokens
    eng = Engine(cfg, params, ServeConfig(max_batch=2, max_len=32,
                                          eos_id=ref[2]))
    assert _drain(eng, _requests(Request, [(5, 6)]))[0].out_tokens == \
        ref[:ref.index(ref[2]) + 1]
    eng = Engine(cfg, params, ServeConfig(max_batch=2, max_len=8))
    (r,) = _drain(eng, _requests(Request, [(5, 10)]))
    assert r.status == "ok" and len(r.out_tokens) == 4    # 5 + 3 == max_len


def test_engine_deadline_and_shedding(lm):
    _, _, cfg, params = lm
    eng = Engine(cfg, params, ServeConfig(max_batch=2, max_len=32,
                                          deadline_s=1e-9))
    done = _drain(eng, _requests(Request, SPECS[:3]))
    assert [r.status for r in done] == ["timeout"] * 3
    eng = Engine(cfg, params, ServeConfig(max_batch=2, max_len=32,
                                          max_queue=2))
    reqs = _requests(Request, SPECS[:3])
    eng.submit(reqs[0])
    eng.submit(reqs[1])
    with pytest.raises(QueueFullError):
        eng.submit(reqs[2])
    eng = Engine(cfg, params, ServeConfig(max_batch=2, max_len=32,
                                          max_queue=2, shed_policy="drop"))
    for r in reqs:
        r.status, r.done = "pending", False
        eng.submit(r)
    assert reqs[2].status == "shed" and eng.stats["shed"] == 1


def test_engine_prefill_fault_absorbed_by_retry(lm):
    _, _, cfg, params = lm
    clean = [r.out_tokens for r in _drain(
        Engine(cfg, params, ServeConfig(max_batch=2, max_len=32)),
        _requests(Request, SPECS))]
    eng = Engine(cfg, params, ServeConfig(max_batch=2, max_len=32))
    with FaultPlan([FaultSpec(site="engine.prefill", kind="raise", nth=2)]):
        done = _drain(eng, _requests(Request, SPECS))
    assert [r.status for r in done] == ["ok"] * len(SPECS)
    assert [r.out_tokens for r in done] == clean
    assert eng.stats["retries"] == 1


def test_engine_decode_fault_retires_active_set_and_rebuilds(lm):
    _, _, cfg, params = lm
    eng = Engine(cfg, params, ServeConfig(max_batch=2, max_len=32))
    with FaultPlan([FaultSpec(site="engine.decode_round", kind="raise",
                              nth=2, times=3)]):
        done = _drain(eng, _requests(Request, SPECS))
    status = [r.status for r in done]
    assert status.count("error") == 2 and status.count("ok") == 3
    assert eng.stats["arena_rebuilds"] == 1 and eng.stats["errors"] == 2


def test_engine_corrupt_fault_is_recorded(lm):
    _, _, cfg, params = lm
    eng = Engine(cfg, params, ServeConfig(max_batch=2, max_len=32))
    with FaultPlan([FaultSpec(site="engine.decode_round", kind="corrupt",
                              nth=1)]):
        done = _drain(eng, _requests(Request, SPECS[:2]))
    assert all(r.status == "ok" for r in done)
    assert eng.poisoned_uids == {0, 1}


# ------------------------------------- static, paged, flash_tri; invalid --

@pytest.mark.parametrize("kw", [
    dict(scheduler="static"), dict(kv_layout="paged", kv_block_size=8),
    dict(attn_impl="flash_tri")], ids=["static", "paged", "flash_tri"])
def test_engine_serves_static_paged_and_flash_tri(lm, kw):
    """The scheduler, KV layout and prefill attention that JAX's engine
    also serves build and serve the streams of JAX's engine under the same
    parameters (tests/test_torch_static.py and tests/test_torch_paged.py
    hold each in depth)."""
    jcfg, jparams, cfg, params = lm
    jdone = _drain(JEngine(jcfg, jparams, JServeConfig(
        max_batch=2, max_len=32, **kw)), _requests(JRequest, SPECS))
    eng = Engine(cfg, params, ServeConfig(max_batch=2, max_len=32, **kw))
    done = _drain(eng, _requests(Request, SPECS))
    assert [r.status for r in done] == ["ok"] * len(SPECS)
    assert [r.out_tokens for r in done] == [r.out_tokens for r in jdone]


@pytest.mark.parametrize("family", ["ssm", "hybrid", "moe", "encdec"])
def test_other_families_raise(lm, family):
    """What each other family still refuses: ssm, hybrid and moe serve in
    "float" only (JAX's message for an integer precision); an encdec model
    is refused by the engine under either scheduler (the continuous one
    with JAX's message; the static one, whose requests carry no encoder
    frames, naming ROADMAP.md); a family name no config uses raises
    everywhere."""
    jcfg, _, cfg, params = lm
    if family in ("ssm", "hybrid"):
        other = get_config("falcon-mamba-7b" if family == "ssm"
                           else "jamba-v0.1-52b")
        with pytest.raises(NotImplementedError,
                           match="precision='int8' quantizes dense FFN"):
            Engine(other, params, ServeConfig(precision="int8"))
        unknown = dataclasses.replace(cfg, family="rwkv")
        for fn in (lambda: Engine(unknown, params, ServeConfig()),
                   lambda: T.init_lm(unknown,
                                     torch.Generator().manual_seed(0)),
                   lambda: api.prefill_fn(unknown, 16)):
            with pytest.raises(NotImplementedError,
                               match="unknown model family 'rwkv'"):
                fn()
        return
    if family == "moe":
        moe = dataclasses.replace(cfg, family="moe", moe=MoEConfig(
            num_experts=4, top_k=2, d_ff=16))
        p = T.init_lm(moe, torch.Generator().manual_seed(0))
        assert p["layers"]["moe"]["w_up"].shape == (2, 4, 32, 16)
        assert "mlp" not in p["layers"]
        with pytest.raises(NotImplementedError,
                           match="precision='int8' quantizes dense FFN"):
            Engine(moe, p, ServeConfig(precision="int8"))
        return
    seamless = get_config("seamless-m4t-large-v2")
    with pytest.raises(NotImplementedError) as want:
        JEngine(j_get_config("seamless-m4t-large-v2"), {}, JServeConfig())
    with pytest.raises(NotImplementedError) as got:
        Engine(seamless, params, ServeConfig())
    assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Engine(seamless, params, ServeConfig(scheduler="static"))


def test_paged_decode_step_and_unregistered_config(lm):
    """``decode_step`` decodes a paged cache (a block table): the logits
    of JAX's decode over the same pages; a config the port has not
    registered is a KeyError naming the registered ones."""
    jcfg, jparams, cfg, params = lm
    toks = np.array([[4, 5, 6, 0], [7, 8, 9, 10]], np.int32)
    lens = [3, 4]
    cache = api.init_paged_cache(cfg, 2, 5, 4, 16, device="cpu")
    jcache = j_api.init_paged_cache(jcfg, 2, 5, 4, 16)
    _, fresh = T.prefill(params, torch.from_numpy(toks).long(), cfg, 16,
                         prompt_lens=lens)
    _, jfresh = j_api.prefill_fn(jcfg, 16)(
        jparams, {"tokens": jnp.asarray(toks),
                  "prompt_lens": jnp.asarray(lens, jnp.int32)})
    table = np.array([[2, 0, 0, 0], [4, 1, 0, 0]], np.int32)
    for i in range(2):
        api.paged_write_prompt(cfg, cache, fresh, [int(table[i, 0])], src=i)
        jcache = j_api.paged_write_prompt(jcfg, jcache, jfresh,
                                          [int(table[i, 0])], src=i)
    cache["block_table"].copy_(torch.from_numpy(table))
    cache["len"].copy_(torch.tensor(lens, dtype=torch.int32))
    jcache = dict(jcache, block_table=jnp.asarray(table),
                  len=jnp.asarray(lens, jnp.int32))
    tok = np.array([[11], [12]], np.int32)
    tl, tc = T.decode_step(params, torch.from_numpy(tok).long(), cache, cfg)
    jl, jc = j_api.decode_fn(jcfg)(jparams, jnp.asarray(tok), jcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-3,
                               atol=1e-4)
    assert tc["len"].tolist() == [4, 5]
    np.testing.assert_allclose(tc["k"].float().numpy(),
                               np.asarray(jc["k"], np.float32),
                               rtol=1e-2, atol=1e-2)
    with pytest.raises(KeyError, match="qwen2-0.5b"):
        get_config("jamba-v0.2-52b")


def test_invalid_serve_configs(lm):
    _, _, cfg, params = lm
    with pytest.raises(ValueError, match="precision"):
        Engine(cfg, params, ServeConfig(precision="int8-xla"))
    errs = check_serve_config(ServeConfig(max_batch=0, temperature=-1.0,
                                          max_retries=-1, prefill_bucket=64,
                                          max_len=32), cfg)
    assert len(errs) == 4, errs
    assert check_serve_config(ServeConfig(), cfg) == []


def test_slot_cache_write_and_free(lm):
    _, _, cfg, params = lm
    live = api.init_slot_cache(cfg, 3, 16, device="cpu")
    toks = torch.tensor([[4, 5, 6, 0]])
    _, fresh = T.prefill(params, toks, cfg, 16, prompt_lens=[3])
    live = api.cache_write_slot(cfg, live, fresh, 1)
    assert live["len"].tolist() == [0, 3, 0]
    assert torch.equal(live["k"][:, 1], fresh["k"][:, 0])
    assert not live["k"][:, 0].any()
    live = api.cache_free_slot(live, 1)
    assert live["len"].tolist() == [0, 0, 0]
    assert torch.equal(live["k"][:, 1], fresh["k"][:, 0])


def test_qwen2_config_matches_jax():
    jcfg, cfg = j_get_config("qwen2-0.5b"), get_config("qwen2-0.5b")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.head_dim == 64
