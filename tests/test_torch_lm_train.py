"""The port's LM training path against the JAX package, on the host: the
loss and every gradient leaf of ``api.loss_fn`` for the six families,
the remat modes, the flash backward, the chunked cross-entropy, the MoE
dispatch's gradients and the train step (with microbatches, and the
in-place update against the functional one).

Both sides compute from the same seeded numpy weights and batches at
``tests/test_arch_smoke.py``'s ``reduce_cfg`` sizes, JAX's results
computed once per module. JAX's ``causal_conv1d`` runs its Pallas kernel
in interpret mode, as the JAX package's own tests run it; the port's runs
its plain version (the tensors are on the host).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.base import get_config as j_get_config  # noqa: E402
from repro.models import api as j_api  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.optim import OptConfig as JOptConfig  # noqa: E402
from repro.optim import init_opt_state as j_init_opt_state  # noqa: E402
from repro.train import TrainConfig as JTrainConfig  # noqa: E402
from repro.train import make_train_step as j_make_train_step  # noqa: E402

from repro_torch.configs import MambaConfig, MoEConfig, get_config  # noqa: E402
from repro_torch.models import api, blocks  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.optim import OptConfig, init_opt_state  # noqa: E402
from repro_torch.train import (TrainConfig, estimate_model_flops,  # noqa: E402
                               make_train_step, trainable, value_and_grad)
from repro_torch.tree import leaves  # noqa: E402
from repro_torch.weights import lm_params_from_numpy, tree_to_numpy  # noqa: E402

from test_arch_smoke import reduce_cfg  # noqa: E402
from test_torch_hybrid import numpy_params  # noqa: E402

FAMILIES = {"dense": "qwen2-0.5b", "vlm": "internvl2-1b",
            "moe": "granite-moe-1b-a400m", "ssm": "falcon-mamba-7b",
            "hybrid": "jamba-v0.1-52b", "encdec": "seamless-m4t-large-v2"}
B, S = 2, 16
#: float32 sums in another order than XLA's: the loss to 1e-5 relative,
#: each gradient leaf to 1e-4 of its largest JAX entry (plus 1e-6)
LOSS_RTOL, GRAD_REL, GRAD_ABS = 1e-5, 1e-4, 1e-6
#: bfloat16 compute rounds at other places in the two frameworks
BF16_LOSS_RTOL = 2e-2



@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The models here are tiny: one intra-op thread runs them faster than
    eight contending with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def port_cfg(jcfg):
    """The port's ModelConfig with every field of the JAX one."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    if jcfg.moe is not None:
        kw["moe"] = MoEConfig(**dataclasses.asdict(jcfg.moe))
    if jcfg.mamba is not None:
        kw["mamba"] = MambaConfig(**dataclasses.asdict(jcfg.mamba))
    return dataclasses.replace(get_config(jcfg.name), **kw)


def make_batch(cfg, seed: int, b: int = B, s: int = S) -> dict:
    """Seeded numpy batch of ``s`` training positions: tokens (b, s + 1),
    a vlm model's 4 patch embeddings (taking 4 of the positions) and an
    encdec model's (b, s, d) frames, float32 as the data pipeline makes
    them."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        p = cfg.frontend_positions
        return {"tokens": rng.integers(0, cfg.vocab, (b, s - p + 1))
                .astype(np.int32),
                "embeds": rng.standard_normal((b, p, cfg.d_model))
                .astype(np.float32)}
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s + 1))
             .astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((b, s, cfg.d_model)) \
            .astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def case(family: str, dtype: str = "float32"):
    return _case(family, dtype)


@functools.lru_cache(maxsize=None)
def _case(family: str, dtype: str):
    """(port config, numpy weights, numpy batch, JAX loss, JAX gradient
    leaves as numpy in flatten order), JAX's computed once."""
    jcfg = dataclasses.replace(reduce_cfg(j_get_config(FAMILIES[family])),
                               compute_dtype=dtype)
    weights = numpy_params(jcfg, 0)
    batch = make_batch(jcfg, 1)
    loss, grads = jax.jit(jax.value_and_grad(j_api.loss_fn(jcfg)))(
        jax.tree_util.tree_map(jnp.asarray, weights), _jax_batch(batch))
    return (port_cfg(jcfg), weights, batch, float(loss),
            [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)])


def port_value_and_grad(family, dtype="float32", **kw):
    cfg, weights, batch, _, _ = case(family, dtype)
    params = trainable(lm_params_from_numpy(weights, device="cpu"))
    return value_and_grad(api.loss_fn(cfg, **kw))(params,
                                                  _torch_batch(batch))


def assert_grads_close(got: list, want: list):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        tol = GRAD_REL * np.abs(w).max() + GRAD_ABS
        np.testing.assert_allclose(g.detach().float().numpy(), w, rtol=0,
                                   atol=tol)


@pytest.mark.parametrize("family", FAMILIES)
def test_loss_and_grads_match_jax(family):
    _, _, _, jloss, jgrads = case(family)
    loss, grads = port_value_and_grad(family)
    np.testing.assert_allclose(float(loss), jloss, rtol=LOSS_RTOL)
    assert_grads_close(leaves(grads), jgrads)


def test_bf16_dense_loss_matches_jax():
    _, _, _, jloss, _ = case("dense", "bfloat16")
    loss, grads = port_value_and_grad("dense", "bfloat16")
    np.testing.assert_allclose(float(loss), jloss, rtol=BF16_LOSS_RTOL)
    assert all(torch.isfinite(g).all() for g in leaves(grads))


@pytest.mark.parametrize("family", FAMILIES)
def test_remat_modes_agree_bitwise(family):
    """Recomputing a layer in the backward, or keeping its matmuls, gives
    the bits of keeping every residual."""
    outs = {mode: port_value_and_grad(family, remat=mode)
            for mode in ("full", "dots", "none")}
    loss0, grads0 = outs["none"]
    for mode in ("full", "dots"):
        loss, grads = outs[mode]
        assert torch.equal(loss, loss0), mode
        for g, g0 in zip(leaves(grads), leaves(grads0)):
            assert torch.equal(g, g0), mode


def test_unknown_remat_mode_raises():
    with pytest.raises(ValueError, match="remat"):
        port_value_and_grad("dense", remat="ful")


def test_flash_loss_and_grads_track_full():
    """attn_impl="flash" (the blockwise forward and the flash backward)
    against "full" on the dense family: the same function, summed in
    another order."""
    loss_f, grads_f = port_value_and_grad("dense", attn_impl="full")
    loss, grads = port_value_and_grad("dense", attn_impl="flash")
    np.testing.assert_allclose(float(loss), float(loss_f), rtol=LOSS_RTOL)
    assert_grads_close(leaves(grads), [g.numpy() for g in leaves(grads_f)])


FLASH_CASES = [  # (causal, Hq, Hkv, Sq, Sk, block_k, q_offset)
    (True, 4, 2, 16, 16, 8, 0),        # GQA, two KV blocks
    (False, 4, 4, 12, 12, 5, 0),       # no mask, ragged block_k -> 4
    (True, 6, 2, 7, 10, 4, 3),         # queries at an offset, block_k -> 2
    (False, 2, 1, 9, 15, 256, 0),      # one KV head, one block of 15
]


@pytest.mark.parametrize("causal,hq,hkv,sq,sk,bk,off", FLASH_CASES)
def test_flash_backward_matches_jax_vjp(causal, hq, hkv, sq, sk, bk, off):
    """dq, dk and dv of the port's flash backward against ``jax.vjp``
    through JAX's custom VJP, float32; and the forward under autograd
    bitwise the forward outside it (the serve path's)."""
    rng = np.random.default_rng(sq * 100 + sk)
    d = 8
    q = rng.standard_normal((2, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((2, sk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((2, sk, hkv, d)).astype(np.float32)
    do = rng.standard_normal((2, sq, hq, d)).astype(np.float32)
    jout, jgrads = jax.jit(lambda a, b, c, g: (lambda o, f: (o, f(g)))(
        *jax.vjp(lambda a, b, c: JA.flash_attention(
            a, b, c, causal=causal, block_k=bk, q_offset=off), a, b, c)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = A.flash_attention(tq, tk, tv, causal=causal, block_k=bk,
                            q_offset=off)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
    for g, w in zip(got, jgrads):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max() + 1e-7)
    with torch.no_grad():
        plain = A.flash_attention(tq, tk, tv, causal=causal, block_k=bk,
                                  q_offset=off)
    assert torch.equal(out.detach(), plain)


@pytest.mark.parametrize("s,chunk", [(10, 4), (8, 512)])
def test_chunked_ce_and_grads_match_jax(s, chunk):
    """chunked_softmax_ce with a padded tail (S not a multiple of the
    chunk) and ignored labels, and its gradients in h and w, against
    JAX's; cross_entropy too."""
    rng = np.random.default_rng(s)
    h = rng.standard_normal((2, s, 16)).astype(np.float32)
    w = (rng.standard_normal((16, 40)) * 0.3).astype(np.float32)
    lab = rng.integers(0, 40, (2, s)).astype(np.int32)
    lab[0, 1] = lab[1, -1] = -1
    jl, jg = jax.jit(jax.value_and_grad(
        lambda a, b: JB.chunked_softmax_ce(a, b, jnp.asarray(lab),
                                           chunk=chunk), argnums=(0, 1)))(
        jnp.asarray(h), jnp.asarray(w))
    th, tw = (torch.from_numpy(a).requires_grad_() for a in (h, w))
    loss = blocks.chunked_softmax_ce(th, tw, torch.from_numpy(lab),
                                     chunk=chunk)
    got = torch.autograd.grad(loss, (th, tw))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    for g, want in zip(got, jg):
        want = np.asarray(want)
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max() + 1e-8)
    logits = h @ w
    jce = JB.cross_entropy(jnp.asarray(logits), jnp.asarray(lab))
    ce = blocks.cross_entropy(torch.from_numpy(logits), torch.from_numpy(lab))
    np.testing.assert_allclose(float(ce), float(jce), rtol=1e-6)


def test_moe_grads_with_drops_match_jax():
    """moe_ffn_local's output and its gradients in x and every expert
    leaf against jax.grad, at a capacity factor that drops pairs: the
    dispatch's index write (its drop row included) and the sort-based
    top-k differentiate as JAX's scatter-add and lax.top_k do."""
    jcfg = reduce_cfg(j_get_config(FAMILIES["moe"]))
    moe = dataclasses.replace(jcfg.moe, capacity_factor=0.5)
    rng = np.random.default_rng(7)
    d, e, ff = jcfg.d_model, moe.num_experts, moe.d_ff
    p = {"router": rng.standard_normal((d, e)) * d ** -0.5,
         "w_gate": rng.standard_normal((e, d, ff)) * d ** -0.5,
         "w_up": rng.standard_normal((e, d, ff)) * d ** -0.5,
         "w_down": rng.standard_normal((e, ff, d)) * ff ** -0.5}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 8, d)).astype(np.float32)
    ct = rng.standard_normal((2, 8, d)).astype(np.float32)

    def jloss(xx, pp):
        y = JM.moe_ffn_local(xx, pp, moe, jcfg.act, jnp.float32)
        return jnp.sum(y * ct), y
    (_, jy), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True))(
        jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, p))
    tx = torch.from_numpy(x).requires_grad_()
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    pmoe = MoEConfig(**dataclasses.asdict(moe))
    y = M.moe_ffn_local(tx, tp, pmoe, jcfg.act, torch.float32)
    n = x.shape[0] * x.shape[1]
    assert n * moe.top_k > e * M._capacity(n, pmoe)      # pairs dropped
    got = torch.autograd.grad(torch.sum(y * torch.from_numpy(ct)),
                              [tx] + [tp[k] for k in sorted(tp)])
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-6)
    want = [jg[0]] + [jg[1][k] for k in sorted(tp)]
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_REL * np.abs(w).max() + GRAD_ABS)


OPT = dict(lr=1e-2, warmup_steps=2, total_steps=10)


@functools.lru_cache(maxsize=None)
def jax_step(mb: int):
    """JAX's train step on the dense family at batch 4: (params, m, v,
    step, loss, lr, grad_norm) as numpy."""
    cfg, weights, _, _, _ = case("dense")
    jcfg = dataclasses.replace(reduce_cfg(j_get_config(FAMILIES["dense"])),
                               compute_dtype="float32")
    params = jax.tree_util.tree_map(jnp.asarray, weights)
    opt = JOptConfig(**OPT)
    step = jax.jit(j_make_train_step(jcfg, JTrainConfig(opt=opt,
                                                        microbatches=mb)))
    p, st, m = step(params, j_init_opt_state(params, opt),
                    _jax_batch(make_batch(cfg, 2, b=4)))
    return jax.tree_util.tree_map(np.asarray, (p, st, m))


def _port_step(mb: int):
    """The port's (in-place) train step on JAX's inputs of :func:`jax_step`."""
    cfg, weights, _, _, _ = case("dense")
    params = trainable(lm_params_from_numpy(weights, device="cpu"))
    opt = OptConfig(**OPT)
    step = make_train_step(cfg, TrainConfig(opt=opt, microbatches=mb))
    st = init_opt_state(params, opt)
    p, st, m = step(params, st, _torch_batch(make_batch(cfg, 2, b=4)))
    return p, st, m


def _adam_direction(m, v, opt):
    """m-hat / (sqrt(v-hat) + eps) of a first AdamW step, per element."""
    m, v = m.astype(np.float64), v.astype(np.float64)
    return (m / (1 - opt.b1)) / (np.sqrt(v / (1 - opt.b2)) + opt.eps)


@pytest.mark.parametrize("mb", [1, 2])
def test_train_step_matches_jax(mb):
    """One step's loss, lr, grad norm, moments and params against JAX's.
    The moments take the gradients' tolerance. A first AdamW step moves a
    parameter by lr * g / (|g| + eps) (plus decay), which turns the
    gradients' last bits into large moves where |g| is near eps, so each
    parameter is held to 1e-6 plus lr times the difference of the two
    sides' own directions."""
    jp, jst, jm = jax_step(mb)
    p, st, m = _port_step(mb)
    np.testing.assert_allclose(float(m["loss"]), jm["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), jm["grad_norm"],
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["lr"]), jm["lr"], rtol=1e-7)
    assert int(st["step"]) == int(jst["step"]) == 1
    assert_grads_close(leaves(st["m"]), jax.tree_util.tree_leaves(jst["m"]))
    opt = OptConfig(**OPT)
    for got, want, tm, tv, wm, wv in zip(
            leaves(tree_to_numpy(p)), jax.tree_util.tree_leaves(jp),
            leaves(tree_to_numpy(st["m"])), leaves(tree_to_numpy(st["v"])),
            jax.tree_util.tree_leaves(jst["m"]),
            jax.tree_util.tree_leaves(jst["v"])):
        moved = np.abs(_adam_direction(tm, tv, opt)
                       - _adam_direction(wm, wv, opt))
        assert np.all(np.abs(got - want) <= 1e-6 + float(jm["lr"]) * moved)


@pytest.mark.parametrize("slice_elems", [None, 100])
def test_in_place_update_equals_functional_bitwise(slice_elems, monkeypatch):
    """Two AdamW steps of apply_updates_ (whole leaves, or slices of 100
    elements) against apply_updates on the same gradients: params, moments,
    step, lr and grad norm bitwise; the in-place form writes into the
    tensors it was given."""
    from repro_torch.optim import apply_updates, apply_updates_, optimizer
    if slice_elems:
        monkeypatch.setattr(optimizer, "SLICE_ELEMS", slice_elems)
    _, weights, _, _, _ = case("dense")
    opt = OptConfig(**OPT)
    p_f = lm_params_from_numpy(weights, device="cpu")
    p_i = lm_params_from_numpy(weights, device="cpu")
    st_f, st_i = init_opt_state(p_f, opt), init_opt_state(p_i, opt)
    ptrs = [t.data_ptr() for t in leaves((p_i, st_i))]
    _, grads = port_value_and_grad("dense")
    for _ in range(2):
        with torch.no_grad():
            p_f, st_f, m_f = apply_updates(p_f, grads, st_f, opt)
        out, st_out, m_i = apply_updates_(p_i, grads, st_i, opt)
        assert out is p_i and st_out is st_i
        for a, b in zip(leaves((p_f, st_f, m_f)), leaves((p_i, st_i, m_i))):
            assert torch.equal(a, b)
    assert [t.data_ptr() for t in leaves((p_i, st_i))] == ptrs
    assert int(st_i["step"]) == 2


def test_train_step_updates_in_place():
    """make_train_step writes params, m, v and step into the tensors it
    was given and returns them."""
    cfg, weights, _, _, _ = case("dense")
    params = trainable(lm_params_from_numpy(weights, device="cpu"))
    opt = OptConfig(**OPT)
    st = init_opt_state(params, opt)
    ptrs = [t.data_ptr() for t in leaves((params, st))]
    before = [t.detach().clone() for t in leaves(params)]
    p, st2, _ = make_train_step(cfg, TrainConfig(opt=opt))(
        params, st, _torch_batch(make_batch(cfg, 2, b=4)))
    assert p is params and st2 is st
    assert [t.data_ptr() for t in leaves((p, st2))] == ptrs
    assert int(st["step"]) == 1
    assert all(not torch.equal(a, b) for a, b in zip(leaves(p), before))


def test_weights_round_trip_and_flops():
    """lm_params_from_numpy's leaves made trainable and tree_to_numpy's way
    back; estimate_model_flops as JAX's."""
    from repro.train import estimate_model_flops as j_flops
    cfg, weights, _, _, _ = case("moe")
    params = lm_params_from_numpy(weights, device="cpu")
    assert not any(t.requires_grad for t in leaves(params))
    assert trainable(params) is params
    assert all(t.requires_grad for t in leaves(params))
    back = tree_to_numpy(params)
    for a, b in zip(leaves(back), jax.tree_util.tree_leaves(weights)):
        assert np.array_equal(a, b)
    jcfg = reduce_cfg(j_get_config(FAMILIES["moe"]))
    assert estimate_model_flops(cfg, 4096) == j_flops(jcfg, 4096)
    assert estimate_model_flops(cfg, 64, "serve") == j_flops(jcfg, 64,
                                                              "serve")
