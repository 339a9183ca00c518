"""The port's CNN training flow against the JAX package: ``apply_block``
with batch statistics, ``cnn_loss`` and its gradients, AdamW
(``repro_torch.optim``), the synthetic data pipeline
(``repro_torch.data``), the checkpointer (``repro_torch.checkpoint``,
checkpoints crossing between the packages) and train -> PTQ, on the same
numpy inputs. On the host."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.core.primitives import ConvSpec as JConvSpec  # noqa: E402
from repro.core.primitives import apply_block as j_apply_block  # noqa: E402
from repro.core.primitives import init_block as j_init_block  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import IndexedDataset as JIndexedDataset  # noqa: E402
from repro.models.convnet import CNNConfig as JCNNConfig  # noqa: E402
from repro.models.convnet import cnn_loss as j_cnn_loss  # noqa: E402
from repro.models.convnet import init_cnn as j_init_cnn  # noqa: E402
from repro.models.convnet import quantize_cnn as j_quantize_cnn  # noqa: E402
from repro import optim as joptim  # noqa: E402

from repro_torch import optim  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.core import ConvSpec, apply_block  # noqa: E402
from repro_torch.data import DataConfig, IndexedDataset, PrefetchLoader  # noqa: E402
from repro_torch.graph import CompiledPlan  # noqa: E402
from repro_torch.models import (CNNConfig, calibrate_bn, cnn_value_and_grad,  # noqa: E402
                                init_cnn, quantize_cnn)
from repro_torch.tree import leaves, tree_map  # noqa: E402
from repro_torch.weights import params_from_numpy, plan_from_numpy  # noqa: E402

from test_torch_graph import _jax_trunk, plan_to_numpy  # noqa: E402

PRIMS = ("standard", "grouped", "dws", "shift", "add")
#: float32 sums taken in another order than XLA's
RTOL, ATOL = 1e-4, 1e-5


def _np_tree(jtree):
    return jax.tree_util.tree_map(np.asarray, jtree)


def _port(jtree):
    return params_from_numpy(_np_tree(jtree), device="cpu")


def _assert_tree_close(got, want, rtol=RTOL, atol=ATOL):
    """Port tree against JAX tree, leaf by leaf in flatten order; JAX's
    float0 gradients of integer leaves against the port's integer zeros."""
    jl = jax.tree_util.tree_leaves(want)
    tl = leaves(got)
    assert len(jl) == len(tl)
    for t, j in zip(tl, jl):
        if j.dtype == jax.dtypes.float0:
            assert not t.is_floating_point() and not t.any()
            continue
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j, np.float32),
                                   rtol=rtol, atol=atol)


def _image_batch(n=4, size=16, seed=0):
    rng = np.random.default_rng(seed)
    return {"images": rng.standard_normal((n, size, size, 3))
            .astype(np.float32),
            "labels": rng.integers(0, 10, n).astype(np.int32)}


def _t(batch):
    """A numpy batch as tensors, float64 images in float32 (as
    ``jnp.asarray`` puts them with x64 off)."""
    return {k: torch.from_numpy(v.astype(np.float32) if v.dtype == np.float64
                                else v) for k, v in batch.items()}


# --------------------------------------------------------------- training --

@pytest.mark.parametrize("prim", PRIMS)
def test_apply_block_train_stats_matches_jax(prim):
    """A conv + BN + relu block with batch statistics: the output and the
    (biased) mean / var written into train_stats."""
    cin = 8
    groups = 2 if prim == "grouped" else 1
    jspec = JConvSpec(prim, cin, 12, 3, groups=groups)
    spec = ConvSpec(prim, cin, 12, 3, groups=groups)
    jp = j_init_block(jax.random.PRNGKey(3), jspec)
    x = np.random.default_rng(1).standard_normal((4, 10, 10, cin)) \
        .astype(np.float32)
    jstats, stats = {}, {}
    want = j_apply_block(jp, jnp.asarray(x), jspec, train_stats=jstats)
    got = apply_block(_port(jp), torch.from_numpy(x), spec,
                      train_stats=stats)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    for k in ("mean", "var"):
        np.testing.assert_allclose(stats[k].numpy(), np.asarray(jstats[k]),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("prim", PRIMS)
def test_cnn_loss_and_grads_match_jax(prim):
    """cnn_loss and its gradient over every leaf at widths (8, 12), 16x16,
    batch 4, against jax.value_and_grad(allow_int=True)."""
    jcfg = JCNNConfig(primitive=prim, widths=(8, 12), image_size=16)
    cfg = CNNConfig(primitive=prim, widths=(8, 12), image_size=16)
    jp = j_init_cnn(jcfg, jax.random.PRNGKey(0))
    batch = _image_batch()
    (jl, ja), jg = jax.value_and_grad(
        lambda p: j_cnn_loss(p, jax.tree_util.tree_map(jnp.asarray, batch),
                             jcfg), has_aux=True, allow_int=True)(jp)
    (loss, acc), grads = cnn_value_and_grad(_port(jp), _t(batch), cfg)
    np.testing.assert_allclose(float(loss), float(jl), rtol=RTOL, atol=ATOL)
    assert float(acc) == float(ja)
    _assert_tree_close(grads, jg)
    if prim == "shift":            # the tables take no gradient
        tables = [b["conv"]["shifts"] for b in grads["blocks"][1:]]
        assert all(t.dtype == torch.int32 for t in tables)


def test_schedule_matches_jax():
    cfg = optim.OptConfig(lr=2e-3, warmup_steps=20, total_steps=100)
    jcfg = joptim.OptConfig(lr=2e-3, warmup_steps=20, total_steps=100)
    for step in (0, 1, 7, 19, 20, 21, 55, 99, 100, 150):
        got = optim.schedule(cfg, torch.tensor(step, dtype=torch.int32))
        want = joptim.schedule(jcfg, jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _grad_tree(seed=0):
    """A CNN-shaped tree of float gradients and an int32 shift table."""
    jp = j_init_cnn(JCNNConfig(primitive="shift", widths=(8, 12)),
                    jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda v: (rng.standard_normal(v.shape) * 0.3).astype(np.float32)
        if np.issubdtype(v.dtype, np.floating) else np.asarray(v), jp)


@pytest.mark.parametrize("max_norm", [0.1, 1e3])
def test_global_norm_and_clipping_match_jax(max_norm):
    g = _grad_tree()
    want_n = joptim.global_norm(g)
    got_n = optim.global_norm(params_from_numpy(g, device="cpu"))
    np.testing.assert_allclose(float(got_n), float(want_n), rtol=1e-6)
    want, wn = joptim.clip_by_global_norm(g, max_norm)
    got, gn = optim.clip_by_global_norm(params_from_numpy(g, device="cpu"),
                                        max_norm)
    np.testing.assert_allclose(float(gn), float(wn), rtol=1e-6)
    _assert_tree_close(got, jax.tree_util.tree_map(np.asarray, want),
                       rtol=1e-6, atol=0)


@pytest.mark.parametrize("state_dtype", [None, "bfloat16"])
def test_apply_updates_one_step_matches_jax(state_dtype):
    """Three AdamW steps from zero moments (clipping on): parameters,
    moments, step, lr and grad norm; the int32 shift table and its
    moments untouched."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
              grad_clip=1.0, state_dtype=state_dtype)
    cfg, jcfg = optim.OptConfig(**kw), joptim.OptConfig(**kw)
    jp = j_init_cnn(JCNNConfig(primitive="shift", widths=(8, 12)),
                    jax.random.PRNGKey(1))
    p = _port(jp)
    jst, st = joptim.init_opt_state(jp, jcfg), optim.init_opt_state(p, cfg)
    for i in range(3):
        g = _grad_tree(seed=10 + i)
        jp, jst, jm = joptim.apply_updates(jp, g, jst, jcfg)
        p, st, m = optim.apply_updates(p, params_from_numpy(g, device="cpu"),
                                       st, cfg)
    tol = dict(rtol=1e-6, atol=1e-7) if state_dtype is None else \
        dict(rtol=1e-2, atol=1e-6)   # bf16 moments: one rounding apart
    _assert_tree_close(p, jp, **tol)
    _assert_tree_close(st["m"], jst["m"], **tol)
    _assert_tree_close(st["v"], jst["v"], **tol)
    assert int(st["step"]) == int(jst["step"]) == 3
    for k in ("lr", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-6)
    table = p["blocks"][1]["conv"]["shifts"]
    assert table.dtype == torch.int32
    np.testing.assert_array_equal(table.numpy(),
                                  np.asarray(jp["blocks"][1]["conv"]
                                             ["shifts"]))
    if state_dtype:
        assert st["m"]["head"].dtype == torch.bfloat16


# ------------------------------------------------------------------- data --

@pytest.mark.parametrize("kind", ["lm", "vlm", "encdec", "image"])
def test_indexed_dataset_bitwise(kind):
    kw = dict(kind=kind, vocab=97, seq_len=12, global_batch=4, seed=5,
              image_size=8, d_model=6, frontend_positions=3)
    for host in ((0, 1), (1, 2)):
        ds = IndexedDataset(DataConfig(**kw), *host)
        jds = JIndexedDataset(JDataConfig(**kw), *host)
        for step in (0, 7, 12345):
            got, want = ds.batch(step), jds.batch(step)
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


def test_prefetch_loader_puts_batches_in_order():
    ds = IndexedDataset(DataConfig(kind="image", global_batch=2,
                                   image_size=8))
    loader = PrefetchLoader(ds, start_step=3, device="cpu")
    for step in (3, 4, 5):
        b = next(loader)
        assert b["images"].dtype == torch.float32
        assert b["labels"].dtype == torch.int32
        want = ds.batch(step)
        np.testing.assert_array_equal(b["images"].numpy(),
                                      want["images"].astype(np.float32))
        np.testing.assert_array_equal(b["labels"].numpy(), want["labels"])
    assert loader.step == 6


# ------------------------------------------------------------- checkpoint --

def _state_tree():
    rng = np.random.default_rng(0)
    return {"params": {"blocks": [{"w": torch.from_numpy(
        rng.standard_normal((3, 3, 2, 4)).astype(np.float32))},
        {"shifts": torch.tensor([[0, 1], [-1, 0]], dtype=torch.int32)}],
        "h": torch.from_numpy(rng.standard_normal(5).astype(np.float32))
        .to(torch.bfloat16)},
        "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def _assert_same(a, b):
    for x, y in zip(leaves(a), leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoint_round_trip(tmp_path, async_save):
    tree = _state_tree()
    ck = Checkpointer(str(tmp_path), async_save=async_save)
    ck.save(5, tree)
    ck.wait()
    assert ck.latest_step() == 5
    assert sorted(os.listdir(tmp_path / "step_000000005")) == \
        ["_COMMITTED", "manifest.json", "shard_0.npz"]
    like = tree_map(torch.zeros_like, tree)
    got, step = ck.restore(like)
    assert step == 5
    _assert_same(got, tree)


def test_checkpoint_keeps_n_and_ignores_uncommitted(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, async_save=False)
    tree = _state_tree()
    for s in (1, 2, 3):
        ck.save(s, tree)
    assert ck.all_steps() == [2, 3]
    # a save cut before its marker (or still under .tmp) is never read
    os.makedirs(tmp_path / "step_000000009")
    os.makedirs(tmp_path / "step_000000010.tmp")
    assert ck.latest_step() == 3
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(tree)


def test_checkpoint_restore_casts_dtype(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    tree = _state_tree()
    ck.save(1, tree)
    like = tree_map(lambda t: t.to(torch.float32)
                    if t.is_floating_point() else t, tree)
    got, _ = ck.restore(like)
    assert got["params"]["h"].dtype == torch.float32
    assert torch.equal(got["params"]["h"], tree["params"]["h"].float())


def test_jax_checkpoint_restores_in_port_and_back(tmp_path):
    """Same layout and keys: a JAX checkpoint of a CNN and its optimizer
    state restores in the port bitwise, and the port's restores in JAX."""
    jcfg = JCNNConfig(primitive="shift", widths=(8, 12))
    jp = j_init_cnn(jcfg, jax.random.PRNGKey(0))
    jtree = {"params": jp, "opt": joptim.init_opt_state(
        jp, joptim.OptConfig(state_dtype="bfloat16"))}
    JCheckpointer(str(tmp_path / "jax"), async_save=False).save(4, jtree)
    like = tree_map(lambda j: torch.zeros(
        j.shape, dtype=getattr(torch, str(j.dtype))),
        jax.tree_util.tree_map(np.asarray, jtree))
    got, step = Checkpointer(str(tmp_path / "jax")).restore(like)
    assert step == 4
    for t, j in zip(leaves(got), jax.tree_util.tree_leaves(jtree)):
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j, np.float32))
    Checkpointer(str(tmp_path / "port"), async_save=False).save(6, got)
    back, step = JCheckpointer(str(tmp_path / "port")).restore(jtree)
    assert step == 6
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jtree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


# -------------------------------------------------- train -> resume -> PTQ --

def _train(cfg, ds, opt, steps, params=None, state=None, start=0,
           ckpt=None, save_at=None):
    if params is None:
        params = init_cnn(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
        state = optim.init_opt_state(params, opt)
    losses = []
    for i in range(start, steps):
        (loss, _), grads = cnn_value_and_grad(params, _t(ds.batch(i)), cfg)
        params, state, _ = optim.apply_updates(params, grads, state, opt)
        losses.append(float(loss))
        if ckpt is not None and i + 1 == save_at:
            ckpt.save(i + 1, {"params": params, "opt": state})
    return params, state, losses


@pytest.mark.parametrize("prim", ["standard", "shift"])
def test_cnn_trains(prim):
    """40 AdamW steps on the synthetic images lower the loss, as the JAX
    package's test_convnet requires of it."""
    cfg = CNNConfig(primitive=prim, widths=(8, 16), image_size=16)
    ds = IndexedDataset(DataConfig(kind="image", global_batch=32,
                                   image_size=16, seed=3))
    opt = optim.OptConfig(lr=3e-3, warmup_steps=2, total_steps=40,
                          weight_decay=0.0)
    _, _, losses = _train(cfg, ds, opt, 40)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses[-5:]


def test_resume_from_checkpoint_reproduces_losses(tmp_path):
    """Kill after step 3, restore into fresh state, finish: the same
    losses as the uninterrupted run (bitwise on the host)."""
    cfg = CNNConfig(primitive="dws", widths=(8, 12), image_size=16)
    ds = IndexedDataset(DataConfig(kind="image", global_batch=8,
                                   image_size=16, seed=7))
    opt = optim.OptConfig(lr=2e-3, warmup_steps=2, total_steps=6)
    ck = Checkpointer(str(tmp_path))
    _, _, full = _train(cfg, ds, opt, 6, ckpt=ck, save_at=3)
    ck.wait()
    fresh = init_cnn(cfg, torch.Generator().manual_seed(1), device="cpu")
    tree, start = ck.restore({"params": fresh,
                              "opt": optim.init_opt_state(fresh, opt)})
    assert start == 3
    _, _, resumed = _train(cfg, ds, opt, 6, tree["params"], tree["opt"],
                           start=start)
    assert resumed == full[3:]


@pytest.mark.parametrize("prim", PRIMS)
def test_ptq_of_port_trained_params_matches_jax(prim):
    """Train a few steps in the port, re-estimate BN, carry the params into
    JAX as numpy: JAX's quantize_cnn(method="xla") plan run by the port
    gives JAX's trunk bit for bit, and the port's own quantize_cnn lowers
    the same scales."""
    cfg = CNNConfig(primitive=prim, widths=(8, 12), image_size=16)
    jcfg = JCNNConfig(primitive=prim, widths=(8, 12), image_size=16)
    ds = IndexedDataset(DataConfig(kind="image", global_batch=8,
                                   image_size=16, seed=7))
    opt = optim.OptConfig(lr=2e-3, warmup_steps=2, total_steps=5)
    params, _, _ = _train(cfg, ds, opt, 5)
    calib = ds.batch(20_000)["images"].astype(np.float32)
    x = ds.batch(10_000)["images"].astype(np.float32)
    params = calibrate_bn(params, cfg, torch.from_numpy(calib))
    nparams = tree_map(lambda t: t.numpy(), params)
    jplan = j_quantize_cnn(jax.tree_util.tree_map(jnp.asarray, nparams),
                           jcfg, calib, method="xla").plan
    ported = plan_from_numpy(plan_to_numpy(jplan), jplan.in_fb,
                             device="cpu")
    got = CompiledPlan(ported, method="torch", device="cpu").trunk(x)
    want = _jax_trunk(jplan, x)
    assert got.frac_bits == want.frac_bits
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    own = quantize_cnn(params, cfg, calib, method="torch", device="cpu")
    assert own.plan.in_fb == jplan.in_fb
    assert [(n.name, n.in_fb, n.out_fb) for n in own.plan.nodes] == \
        [(n.name, n.in_fb, n.out_fb) for n in jplan.nodes]
