"""The port's sharded serving on the CPU: ``parallel.sharding``'s
``constrain``, ``named_sharding`` and collectives, the sequence-parallel
(SP) decode and the expert-parallel (EP) MoE, held against JAX's
8-device meshes and against the port's own unsharded path.

Two launches serve every test of the file, each made once and both at
the same time:

* one JAX subprocess with 8 host devices (``XLA_FLAGS``, as
  ``tests/test_sharded.py``), which computes, on a (2, 4) ("data",
  "model") mesh from the seeded numpy inputs written here: the SP decode
  step of granite-3-2b at ``tests/test_sharded.py``'s reduced size (its
  bf16 compute, a cache of 8 of 16 positions, so the new token lands on
  the third model rank and the fourth holds no valid position), the
  unsharded step, ``moe_ffn_sharded`` and ``moe_ffn_local`` on that
  test's ``MoEConfig(4, 2, 16, capacity_factor=8.0)`` (and on a call whose
  3 tokens a data shard do not split over 4 model ranks), and JAX's
  refusals of ``sp_axis`` with a paged and an int8 cache;
* one world of 8 gloo processes (``launch.world.run_world``, a
  ``FileStore`` under a temporary directory, no fixed port), each rank
  running the port's counterparts on its own block of the same inputs and
  weights (``weights.lm_params_from_numpy``), and the port's own unsharded
  path beside them: SP decode over 5 greedy steps in float32 (positions
  8-12: a shard's first and last position and the next shard's first), a
  moe-family decode inside the mesh (every layer's FFN on the EP path),
  hybrid and encdec SP decodes, ``constrain`` on a DTensor and on a plain
  tensor, and a Mamba prefill under the mesh (``causal_conv1d`` keeps the
  ``"cuda"`` route: JAX's ``"auto"`` takes XLA under a mesh and counts
  ``kernels.fallback.causal_conv1d.mesh``, the port does not).

Tolerances, each with its reason: port against JAX, SP logits 5e-2 and
MoE outputs 5e-4 (the bounds of ``tests/test_sharded.py``: bf16 compute
there, and the two frameworks sum in other orders); port sharded against
port unsharded in float32, 1e-5 (the SP combine rescales and sums the
shards' statistics in another order than one softmax; the EP experts run
on other block shapes); the Mamba prefill under a mesh, bitwise.

Run here with ``PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q
tests/test_torch_sharded.py`` (about 40 s).
"""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
if importlib.util.find_spec("jax") is None:          # the ranks import this
    pytest.skip("needs jax for the reference", allow_module_level=True)

from repro_torch.configs import MoEConfig, get_config  # noqa: E402
from repro_torch.models import api, moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.parallel import sharding as S  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = ((2, 4), ("data", "model"))
#: tests/test_sharded.py's SP case: granite-3-2b reduced, its own compute
SP_ARCH = "granite-3-2b"
SP_CFG = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
              vocab=128)
SP_BATCH, SP_LEN, SP_MAX, SP_STEPS = 2, 8, 16, 5
#: tests/test_sharded.py's MoE case, and a call of 3 tokens a data shard
MOE = dict(num_experts=4, top_k=2, d_ff=16, capacity_factor=8.0)
MOE_X, MOE_PAD_X = (4, 8, 8), (2, 3, 8)
#: the other families, reduce_cfg's sizes in float32; every moe capacity
#: factor E / top_k, so no pair drops and EP routes the pairs local does
FAMILIES = {
    "moe": ("granite-moe-1b-a400m", dict(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=256)),
    "hybrid": ("jamba-v0.1-52b", dict(
        n_layers=8, attn_period=8, attn_offset=4, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=256)),
    "encdec": ("seamless-m4t-large-v2", dict(
        n_layers=2, n_encoder_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=256)),
    "ssm": ("falcon-mamba-7b", dict(n_layers=2, d_model=32, vocab=64)),
}
FAM_BATCH, FAM_PROMPT, FAM_MAX, FAM_STEPS, ENC_LEN = 4, 6, 16, 3, 8
F32 = dict(atol=1e-5, rtol=1e-5)
TIMEOUT = 300

JAX_SCRIPT = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.configs.base import MoEConfig
from repro.launch.mesh import make_mesh
from repro.models import api
from repro.models.moe import moe_ffn_local, moe_ffn_sharded
from repro.models.transformer import decode_step
from repro.parallel.sharding import (make_rules, prune_batch_axes,
                                     tree_shardings, use_rules)
src, dst, meta = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
data = dict(np.load(src))

def tree(prefix):
    out = {}
    for key, v in data.items():
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            node = out
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(v)
    return out

cfg = dataclasses.replace(get_config(meta["arch"]), **meta["cfg"])
params = tree("p/")
cache = {"k": jnp.asarray(data["k"], jnp.bfloat16),
         "v": jnp.asarray(data["v"], jnp.bfloat16),
         "len": jnp.array(meta["len"], jnp.int32)}
tok = jnp.asarray(data["tok"])
out = {}
out["sp_ref"], _ = jax.jit(lambda p, t, c: decode_step(p, t, c, cfg))(
    params, tok, cache)
mesh = make_mesh(tuple(meta["mesh"][0]), tuple(meta["mesh"][1]))
rules = prune_batch_axes(mesh, make_rules(mesh, cfg, "decode", fsdp=False,
                                          sp=True), tok.shape[0])
with mesh, use_rules(rules):
    cache_sh = jax.device_put(cache, tree_shardings(api.cache_specs(cfg),
                                                    mesh))
    out["sp"], _ = jax.jit(lambda p, t, c: decode_step(
        p, t, c, cfg, sp_axis="model"))(params, tok, cache_sh)
moe = MoEConfig(**meta["moe"])
mp = tree("moe/")
for name in ("x", "xpad"):
    x = jnp.asarray(data["moe_" + name])
    out["moe_local_" + name] = moe_ffn_local(x, mp, moe, "silu",
                                             jnp.float32)
    with mesh:
        out["moe_sh_" + name] = jax.jit(lambda xx, pp: moe_ffn_sharded(
            xx, pp, moe, "silu", jnp.float32))(x, mp)
msgs = {}
b = tok.shape[0]
paged = dict(cache, block_table=jnp.zeros((b, 1), jnp.int32),
             len=jnp.zeros((b,), jnp.int32))
for name, c in (("paged", paged),
                ("int8", api.init_slot_cache(cfg, b, 16, kv="int8"))):
    try:
        decode_step(params, tok, c, cfg, sp_axis="model")
    except NotImplementedError as e:
        msgs[name] = str(e)
np.savez(dst, **{k: np.asarray(v, np.float32) for k, v in out.items()})
print("MSGS::" + json.dumps(msgs))
"""


def _cfg(arch, **kw):
    return dataclasses.replace(get_config(arch), **kw)


def _wide_moe(cfg):
    """``cfg`` with the capacity factor E / top_k: no pair drops."""
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _nest(flat, prefix):
    out = {}
    for key, v in flat.items():
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            node = out
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    return out


def _bf16(a):
    """``a`` rounded to bfloat16 values, kept as float32."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def make_inputs(path):
    """The seeded numpy inputs both launches read: granite-3-2b's reduced
    weights (JAX's ``init_params`` layout and scales, through the port's
    ``param_structs``), a prefilled-looking cache of ``SP_LEN`` positions
    (bf16 values), the next token, the MoE weights and inputs."""
    rng = np.random.default_rng(0)
    cfg = _cfg(SP_ARCH, **SP_CFG)

    def leaf(name, shape):
        if name.startswith("ln") or name.endswith("_norm"):
            return np.ones(shape, np.float32)
        std = 0.02 if name == "embed" else shape[-2] ** -0.5
        return (rng.standard_normal(shape) * std).astype(np.float32)
    structs = _flat(api.param_structs(cfg))
    data = {"p/" + k: leaf(k.split("/")[-1], tuple(v.shape))
            for k, v in structs.items()}
    kv = (cfg.n_layers, SP_BATCH, SP_MAX, cfg.n_kv_heads, cfg.head_dim)
    for name in ("k", "v"):
        a = np.zeros(kv, np.float32)
        a[:, :, :SP_LEN] = rng.standard_normal(a[:, :, :SP_LEN].shape)
        data[name] = _bf16(a)
    data["tok"] = rng.integers(0, cfg.vocab, (SP_BATCH, 1)).astype(np.int32)
    d, e, ff = MOE_X[-1], MOE["num_experts"], MOE["d_ff"]
    for name, shape, std in (("router", (d, e), d ** -0.5),
                             ("w_up", (e, d, ff), d ** -0.5),
                             ("w_gate", (e, d, ff), d ** -0.5),
                             ("w_down", (e, ff, d), ff ** -0.5)):
        data["moe/" + name] = (rng.standard_normal(shape) * std).astype(
            np.float32)
    data["moe_x"] = rng.standard_normal(MOE_X).astype(np.float32)
    data["moe_xpad"] = rng.standard_normal(MOE_PAD_X).astype(np.float32)
    np.savez(path, **data)


# ----------------------------------------------------------- the ranks --

def _mesh():
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(*MESH, device_type="cpu")


def _steps(fn, params, tok, cache, n):
    """``n`` greedy lockstep steps: the logits of each, stacked."""
    out = []
    for _ in range(n):
        logits, cache = fn(params, tok, cache)
        out.append(logits[:, -1])
        tok = logits[:, -1:].argmax(-1)
    return torch.stack(out, 1)


def _clone(tree):
    return {k: v.clone() for k, v in tree.items()}


def _sp_case(cfg, params, cache, tok, n, mesh, rules):
    """(unsharded logits of this rank's batch rows, sharded logits, this
    rank's cache bytes, the whole cache's) over ``n`` greedy steps."""
    ref = _steps(api.decode_fn(cfg), params, tok, _clone(cache), n)
    with S.use_mesh(mesh), S.use_rules(rules):
        local = _clone(S.shard_tree(cache, api.cache_specs(cfg)))
        rows = S.local_shard(torch.arange(tok.shape[0]),
                             S.named_sharding("batch"))
        got = _steps(api.decode_fn(cfg, sp_axis="model"), params, tok[rows],
                     local, n)
    nbytes = [sum(t.numel() * t.element_size() for k, t in c.items()
                  if k != "len") for c in (local, cache)]
    return ref[rows].numpy(), got.numpy(), nbytes[0], nbytes[1]


def _rank(rank, path):
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.obs import metrics
    from repro_torch.weights import lm_params_from_numpy
    mesh = _mesh()
    data = dict(np.load(path))
    out = {"data": mesh.get_local_rank("data"),
           "model": mesh.get_local_rank("model")}
    # SP decode, JAX's case: one step in the config's bf16 compute
    cfg = _cfg(SP_ARCH, **SP_CFG)
    params = lm_params_from_numpy(_nest(data, "p/"), device="cpu")
    cache = {"k": torch.from_numpy(data["k"]).to(torch.bfloat16),
             "v": torch.from_numpy(data["v"]).to(torch.bfloat16),
             "len": torch.tensor(SP_LEN, dtype=torch.int32)}
    tok = torch.from_numpy(data["tok"]).long()
    rules = S.spmd_rules(S.prune_batch_axes(mesh, S.make_rules(
        mesh, cfg, "decode", sp=True), SP_BATCH))
    out["sp"] = _sp_case(cfg, params, cache, tok, 1, mesh, rules)[1]
    # ... and in float32 over SP_STEPS steps against the unsharded path
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    c32 = {k: v.float() if k != "len" else v for k, v in cache.items()}
    out["sp32"] = _sp_case(cfg32, params, c32, tok, SP_STEPS, mesh, rules)
    # EP MoE on this rank's data block, against JAX and the local path
    moe = MoEConfig(**MOE)
    mp = {k: torch.from_numpy(v) for k, v in _nest(data, "moe/").items()}
    with S.use_mesh(mesh), S.use_rules(S.spmd_rules(S.ShardingRules(
            batch="data"))):
        # this rank's experts only, as shard_tree cuts the expert leaves
        mine = S.shard_tree(mp, M.moe_specs("silu", prefix_layers=False))
        out["experts_held"] = mine["w_up"].shape[0]
        for name in ("x", "xpad"):
            x = torch.from_numpy(data["moe_" + name])
            rows = S.local_shard(torch.arange(x.shape[0]),
                                 S.named_sharding("batch"))
            y = M.moe_ffn_sharded(x[rows], mp, moe, "silu", torch.float32)
            out["moe_" + name] = (
                y.numpy(),
                M.moe_ffn_local(x, mp, moe, "silu", torch.float32)[rows]
                .numpy(),
                torch.equal(y, M.moe_ffn_sharded(x[rows], mine, moe, "silu",
                                                 torch.float32)))
    out.update(_families(mesh))
    # constrain: a DTensor redistributed, a plain tensor passed through
    x = torch.arange(64.0).reshape(8, 8)
    with S.use_mesh(mesh), S.use_rules(S.ShardingRules(batch="data",
                                                       vocab="model")):
        y = S.constrain(distribute_tensor(x, mesh, [Replicate()] * 2),
                        "batch", "vocab")
        plain = torch.ones(3)
        out["constrain"] = dict(
            placements=[(type(p).__name__, getattr(p, "dim", None))
                        for p in y.placements],
            local=y.to_local().numpy(), full=y.full_tensor().numpy(),
            plain_same=S.constrain(plain, "batch") is plain,
            spec=S.named_sharding("batch", "vocab").spec)
    # the Mamba prefill under the mesh: the kernel's route, bitwise
    arch, kw = FAMILIES["ssm"]
    cfg = _cfg(arch, **kw, compute_dtype="float32")
    params = api.init_params(cfg, torch.Generator().manual_seed(4),
                             device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 12),
                         generator=torch.Generator().manual_seed(5))
    pre = api.prefill_fn(cfg, FAM_MAX)
    want, wc = pre(params, {"tokens": toks})
    names = ("kernels.dispatch.causal_conv1d.cuda",
             "kernels.fallback.causal_conv1d.mesh")
    before = [metrics.counter(n).value for n in names]
    with S.use_mesh(mesh):
        got, gc = pre(params, {"tokens": toks})
    out["ssm"] = dict(
        calls=[metrics.counter(n).value - b for n, b in zip(names, before)],
        logits=bool(torch.equal(got, want)),
        state=all(torch.equal(gc[k], wc[k]) for k in ("conv", "ssm")))
    return out


def _families(mesh) -> dict:
    """The moe-family decode inside the mesh (no SP: the cache sharded by
    batch; every layer's FFN on the EP path) and the hybrid and encdec SP
    decodes, each against the same steps outside the mesh, float32."""
    out = {}
    gen = torch.Generator().manual_seed(1)
    for fam in ("moe", "hybrid", "encdec"):
        arch, kw = FAMILIES[fam]
        cfg = _cfg(arch, **kw, compute_dtype="float32")
        if cfg.moe is not None:
            cfg = _wide_moe(cfg)
        params = api.init_params(cfg, torch.Generator().manual_seed(2),
                                 device="cpu")
        toks = torch.randint(0, cfg.vocab, (FAM_BATCH, FAM_PROMPT),
                             generator=gen)
        batch = {"tokens": toks}
        if fam == "encdec":
            batch["frames"] = torch.randn((FAM_BATCH, ENC_LEN, cfg.d_model),
                                          generator=gen)
        logits, cache = api.prefill_fn(cfg, FAM_MAX)(params, batch)
        tok = logits.argmax(-1)
        rules = S.spmd_rules(S.prune_batch_axes(mesh, S.make_rules(
            mesh, cfg, "decode", sp=fam != "moe"), FAM_BATCH))
        if fam == "moe":
            ref = _steps(api.decode_fn(cfg), params, tok, _clone(cache),
                         FAM_STEPS)
            with S.use_mesh(mesh), S.use_rules(rules):
                local = _clone(S.shard_tree(cache, api.cache_specs(cfg)))
                rows = S.local_shard(torch.arange(FAM_BATCH),
                                     S.named_sharding("batch"))
                got = _steps(api.decode_fn(cfg), params, tok[rows], local,
                             FAM_STEPS)
            out[fam] = (ref[rows].numpy(), got.numpy())
        else:
            out[fam] = _sp_case(cfg, params, cache, tok, FAM_STEPS, mesh,
                                rules)[:2]
    return out


# ------------------------------------------------------------- launches --

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's results, JAX's refusal messages, the world): the JAX
    subprocess and the gloo world run at once."""
    from repro_torch.launch.world import run_world
    tmp = tmp_path_factory.mktemp("sharded")
    src, dst = str(tmp / "inputs.npz"), str(tmp / "jax.npz")
    make_inputs(src)
    meta = dict(arch=SP_ARCH, cfg=SP_CFG, len=SP_LEN, moe=MOE,
                mesh=[list(MESH[0]), list(MESH[1])])
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, src, dst,
                             json.dumps(meta)], env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        world = run_world(_rank, 8, src, device_type="cpu", timeout=TIMEOUT)
        stdout, stderr = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-3000:]
    msgs = json.loads([line for line in stdout.splitlines()
                       if line.startswith("MSGS::")][-1][len("MSGS::"):])
    return dict(np.load(dst)), msgs, world


def _by_data(world, key, part=None):
    """``key`` (its item ``part``) of each rank, checked equal across the
    model ranks of a data shard, concatenated in data order."""
    out = {}
    for r in world.results:
        v = r[key] if part is None else r[key][part]
        if r["data"] in out:
            np.testing.assert_array_equal(v, out[r["data"]])
        out[r["data"]] = v
    return np.concatenate([out[i] for i in sorted(out)])


# ---------------------------------------------------------------- tests --

def test_world_is_eight_gloo_ranks_on_a_2x4_mesh(runs):
    world = runs[2]
    assert (world.backend, world.ranks) == ("gloo", 8)
    assert sorted((r["data"], r["model"]) for r in world.results) == [
        (i, j) for i in range(2) for j in range(4)]


def test_sp_decode_matches_jax(runs):
    """The SP step's logits against JAX's SP step on the same mesh and
    inputs, and against JAX's unsharded step."""
    want, _, world = runs
    got = _by_data(world, "sp")
    assert got.shape == want["sp"].shape == (SP_BATCH, 1, SP_CFG["vocab"])
    assert np.abs(got - want["sp"]).max() < 5e-2
    assert np.abs(got - want["sp_ref"]).max() < 5e-2


def test_sp_decode_matches_unsharded_over_shard_edges(runs):
    """Five greedy float32 steps from position 8: the writes land on the
    third model rank's first and last positions, then on the fourth's
    first; logits of every step against the port's unsharded decode."""
    world = runs[2]
    for r in world.results:
        ref, got, _, _ = r["sp32"]
        assert got.shape == ref.shape == (1, SP_STEPS, SP_CFG["vocab"])
        np.testing.assert_allclose(got, ref, **F32)


def test_sp_decode_holds_a_quarter_of_the_cache_a_rank(runs):
    """Each rank holds its data shard's rows and S / 4 positions: an
    eighth of the cache's bytes on the (2, 4) mesh."""
    for r in runs[2].results:
        _, _, mine, whole = r["sp32"]
        assert mine * 8 == whole


def test_moe_sharded_matches_jax(runs):
    want, _, world = runs
    for name in ("x", "xpad"):
        got = _by_data(world, "moe_" + name, part=0)
        assert got.shape == want["moe_sh_" + name].shape
        assert np.abs(got - want["moe_sh_" + name]).max() < 5e-4
        assert np.abs(got - want["moe_local_" + name]).max() < 5e-4


@pytest.mark.parametrize("name", ["x", "xpad"])
def test_moe_sharded_matches_local(runs, name):
    """EP against the local path on the same rows: 16 tokens a data shard
    over 4 model ranks, and 3 (padded to 4, one token a rank, three ranks
    routing only a zero pad row); the same bits whether a rank's expert
    leaves hold every expert or only its own (``shard_tree`` under the
    sharded step's rules: one of the 4 experts a rank)."""
    for r in runs[2].results:
        got, ref, own_only = r["moe_" + name]
        np.testing.assert_allclose(got, ref, **F32)
        assert own_only and r["experts_held"] == 1


@pytest.mark.parametrize("family", ["moe", "hybrid", "encdec"])
def test_family_decode_in_mesh_matches_unsharded(runs, family):
    """The moe family's decode inside the mesh (EP in every layer, the
    cache sharded by batch) and the hybrid (SP attention, EP MoE
    sublayers, batch-sharded Mamba state) and encdec (SP self- and
    cross-attention) decodes, three greedy steps against the same steps
    outside the mesh, float32: equal tokens, logits within 1e-5. The
    random reduced Jamba's Mamba sublayers amplify input differences
    about 1000-fold from step to step (its unsharded decode with each
    Mamba input moved by 1e-6 gives logits 3.6e-3 apart by the fifth
    step), so its EP's reordered sums (5e-7 a MoE call) are held to 1e-5
    on the first step only."""
    for r in runs[2].results:
        ref, got = r[family]
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
        n = 1 if family == "hybrid" else FAM_STEPS
        np.testing.assert_allclose(got[:, :n], ref[:, :n], **F32)


def test_sp_refusals_keep_jax_messages(runs):
    """``sp_axis`` with a paged cache and with an int8 cache raises JAX's
    ``NotImplementedError`` with JAX's message, outside a mesh too."""
    msgs = runs[1]
    cfg = _cfg(SP_ARCH, **SP_CFG)
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    tok = torch.zeros((2, 1), dtype=torch.long)
    paged = api.init_paged_cache(cfg, 2, 4, 4, 16, device="cpu")
    kv8 = api.init_slot_cache(cfg, 2, 16, kv="int8", device="cpu")
    kv8["len"] = torch.tensor(3, dtype=torch.int32)
    for name, cache in (("paged", paged), ("int8", kv8)):
        with pytest.raises(NotImplementedError) as e:
            api.decode_fn(cfg, sp_axis="model")(params, tok, cache)
        assert str(e.value) == msgs[name]


def test_constrain_inside_a_mesh(runs):
    """A DTensor is redistributed to the rules' placements (batch over
    "data", vocab over "model"), a plain tensor passes through as it is,
    ``named_sharding`` gives the rules' spec."""
    x = np.arange(64.0).reshape(8, 8)
    for r in runs[2].results:
        c = r["constrain"]
        assert c["placements"] == [("Shard", 0), ("Shard", 1)]
        i, j = r["data"], r["model"]
        np.testing.assert_array_equal(c["local"],
                                      x[4 * i:4 * i + 4, 2 * j:2 * j + 2])
        np.testing.assert_array_equal(c["full"], x)
        assert c["plain_same"] and c["spec"] == ("data", "model")


def test_causal_conv1d_keeps_its_route_under_a_mesh(runs):
    """A Mamba prefill inside the mesh runs ``causal_conv1d`` through the
    ``"cuda"`` entry point once a layer (its plain version on host
    tensors), counts no ``.mesh`` fallback, and gives the bits of the
    prefill outside the mesh (a deliberate difference from JAX, whose
    ``"auto"`` takes XLA under a mesh)."""
    n = FAMILIES["ssm"][1]["n_layers"]
    for r in runs[2].results:
        assert r["ssm"] == dict(calls=[n, 0], logits=True, state=True)


def test_constrain_and_named_sharding_outside_a_mesh():
    x = torch.ones(2, 3)
    assert S.current_mesh() is None
    assert S.constrain(x, "batch", None) is x
    assert S.named_sharding("batch", None) is None
    with S.use_rules(S.ShardingRules(batch="data")):
        assert S.constrain(x, "batch", "vocab") is x


def test_spmd_rules_keep_only_what_the_ranks_split():
    """A sharded step's rules keep batch, kv_seq and experts and hold
    every other dim whole (the port's layers compute them whole on each
    rank); the cache's specs under them shard only batch and kv_seq."""
    rules = S.ShardingRules(batch=("data",), kv_seq="model", heads="model",
                            ffn="model", vocab="model", experts="model",
                            d_inner="model", embed="data")
    got = S.spmd_rules(rules)
    assert got == S.ShardingRules(batch=("data",), kv_seq="model",
                                  heads=None, kv_heads=None, ffn=None,
                                  vocab=None, experts="model", d_inner=None)
    cfg = _cfg(SP_ARCH, **SP_CFG)
    assert got.spec(*T.cache_specs(cfg)["k"]) == (None, ("data",), "model",
                                                  None, None)


def test_sharded_paths_outside_a_mesh_are_the_local_paths():
    """Outside a mesh ``moe_ffn_sharded`` and ``moe_ffn`` are
    ``moe_ffn_local`` bitwise, and ``decode_step(sp_axis=...)`` is the
    unsharded step bitwise."""
    gen = torch.Generator().manual_seed(7)
    moe = MoEConfig(4, 2, 8, capacity_factor=1.0)
    p = {"router": torch.randn(8, 4, generator=gen),
         "w_up": torch.randn(4, 8, 8, generator=gen),
         "w_gate": torch.randn(4, 8, 8, generator=gen),
         "w_down": torch.randn(4, 8, 8, generator=gen)}
    x = torch.randn(3, 5, 8, generator=gen)
    want = M.moe_ffn_local(x, p, moe, "silu", torch.float32)
    assert torch.equal(M.moe_ffn_sharded(x, p, moe, "silu", torch.float32),
                       want)
    assert torch.equal(M.moe_ffn(x, p, moe, "silu", torch.float32), want)
    cfg = _cfg(SP_ARCH, **SP_CFG)
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 6), generator=gen)
    _, cache = api.prefill_fn(cfg, 16)(params, {"tokens": toks})
    tok = torch.zeros((2, 1), dtype=torch.long)
    a = _steps(api.decode_fn(cfg), params, tok, _clone(cache), 3)
    b = _steps(api.decode_fn(cfg, sp_axis="model"), params, tok,
               _clone(cache), 3)
    assert torch.equal(a, b)


def test_all_to_all_and_all_gather_match_jax_semantics():
    """The tiled collectives on the card's world (threads, here of 4 host
    ranks): JAX's
    ``all_to_all(split_axis=0, concat_axis=1)`` and ``all_gather(axis=0)``
    block orders, ``psum`` / ``pmax``, ``axis_index``."""
    from repro_torch.launch.world import _thread_world
    world = _thread_world(_collectives, 4, (), 60, "cpu")
    assert (world.backend, world.ranks) == ("threaded", 4)
    for r, (i, a2a, gath, s, m) in enumerate(world.results):
        assert i == r
        # rank r gets row r of every rank j's x, side by side in j order
        want = np.concatenate([np.arange(8.0).reshape(4, 2)[r:r + 1] + 10 * j
                               for j in range(4)], axis=1)
        np.testing.assert_array_equal(a2a, want)
        np.testing.assert_array_equal(gath, np.arange(4.0)[:, None])
        assert (s, m) == (6.0, 3.0)


def _collectives(rank):
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((4,), ("model",), device_type="cpu")
    with S.use_mesh(mesh):
        x = torch.arange(8.0).reshape(4, 2) + 10 * rank
        return (S.axis_index("model"),
                S.all_to_all(x, "model", 0, 1).numpy(),
                S.all_gather(torch.tensor([[float(rank)]]), "model").numpy(),
                S.psum(torch.tensor(float(rank)), "model").item(),
                S.pmax(torch.tensor(float(rank)), "model").item())
