"""The port's sharded training on the CPU: the differentiable collectives,
the FSDP + TP train step, ``allreduce_compressed``, sharded checkpoints
with elastic restore and the sharded ``Trainer``, held against JAX's
meshes and against the port's own single-device step.

Three launches serve the file, the first two at the same time:

* two JAX subprocesses with 8 host devices (``XLA_FLAGS``, as
  ``tests/test_sharded.py``), which compute from the seeded numpy inputs
  written here ``tests/test_sharded.py``'s train-step case (granite-3-2b
  at its reduced size, its bf16 compute, one step on one device and on a
  (2, 2, 2) ("pod", "data", "model") mesh with FSDP and pruned batch
  axes; the compiled sharded step's collective bytes by
  ``analyze_hlo``), one step of the reduced seamless and (in the second
  process, whose compile is the longest) jamba cases of ``JAX_CASES`` on
  that mesh,
  and its compressed all-reduce (its own input, written out), and
  exchange checkpoints with the port: the first restores onto a (4, 2)
  mesh the checkpoint the port saved sharded there, and saves one of its
  own;
* one world of 8 gloo processes (``launch.world.run_world``), each rank
  running the port's sharded step on its blocks (and one rank a case the
  port's single-device step, the same on every rank, ``_owner``): JAX's
  cases (jamba at 4
  experts, top-2, also against the port's single-device step: expert
  selection and expert-parallel dispatch), then dense (granite-34b: gelu,
  one key/value head, so each rank's query heads meet their group's head;
  untied unembedding), vlm (internvl2-1b: embeddings, qkv biases), moe
  (granite-moe at capacity factor E / top_k: nothing drops, so expert
  parallelism routes the pairs the local path routes), ssm
  (falcon-mamba: ``in_proj`` gathered over "model", ``causal_conv1d``'s
  plain version on the host), hybrid (jamba: one super-block of 7 Mamba
  sublayers, attention and 2 experts, top-2, gathered whole; 2 experts
  only for the two-step params check, where every token takes both: with
  4 experts a token's second choice can flip on a near-tie after the
  first step, and the second step then moved weights by up to 1.2e-3 on
  either side of the single-device step, both sides 3-7e-6 of a float64
  reference apart in their gradients; the one-step 4-expert case above
  holds the routing) and encdec (seamless: self- and
  cross-attention split by heads, the tied vocabulary split), each in
  float32 for two steps, one case with
  ``microbatches=2``; each rank's bytes; the sharded ``Trainer`` over 4
  steps, restored from step 2 onto 2 of the ranks;
* worlds of threads in this process (the card's world, here on host
  tensors) for the collectives and the checkpoints around the JAX
  subprocess: the port's sharded save before it starts, the restores of
  JAX's checkpoint after it ends.

Tolerances, each with its reason: against JAX, JAX's own bounds (loss
2e-3 absolute, grad norm 2e-2 relative; bf16 compute, and the two
frameworks sum in other orders). The port sharded against the port
single-device, float32: loss and grad norm 1e-5 relative (the ranks'
partial products and the collectives sum in another order than one
device's GEMMs; read: 2e-7 and 4e-7), the params after two AdamW steps at
lr 1e-2 within 5e-4 (a first AdamW step moves a weight by about lr times
the sign of its gradient, so weights whose gradients are near zero carry
the summation order's difference up to that scale; read: 1.3e-4 on moe).
The compressed all-reduce and every checkpoint, bitwise.

Run here with ``PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q
tests/test_torch_sharded_train.py``.
"""
import dataclasses
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
if importlib.util.find_spec("jax") is None:          # the ranks import this
    pytest.skip("needs jax for the reference", allow_module_level=True)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.parallel import sharding as S  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = ((2, 2, 2), ("pod", "data", "model"))
#: tests/test_sharded.py's train-step case: its config, batch and optimizer
JAX_ARCH = "granite-3-2b"
JAX_CFG = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
               vocab=128)
BATCH, SEQ = 8, 16
OPT = dict(lr=1e-2, warmup_steps=0, grad_clip=1e9)
#: the port against itself, two steps: reduced configs in float32; a
#: ``"moe"`` entry replaces fields of the arch's MoEConfig
FAMILIES = {
    "dense": ("granite-34b", dict(n_layers=2, d_model=32, n_heads=4,
                                  n_kv_heads=1, d_ff=64, vocab=128)),
    "vlm": ("internvl2-1b", dict(n_layers=2, d_model=32, n_heads=4,
                                 n_kv_heads=2, d_ff=64, vocab=128,
                                 frontend_positions=4)),
    "moe": ("granite-moe-1b-a400m", dict(n_layers=2, d_model=32, n_heads=4,
                                         n_kv_heads=2, d_ff=64, vocab=128)),
    "ssm": ("falcon-mamba-7b", dict(n_layers=2, d_model=32, vocab=64)),
    "hybrid": ("jamba-v0.1-52b", dict(
        n_layers=8, attn_period=8, attn_offset=4, d_model=32, n_heads=4,
        n_kv_heads=2, d_ff=64, vocab=128, moe=dict(num_experts=2,
                                                   d_ff=64))),
    "encdec": ("seamless-m4t-large-v2", dict(
        n_layers=2, n_encoder_layers=2, d_model=32, n_heads=4,
        n_kv_heads=2, d_ff=64, vocab=128)),
}
#: the cases JAX's subprocess also steps once on the mesh: jamba at 4
#: experts, top-2, so that tokens choose among experts (FAMILIES' 2 take
#: both), and FAMILIES' seamless
JAX_CASES = {
    "hybrid": ("jamba-v0.1-52b", dict(FAMILIES["hybrid"][1], moe=dict(
        num_experts=4, d_ff=64))),
    "encdec": FAMILIES["encdec"],
}
#: the one-step case of JAX's jamba, held against the port's single-device
#: step as well
ROUTED = "hybrid-4-experts"
#: an encdec batch's frames
ENC_SEQ = 8
STEPS = 2
REL = 1e-5
PARAM_ATOL = 5e-4
#: the sharded Trainer: steps, the checkpoint step, the restore mesh
TRAIN_STEPS, TRAIN_CKPT = 4, 2
RESTORE_MESH = ((1, 2), ("data", "model"))
#: the checkpoint exchange: a (4, 2) mesh and an (8, 8) array each way
CKPT_MESH = ((4, 2), ("data", "model"))
CKPT_W = np.arange(64, dtype=np.float32).reshape(8, 8)
CKPT_JAX_W = CKPT_W * 2 + 1
TIMEOUT = 300
#: the single-device reference steps, each taken by one rank of the world
#: (every rank's would be the same), spread over the ranks to run at once
REF_CASES = ("jax_case", ROUTED, *FAMILIES, "microbatches")


def _owner(case) -> int:
    """The rank that takes ``case``'s single-device steps."""
    return REF_CASES.index(case) % int(np.prod(MESH[0]))

JAX_SCRIPT = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax, jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.checkpoint import Checkpointer
from repro.configs import get_config
from repro.launch.mesh import make_mesh
from repro.models import api
from repro.optim import OptConfig, allreduce_compressed, init_errors
from repro.optim import init_opt_state
from repro.parallel.sharding import (make_rules, prune_batch_axes,
                                     tree_shardings, use_rules)
from repro.roofline.hlo import analyze_hlo
from repro.train import TrainConfig, make_train_step
src, dst, meta = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
data = dict(np.load(src))
def subtree(prefix):
    out = {}
    for key, v in data.items():
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            node = out
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(v)
    return out
def config(arch, kw):
    base = get_config(arch)
    kw = dict(kw)
    if "moe" in kw:
        kw["moe"] = dataclasses.replace(base.moe, **kw["moe"])
    return dataclasses.replace(base, **kw)
tcfg = TrainConfig(opt=OptConfig(**meta["opt"]))
mesh = make_mesh(tuple(meta["mesh"][0]), tuple(meta["mesh"][1]))
def sharded(cfg, params, batch, hlo=None):
    step = make_train_step(cfg, tcfg)
    rules = prune_batch_axes(mesh, make_rules(mesh, cfg, "train", fsdp=True),
                             batch["tokens"].shape[0])
    with mesh, use_rules(rules):
        psh = tree_shardings(api.param_specs(cfg), mesh)
        p2 = jax.device_put(params, psh)
        opt = init_opt_state(p2, tcfg.opt)
        fn = jax.jit(step).lower(p2, opt, batch).compile()
        _, _, m = fn(p2, opt, batch)
    if hlo is not None:   # the compiled step's collectives, a device's
        got = analyze_hlo(fn.as_text(), pod_size=mesh.devices.size
                          // mesh.shape["pod"])
        hlo.update({k: got[k] for k in ("coll_bytes_ici", "coll_bytes_dcn",
                                         "coll_by_kind")})
    return m
out = {}
for fam, (arch, kw) in meta["families"].items():
    m = sharded(config(arch, kw), subtree(fam + "/p/"),
                subtree(fam + "/batch/"))
    out[fam] = (float(m["loss"]), float(m["grad_norm"]))
if not meta.get("arch"):          # a process of the families alone
    print("OUT::" + json.dumps(out))
    sys.exit(0)
cfg = config(meta["arch"], meta["cfg"])
params = subtree("p/")
batch = {"tokens": jnp.asarray(data["tokens"])}
step = make_train_step(cfg, tcfg)
_, _, m1 = jax.jit(step)(params, init_opt_state(params, tcfg.opt), batch)
out["hlo"] = {}
m2 = sharded(cfg, params, batch, out["hlo"])
out.update(l1=float(m1["loss"]), l2=float(m2["loss"]),
           g1=float(m1["grad_norm"]), g2=float(m2["grad_norm"]))
# tests/test_sharded.py's compressed all-reduce, its input included
mesh8 = make_mesh((8,), ("data",))
g = jax.random.normal(jax.random.PRNGKey(0), (8, 64)) * 0.1
def body(gs, es):
    o, new_e = allreduce_compressed({"w": gs[0]}, {"w": es[0]}, "data")
    return o["w"][None], new_e["w"][None]
with mesh8:
    fn = shard_map(body, mesh=mesh8, in_specs=(P("data", None),) * 2,
                   out_specs=(P("data", None),) * 2, check_rep=False)
    got, errs = fn(g, jnp.zeros_like(g))
# the port's checkpoint, saved sharded on (4, 2), restored onto (4, 2)
mesh42 = make_mesh(tuple(meta["ckpt_mesh"][0]), tuple(meta["ckpt_mesh"][1]))
sh = NamedSharding(mesh42, P("data", "model"))
w = jnp.asarray(data["ckpt_w"])
tree, at = Checkpointer(meta["port_ckpt"]).restore({"w": w},
                                                   shardings={"w": sh})
out["port_ckpt"] = dict(
    equal=bool(jnp.all(tree["w"] == w)), step=at,
    ndev=len(tree["w"].sharding.device_set),
    shard=list(tree["w"].sharding.shard_shape(w.shape)))
# and one of JAX's, saved sharded there
Checkpointer(meta["jax_ckpt"], async_save=False).save(
    meta["jax_step"], {"w": jax.device_put(jnp.asarray(data["ckpt_jax_w"]),
                                           sh)})
np.savez(dst, g=np.asarray(g), got=np.asarray(got), errs=np.asarray(errs))
print("OUT::" + json.dumps(out))
"""


def _cfg(arch, **kw):
    base = get_config(arch)
    if "moe" in kw:
        kw["moe"] = dataclasses.replace(base.moe, **kw["moe"])
    return dataclasses.replace(base, **kw)


def _f32(arch, kw):
    cfg = _cfg(arch, **kw, compute_dtype="float32")
    if cfg.moe is not None:
        m = cfg.moe
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            m, capacity_factor=m.num_experts / m.top_k))
    return cfg


def _f32_fields(arch, kw):
    """(arch, the config fields :func:`_f32` sets) of a case, as JSON for
    JAX's subprocess."""
    cfg = _f32(arch, kw)
    kw = dict(kw, compute_dtype="float32")
    if cfg.moe is not None:
        kw["moe"] = dict(kw.get("moe", {}),
                         capacity_factor=cfg.moe.capacity_factor)
    return arch, kw


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


def numpy_params(cfg, rng) -> dict:
    """Seeded numpy weights in JAX's ``init_params`` layout and scales
    (through the port's ``param_structs``), flat by path."""
    def leaf(name, shape):
        if name.startswith("ln") or name.endswith("_norm"):
            return np.ones(shape, np.float32)
        std = 0.02 if name == "embed" else shape[-2] ** -0.5
        return (rng.standard_normal(shape) * std).astype(np.float32)
    return {k: leaf(k.split("/")[-1], tuple(v.shape))
            for k, v in _flat(api.param_structs(cfg)).items()}


def make_inputs(path):
    rng = np.random.default_rng(0)
    cfg = _cfg(JAX_ARCH, **JAX_CFG)
    data = {"p/" + k: v for k, v in numpy_params(cfg, rng).items()}
    data["tokens"] = rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(
        np.int32)
    for fam, case in JAX_CASES.items():
        cfg = _f32(*case)
        data.update({f"{fam}/p/{k}": v
                     for k, v in numpy_params(cfg, rng).items()})
        data[f"{fam}/batch/tokens"] = rng.integers(
            0, cfg.vocab, (BATCH, SEQ + 1)).astype(np.int32)
        if cfg.family == "encdec":
            data[f"{fam}/batch/frames"] = rng.standard_normal(
                (BATCH, ENC_SEQ, cfg.d_model)).astype(np.float32)
    data["ckpt_w"] = CKPT_W
    data["ckpt_jax_w"] = CKPT_JAX_W
    np.savez(path, **data)


# ----------------------------------------------------------- the ranks --

def _mesh(spec=MESH):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(*spec, device_type="cpu")


def _rules(mesh, cfg):
    return S.prune_batch_axes(mesh, S.make_rules(mesh, cfg, "train",
                                                 fsdp=True), BATCH)


def _tcfg(**kw):
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainConfig
    return TrainConfig(opt=OptConfig(**OPT), **kw)


def _batches(cfg, seed, n=STEPS):
    gen = torch.Generator().manual_seed(seed)
    s = SEQ + 1 - (cfg.frontend_positions if cfg.family == "vlm" else 0)
    out = []
    for _ in range(n):
        b = {"tokens": torch.randint(0, cfg.vocab, (BATCH, s),
                                     generator=gen)}
        if cfg.family == "vlm":
            b["embeds"] = torch.randn((BATCH, cfg.frontend_positions,
                                       cfg.d_model), generator=gen)
        if cfg.family == "encdec":
            b["frames"] = torch.randn((BATCH, ENC_SEQ, cfg.d_model),
                                      generator=gen)
        out.append(b)
    return out


def _rows(batch):
    """This rank's rows of a global batch under the active rules."""
    return {k: S.local_shard(v, S.named_sharding(
        "batch", *([None] * (v.dim() - 1)))) for k, v in batch.items()}


def _gathered(tree, shardings):
    """The global arrays of this rank's blocks: every split dim gathered
    over its mesh axes."""
    def whole(t, sh):
        for dim, entry in enumerate(sh.spec):
            if entry is not None and S.axis_size(entry) > 1:
                t = S.all_gather(t, entry, dim)
        return t
    with torch.no_grad():
        return {k: (_gathered(v, shardings[k]) if isinstance(v, dict)
                    else whole(v, shardings[k])) for k, v in tree.items()}


def _steps(cfg, tcfg, params, batches, mesh=None, count=None,
           moments=None):
    """Metrics of each step and the params after them: the single-device
    step on a copy of ``params``, or inside ``mesh`` the sharded step on
    this rank's blocks and rows (the params returned gathered; with a
    ``count`` dict, the steps' collectives, ``Count.collective_bytes``,
    put in it; with a ``moments`` dict, the first moments, gathered and
    flat by path, put in it)."""
    from repro_torch.roofline import count as roofline
    from repro_torch.optim import init_opt_state
    from repro_torch.train import make_train_step
    step = make_train_step(cfg, tcfg)
    if mesh is None:
        p = {k: v.clone() for k, v in _flat(params).items()}
        p = _nest(p, "")
        opt = init_opt_state(p, tcfg.opt)
        metrics = []
        for b in batches:
            p, opt, m = step(p, opt, b)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        if moments is not None:
            moments.update(_numpy(opt["m"]))
        return metrics, p
    with S.use_mesh(mesh), S.use_rules(_rules(mesh, cfg)):
        psh = S.tree_shardings(api.param_specs(cfg))
        p = S.local_tree(params, psh, copy=True)
        opt = init_opt_state(p, tcfg.opt)
        metrics = []
        with roofline.counting(flops=False) as c:
            for b in batches:
                p, opt, m = step(p, opt, _rows(b))
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
        if count is not None:
            count.update(c.collective_bytes())
        if moments is not None:
            moments.update(_numpy(_gathered(opt["m"], psh)))
        return metrics, _gathered(p, psh)


def _numpy(tree):
    return {k: v.detach().numpy() for k, v in _flat(tree).items()}


def _moment64(cfg, params, batch):
    """The first moment after one AdamW step, (1 - b1) g, of the loss's
    gradient computed in float64, flat by path."""
    cfg = dataclasses.replace(cfg, compute_dtype="float64")
    p = {k: v.detach().double().requires_grad_()
         for k, v in _flat(params).items()}
    b = {k: v.double() if v.is_floating_point() else v
         for k, v in batch.items()}
    api.loss_fn(cfg)(_nest(p, ""), b).backward()
    return {k: (1 - _tcfg().opt.b1) * v.grad.numpy() for k, v in p.items()}


def _rank(rank, path, ckpt_dir):
    from repro_torch.weights import lm_params_from_numpy
    torch.manual_seed(0)
    mesh = _mesh()
    data = dict(np.load(path))
    out = {"coord": tuple(mesh.get_coordinate())}
    # JAX's case: its bf16 compute, one step, sharded and not
    cfg = _cfg(JAX_ARCH, **JAX_CFG)
    params = lm_params_from_numpy(_nest(data, "p/"), device="cpu")
    batch = [{"tokens": torch.from_numpy(data["tokens"]).long()}]
    # the single-device steps, the same on every rank: each case's owner
    # takes them
    def mine(case):
        return _owner(case) == rank
    out["collectives"] = {}
    out["jax_case"] = (mine("jax_case") and _steps(cfg, _tcfg(), params, batch)[0][0],
                       _steps(cfg, _tcfg(), params, batch, mesh,
                              out["collectives"])[0][0])
    out["bytes"] = _bytes(cfg, params, mesh)
    # JAX's hybrid and encdec cases, float32, one sharded step; the
    # 4-expert jamba's also against the single-device step
    for fam, case in JAX_CASES.items():
        cfg = _f32(*case)
        params = lm_params_from_numpy(_nest(data, f"{fam}/p/"), device="cpu")
        batch = {k: torch.from_numpy(v).long() if k == "tokens"
                 else torch.from_numpy(v)
                 for k, v in _nest(data, f"{fam}/batch/").items()}
        coll, mom, ref_mom = {}, {}, {}
        got_m, got_p = _steps(cfg, _tcfg(), params, [batch], mesh, coll,
                              mom)
        out["jax_" + fam] = got_m[0]
        if fam == "hybrid":
            ref = mine(ROUTED) and _steps(cfg, _tcfg(), params, [batch],
                                   moments=ref_mom)
            out[ROUTED] = (ref and (ref[0], _numpy(ref[1]), ref_mom,
                                    _moment64(cfg, params, batch)),
                           (got_m, _numpy(got_p), mom))
            out[ROUTED + "/by_kind"] = coll["by_kind"]
    # the port against itself, float32
    out["family_bytes"] = {}
    for fam, (arch, kw) in FAMILIES.items():
        cfg = _f32(arch, kw)
        params = api.init_params(cfg, torch.Generator().manual_seed(3),
                                 device="cpu")
        batches = _batches(cfg, 4)
        ref = mine(fam) and _steps(cfg, _tcfg(), params, batches)
        got_m, got_p = _steps(cfg, _tcfg(), params, batches, mesh)
        out[fam] = (ref and (ref[0], _numpy(ref[1])), (got_m, _numpy(got_p)))
        out["family_bytes"][fam] = _bytes(cfg, params, mesh)
    cfg = _f32(JAX_ARCH, JAX_CFG)
    params = api.init_params(cfg, torch.Generator().manual_seed(5),
                             device="cpu")
    batches = _batches(cfg, 6)
    ref = mine("microbatches") and _steps(cfg, _tcfg(microbatches=2),
                                          params, batches)
    got_m, got_p = _steps(cfg, _tcfg(microbatches=2), params, batches, mesh)
    out["microbatches"] = (ref and (ref[0], _numpy(ref[1])),
                           (got_m, _numpy(got_p)))
    out["serve"] = _serve_paths(mesh)
    out["trainer"] = _trainer(rank, mesh, ckpt_dir)
    return out


def _bytes(cfg, params, mesh):
    """(this rank's param + m + v bytes, the dry run's first-device bytes
    of the same: local_bytes of each under the param shardings)."""
    from repro_torch.optim import init_opt_state
    with S.use_mesh(mesh), S.use_rules(_rules(mesh, cfg)):
        psh = S.tree_shardings(api.param_specs(cfg))
        p = S.local_tree(params, psh, copy=True)
        opt = init_opt_state(p, _tcfg().opt)
        mine = sum(t.numel() * t.element_size()
                   for tree in (p, opt["m"], opt["v"])
                   for t in _flat(tree).values())
        return mine, 3 * S.local_bytes(api.param_structs(cfg), psh)


def _serve_paths(mesh):
    """Per dense, vlm and ssm family (moe's FFN takes the EP path inside a
    mesh, ``tests/test_torch_sharded.py``), whether its prefill and a
    decode step of this rank's rows inside the mesh under spmd_rules of
    the train rules (every dim they split but the batch, the cache and the
    experts held whole) give the bits they give outside it."""
    out = {}
    for fam in ("dense", "vlm", "ssm"):
        cfg = _f32(*FAMILIES[fam])
        params = api.init_params(cfg, torch.Generator().manual_seed(7),
                                 device="cpu")
        batch = {k: v[:, :8] if k == "tokens" else v
                 for k, v in _batches(cfg, 8, 1)[0].items()}

        def run(b):
            logits, cache = api.prefill_fn(cfg, 16)(params, b)
            step, _ = api.decode_fn(cfg)(params, logits[:, -1:].argmax(-1),
                                         cache)
            return logits, step
        with S.use_mesh(mesh), S.use_rules(S.spmd_rules(_rules(mesh, cfg))):
            rows = _rows(batch)
            got = run(rows)
        want = run(rows)
        out[fam] = all(torch.equal(a, b) for a, b in zip(got, want))
    return out


def _trainer(rank, mesh, ckpt_dir):
    """The sharded Trainer on the (2, 2, 2) mesh for TRAIN_STEPS steps,
    checkpointing every TRAIN_CKPT; then ranks 0 and 1 as a (1, 2) mesh
    restore step TRAIN_CKPT from a copy of that checkpoint and take the
    remaining steps. (losses of both runs, the restored blocks each equal
    to its slice of the stored global array)."""
    from repro_torch.data.pipeline import DataConfig, IndexedDataset
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.trainer import LoopConfig, Trainer
    cfg = _f32(JAX_ARCH, JAX_CFG)
    ds = IndexedDataset(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                   global_batch=BATCH, seed=2))

    def init(gen):
        return api.init_params(cfg, gen, device="cpu")

    def run(mesh, directory):
        with S.use_mesh(mesh), S.use_rules(_rules(mesh, cfg)):
            psh = S.tree_shardings(api.param_specs(cfg))
            tr = Trainer(cfg, _tcfg(), LoopConfig(
                total_steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT,
                ckpt_dir=directory, keep=TRAIN_STEPS, log_every=0), ds,
                init, psh, S.named_sharding("batch", None), device="cpu")
            params, opt, start = tr.init_or_restore()
            _, _, _, hist = tr.run(params, opt, start)
            return [h["loss"] for h in hist], params, psh, start
    straight = os.path.join(ckpt_dir, "straight")
    losses = run(mesh, straight)[0]
    agreed = _agreement(rank, mesh, os.path.join(ckpt_dir, "faulty"), cfg,
                        ds, init)
    sub = os.path.join(ckpt_dir, "restored")
    if rank == 0:
        os.makedirs(sub)
        name = f"step_{TRAIN_CKPT:09d}"
        shutil.copytree(os.path.join(straight, name),
                        os.path.join(sub, name))
    with S.use_mesh(mesh):
        S.psum(torch.zeros(1), MESH[1])         # the copy is there
    small = make_mesh(*RESTORE_MESH, device_type="cpu")
    # a DeviceMesh over ranks 0 and 1 only (every rank makes it)
    from torch.distributed.device_mesh import DeviceMesh
    small = DeviceMesh("cpu", torch.arange(2).reshape(RESTORE_MESH[0]),
                       mesh_dim_names=RESTORE_MESH[1]) if rank > 1 \
        else small
    if rank > 1:
        return losses, None, agreed
    restored = {}

    def capture(fn):
        def wrapped(self, *a, **k):
            out = fn(self, *a, **k)
            restored["blocks"] = {key: t.clone() for key, t in
                                  _flat(out[0]).items()}
            return out
        return wrapped
    from repro_torch.train import trainer as TR
    orig = TR.Trainer.init_or_restore
    TR.Trainer.init_or_restore = capture(orig)
    try:
        more, _, psh, start = run(small, sub)
    finally:
        TR.Trainer.init_or_restore = orig
    stored = np.load(os.path.join(sub, f"step_{TRAIN_CKPT:09d}",
                                  "shard_0.npz"))
    with S.use_mesh(small):
        flat_sh = _flat(psh)
        equal = all(np.array_equal(
            blk.detach().numpy(),
            S.local_shard(torch.from_numpy(stored["params/" + key]),
                          flat_sh[key]).numpy())
            for key, blk in restored["blocks"].items())
        halves = {key: (tuple(blk.shape), stored["params/" + key].shape)
                  for key, blk in restored["blocks"].items()}
    return losses, (more, start, equal, halves), agreed


def _agreement(rank, mesh, directory, cfg, ds, init):
    """A sharded Trainer whose second step has a non-finite loss (on every
    rank, as a global loss would) and leaves rank 5's params non-finite,
    and whose SIGTERM after the third reaches rank 3 alone: every rank
    restores the last checkpoint, and every rank saves and returns at
    the same step. (step returned, steps skipped, restores, losses)."""
    from repro_torch.train.trainer import LoopConfig, Trainer
    with S.use_mesh(mesh), S.use_rules(_rules(mesh, cfg)):
        psh = S.tree_shardings(api.param_specs(cfg))
        tr = Trainer(cfg, _tcfg(), LoopConfig(
            total_steps=TRAIN_STEPS + 2, ckpt_every=1, ckpt_dir=directory,
            log_every=0), ds, init, psh, S.named_sharding("batch", None),
            device="cpu")
        step_fn, calls, restores = tr.step_fn, [0], [0]

        def step(p, o, b):
            p, o, m = step_fn(p, o, b)
            calls[0] += 1
            if calls[0] == 2:
                if rank == 5:
                    p["final_norm"].detach().fill_(float("nan"))
                m = dict(m, loss=torch.tensor(float("nan")))
            if calls[0] == 3 and rank == 3:
                tr._preempted = True
            return p, o, m
        restore = tr._restore

        def counted(*a, **k):
            restores[0] += 1
            return restore(*a, **k)
        tr.step_fn, tr._restore = step, counted
        params, opt, start = tr.init_or_restore()
        _, _, at, hist = tr.run(params, opt, start)
        return at, tr.skipped, restores[0], [h["loss"] for h in hist]


# ------------------------------------------------------------- launches --

def _save_port_ckpt(rank, directory):
    """The port's sharded save of CKPT_W on the (4, 2) mesh, every rank
    holding its block."""
    from repro_torch.checkpoint import Checkpointer
    mesh = _mesh(CKPT_MESH)
    with S.use_mesh(mesh):
        sh = S.NamedSharding(mesh, ("data", "model"))
        Checkpointer(directory, async_save=False).save(
            3, {"w": S.local_shard(torch.from_numpy(CKPT_W), sh).clone()},
            shardings={"w": sh})
        return tuple(mesh.get_coordinate())


def _restore_ckpt(rank, directory, spec, want):
    """This rank's block of ``directory``'s checkpoint restored onto a
    mesh of ``spec`` with P("data", "model") (or P("data", None) on a
    one-axis mesh), and the block ``local_shard`` cuts of ``want``."""
    from repro_torch.checkpoint import Checkpointer
    mesh = _mesh(spec)
    with S.use_mesh(mesh):
        sh = S.NamedSharding(mesh, ("data", "model") if len(spec[1]) == 2
                             else ("data", None))
        tree, step = Checkpointer(directory).restore(
            {"w": torch.zeros(())}, shardings={"w": sh})
        return step, tree["w"].numpy(), S.local_shard(
            torch.from_numpy(want), sh).numpy()


def _compressed(rank, g):
    """``allreduce_compressed`` of row ``rank`` of ``g`` over an 8-rank
    ("data",) mesh, zero residuals in."""
    from repro_torch.optim import allreduce_compressed, init_errors
    mesh = _mesh(((8,), ("data",)))
    with S.use_mesh(mesh):
        mine = {"w": torch.from_numpy(g[rank])}
        got, errs = allreduce_compressed(mine, init_errors(mine), "data")
        return got["w"].numpy(), errs["w"].numpy()


def _threads(fn, n, *args):
    from repro_torch.launch.world import _thread_world
    return _thread_world(fn, n, args, TIMEOUT, "cpu").results


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's results, JAX's arrays, the gloo world's results, the
    checkpoint directories): the port's sharded save, then the JAX
    subprocess and the gloo world at once."""
    from repro_torch.launch.world import run_world
    tmp = tmp_path_factory.mktemp("sharded_train")
    src, dst = str(tmp / "inputs.npz"), str(tmp / "jax.npz")
    make_inputs(src)
    port_ckpt, jax_ckpt = str(tmp / "port_ckpt"), str(tmp / "jax_ckpt")
    _threads(_save_port_ckpt, 8, port_ckpt)
    trainer_dir = str(tmp / "trainer")
    os.makedirs(trainer_dir)
    common = dict(opt=OPT, mesh=[list(MESH[0]), list(MESH[1])])
    metas = [  # JAX's own cases and seamless; jamba's compile, at once
        dict(common, arch=JAX_ARCH, cfg=JAX_CFG,
             families={"encdec": _f32_fields(*JAX_CASES["encdec"])},
             ckpt_mesh=[list(CKPT_MESH[0]), list(CKPT_MESH[1])],
             port_ckpt=port_ckpt, jax_ckpt=jax_ckpt, jax_step=5),
        dict(common, families={"hybrid": _f32_fields(*JAX_CASES["hybrid"])})]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, src, dst,
                               json.dumps(meta)], env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for meta in metas]
    out = {}
    try:
        world = run_world(_rank, 8, src, trainer_dir, device_type="cpu",
                          timeout=TIMEOUT)
        for proc in procs:
            stdout, stderr = proc.communicate(timeout=TIMEOUT)
            assert proc.returncode == 0, stderr[-3000:]
            out.update(json.loads([
                line for line in stdout.splitlines()
                if line.startswith("OUT::")][-1][len("OUT::"):]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out, dict(np.load(dst)), world.results, (port_ckpt, jax_ckpt)


# ---------------------------------------------------------------- tests --

def test_jax_train_step_case_matches_jax(runs):
    """tests/test_sharded.py's case: the port's sharded loss and grad norm
    on the (2, 2, 2) mesh against JAX's sharded ones, within JAX's bounds
    (and the port's single-device step against JAX's)."""
    jax_out, _, results, _ = runs
    l1, g1 = results[_owner("jax_case")]["jax_case"][0]
    assert abs(l1 - jax_out["l1"]) < 2e-3, (l1, jax_out)
    assert abs(g1 - jax_out["g1"]) / max(jax_out["g1"], 1e-6) < 2e-2
    for r in results:
        l2, g2 = r["jax_case"][1]
        assert abs(l2 - jax_out["l2"]) < 2e-3, (l2, jax_out)
        assert abs(g2 - jax_out["g2"]) / max(jax_out["g2"], 1e-6) < 2e-2


def test_collective_bytes_beside_jax_hlo(runs):
    """A reading, not a gate: rank 0's collective bytes of JAX's case
    (``roofline.count``, by JAX's kind names) printed beside
    ``analyze_hlo``'s of JAX's compiled sharded step (XLA's partitioner
    picks its own collectives); shown with ``-s``."""
    jax_hlo = runs[0]["hlo"]
    mine = runs[2][0]["collectives"]
    print(f"\n[collectives] {JAX_ARCH} reduced, one step on {MESH}: the "
          f"port (rank 0) {mine['bytes_in_pod']} B in pod, "
          f"{mine['bytes_cross_pod']} B across pods, {mine['calls']} calls, "
          f"by kind {mine['by_kind']}; JAX's analyze_hlo "
          f"{jax_hlo['coll_bytes_ici']:.0f} B in pod, "
          f"{jax_hlo['coll_bytes_dcn']:.0f} B across pods, by kind "
          f"{ {k: int(v) for k, v in jax_hlo['coll_by_kind'].items()} }")
    assert mine["calls"] > 0 and jax_hlo["coll_by_kind"]


def test_world_covers_the_mesh(runs):
    assert sorted(r["coord"] for r in runs[2]) == [
        (i, j, k) for i in range(2) for j in range(2) for k in range(2)]


@pytest.mark.parametrize("family", list(JAX_CASES))
def test_sharded_step_matches_jax(runs, family):
    """One FSDP + TP step of the reduced jamba (4 experts, top-2) and
    seamless on the (2, 2, 2) mesh from the same numpy params and batch,
    float32 compute: the port's loss and grad norm against JAX's sharded
    ones, within JAX's bounds."""
    want = runs[0][family]
    for r in runs[2]:
        loss, gnorm = r["jax_" + family]
        assert abs(loss - want[0]) < 2e-3, (loss, want)
        assert abs(gnorm - want[1]) / max(want[1], 1e-6) < 2e-2, (gnorm,
                                                                    want)


@pytest.mark.parametrize("case", list(FAMILIES) + ["microbatches"])
def test_sharded_step_matches_single_device(runs, case):
    """Two FSDP + TP steps of each family on the (2, 2, 2) mesh against
    the port's single-device step, float32: losses and grad norms within
    1e-5 relative, the params gathered back to global within 5e-4 (module
    docstring); microbatches=2 on the dense case. The single-device steps
    are one rank's (``_owner``; every rank's are the same)."""
    ref_m, ref_p = runs[2][_owner(case)][case][0]
    for r in runs[2]:
        got_m, got_p = r[case][1]
        for (l1, g1), (l2, g2) in zip(ref_m, got_m):
            assert abs(l2 - l1) <= REL * abs(l1), (case, ref_m, got_m)
            assert abs(g2 - g1) <= REL * abs(g1), (case, ref_m, got_m)
        assert set(got_p) == set(ref_p)
        for k in ref_p:
            assert got_p[k].shape == ref_p[k].shape, k
            np.testing.assert_allclose(got_p[k], ref_p[k], rtol=0,
                                       atol=PARAM_ATOL, err_msg=k)


def test_routed_hybrid_step_matches_single_device(runs):
    """One FSDP + TP step of JAX's jamba case (4 experts, top-2: tokens
    choose, and the MoE dispatches expert-parallel, an all-to-all on every
    rank) against the port's single-device step, float32: loss and grad
    norm within 1e-5 relative; the gradient itself (the first moment after
    one step, (1 - b1) g, gathered back to global) no further in norm from
    the float64 gradient than twice the single-device float32 one is
    (read: 1.99e-4 against 2.34e-4; the two float32 gradients 9.5e-5
    apart, of 9.26); the params within 2 lr elementwise, as far as two
    AdamW paths can part them. Not the 5e-4 of the two-step cases: AdamW's
    first step moves a weight by lr g / (|g| + 1e-8), a few of this case's
    gradients lie within float32 rounding of zero (6 of 28,672 Mamba
    ``in_proj`` gradients below 1e-6, where the single-device float32
    gradient changes sign against float64's), and the sharded sum's order
    moves such a weight by up to a few lr / 10 (read: 4.9e-3, 2 of the
    attention block's 8,192 FFN ``w_down`` weights)."""
    def dist(a, b):
        return np.sqrt(sum(float(((a[k] - b[k]).astype(np.float64) ** 2)
                                 .sum()) for k in b))
    for r in runs[2]:
        assert r[ROUTED + "/by_kind"].get("all-to-all", 0) > 0
    ref_m, ref_p, ref_g, g64 = runs[2][_owner(ROUTED)][ROUTED][0]
    bound = 2 * dist(ref_g, g64)
    for r in runs[2]:
        got_m, got_p, got_g = r[ROUTED][1]
        (l1, g1), (l2, g2) = ref_m[0], got_m[0]
        assert abs(l2 - l1) <= REL * abs(l1), (ref_m, got_m)
        assert abs(g2 - g1) <= REL * abs(g1), (ref_m, got_m)
        assert set(got_p) == set(ref_p) == set(got_g) == set(g64)
        assert 0 < dist(got_g, g64) <= bound, (dist(got_g, g64), bound)
        for k in ref_p:
            np.testing.assert_allclose(got_p[k], ref_p[k], rtol=0,
                                       atol=2 * OPT["lr"], err_msg=k)


def test_rank_bytes_equal_local_bytes(runs):
    """Each rank's param + m + v bytes are the dry run's first-device
    bytes of the same (``local_bytes`` under ``tree_shardings``)."""
    for r in runs[2]:
        mine, want = r["bytes"]
        assert mine == want > 0


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_rank_bytes_equal_local_bytes(runs, family):
    """Each family's param + m + v bytes on each rank are the dry run's
    first-device bytes of the same."""
    for r in runs[2]:
        mine, want = r["family_bytes"][family]
        assert mine == want > 0


def test_serve_paths_under_spmd_rules_keep_their_bits(runs):
    """Inside the (2, 2, 2) mesh under ``spmd_rules`` of the train rules
    the dense, vlm and ssm prefills and decode steps give the bits of the
    same calls outside the mesh: the heads, FFN, vocabulary and Mamba
    channels stay whole."""
    for r in runs[2]:
        assert r["serve"] == {"dense": True, "vlm": True, "ssm": True}


def test_hybrid_and_encdec_losses_run_outside_a_mesh():
    """Outside a mesh (no rules made active) the hybrid and encdec losses
    run unsharded and are finite."""
    for fam in ("hybrid", "encdec"):
        cfg = _f32(*FAMILIES[fam])
        params = api.init_params(cfg, torch.Generator().manual_seed(1),
                                 device="cpu")
        batch = {"tokens": torch.zeros((2, 9), dtype=torch.long)}
        if fam == "encdec":
            batch["frames"] = torch.zeros((2, 8, cfg.d_model))
        assert torch.isfinite(api.loss_fn(cfg)(params, batch))


def test_sharded_trainer_restores_onto_two_ranks(runs):
    """The sharded Trainer's losses are the same on every rank; restored
    from its step-2 checkpoint onto 2 ranks of a (1, 2) mesh, each rank's
    blocks are bitwise its slice of the stored global arrays (half of each
    leaf the rules split over "model"), and the two remaining steps' losses
    are within 1e-4 of the straight run's."""
    results = runs[2]
    straight = results[0]["trainer"][0]
    assert len(straight) == TRAIN_STEPS
    for r in results:
        assert r["trainer"][0] == straight
    for r in results[:2]:
        more, start, equal, halves = r["trainer"][1]
        assert start == TRAIN_CKPT and equal
        assert halves["layers/mlp/w_up"][0][-1] * 2 == \
            halves["layers/mlp/w_up"][1][-1]
        np.testing.assert_allclose(more, straight[TRAIN_CKPT:], rtol=0,
                                   atol=1e-4)


def test_sharded_trainer_agrees_on_restores_and_preemption(runs):
    """A non-finite step whose params went bad on one rank makes every
    rank restore the last checkpoint, and a SIGTERM seen by one rank makes
    every rank save and return after the same step (the preemption flag
    is the world's pmax), with the same losses."""
    got = [r["trainer"][2] for r in runs[2]]
    at, skipped, restores, losses = got[0]
    assert (at, skipped, restores, len(losses)) == (3, 1, 1, 2)
    assert all(g == got[0] for g in got)


def test_compressed_allreduce_matches_jax_bitwise(runs):
    """``allreduce_compressed`` on tests/test_sharded.py's input over 8
    ranks: bitwise JAX's outputs and residuals, within 0.08 of the mean,
    residuals not zero."""
    _, arrays, _, _ = runs
    g = arrays["g"]
    results = _threads(_compressed, 8, g)
    got = np.stack([o for o, _ in results])
    errs = np.stack([e for _, e in results])
    np.testing.assert_array_equal(got, arrays["got"])
    np.testing.assert_array_equal(errs, arrays["errs"])
    want = g.mean(0)
    assert np.abs(got[0] - want).max() / (np.abs(want).max() + 1e-9) < 0.08
    assert np.abs(errs).max() > 0


def test_compression_scale_is_a_power_of_two():
    """The port's scale is an exact power of two covering max|x| at int8's
    full scale, also where max|x| is a power of two (module docstring of
    ``optim.compression``: JAX's is off by an ulp at some exponents)."""
    from repro_torch.optim.compression import _pow2_scale, compress
    for e in range(-20, 16):
        for m in (2.0 ** e, 2.0 ** e * 1.5):
            x = torch.tensor([m, -m / 3], dtype=torch.float32)
            s = float(_pow2_scale(x))
            assert s == 2.0 ** (np.ceil(np.log2(m)) - 7)
            # a max of exactly 128 steps clips to 127: one step's error
            q, _, err = compress(x, torch.zeros(2))
            assert float(err.abs().max()) <= (s if m == 2.0 ** e else s / 2)


def test_checkpoints_cross_meshes_and_packages(runs):
    """The port's checkpoint saved sharded on (4, 2): JAX restores it onto
    its (4, 2) mesh equal, 2 x 4 a device; the port restores it onto 2
    ranks, each holding half the rows, bitwise. JAX's checkpoint saved
    sharded on (4, 2): the port restores it onto (4, 2), every block
    bitwise its slice."""
    jax_out, _, _, (port_ckpt, jax_ckpt) = runs
    assert jax_out["port_ckpt"] == dict(equal=True, step=3, ndev=8,
                                        shard=[2, 4])
    two = _threads(_restore_ckpt, 2, port_ckpt, ((2,), ("data",)), CKPT_W)
    assert [r[0] for r in two] == [3, 3]
    np.testing.assert_array_equal(np.concatenate([r[1] for r in two]),
                                  CKPT_W)
    for step, got, want in two:
        assert got.shape == (4, 8)
        np.testing.assert_array_equal(got, want)
    eight = _threads(_restore_ckpt, 8, jax_ckpt, CKPT_MESH, CKPT_JAX_W)
    for step, got, want in eight:
        assert step == 5 and got.shape == (2, 4)
        np.testing.assert_array_equal(got, want)


def test_collectives_are_differentiable_with_jax_transposes():
    """On 4 thread ranks of a (2, 2) mesh: the gradients through
    ``psum`` (its own transpose), ``all_gather`` / ``psum_scatter`` (each
    other's) over one axis and over both, and ``all_to_all`` (the
    exchange swapped) equal the hand-derived transposes; a tuple of axes
    gathers in the mesh's major-to-minor order, ``local_shard``'s."""
    for r, got in enumerate(_threads(_grads, 4)):
        for name, (a, b) in got.items():
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=0,
                                       err_msg=f"rank {r} {name}")


def _grads(rank):
    """Rank ``rank``'s (got, want) pairs of the collectives' gradients
    (``test_collectives_are_differentiable_with_jax_transposes``); rank r
    is (data r // 2, model r % 2)."""
    mesh = _mesh(((2, 2), ("data", "model")))
    data, model = divmod(rank, 2)
    x = (torch.arange(8.0) + 10 * rank).reshape(4, 2).requires_grad_()
    out = {}
    with S.use_mesh(mesh):
        # the gather over both axes, rank r's block at row block r; each
        # rank weights the (16, 2) result by arange(32) * (r + 1)
        y = S.all_gather(x, ("data", "model"), 0)
        out["gather_order"] = (y.detach().numpy(), np.concatenate(
            [np.arange(8.0).reshape(4, 2) + 10 * r for r in range(4)]))
        c = torch.arange(32.0).reshape(16, 2)
        (g,) = torch.autograd.grad((y * c * (rank + 1)).sum(), x)
        out["gather"] = (g.numpy(), c[4 * rank:4 * rank + 4].numpy() * 10)
        # psum over "model", each rank's cotangent r + 1
        (g,) = torch.autograd.grad((S.psum(x, "model") * (rank + 1)).sum(),
                                   x)
        peers = [2 * data + m for m in range(2)]
        out["psum"] = (g.numpy(), np.full((4, 2), float(sum(
            p + 1 for p in peers))))
        # psum_scatter over "data" along dim 0, each rank's cotangent r + 1
        (g,) = torch.autograd.grad(
            (S.psum_scatter(x, "data", 0) * (rank + 1)).sum(), x)
        out["scatter"] = (g.numpy(), np.concatenate(
            [np.full((2, 2), float(2 * d + model + 1)) for d in range(2)]))
        # all_to_all over "model" (split rows, concat columns): x's row
        # block j went to model peer j, as its column block ``model``
        z = S.all_to_all(x, "model", 0, 1)

        def cot(r):
            return np.arange(8.0).reshape(2, 4) + 100 * r
        (g,) = torch.autograd.grad((z * torch.from_numpy(cot(rank))).sum(),
                                   x)
        out["all_to_all"] = (g.numpy(), np.concatenate(
            [cot(2 * data + j)[:, 2 * model:2 * model + 2]
             for j in range(2)]))
    return out
