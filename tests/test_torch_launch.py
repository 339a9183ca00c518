"""The port's dry-run chain against the JAX package on the CPU: the shapes
and the skip rule, the models' spec trees and meta structs, the sharding
rules on both production meshes, and every supported cell's rules and
per-device argument bytes against JAX's own ``build_cell``.

The port's meshes are ``DeviceMesh`` es over ``torch.distributed``'s fake
backend (``launch.dryrun.fake_world``; the module's fixture destroys the
group after it). JAX's ``make_rules`` runs on ``jax.sharding.AbstractMesh``
stand-ins of the two production meshes in this process; JAX's
``build_cell`` needs 512 host devices, so it runs in one subprocess (as
``tests/test_sharded.py`` runs JAX's meshes): importing
``repro.launch.dryrun`` sets ``XLA_FLAGS``, so this process never imports
it. Everything compared here is exact: names, shapes, dtypes, rules and
byte counts.

Run here with ``PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q
tests/test_torch_launch.py``."""
import dataclasses
import itertools
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import base as JB  # noqa: E402
from repro.models import api as j_api  # noqa: E402
from repro.parallel import sharding as JS  # noqa: E402

from repro_torch.configs import base as B  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.mesh import (batch_axes,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models import api  # noqa: E402
from repro_torch.parallel import sharding as S  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: one reduced config a family (tests/test_arch_smoke.py's reduce_cfg
#: sizes), each family's arch
FAMILY_ARCH = {"dense": "qwen2-0.5b", "vlm": "internvl2-1b",
               "moe": "granite-moe-1b-a400m", "arctic": "arctic-480b",
               "ssm": "falcon-mamba-7b", "hybrid": "jamba-v0.1-52b",
               "encdec": "seamless-m4t-large-v2", "bias": "qwen1.5-32b",
               "gelu": "granite-34b"}


def _reduce(cfg):
    kw = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
              vocab=256)
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(cfg.moe, num_experts=4,
                                        top_k=min(cfg.moe.top_k, 2), d_ff=64)
    if cfg.family == "hybrid":
        kw.update(n_layers=8, attn_period=8, attn_offset=4)
    if cfg.family == "encdec":
        kw["n_encoder_layers"] = 2
    if cfg.family == "vlm":
        kw["frontend_positions"] = 4
    return dataclasses.replace(cfg, **kw)


def _pair(arch):
    """(JAX config, port config) of ``arch`` at reduced sizes."""
    j = _reduce(JB.get_config(arch))
    return j, B.ModelConfig(**{f.name: getattr(j, f.name)
                               for f in dataclasses.fields(j)
                               if f.name not in ("moe", "mamba")},
                            moe=None if j.moe is None
                            else B.MoEConfig(**dataclasses.asdict(j.moe)),
                            mamba=None if j.mamba is None
                            else B.MambaConfig(**dataclasses.asdict(j.mamba)))


def _struct(tree):
    """A tree of (shape, dtype name) from meta tensors or JAX structs."""
    if isinstance(tree, dict):
        return {k: _struct(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape), str(tree.dtype).replace("torch.", "")
    return tuple(tree.shape), np.dtype(tree.dtype).name


@pytest.fixture(scope="module")
def meshes():
    """The port's two production meshes (each made under a fake world of
    its size; a mesh outlives the group switch for what the rules read)."""
    import torch.distributed as dist
    out = {}
    for mp in (False, True):
        D.fake_world(512 if mp else 256)
        out[mp] = make_production_mesh(multi_pod=mp, device_type="cpu")
    yield out
    if dist.is_initialized():
        dist.destroy_process_group()


def test_shapes_and_cell_supported_match_jax():
    assert B.ARCH_IDS == JB.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in B.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JB.SHAPES.items()}
    for arch, shape in itertools.product(B.ARCH_IDS, B.SHAPES):
        assert B.cell_supported(B.get_config(arch), B.SHAPES[shape]) == \
            JB.cell_supported(JB.get_config(arch), JB.SHAPES[shape])


@pytest.mark.parametrize("family", sorted(FAMILY_ARCH))
def test_specs_and_structs_match_jax(family):
    jcfg, cfg = _pair(FAMILY_ARCH[family])
    assert api.param_specs(cfg) == j_api.param_specs(jcfg)
    assert api.cache_specs(cfg) == j_api.cache_specs(jcfg)
    params = api.param_structs(cfg)
    assert _struct(params) == _struct(j_api.param_structs(jcfg))
    # the spec tree and the parameter tree have the same structure, and
    # every spec names each dim of its leaf
    assert S.map_specs(len, api.param_specs(cfg)) == \
        S.map_specs(lambda t: t.dim(), params)
    assert _struct(api.cache_structs(cfg, 3, 32)) == \
        _struct(j_api.cache_structs(jcfg, 3, 32))
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        small = dataclasses.replace(B.SHAPES[shape], seq_len=64,
                                    global_batch=4)
        jsmall = dataclasses.replace(JB.SHAPES[shape], seq_len=64,
                                     global_batch=4)
        assert _struct(api.input_specs(cfg, small)) == \
            _struct(j_api.input_specs(jcfg, jsmall))
    assert {t.device.type for t in leaves(params)} == {"meta"}


def _jax_mesh(multi_pod):
    if multi_pod:
        return jax.sharding.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return jax.sharding.AbstractMesh((16, 16), ("data", "model"))


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
def test_make_rules_and_prune_match_jax(meshes, multi_pod):
    mesh, jmesh = meshes[multi_pod], _jax_mesh(multi_pod)
    assert S.mesh_shape(mesh) == dict(jmesh.shape)
    assert batch_axes(mesh) == tuple(a for a in ("pod", "data")
                                     if a in jmesh.axis_names)
    n = 0
    for arch in B.ARCH_IDS:
        cfg, jcfg = B.get_config(arch), JB.get_config(arch)
        for kind, fsdp, sp, res in itertools.product(
                ("train", "prefill", "decode"), *([(False, True)] * 3)):
            got = S.make_rules(mesh, cfg, kind, fsdp=fsdp, sp=sp,
                               shard_residuals=res)
            want = JS.make_rules(jmesh, jcfg, kind, fsdp=fsdp, sp=sp,
                                 shard_residuals=res)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), \
                (arch, kind, fsdp, sp, res)
            for gb in (1, 2, 3, 16, 32, 128, 256, 512):
                assert dataclasses.asdict(S.prune_batch_axes(mesh, got, gb)) \
                    == dataclasses.asdict(JS.prune_batch_axes(jmesh, want,
                                                              gb))
            n += 1
    assert n == 10 * 3 * 8


def test_rules_for_spec_and_shard_shape(meshes):
    for fam, fsdp, sp in itertools.product(("dense", "ssm"), (False, True),
                                           (False, True)):
        assert dataclasses.asdict(S.rules_for(fam, fsdp=fsdp, sp=sp)) == \
            dataclasses.asdict(JS.rules_for(fam, fsdp=fsdp, sp=sp))
    rules = S.ShardingRules()
    assert rules.spec("batch", None, "heads") == \
        tuple(JS.ShardingRules().spec("batch", None, "heads"))
    mesh = meshes[True]
    sh = S.NamedSharding(mesh, (("pod", "data"), None, "model"))
    assert sh.shard_shape((256, 7, 4096)) == (8, 7, 256)
    with pytest.raises(ValueError, match="order"):
        S.NamedSharding(mesh, (("data", "pod"),)).placements
    with pytest.raises(ValueError, match="twice"):
        S.NamedSharding(mesh, ("model", "model")).placements
    with S.use_mesh(mesh):
        assert S.current_mesh() is mesh
        assert S.axis_size(("pod", "data")) == 32
        assert S.axis_size("model") == 16
    assert S.current_mesh() is None and S.axis_size("model") == 1


#: JAX's build_cell over every supported cell of both meshes: the rules
#: and the first device's argument bytes, sum over ``args`` of each
#: leaf's ``in_sh`` shard shape times its itemsize
_JAX_CELLS = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import json
import jax
import numpy as np
from jax.sharding import NamedSharding
from repro.configs.base import ARCH_IDS, SHAPES, cell_supported, get_config
from repro.launch import dryrun
from repro.launch.mesh import make_production_mesh

def leaf_bytes(sh, a):
    shape = a.shape if sh is None else sh.shard_shape(a.shape)
    return int(np.prod(shape, dtype=np.int64)) * np.dtype(a.dtype).itemsize

out = {}
for mp in (False, True):
    mesh = make_production_mesh(multi_pod=mp)
    for arch in ARCH_IDS:
        for shape in SHAPES:
            if not cell_supported(get_config(arch), SHAPES[shape])[0]:
                continue
            fn, args, in_sh, donate, rules, *_ = dryrun.build_cell(
                arch, shape, mesh)
            total = sum(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
                leaf_bytes, in_sh, args,
                is_leaf=lambda x: x is None or isinstance(x, NamedSharding))))
            out[f"{arch}|{shape}|{int(mp)}"] = dict(
                argument_bytes=int(total),
                rules={k: getattr(rules, k)
                       for k in rules.__dataclass_fields__})
print("RESULT::" + json.dumps(out))
"""


def _jax_cells() -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("REPRO_")}
    env.update(PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_JAX_CELLS)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [x for x in r.stdout.splitlines() if x.startswith("RESULT::")][-1]
    return json.loads(line[len("RESULT::"):])


def test_every_cell_matches_jax_build_cell(meshes, monkeypatch):
    for k in [k for k in os.environ if k.startswith("REPRO_")]:
        monkeypatch.delenv(k)
    want = _jax_cells()
    got = {}
    for mp in (False, True):
        D.fake_world(512 if mp else 256)
        mesh = meshes[mp]
        for arch, shape in itertools.product(B.ARCH_IDS, B.SHAPES):
            if not B.cell_supported(B.get_config(arch), B.SHAPES[shape])[0]:
                continue
            _, args, in_sh, _, rules, *_ = D.build_cell(arch, shape, mesh)
            got[f"{arch}|{shape}|{int(mp)}"] = dict(
                argument_bytes=D.argument_bytes(args, in_sh),
                rules=json.loads(json.dumps(rules.as_dict())))
    assert len(got) == 64
    assert got == want
