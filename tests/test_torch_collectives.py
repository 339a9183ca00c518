"""The dry run's collective count on the CPU: ``roofline.count`` records
every collective a sharded step makes (``parallel.sharding``'s helpers:
JAX's kind name, the operand's bytes on the rank, the group's mesh axes).

* For each of the six families' reduced cases of
  ``tests/test_torch_sharded_train.py``, one FSDP + TP train step on a
  (2, 2, 2) ("pod", "data", "model") mesh: rank 0's count on meta tensors
  over ``torch.distributed``'s fake backend (the dry run's way,
  ``launch.dryrun.count_step``) equals, call by call, the count rank 0 of
  a world of 8 gloo processes records on real tensors.
* The dense case's bytes equal a reckoning by hand from its rules.
* ``launch.dryrun.run_cell`` on a reduced config at 16x16 and 2x16x16:
  the records pass ``record_faults``, the checks ``chip_smoke.py`` phase
  13 makes of the whole sweep.

Run here with ``PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q
tests/test_torch_collectives.py``.
"""
import collections
import dataclasses
import importlib.util
import json

import pytest

torch = pytest.importorskip("torch")
if importlib.util.find_spec("jax") is None:      # the shared cases' module
    pytest.skip("needs jax for the shared cases", allow_module_level=True)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.parallel import sharding as S  # noqa: E402
from test_torch_sharded_train import (BATCH, FAMILIES, MESH,  # noqa: E402
                                      SEQ, _batches, _f32, _rows, _rules,
                                      _tcfg)

TIMEOUT = 300


def _mesh():
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(*MESH, device_type="cpu")


def _count(mesh, cfg, params, batch) -> list:
    """``(kind, bytes, axes)`` of every collective of this rank's FSDP + TP
    train step on its blocks of ``params`` (global tensors, real or meta)
    and its rows of ``batch``, in call order."""
    from repro_torch.optim import init_opt_state
    from repro_torch.train import make_train_step
    with S.use_mesh(mesh), S.use_rules(_rules(mesh, cfg)):
        psh = S.tree_shardings(api.param_specs(cfg))
        p = S.local_tree(params, psh, copy=True)
        opt = init_opt_state(p, _tcfg().opt)
        _, c = D.count_step(make_train_step(cfg, _tcfg()),
                            (p, opt, _rows(batch)), flops=False)
    return [(x.kind, x.nbytes, x.axes) for x in c.collectives]


def _rank(rank):
    """Every family's count on this rank of the gloo world, real
    tensors."""
    mesh = _mesh()
    out = {}
    for fam, (arch, kw) in FAMILIES.items():
        cfg = _f32(arch, kw)
        params = api.init_params(cfg, torch.Generator().manual_seed(3),
                                 device="cpu")
        out[fam] = _count(mesh, cfg, params, _batches(cfg, 4, 1)[0])
    return out


@pytest.fixture(scope="module")
def counts():
    """(rank 0's counts on the gloo world, rank 0's counts on meta tensors
    over an 8-rank fake world), by family."""
    import torch.distributed as dist
    from repro_torch.launch.world import run_world
    world = run_world(_rank, 8, device_type="cpu", timeout=TIMEOUT)
    D.fake_world(8)
    try:
        mesh = _mesh()
        fake = {}
        for fam, (arch, kw) in FAMILIES.items():
            cfg = _f32(arch, kw)
            batch = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                     for k, v in _batches(cfg, 4, 1)[0].items()}
            fake[fam] = _count(mesh, cfg, api.param_structs(cfg), batch)
    finally:
        dist.destroy_process_group()
    return world.results[0], fake


@pytest.mark.parametrize("family", list(FAMILIES))
def test_meta_count_equals_the_gloo_worlds(counts, family):
    """Rank 0's collectives on meta tensors over the fake backend are
    those rank 0 of the gloo world makes on real tensors: the same kinds,
    bytes and axes, call by call."""
    real, fake = counts
    assert fake[family] == real[family]
    assert fake[family], family


def _dense_reckoning() -> collections.Counter:
    """Rank 0's collective bytes of one FSDP + TP step of the dense case
    (granite-34b reduced: 2 layers, d 32, 4 query heads of 8 and 1
    key/value head, gelu FFN 64, vocabulary 128, untied; float32) on the
    (2, 2, 2) mesh, by (kind, axes), from its rules: the batch over
    ("pod", "data"), heads, FFN and vocabulary over "model" (the single
    key/value head stays whole), every weight's embed dim over ("pod",
    "data")."""
    f = 4                                   # float32 bytes
    d, layers, v, ff, dh = 32, 2, 128, 64, 8
    rows = BATCH // 4                       # rows a rank
    act = rows * SEQ * d * f                # one (rows, S, d) activation
    dp, mp, every = ("pod", "data"), ("model",), ("pod", "data", "model")
    # a rank's block of a layer's weights: embed dims / 4, heads and FFN
    # / 2; wq (8, 16), wk and wv (8, 8), wo (16, 8), w_up (8, 32), w_down
    # (32, 8); and of the tables, (64, 8) and (8, 64)
    layer = (d // 4) * (4 * dh // 2) + 2 * (d // 4) * dh \
        + (4 * dh // 2) * (d // 4) + 2 * (d // 4) * (ff // 2)
    tables = 2 * (v // 2) * (d // 4)
    want = collections.Counter()
    # FSDP: the tables gathered once a step, each layer in its forward and
    # again in its recompute; the backward reduce-scatters the gathered
    # gradients, every rank's block of them (4 ranks)
    want["all-gather", dp] += f * (tables + 2 * layers * layer)
    want["reduce-scatter", dp] += f * 4 * (tables + layers * layer)
    # TP: the vocabulary-split lookup and its backward; a layer's
    # attention and FFN outputs in the forward and the backward, and the
    # attention's again in the recompute (torch's checkpoint stops its
    # recompute at the last tensor the backward keeps: nothing keeps the
    # FFN's summed output)
    want["all-reduce", mp] += act * (2 + layers * (2 + 2 + 1))
    # the loss, one chunk of S positions: the logsumexp's max, its sum of
    # exponentials and the label's logit, (rows, S) each, in the forward
    # and in the chunk's recompute, and the two sums' backward
    want["all-reduce", mp] += rows * SEQ * f * (3 + 3 + 2)
    # the nll, z and label-count sums over the batch's ranks, and back
    want["all-reduce", dp] += 3 * f * 2
    # gradients summed over the ranks that hold copies: the norms' over
    # every axis (final_norm, then ln1 and ln2 of each layer), wk and wv
    # over "model"
    want["all-reduce", every] += f * (d + 2 * layers * d)
    want["all-reduce", mp] += f * 2 * layers * (d // 4) * dh
    # the global norm: a sum of squares a leaf, over the axes that split
    # it: embed, unembed, wq, wo, w_up, w_down over every axis, wk and wv
    # over ("pod", "data")
    want["all-reduce", every] += f * 6
    want["all-reduce", dp] += f * 2
    return want


def test_dense_bytes_match_a_hand_reckoning(counts):
    """The dense case's count, summed by kind and axes, is what its
    rules make of it by hand (:func:`_dense_reckoning`)."""
    got = collections.Counter()
    for kind, nbytes, axes in counts[1]["dense"]:
        got[kind, axes] += nbytes
    assert got == _dense_reckoning()


def test_records_pass_the_launch_phase_checks(tmp_path, monkeypatch):
    """``run_cell`` on qwen2-0.5b cut to tests/test_arch_smoke.py's sizes,
    train_4k at 16x16 and 2x16x16: both ok, with collectives under the
    cell's rules; none crosses a pod at 16x16, and at 2x16x16, where FSDP
    spans "pod", some do; ``record_faults`` finds nothing."""
    import torch.distributed as dist
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), n_layers=2,
                              d_model=64, n_heads=4, n_kv_heads=2,
                              d_ff=128, vocab=256)
    monkeypatch.setattr(D, "get_config", lambda arch: cfg)
    monkeypatch.setattr(D, "_RUNS", {})
    try:
        recs = [D.run_cell("qwen2-0.5b", "train_4k", mp, str(tmp_path))
                for mp in (False, True)]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    recs = [json.loads(json.dumps(r, default=list)) for r in recs]
    assert D.record_faults(recs) == []
    single, multi = (r["collectives"] for r in recs)
    assert single["step_rules"] == multi["step_rules"] == "cell"
    assert single["bytes_cross_pod"] == 0 < single["bytes_in_pod"]
    assert multi["bytes_cross_pod"] > 0 and "pod" in recs[1]["rules"]["embed"]
    assert set(single["by_kind"]) == {"all-reduce", "all-gather",
                                      "reduce-scatter"}
