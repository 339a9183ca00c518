"""The port's autotuner (``repro_torch.tune``) against the JAX package's
(``repro.tune``) and on its own, on the CPU.

Against JAX: every ``sig_*`` gives JAX's ``key()`` string; the
(kernel, key, dtype) triples of ``plan_jobs(plan, batch=8)`` on a JAX plan
carried across by ``weights.plan_from_numpy`` equal JAX's for the four
served primitives with int8 and W4 weights; ``shapes_table2`` and
``shapes_smoke`` give ``scripts/tune.py``'s triples (the script is
imported here, never edited). On its own: the space (default first and a
member, analytic choice a member, non-members and launch-limit breaches
rejected), the cache (round trip, other schema and corrupt file ignored),
``get_config``'s memo -> cache -> analytic order, ``config=`` on every op,
``autotune`` on host tensors, and ``CompiledPlan`` with a planted cache
giving the untuned trunk bit for bit."""
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import tune as jtune  # noqa: E402
from repro.graph import build_cnn_graph as j_build  # noqa: E402
from repro.graph import lower as j_lower  # noqa: E402
from repro.models.convnet import CNNConfig as JCNNConfig  # noqa: E402
from repro.models.convnet import init_cnn as j_init_cnn  # noqa: E402

from repro_torch import kernels, tune  # noqa: E402
from repro_torch.graph import CompiledPlan, build_cnn_graph, lower  # noqa: E402
from repro_torch.kernels import ops as K  # noqa: E402
from repro_torch.models import CNNConfig, init_cnn  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402
from repro_torch.weights import plan_from_numpy  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_graph import plan_to_numpy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clean_tuner_state():
    """Each test starts from no cache and an empty memo, in both tuners."""
    tune.set_default_cache(tune.TuneCache(None))
    jtune.set_default_cache(jtune.TuneCache(None))
    yield
    tune.reset()
    jtune.reset()


def _jax_script():
    """``scripts/tune.py`` as a module (imported, not run, not edited)."""
    spec = importlib.util.spec_from_file_location(
        "repro_scripts_tune", ROOT / "scripts" / "tune.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------- against JAX ------

SIG_ARGS = [("sig_conv2d", (1, 8, 8, 4, 8, 3)),
            ("sig_conv2d", (2, 12, 12, 16, 16, 5, 4)),
            ("sig_depthwise2d", (1, 8, 8, 12, 3)),
            ("sig_shift_conv2d", (1, 8, 8, 8, 12)),
            ("sig_add_conv2d", (1, 6, 6, 4, 6, 3)),
            ("sig_causal_conv1d", (2, 96, 48, 4)),
            ("sig_matmul", (96, 64, 80)),
            ("sig_maxpool2d", (8, 32, 32, 64, 2, 2))]


@pytest.mark.parametrize("fn,args", SIG_ARGS, ids=str)
def test_shape_keys_equal_jax(fn, args):
    ours, theirs = getattr(tune, fn)(*args), getattr(jtune, fn)(*args)
    assert (ours.kernel, ours.key(), ours.dims) == \
        (theirs.kernel, theirs.key(), theirs.dims)


def _triples(jobs):
    return [(j[0], j[1].key(), str(j[3])) for j in jobs]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("prim", ["standard", "dws", "shift", "add"])
def test_plan_jobs_equal_jax(prim, bits):
    """The same JAX plan, carried across: the same (kernel, key, dtype)
    jobs in the same order, on the port's operands."""
    jcfg = JCNNConfig(primitive=prim, widths=(8, 12), image_size=16)
    jparams = j_init_cnn(jcfg, jax.random.PRNGKey(1))
    calib = (np.random.default_rng(2).standard_normal((4, 16, 16, 3)) * 0.5
             ).astype(np.float32)
    jplan = j_lower(j_build(jcfg), jparams, calib, weight_bits=bits)
    plan = plan_from_numpy(plan_to_numpy(jplan), jplan.in_fb, device="cpu")
    ours = tune.plan_jobs(plan, batch=8)
    assert _triples(ours) == _triples(jtune.plan_jobs(jplan, batch=8))
    assert {j[3] for j in ours} == ({"int8"} if bits == 8 else
                                    {"int8", "w4a8"})
    for kernel, sig, arrays, dtype, kwargs in ours:
        assert arrays[0].shape[0] == 8 and arrays[0].dtype == torch.int8
        assert ("w_shifts" in kwargs) == (dtype == "w4a8")


@pytest.mark.parametrize("shapes", ["shapes_table2", "shapes_smoke"])
def test_shape_sets_equal_scripts_tune(shapes):
    theirs = getattr(_jax_script(), shapes)()
    from repro_torch.tune.__main__ import SHAPE_SETS
    ours = SHAPE_SETS[shapes.split("_")[1]](device="cpu")
    assert _triples(ours) == _triples(theirs)
    for kernel, sig, arrays, dtype, *rest in ours:
        assert str(arrays[0].dtype) == f"torch.{dtype}"


# ------------------------------------------------------------- space ------

SIGS = [(tune.sig_conv2d(1, 10, 10, 128, 64, 3, 4), "float32"),
        (tune.sig_conv2d(256, 32, 32, 3, 16, 3), "int8"),
        (tune.sig_conv2d(256, 16, 16, 16, 32, 1), "w4a8"),
        (tune.sig_depthwise2d(1, 32, 32, 64, 3), "bfloat16"),
        (tune.sig_depthwise2d(256, 16, 16, 16, 3), "int8"),
        (tune.sig_add_conv2d(256, 8, 8, 32, 64, 3), "w4a8"),
        (tune.sig_shift_conv2d(8, 32, 32, 64, 64), "int8"),
        (tune.sig_add_conv2d(1, 10, 10, 16, 16, 3), "float32"),
        (tune.sig_maxpool2d(8, 32, 32, 64, 2, 2), "int8"),
        (tune.sig_causal_conv1d(2, 512, 256, 4), "float32"),
        (tune.sig_matmul(8, 896, 4864), "int8"),
        (tune.sig_matmul(64, 4864, 896), "w4a8"),
        (tune.sig_matmul(256, 512, 256), "float32"),
        (tune.sig_matmul(1, 45, 37), "bfloat16")]


@pytest.mark.parametrize("sig,dtype", SIGS,
                         ids=lambda v: v.key() if hasattr(v, "key") else v)
def test_space_default_first_analytic_member(sig, dtype):
    cands = list(tune.candidates(sig, dtype))
    default = tune.default_config(sig.kernel, sig, dtype)
    assert cands[0] == default and len(cands) >= 2
    keys = [tuple(sorted(tune.effective_config(sig, c, dtype).items()))
            for c in cands]
    assert len(keys) == len(set(keys)) == tune.space_size(sig, dtype)
    best = tune.analytic_config(sig, dtype)
    assert best in cands
    assert tune.analytic_config(sig, dtype) == best        # deterministic
    for c in cands:
        assert tune.check_config(sig, c, dtype) is c
        assert tune.estimate_s(sig, c, dtype) > 0


def test_space_knobs_and_defaults_are_todays_launches():
    from repro_torch.kernels.conv_dw import default_dw_tile
    from repro_torch.kernels.matmul_q8 import default_mmq_config
    # the integer add conv takes the float GEMM's tile (bp, q) and its
    # default; the depthwise conv its (pt, rows) tile in every mode
    asig = tune.sig_add_conv2d(1, 6, 6, 4, 6, 3)
    from repro_torch.kernels.conv_im2col import default_f_tile as dft
    for dt in ("int8", "w4a8"):
        assert tune.default_config("add_conv2d", asig, dt) == \
            dft(1, 6, 6, 4, 6, 3, 1)
        assert {(c["bp"], c["q"]) for c in tune.candidates(asig, dt)} == \
            {(bp, q) for bp in (32, 64, 128, 256) for q in (4, 8, 16)}
    dsig = tune.sig_depthwise2d(256, 16, 16, 16, 3)
    for dt, es in (("int8", 1), ("w4a8", 1), ("float32", 4),
                   ("bfloat16", 2)):
        assert tune.default_config("depthwise2d", dsig, dt) == \
            default_dw_tile(256, 16, 16, 16, 3, es)
        assert {(c["pt"], c["rows"]) for c in tune.candidates(dsig, dt)} \
            == {(pt, r) for pt in (1, 2, 4) for r in (1, 2, 4, 8)}
    # causal_conv1d's knobs are its vector path's run and its block size;
    # its default is the wrapper's, the cheapest config under the kernel's
    # fitted cost model, by the shape (a Falcon-Mamba prefill: runs of 4
    # in bf16, of 8 in float32, 64 threads); where D * elsize is off 16
    # bytes (the scalar path, no run) only the block size varies
    from repro_torch.kernels.conv1d_causal import default_c1d_config
    with pytest.raises(ValueError, match="pass sig"):
        tune.default_config("causal_conv1d")
    csig = tune.sig_causal_conv1d(1, 96, 8192, 4)
    assert tune.default_config("causal_conv1d", csig, "bfloat16") == \
        default_c1d_config(1, 96, 8192, 4, 2) == {"run": 4, "threads": 64}
    assert tune.default_config("causal_conv1d", csig, "float32") == \
        {"run": 8, "threads": 64}
    assert {(c["run"], c["threads"]) for c in tune.candidates(
        csig, "bfloat16")} == {(r, t) for r in (1, 2, 4, 8)
                               for t in (64, 128, 256)}
    ssig = tune.sig_causal_conv1d(2, 70, 300, 4)
    assert {(c["run"], c["threads"]) for c in tune.candidates(
        ssig, "bfloat16")} == {(8, t) for t in (64, 128, 256)}
    assert len(list(tune.candidates(ssig, "float32"))) == 12
    sig = tune.sig_matmul(8, 896, 4864)
    assert tune.default_config("matmul", sig, "int8") == \
        default_mmq_config(8, 896, 4864, 132) == \
        {"bn": 64, "bm": 8, "cluster": 1}
    from repro_torch.kernels.conv_im2col import default_tile
    from repro_torch.kernels.matmul_q8 import MMF_TILES, default_mmf_tile
    assert tune.default_config("matmul", tune.sig_matmul(64, 8, 8),
                               "float32") == default_mmf_tile(64, 8)
    # the float matmul has no K split: its knobs are the tile, every
    # instantiated tile a candidate; splits stay within the K stages
    fcands = list(tune.candidates(sig, "float32"))
    assert all(set(c) == {"bm", "bn", "tm", "tn"} for c in fcands)
    assert {tuple(c[k] for k in ("bm", "bn", "tm", "tn"))
            for c in fcands} == set(MMF_TILES)
    # the integer matmul's knobs are its tile (bn, bm) and cluster: every
    # instantiated tile no taller than M needs that fits a block's shared
    # memory, every cluster that leaves each warp a K stage (gate/up: 14
    # stages, 8 warps a decode block, no cluster; down: 76, up to 8); a
    # 128-column decode tile fits only in W4
    from repro_torch.kernels.matmul_q8 import MMQ_TILES
    for dt in ("int8", "w4a8"):
        wide = (128,) if dt == "w4a8" else ()
        icands = list(tune.candidates(sig, dt))
        assert all(set(c) == {"bn", "bm", "cluster"} for c in icands)
        assert {(c["bn"], c["bm"], c["cluster"]) for c in icands} == \
            {(bn, 8, 1) for bn in (32, 64) + wide}
        dsig = tune.sig_matmul(8, 4864, 896)
        assert {(c["bn"], c["bm"], c["cluster"])
                for c in tune.candidates(dsig, dt)} == \
            {(bn, 8, c) for bn in (32, 64) + wide for c in (1, 2, 4, 8)}
        psig = tune.sig_matmul(128, 896, 4864)
        assert {(c["bn"], c["bm"]) for c in tune.candidates(psig, dt)} == \
            set(MMQ_TILES) - ({(128, 8), (128, 16)} if not wide else set())
    # conv2d's knobs are its tile in every mode: the integer modes' implicit
    # GEMM and the float mode's take the same (bp, q) space, with their own
    # default tiles
    from repro_torch.kernels.conv_im2col import default_f_tile
    csig = tune.sig_conv2d(256, 32, 32, 3, 16, 3)
    for dt in ("int8", "w4a8", "float32", "bfloat16"):
        tile = default_tile if dt in ("int8", "w4a8") else default_f_tile
        assert tune.default_config("conv2d", csig, dt) == \
            tile(256, 32, 32, 3, 16, 3, 1)
        assert {(c["bp"], c["q"]) for c in tune.candidates(csig, dt)} == \
            {(bp, q) for bp in (32, 64, 128, 256) for q in (4, 8, 16)}
    assert tune.default_config("conv2d", csig, "float32") == \
        {"bp": 128, "q": 16}
    with pytest.raises(ValueError, match="pass sig"):
        tune.default_config("conv2d")


@pytest.mark.parametrize("sig,dtype,bad,match", [
    (tune.sig_conv2d(1, 8, 8, 4, 8, 3), "int8", {"bp": 96, "q": 16},
     "outside"),
    (tune.sig_conv2d(1, 8, 8, 4, 8, 3), "int8", {"bp": 512, "q": 16},
     "cannot launch"),
    (tune.sig_conv2d(1, 8, 8, 4, 8, 3), "int8", {"block_co": 8}, "unknown"),
    (tune.sig_matmul(8, 64, 64), "float32", {"splits": 2}, "unknown"),
    (tune.sig_matmul(8, 64, 64), "int8", {"bn": 48}, "cannot launch"),
    (tune.sig_matmul(8, 4864, 896), "int8", {"bm": 64}, "outside"),
    (tune.sig_matmul(8, 4864, 896), "w4a8", {"cluster": 16},
     "cannot launch"),
    (tune.sig_matmul(8, 896, 4864), "int8", {"cluster": 4}, "outside"),
    (tune.sig_matmul(8, 4864, 896), "int8", {"splits": 3}, "unknown"),
    (tune.sig_causal_conv1d(1, 16, 64, 4), "float32", {"threads": 512},
     "cannot launch"),
    (tune.sig_causal_conv1d(1, 16, 64, 4), "float32", {"run": 3},
     "cannot launch"),
    (tune.sig_causal_conv1d(1, 16, 64, 4), "float32", {"block": 64},
     "unknown"),
    (tune.sig_causal_conv1d(1, 16, 100, 4), "bfloat16", {"run": 1},
     "outside"),
])
def test_check_config_rejects_non_members(sig, dtype, bad, match):
    with pytest.raises(ValueError, match=match):
        tune.check_config(sig, bad, dtype)


def test_unknown_kernel_rejected():
    with pytest.raises(ValueError, match="unknown kernel"):
        tune.ShapeSig("conv3d", (("n", 1),))


# ------------------------------------------------------------- cache ------

def test_cache_roundtrip_keeps_unknown_fields(tmp_path):
    p = tmp_path / "c.json"
    c = tune.TuneCache(None)
    key = tune.cache_key("conv2d", "n1", "int8", "cpu")
    c.put(key, {"threads": 128}, us=1.5, source="measured", note="x")
    c.save(str(p))
    blob = json.loads(p.read_text())
    assert blob["schema_version"] == tune.SCHEMA_VERSION
    c2 = tune.TuneCache(str(p))
    assert not c2.stale and len(c2) == 1
    assert c2.get(key) == {"config": {"threads": 128}, "us": 1.5,
                           "source": "measured", "note": "x"}


def test_cache_other_schema_is_ignored(tmp_path):
    p = tmp_path / "c.json"
    p.write_text(json.dumps({"schema_version": 999, "entries": {
        "k": {"config": {"threads": 64}}}}))
    c = tune.TuneCache(str(p))
    assert c.stale and len(c) == 0


def test_cache_of_the_threads_space_is_stale_not_an_error(tmp_path):
    """A v1 cache, written when the integer conv2d took threads and the
    float matmul bm, is ignored as stale: lookups fall back to the analytic
    model instead of raising in check_config."""
    assert tune.SCHEMA_VERSION == 7
    sig = tune.sig_conv2d(8, 16, 16, 16, 32, 3)
    key = tune.cache_key("conv2d", sig.key(), "int8", "cpu")
    p = tmp_path / "v1.json"
    p.write_text(json.dumps({"schema_version": 1, "entries": {
        key: {"config": {"threads": 64}, "us": 1.0,
              "source": "measured"}}}))
    c = tune.TuneCache(str(p))
    assert c.stale and len(c) == 0
    tune.set_default_cache(c)
    assert tune.get_config(sig, "int8", "cpu") == \
        tune.analytic_config(sig, "int8")


def test_cache_of_the_shift_threads_space_is_stale(tmp_path):
    """A v2 cache, written when shift_conv2d took threads, is ignored as
    stale: its shift entries are never applied to the (bp, q) space."""
    sig = tune.sig_shift_conv2d(8, 32, 32, 64, 64)
    key = tune.cache_key("shift_conv2d", sig.key(), "int8", "cpu")
    p = tmp_path / "v2.json"
    p.write_text(json.dumps({"schema_version": 2, "entries": {
        key: {"config": {"threads": 128}, "us": 1.0,
              "source": "measured"}}}))
    c = tune.TuneCache(str(p))
    assert c.stale and len(c) == 0
    tune.set_default_cache(c)
    assert set(tune.get_config(sig, "int8", "cpu")) == {"bp", "q"}


def test_cache_of_the_float_threads_space_is_stale(tmp_path):
    """A v3 cache, written when the float conv2d and the float add_conv2d
    took threads, is ignored as stale: its entries are never applied to
    their (bp, q) space, and a lookup gives a tile."""
    csig = tune.sig_conv2d(1, 10, 10, 128, 64, 3, 1)
    asig = tune.sig_add_conv2d(1, 10, 10, 16, 16, 3)
    keys = [tune.cache_key(s.kernel, s.key(), "float32", "cpu")
            for s in (csig, asig)]
    p = tmp_path / "v3.json"
    p.write_text(json.dumps({"schema_version": 3, "entries": {
        k: {"config": {"threads": 512}, "us": 1.0, "source": "measured"}
        for k in keys}}))
    c = tune.TuneCache(str(p))
    assert c.stale and len(c) == 0
    tune.set_default_cache(c)
    for sig in (csig, asig):
        cfg = tune.get_config(sig, "float32", "cpu")
        assert set(cfg) == {"bp", "q"}
        assert tune.check_config(sig, cfg, "float32") is cfg


def test_cache_of_the_depthwise_and_integer_add_threads_is_stale(tmp_path):
    """A v4 cache, written when depthwise2d and the integer add_conv2d
    took threads, is ignored as stale: its entries are never applied to
    their tile spaces, and a lookup gives a tile."""
    dsig = tune.sig_depthwise2d(256, 16, 16, 16, 3)
    asig = tune.sig_add_conv2d(256, 8, 8, 32, 64, 3)
    keys = [tune.cache_key(s.kernel, s.key(), dt, "cpu")
            for s in (dsig, asig) for dt in ("int8", "w4a8")]
    p = tmp_path / "v4.json"
    p.write_text(json.dumps({"schema_version": 4, "entries": {
        k: {"config": {"threads": 512}, "us": 1.0, "source": "measured"}
        for k in keys}}))
    c = tune.TuneCache(str(p))
    assert c.stale and len(c) == 0
    tune.set_default_cache(c)
    for sig, knobs in ((dsig, {"pt", "rows"}), (asig, {"bp", "q"})):
        for dt in ("int8", "w4a8"):
            cfg = tune.get_config(sig, dt, "cpu")
            assert set(cfg) == knobs
            assert tune.check_config(sig, cfg, dt) is cfg


def test_cache_of_the_integer_matmul_split_space_is_stale(tmp_path):
    """A v5 cache, written when the integer matmul took a tile height and
    a K split (bm, splits), is ignored as stale: a lookup gives the new
    (bn, bm, cluster) space's config."""
    sig = tune.sig_matmul(8, 896, 4864)
    keys = [tune.cache_key("matmul", sig.key(), dt, "cpu")
            for dt in ("int8", "w4a8")]
    p = tmp_path / "v5.json"
    p.write_text(json.dumps({"schema_version": 5, "entries": {
        k: {"config": {"bm": 16, "splits": 28}, "us": 1.0,
            "source": "measured"} for k in keys}}))
    c = tune.TuneCache(str(p))
    assert c.stale and len(c) == 0
    tune.set_default_cache(c)
    for dt in ("int8", "w4a8"):
        cfg = tune.get_config(sig, dt, "cpu")
        assert set(cfg) == {"bn", "bm", "cluster"}
        assert tune.check_config(sig, cfg, dt) is cfg


def test_cache_of_the_conv1d_threads_space_is_stale(tmp_path):
    """A v6 cache, written when causal_conv1d took only threads, is ignored
    as stale: a lookup gives the new (run, threads) space's config, the
    analytic one, which is the wrapper's default."""
    sig = tune.sig_causal_conv1d(1, 96, 8192, 4)
    key = tune.cache_key("causal_conv1d", sig.key(), "bfloat16", "cpu")
    p = tmp_path / "v6.json"
    p.write_text(json.dumps({"schema_version": 6, "entries": {
        key: {"config": {"threads": 256}, "us": 1.0,
              "source": "measured"}}}))
    c = tune.TuneCache(str(p))
    assert c.stale and len(c) == 0
    tune.set_default_cache(c)
    cfg = tune.get_config(sig, "bfloat16", "cpu")
    assert cfg == tune.default_config("causal_conv1d", sig, "bfloat16") \
        == tune.analytic_config(sig, "bfloat16")
    assert tune.check_config(sig, cfg, "bfloat16") is cfg


def test_cache_corrupt_file_is_ignored(tmp_path):
    p = tmp_path / "c.json"
    p.write_text("{not json")
    before = metrics.counter("tune.cache.load_failed").value
    with pytest.warns(RuntimeWarning, match="unreadable"):
        c = tune.TuneCache(str(p))
    assert c.stale and len(c) == 0
    assert metrics.counter("tune.cache.load_failed").value == before + 1


def test_cache_load_fault_seam_degrades_to_analytic(tmp_path):
    from repro_torch.faults.inject import FaultPlan, FaultSpec
    p = tmp_path / "c.json"
    tune.TuneCache(None).save(str(p))
    with FaultPlan([FaultSpec("tune.cache_load", "raise")]):
        with pytest.warns(RuntimeWarning, match="unreadable"):
            c = tune.TuneCache(str(p))
    assert c.stale


def test_default_cache_comes_from_the_env_var_only(tmp_path, monkeypatch):
    p = tmp_path / "c.json"
    sig = tune.sig_conv2d(1, 8, 8, 4, 8, 3)
    c = tune.TuneCache(None)
    c.put(tune.cache_key("conv2d", sig.key(), "int8", "cpu"),
          {"threads": 64})
    c.save(str(p))
    tune.reset()
    monkeypatch.delenv(tune.ENV_VAR, raising=False)
    assert tune.get_default_cache().path is None       # no default file
    tune.reset()
    monkeypatch.setenv(tune.ENV_VAR, str(p))
    assert tune.get_default_cache().path == str(p)
    assert tune.get_config(sig, "int8", "cpu") == {"threads": 64}


# -------------------------------------------------------- get_config ------

def test_get_config_memo_then_cache_then_analytic():
    sig = tune.sig_conv2d(1, 10, 10, 128, 64, 3, 1)
    hit = metrics.counter("tune.cache.hit")
    fallback = metrics.counter("tune.cache.analytic_fallback")
    h0, f0 = hit.value, fallback.value
    # no entry: the analytic choice, counted, then memoized
    assert tune.get_config(sig, "float32", "cpu") == \
        tune.analytic_config(sig, "float32")
    assert fallback.value == f0 + 1
    tune.get_config(sig, "float32", "cpu")
    assert fallback.value == f0 + 1 and hit.value == h0
    # a planted entry wins over the analytic model
    c = tune.TuneCache(None)
    c.put(tune.cache_key("conv2d", sig.key(), "float32", "cpu"),
          {"bp": 64, "q": 8})
    tune.set_default_cache(c)
    assert tune.get_config(sig, torch.float32, "cpu") == {"bp": 64, "q": 8}
    assert hit.value == h0 + 1
    # memoized: a later change to the cache is not re-read
    c.put(tune.cache_key("conv2d", sig.key(), "float32", "cpu"),
          {"bp": 32, "q": 4})
    assert tune.get_config(sig, "float32", "cpu") == {"bp": 64, "q": 8}
    assert hit.value == h0 + 1


def test_get_config_keys_on_the_backend():
    """Host lookups carry the "cpu" tag: an entry for a card is never
    consumed on the host (nor the other way round)."""
    sig = tune.sig_conv2d(1, 8, 8, 4, 8, 3)
    c = tune.TuneCache(None)
    c.put(tune.cache_key("conv2d", sig.key(), "int8",
                         "cuda:NVIDIA_H100_80GB_HBM3:sm90"), {"threads": 64})
    tune.set_default_cache(c)
    assert tune.backend_tag("cpu") == "cpu"
    assert tune.get_config(sig, "int8", "cpu") == \
        tune.analytic_config(sig, "int8")


# ------------------------------------------------------------ config= ------

def _op_args():
    rng = np.random.default_rng(5)
    x8 = torch.from_numpy(rng.integers(-100, 100, (2, 8, 8, 8))
                          .astype(np.int8))
    w = torch.from_numpy(rng.integers(-100, 100, (3, 3, 8, 4))
                         .astype(np.int8))
    table = torch.zeros((8, 2), dtype=torch.int32)
    return {
        "conv2d": ((x8, w), dict(requant_shift=7), {"bp": 64, "q": 8}),
        "depthwise2d": ((x8, w[..., 0]), dict(requant_shift=7),
                        {"pt": 2, "rows": 4}),
        "shift_conv2d": ((x8, table, w[0, 0]), dict(requant_shift=7),
                         {"bp": 32, "q": 4}),
        "add_conv2d": ((x8, w), dict(requant_shift=9), {"bp": 64, "q": 8}),
        "maxpool2d": ((x8,), {}, {"threads": 64}),
        "matmul": ((x8.reshape(128, 8), w[0, 0]), dict(requant_shift=7),
                   {"bn": 32, "bm": 64, "cluster": 1}),
        "causal_conv1d": ((torch.randn(2, 16, 8), torch.randn(4, 8)), {},
                          {"threads": 256}),
    }


@pytest.mark.parametrize("op", list(_op_args()))
def test_config_with_torch_method_raises(op):
    args, kw, cfg = _op_args()[op]
    with pytest.raises(ValueError, match="config"):
        getattr(K, op)(*args, method="torch", config=cfg, **kw)


@pytest.mark.parametrize("op", list(_op_args()))
def test_explicit_config_checked_and_output_unchanged(op):
    """A member config runs (the plain version on the host) with the
    default's output; a non-member raises before anything runs."""
    args, kw, cfg = _op_args()[op]
    fn = getattr(K, op)
    assert torch.equal(fn(*args, config=cfg, **kw), fn(*args, **kw))
    bad = {"bm": 48} if op == "matmul" else {"threads": 48}
    with pytest.raises(ValueError):
        fn(*args, config=bad, **kw)


def test_qconv_apply_configs_only_under_cuda():
    from repro_torch.core.primitives import ConvSpec
    from repro_torch.core.qconv import qconv_apply
    from repro_torch.core.quantize import QTensor
    spec = ConvSpec(primitive="standard", in_channels=4, out_channels=4,
                    kernel_size=3)
    x = QTensor(torch.zeros((1, 4, 4, 4), dtype=torch.int8), 5)
    qp = {"w": QTensor(torch.ones((3, 3, 4, 4), dtype=torch.int8), 5)}
    cfg = {"main": {"bp": 64, "q": 8}}
    with pytest.raises(ValueError, match="configs"):
        qconv_apply(qp, x, spec, 4, method="torch", configs=cfg)
    y = qconv_apply(qp, x, spec, 4, method="cuda", configs=cfg)
    assert torch.equal(y.q, qconv_apply(qp, x, spec, 4, method="torch").q)


# ----------------------------------------------------------- autotune ------

def test_autotune_on_host_records_best_and_default(tmp_path):
    from repro_torch.obs import trace
    sig = tune.sig_conv2d(1, 6, 6, 4, 8, 3)
    x = torch.randn(1, 6, 6, 4)
    w = torch.randn(3, 3, 4, 8)
    trace.clear()
    trace.enable()
    try:
        cache = tune.TuneCache(None)
        best, best_us = tune.autotune_into(cache, "conv2d", sig, (x, w),
                                           "float32", reps=1, warmup=0)
    finally:
        trace.disable()
    entry = cache.get(tune.cache_key("conv2d", sig.key(), "float32", "cpu"))
    assert entry["config"] == best and entry["us"] == best_us > 0
    assert entry["default_us"] > 0 and entry["source"] == "measured"
    assert entry["n_candidates"] == tune.space_size(sig, "float32")
    spans = [e for e in trace.TRACER.events()
             if e["name"] == "tune.candidate"]
    assert len(spans) == 2 * entry["n_candidates"]
    assert all("us" in e["args"] for e in spans if e["ph"] == "E")
    cache.save(str(tmp_path / "c.json"))
    assert len(tune.TuneCache(str(tmp_path / "c.json"))) == 1


def test_tune_main_on_host_writes_a_cache(tmp_path, capsys):
    from repro_torch.tune.__main__ import main
    out = tmp_path / "t.json"
    cache = main(["--shapes", "smoke", "--device", "cpu", "--out", str(out),
                  "--reps", "1", "--warmup", "0", "--kernels",
                  "conv2d,matmul", "--max-candidates", "2"])
    printed = capsys.readouterr().out
    assert "backend=cpu" in printed and "speedup=" in printed
    blob = json.loads(out.read_text())
    assert len(blob["entries"]) == len(cache) == 4
    assert all(k.endswith("|cpu") for k in blob["entries"])


# ------------------------------------------------------ CompiledPlan ------

@pytest.fixture(scope="module", params=[("dws", 8), ("shift", 4)], ids=str)
def host_plan(request):
    prim, bits = request.param
    cfg = CNNConfig(primitive=prim, widths=(8, 12), image_size=16)
    params = init_cnn(cfg, torch.Generator().manual_seed(3), device="cpu")
    rng = np.random.default_rng(4)
    calib = torch.from_numpy((rng.standard_normal((4, 16, 16, 3)) * 0.5)
                             .astype(np.float32))
    plan = lower(build_cnn_graph(cfg), params, calib, weight_bits=bits)
    x = (rng.standard_normal((5, 16, 16, 3)) * 0.5).astype(np.float32)
    return plan, x


def test_planted_cache_plan_trunk_equals_untuned(host_plan, tmp_path):
    """Every job of the plan tuned on the host into a cache, the cache
    installed: the trunk is bitwise the untuned one, and each node's
    configs came from the cache."""
    plan, x = host_plan
    want = CompiledPlan(plan, method="cuda", device="cpu").trunk(x)
    cache = tune.TuneCache(None)
    tune.autotune_plan(cache, plan, batch=8, reps=1, warmup=0,
                       max_candidates=2)
    path = tmp_path / "c.json"
    cache.save(str(path))
    tune.set_default_cache(tune.TuneCache(str(path)))
    hits = metrics.counter("tune.cache.hit").value
    ex = CompiledPlan(plan, method="cuda", device="cpu")
    got = ex.trunk(x)                    # batch 5 -> bucket 8 in forward_b.
    got_b = ex.forward_batch(x)
    assert torch.equal(got.q, want.q)
    assert torch.isfinite(got_b).all()
    assert metrics.counter("tune.cache.hit").value > hits
    qconv = [n.name for n in plan.nodes if n.op == "qconv"]
    assert set(ex.node_configs) == set(qconv)
    for name, cfgs in ex.node_configs.items():
        # the convs' knobs are their (bp, q) tile, the depthwise conv's
        # its (pt, rows) tile
        assert all(set(c) in ({"bp", "q"}, {"pt", "rows"})
                   for c in cfgs.values())


def test_plan_configs_resolved_once_per_node_and_bucket(host_plan):
    plan, x = host_plan
    ex = CompiledPlan(plan, method="cuda", device="cpu")
    misses = metrics.counter("tune.memo.miss")
    ex.forward_batch(x)
    m0 = misses.value
    ex.forward_batch(x)
    ex.forward_batch(x[:3])               # bucket 4: new lookups
    assert misses.value > m0
    m1 = misses.value
    ex.forward_batch(x[:4])
    assert misses.value == m1
    assert {k[1] for k in ex._configs} == {4, 8}


def test_plan_validate_rejects_a_bad_cached_config(host_plan):
    """validate=True checks every config a node resolves (a cache entry
    outside the space raises, naming the node); with validate=False the
    op that receives it checks it as an explicit config."""
    plan, x = host_plan
    node = next(n for n in plan.nodes if n.op == "qconv")
    h, w = node.attrs["in_hw"]
    c = tune.TuneCache(None)
    sig = tune.sig_conv2d(8, h, w, node.spec.in_channels,
                          node.spec.out_channels, node.spec.kernel_size)
    from repro_torch.graph.executor import _node_dtype
    c.put(tune.cache_key("conv2d", sig.key(), _node_dtype(node), "cpu"),
          {"bp": 512, "q": 16})
    tune.set_default_cache(c)
    with pytest.raises(ValueError, match="node 'conv0'.*bp"):
        CompiledPlan(plan, method="cuda", device="cpu").forward_batch(x)
    with pytest.raises(ValueError, match="cannot launch"):
        CompiledPlan(plan, method="cuda", device="cpu",
                     validate=False).forward_batch(x)


def test_plan_throughput_reports_images_per_s(host_plan):
    plan, x = host_plan
    r = CompiledPlan(plan, method="torch", device="cpu").throughput(
        x, reps=2, warmup=1)
    assert r["batch"] == 5 and r["bucket"] == 8
    assert r["images_per_s"] == pytest.approx(5e6 / r["us_per_batch"])
    assert r["images_per_s"] > 0


def test_torch_method_plan_resolves_no_config(host_plan):
    plan, x = host_plan
    ex = CompiledPlan(plan, method="torch", device="cpu")
    ex.trunk(x)
    assert ex.node_configs == {}
    kernels.reset_launches()


# --------------------------------------------------------- device timer ------

class _Row:
    def __init__(self, key, count, us):
        self.device_type = torch.autograd.DeviceType.CUDA
        self.key, self.count, self.self_device_time_total = key, count, us


def _fake_profiler(monkeypatch, sessions):
    """torch.profiler.profile replaced by sessions that record the given
    ``{kernel: (records, us)}`` in turn (the card's lossy sessions)."""
    import torch.profiler as tp
    from repro_torch.tune import runner
    seq = iter(sessions)

    class Session:
        def __init__(self, **kw):
            pass

        def __enter__(self):
            self.rows = next(seq)
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return [_Row(k, n, us) for k, (n, us) in self.rows.items()]

    monkeypatch.setattr(tp, "profile", Session)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(runner.time, "sleep", lambda s: None)


def test_device_us_fills_in_lost_records(monkeypatch):
    """An empty session is run again; records a session lost are filled in
    at the kernel's mean time per record, its launches per call being the
    most any session saw, rounded up to a whole number (20 calls: 2
    launches of "a" at 3 us, 1 of "b" at 10 us a call)."""
    _fake_profiler(monkeypatch, [
        {},
        {"a": (28, 84.0), "b": (20, 200.0)},      # lost 12 records of "a"
        {"a": (40, 120.0), "b": (13, 130.0)}])    # lost 7 of "b"
    lost = metrics.counter("tune.profile.lost_sessions")
    l0 = lost.value
    rows = tune.device_kernels(lambda: None, calls=20)
    assert [(r.key, r.launches) for r in rows] == [("a", 2.0), ("b", 1.0)]
    assert [r.us for r in rows] == pytest.approx([6.0, 10.0])
    assert lost.value == l0 + 3
    _fake_profiler(monkeypatch, [{"a": (20, 60.0)}, {"a": (20, 60.0)}])
    assert tune.device_us(lambda: None, reps=5) == pytest.approx(3.0)
    # both sessions lost about half the records of a one-launch kernel
    _fake_profiler(monkeypatch, [{"k": (11, 55.0)}, {"k": (12, 60.0)}])
    assert tune.device_us(lambda: None, reps=20) == pytest.approx(5.0)


def test_device_us_raises_when_sessions_record_nothing(monkeypatch):
    from repro_torch.tune import runner
    _fake_profiler(monkeypatch, [{}] * (runner.PROFILE_TRIES - 1)
                   + [{"a": (20, 1.0)}])
    with pytest.raises(RuntimeError, match="recorded device activity"):
        tune.device_us(lambda: None, reps=20)
