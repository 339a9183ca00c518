"""The launch arithmetic around the port's tiled kernels, on the CPU: the
integer conv's implicit-GEMM tiles (``kernels.conv_im2col.conv_plan``),
the float conv's and every add conv mode's (``conv_f_plan``,
``conv_add.add_f_plan``), the shift conv's (``conv_shift.shift_plan``,
``shift_f_plan``), the depthwise conv's staged rows
(``kernels.conv_dw.dw_plan``), the float matmul's register tiles
(``kernels.matmul_q8.mmf_plan``), the integer matmul's tiles and clusters
(``mmq_plan``), the int8 and float pools' vector or scalar launches
(``kernels.pool.pool_plan``, ``pool_f_plan``) and the causal conv1d's
(``kernels.conv1d_causal.c1d_plan``), their default tiles, the wrappers' checks of
the tile knobs, and the tuner's Hopper footprint check
(``tune.launch_errors``). The CUDA sources compute the same arithmetic
themselves; ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the
two equal on the card."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tune  # noqa: E402
from repro_torch.core.quantize import pack_w4  # noqa: E402

C = importlib.import_module("repro_torch.kernels.conv_im2col")
M = importlib.import_module("repro_torch.kernels.matmul_q8")


# (shape, bp, q) -> (grid, threads, k_words, window, smem, block channels),
# counted by hand from the kernel's layout (a block of fewer than 128
# threads padded to 128 that only stage): the window (rows spanned + HK-1)
# x (columns + HK-1) x a pixel's bytes (Cx/g, + 4 where Cx/g is a multiple
# of 4), then 4-byte words of the K chunk's im2col tile, its filter tile,
# its K offsets and the block's pixel bases
CONV_PLANS = [
    # the dws stem: 8 rows of 32 a block, K = 27 -> 7 words
    ((256, 32, 32, 3, 16, 3, 1), 256, 16,
     ((1024, 1), 128, 7, 1024, 1024 + 4 * (7 * 256 + 7 * 16 + 28 + 256),
      16)),
    # pw1: HK = 1 runs as one row of 65,536 pixels
    ((256, 16, 16, 16, 32, 1, 1), 128, 16,
     ((512, 1), 128, 4, 128 * 20, 128 * 20 + 4 * (4 * 128 + 4 * 32 + 16
                                                  + 128), 32)),
    # Table-2, g = 4: a 32-pixel run spans at most 5 rows of 10
    ((1, 10, 10, 128, 64, 3, 4), 32, 16,
     ((4, 4), 128, 72, 7 * 12 * 36, 3024 + 4 * (32 * 32 + 32 * 16 + 128
                                               + 32), 16)),
    # odd Cx = 5: bytes, no pad; runs of 64 span at most 6 rows of 13
    ((2, 15, 13, 5, 8, 3, 1), 64, 8,
     ((8, 1), 128, 12, 608, 608 + 4 * (12 * 64 + 12 * 8 + 48 + 64), 8)),
]


@pytest.mark.parametrize("shape,bp,q,want", CONV_PLANS, ids=str)
def test_conv_plan_counts(shape, bp, q, want):
    grid, threads, k_words, window, smem, bn = want
    p = C.conv_plan(*shape, bp, q)
    assert p["grid"] == grid and p["threads"] == threads
    assert p["k_words"] == k_words and p["window"] == window
    assert p["smem"] == smem and p["block_channels"] == bn


def _blocks(n, h, w, cx, cy, hk, g, bp):
    """Each block's input window as the kernel computes it from blockIdx:
    (rows, columns, [(pixel row, pixel column) in the window])."""
    if hk == 1:
        n, h, w = 1, 1, n * h * w
    hw = h * w
    for blk in range(-(-hw // bp)):
        p0, p1 = blk * bp, min(blk * bp + bp, hw)
        r0, r1 = p0 // w, (p1 - 1) // w
        one_row = r0 == r1
        cmin = p0 - r0 * w if one_row else 0
        wwb = p1 - p0 + hk - 1 if one_row else w + hk - 1
        whb = r1 - r0 + hk
        yield whb, wwb, [(pi // w - r0, pi % w - cmin) for pi in range(p0, p1)]


@pytest.mark.parametrize("shape", [
    (2, 32, 32, 3, 16, 3, 1), (2, 16, 16, 16, 32, 1, 1),
    (1, 10, 10, 128, 64, 3, 4), (2, 15, 13, 5, 8, 3, 1),
    (2, 9, 9, 6, 9, 3, 3), (3, 5, 40, 8, 20, 3, 1), (1, 12, 11, 8, 12, 7, 2),
    (2, 6, 7, 4, 8, 2, 1), (2, 33, 70, 4, 4, 5, 1)], ids=str)
@pytest.mark.parametrize("bp", [32, 64, 96, 128, 256])
def test_conv_plan_window_holds_every_blocks_taps(shape, bp):
    """The window the plan sizes shared memory for holds every block's
    window, and every tap of every pixel of a block lies inside it."""
    n, h, w, cx, cy, hk, g = shape
    p = C.conv_plan(*shape, bp, 16)
    cxg = cx // g
    ps = cxg + 4 if cxg % 4 == 0 and cx % 4 == 0 else cxg
    for whb, wwb, pixels in _blocks(*shape, bp):
        assert whb * wwb * ps <= p["window"]
        for pr, pc in pixels:
            assert 0 <= pr and pr + hk - 1 < whb
            assert 0 <= pc and pc + hk - 1 < wwb


def test_default_tiles():
    # the dws plan at B=256: the largest block whose grid holds 128 blocks
    # (conv0 1,024 of 256 pixels, pw2 64 x 2 channel blocks); at most
    # twice an 8x8 image with a halo; 32 pixels for a small batch; 16
    # channels a thread, fewer for narrow groups
    assert C.default_tile(256, 32, 32, 3, 16, 3, 1) == {"bp": 256, "q": 16}
    assert C.default_tile(256, 16, 16, 16, 32, 1, 1) == {"bp": 256, "q": 16}
    assert C.default_tile(256, 8, 8, 32, 64, 1, 1) == {"bp": 256, "q": 16}
    assert C.default_tile(8, 32, 32, 16, 16, 3, 1) == {"bp": 64, "q": 16}
    assert C.default_tile(256, 8, 8, 32, 64, 3, 1) == {"bp": 128, "q": 16}
    assert C.default_tile(1, 10, 10, 128, 64, 3, 4) == {"bp": 32, "q": 16}
    assert C.default_tile(2, 2, 3, 4, 8, 3, 1) == {"bp": 32, "q": 8}
    assert C.default_tile(2, 8, 8, 4, 6, 3, 2) == {"bp": 32, "q": 4}
    for m, n in ((256, 256), (512, 512), (1, 37), (8, 4864)):
        tile = tuple(M.default_mmf_tile(m, n).values())
        assert tile in M.MMF_TILES and not M.mmf_tile_errors(m, n, tile)
    # Table-2: 16 x 32 blocks of 2 x 2 at 256^2, 32 x 64 of 2 x 4 at 512^2
    assert M.default_mmf_tile(256, 256) == dict(bm=16, bn=32, tm=2, tn=2)
    assert M.default_mmf_tile(512, 512) == dict(bm=32, bn=64, tm=2, tn=4)


@pytest.mark.parametrize("m,n,tile,esize,want", [
    # three 64-deep stages of A (words of 1 or 2 elements, rows padded by 4)
    # and of B
    (256, 256, (16, 32, 2, 2), 4, ((8, 16), 128, 3 * (64 * 20 * 4
                                                       + 64 * 32 * 4))),
    (256, 256, (16, 32, 2, 2), 2, ((8, 16), 128, 3 * (32 * 20 * 4
                                                       + 64 * 32 * 2))),
    (257, 513, (64, 64, 8, 4), 4, ((9, 5), 128, 3 * (64 * 68 * 4
                                                      + 64 * 64 * 4))),
    (37, 33, (32, 64, 2, 4), 2, ((1, 2), 256, 3 * (32 * 36 * 4
                                                    + 64 * 64 * 2))),
], ids=str)
def test_mmf_plan_counts(m, n, tile, esize, want):
    grid, threads, smem = want
    assert M.mmf_plan(m, n, tile, esize) == dict(grid=grid, threads=threads,
                                                 smem=smem)


# (m, k, n, bn, bm, cluster, w4) -> (grid, threads, smem, stages, ring),
# counted by hand: grid x = N / bn column tiles x the cluster, y = M / bm;
# 8 warps of a ring of 4 stages for bm <= 16, else 4 warps of 3; a stage
# is b's 64 rows (W4: 32 packed) x bn, a's bm rows of 64 + 16 bytes and, in
# W4, 64 group shifts; then the leader's inbox of cluster - 1 int32
# partial tiles; stages: the 64-deep K stages over the cluster's warps,
# rounded up
MMQ_PLANS = [
    # decode gate/up: 76 tiles of 64 columns, 14 stages over 8 warps
    ((8, 896, 4864, 64, 8, 1, False),
     ((76, 1), 256, 8 * 4 * (64 * 64 + 8 * 80), 2, 4)),
    ((8, 896, 4864, 64, 8, 2, True),
     ((152, 1), 256, 8 * 4 * (32 * 64 + 8 * 80 + 64) + 8 * 64 * 4, 1, 4)),
    # decode down: 28 tiles of 32 x 4 = 112 blocks, 76 stages over 32 warps
    ((8, 4864, 896, 32, 8, 4, False),
     ((112, 1), 256, 8 * 4 * (64 * 32 + 8 * 80) + 3 * 8 * 32 * 4, 3, 4)),
    ((8, 4864, 896, 32, 8, 8, True),
     ((224, 1), 256, 8 * 4 * (32 * 32 + 8 * 80 + 64) + 7 * 8 * 32 * 4, 2,
      4)),
    # prefill gate/up M = 32, 64, 128 and down M = 64
    ((32, 896, 4864, 64, 32, 2, False),
     ((152, 1), 128, 4 * 3 * (64 * 64 + 32 * 80) + 32 * 64 * 4, 2, 3)),
    ((64, 896, 4864, 64, 64, 2, False),
     ((152, 1), 128, 4 * 3 * (64 * 64 + 64 * 80) + 64 * 64 * 4, 2, 3)),
    ((128, 896, 4864, 64, 64, 1, True),
     ((76, 2), 128, 4 * 3 * (32 * 64 + 64 * 80 + 64), 4, 3)),
    ((64, 4864, 896, 32, 64, 8, False),
     ((224, 1), 128, 4 * 3 * (64 * 32 + 64 * 80) + 7 * 64 * 32 * 4, 3, 3)),
    # ragged: one stage, a tile past every edge
    ((5, 45, 37, 32, 8, 1, False),
     ((2, 1), 256, 8 * 4 * (64 * 32 + 8 * 80), 1, 4)),
    ((70, 4864, 37, 32, 64, 4, True),
     ((8, 2), 128, 4 * 3 * (32 * 32 + 64 * 80 + 64) + 3 * 64 * 32 * 4, 5,
      3)),
    # a 128-column decode tile: 8 rings of 4 stages of 8,832 bytes, past
    # what a block can use in int8 (W4's packed stages fit)
    ((8, 896, 4864, 128, 8, 1, False),
     ((38, 1), 256, 8 * 4 * (64 * 128 + 8 * 80), 2, 4)),
]


@pytest.mark.parametrize("args,want", MMQ_PLANS, ids=str)
def test_mmq_plan_counts(args, want):
    m, k, n, bn, bm, cs, w4 = args
    grid, threads, smem, stages, ring = want
    assert M.mmq_plan(m, k, n, bn, bm, cs, w4) == dict(
        grid=grid, cluster=cs, threads=threads, smem=smem, stages=stages,
        ring=ring)


def test_default_mmq_configs():
    """The integer wrappers' default: a decode tile (8 warps a block) of 64
    columns with no cluster where that gives 66 blocks on an H100
    (gate/up: 76), else 32 columns on the smallest cluster that does
    (down: 28 x 4 = 112); a taller tile of 32 columns (64 x 64 first past
    64 rows) on the smallest cluster that gives 132 blocks, else the one
    with the most (Table-2's 256^3: 32 x 32, 64 blocks, not 64 x 64's 16);
    and no warp of a default is left without a K stage."""
    d = M.default_mmq_config
    assert d(8, 896, 4864) == dict(bn=64, bm=8, cluster=1)
    assert d(8, 4864, 896) == dict(bn=32, bm=8, cluster=4)
    assert d(16, 896, 4864) == dict(bn=64, bm=16, cluster=1)
    assert d(32, 896, 4864) == dict(bn=32, bm=32, cluster=1)
    assert d(64, 896, 4864) == dict(bn=32, bm=32, cluster=1)
    assert d(128, 896, 4864) == dict(bn=64, bm=64, cluster=1)
    assert d(64, 4864, 896) == dict(bn=32, bm=32, cluster=4)
    assert d(128, 4864, 896) == dict(bn=64, bm=64, cluster=8)
    assert d(5, 45, 37) == dict(bn=32, bm=8, cluster=1)
    assert d(256, 256, 256) == dict(bn=32, bm=32, cluster=1)
    assert d(512, 512, 512) == dict(bn=32, bm=32, cluster=1)
    assert d(300, 4096, 4096) == dict(bn=64, bm=64, cluster=1)
    for m, k, n in ((8, 896, 4864), (8, 4864, 896), (1, 896, 4864),
                    (128, 896, 4864), (64, 4864, 896), (3, 100, 7)):
        cfg = d(m, k, n)
        p = M.mmq_plan(m, k, n, *cfg.values())
        assert not M.mmq_config_errors(m, k, n, cfg)
        warps = M.mmq_warps(cfg["bm"]) * cfg["cluster"]
        assert warps <= max(M.mmq_warps(cfg["bm"]), -(-k // M.MMQ_BK))
        if (m, k, n) in ((8, 896, 4864), (8, 4864, 896)):
            assert p["grid"][0] * p["grid"][1] * p["threads"] >= 132 * 128
    assert [M.mmq_bm_cap(m) for m in (1, 8, 9, 16, 17, 33, 64, 65, 500)] \
        == [8, 8, 16, 16, 32, 64, 64, 64, 64]
    assert [M.mmq_warps(bm) for bm in (8, 16, 32, 64)] == [8, 8, 4, 4]
    assert [M.mmq_ring(bm) for bm in (8, 16, 32, 64)] == [4, 4, 3, 3]
    # clusters whose every warp gets a K stage: 8 or 4 warps a block
    assert [M.mmq_cluster_cap(k, 8) for k in (64, 512, 896, 1024, 4864)] \
        == [1, 1, 1, 2, 8]
    assert [M.mmq_cluster_cap(k, 32) for k in (64, 512, 896, 1024, 4864)] \
        == [1, 2, 2, 4, 8]


@pytest.mark.parametrize("w4", [False, True], ids=["q8", "w4"])
@pytest.mark.parametrize("knobs,match", [
    (dict(bn=48), "not one of"), (dict(bm=24), "not one of"),
    (dict(cluster=16), "at most 8"), (dict(cluster=3), "at most 8")])
def test_integer_matmul_rejects_bad_configs(w4, knobs, match):
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.integers(-128, 128, (8, 64)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-128, 128, (64, 40)).astype(np.int8))
    with pytest.raises(ValueError, match=match):
        M.check_mmq_config("matmul", 8, 64, 40, w4, sms=132,
                           **{**dict(bn=None, bm=None, cluster=None),
                              **knobs})
    # on the host the wrappers run the plain version for every member
    want = M.matmul_q8_plain(a, b, requant_shift=9)
    for bn, bm in M.MMQ_TILES:
        assert torch.equal(M.matmul_q8(a, b, requant_shift=9, bn=bn, bm=bm,
                                       cluster=2), want)


def test_integer_matmul_footprint_check(monkeypatch):
    """A config past the 232,448 bytes of shared memory a block can use is
    rejected with its reason: a 128 x 32 tile's rings (129,024 bytes) and
    a cluster of 8's inbox (7 x 16,384) in int8; a 128-column decode
    tile's eight int8 rings (282,624); a 256 x 64 tile's four warps'
    partial tiles (4 x 64 x 256 x 4, more than its rings' 4 x 3 x 21,504);
    so is a cluster past the portable 8."""
    sig = tune.sig_matmul(64, 896, 4864)
    assert M.mmq_plan(64, 896, 4864, 128, 32, 8)["smem"] == 243712
    errs = tune.space.launch_errors(sig, dict(bn=128, bm=32, cluster=8),
                                    "int8")
    assert any("shared memory" in e for e in errs), errs
    assert not tune.space.launch_errors(sig, dict(bn=128, bm=32, cluster=4),
                                        "int8")
    for bm in (8, 16):
        errs = tune.space.launch_errors(sig, dict(bn=128, bm=bm, cluster=1),
                                        "int8")
        assert any("shared memory" in e for e in errs), errs
        assert not tune.space.launch_errors(
            sig, dict(bn=128, bm=bm, cluster=1), "w4a8")
    monkeypatch.setattr(M, "MMQ_TILES", M.MMQ_TILES + ((256, 64),))
    big = dict(bn=256, bm=64, cluster=1)
    assert M.mmq_plan(64, 896, 4864, 256, 64, 1)["smem"] == 262144
    errs = tune.space.launch_errors(sig, big, "int8")
    assert any("shared memory" in e for e in errs), errs
    errs = tune.space.launch_errors(sig, dict(big, bn=64, cluster=16),
                                    "w4a8")
    assert any("at most 8" in e for e in errs), errs
    fits = [(bn, bm, c) for bn, bm in M.MMQ_TILES[:-1]
            for c in M.MMQ_CLUSTERS
            if not tune.space.launch_errors(
                sig, dict(bn=bn, bm=bm, cluster=c), "int8")]
    # all but 128 x 8 and 128 x 16 (any cluster) and 128 x 32 x 8
    assert len(fits) == 4 * 11 - 9


P = importlib.import_module("repro_torch.kernels.pool")


@pytest.mark.parametrize("shape,aligned,threads,want", [
    # the dws plan's pools at B=256: 16 channels a thread
    ((256, 16, 16, 16), True, 256, (256, True)),
    ((256, 8, 8, 32), True, 256, (128, True)),
    ((256, 4, 4, 64), True, 256, (64, True)),
    ((256, 4, 4, 64), True, 1024, (16, True)),
    # C = 19, or x off a 16-byte boundary: a thread a byte
    ((2, 7, 6, 19), True, 256, (7, False)),
    ((256, 16, 16, 16), False, 256, (4096, False)),
    ((3, 5, 4, 64), False, 64, (60, False)),
], ids=str)
def test_pool_plan_counts(shape, aligned, threads, want):
    blocks, vector = want
    assert P.pool_plan(*shape, aligned, threads) == dict(
        blocks=blocks, threads=threads, vector=vector)


@pytest.mark.parametrize("shape,esize,aligned,threads,want", [
    # the tuner's float pool job: a 16-byte vector a thread (4 float32, 8
    # bf16), or a thread an element at an odd address
    ((8, 16, 16, 64), 4, True, 256, (128, True)),
    ((8, 16, 16, 64), 2, True, 256, (64, True)),
    ((8, 16, 16, 64), 4, False, 256, (512, False)),
    # C = 12: three float32 vectors a pixel; 24 bf16 bytes: scalar
    ((3, 5, 4, 12), 4, True, 64, (3, True)),
    ((3, 5, 4, 12), 2, True, 64, (12, False)),
    # C = 4 and 8: one float32 / one bf16 vector; C = 4 bf16: scalar
    ((3, 5, 4, 4), 4, True, 64, (1, True)),
    ((3, 5, 4, 8), 2, True, 64, (1, True)),
    ((3, 5, 4, 4), 2, True, 64, (4, False)),
    ((2, 7, 6, 19), 4, True, 1024, (2, False)),
], ids=str)
def test_pool_f_plan_counts(shape, esize, aligned, threads, want):
    blocks, vector = want
    assert P.pool_f_plan(*shape, esize, aligned, threads) == dict(
        blocks=blocks, threads=threads, vector=vector)


C1 = importlib.import_module("repro_torch.kernels.conv1d_causal")


@pytest.mark.parametrize("args,want", [
    # Falcon-Mamba's prefill (d_inner 8192): 1,024 bf16 vectors (2,048
    # float32) over 64 threads, runs of R positions
    ((1, 96, 8192, 2, True, 4, 64), ((16, 24, 1), 4, True)),
    ((1, 96, 8192, 4, True, 8, 64), ((32, 12, 1), 8, True)),
    ((1, 16, 8192, 2, True, 2, 64), ((16, 8, 1), 2, True)),
    ((1, 256, 8192, 2, True, 8, 128), ((8, 32, 1), 8, True)),
    ((8, 64, 8192, 2, True, 8, 256), ((4, 8, 8), 8, True)),
    # x at an odd address: the scalar path, a channel a thread, runs of 32
    ((1, 96, 8192, 2, False, 4, 64), ((128, 3, 1), 32, False)),
    # D = 100: 200 bf16 bytes is off 16 (scalar), 400 float32 bytes is 25
    # vectors
    ((3, 45, 100, 2, True, 2, 128), ((1, 2, 3), 32, False)),
    ((3, 45, 100, 4, True, 2, 128), ((1, 23, 3), 2, True)),
    ((1, 20, 8196, 2, True, 1, 64), ((129, 1, 1), 32, False)),
    # L < K
    ((2, 2, 64, 2, True, 8, 64), ((1, 1, 2), 8, True)),
], ids=str)
def test_c1d_plan_counts(args, want):
    grid, run, vector = want
    assert C1.c1d_plan(*args) == dict(grid=grid, threads=args[-1], run=run,
                                      vector=vector)


def test_default_c1d_configs():
    """The wrapper's default is the cheapest config under the fitted cost
    model, which the tuner's analytic model prices with: longer runs as L
    grows, 64 threads at every prefill shape."""
    want = {(1, 16, 2): 2, (1, 33, 2): 2, (1, 96, 2): 4, (1, 256, 2): 8,
            (8, 64, 2): 8, (1, 96, 4): 8}
    for (b, l, es), run in want.items():
        cfg = C1.default_c1d_config(b, l, 8192, 4, es)
        assert cfg == {"run": run, "threads": 64}
        dt = "bfloat16" if es == 2 else "float32"
        sig = tune.sig_causal_conv1d(b, l, 8192, 4)
        assert tune.analytic_config(sig, dt) == cfg
        for c in tune.candidates(sig, dt):
            assert C1.c1d_cost_s(b, l, 8192, 4, es, c["run"], c["threads"]) \
                >= C1.c1d_cost_s(b, l, 8192, 4, es, run, 64)


def test_c1d_launch_errors():
    """The tuner holds causal_conv1d's configs to its instantiations and
    the grid's y (runs) and z (batch) limits."""
    sig = tune.sig_causal_conv1d(1, 70000, 64, 4)
    assert tune.space.launch_errors(sig, {"run": 1, "threads": 64},
                                    "float32")
    assert not tune.space.launch_errors(sig, {"run": 2, "threads": 64},
                                        "float32")
    assert tune.space.launch_errors(
        tune.sig_causal_conv1d(70000, 4, 64, 4), {"run": 1, "threads": 64},
        "float32")
    for bad in ({"run": 3, "threads": 64}, {"run": 2, "threads": 96}):
        assert tune.space.launch_errors(tune.sig_causal_conv1d(1, 8, 64, 4),
                                        bad, "float32")
    x = torch.zeros((1, 8, 64))
    for kw in ({"run": 3}, {"threads": 96}):
        with pytest.raises(ValueError, match="must be one of"):
            C1.causal_conv1d(x, torch.zeros((4, 64)), **kw)


def _conv_args(cx=8, cy=8, hk=3, g=1, w4=False):
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.integers(-128, 128, (2, 6, 6, cx))
                         .astype(np.int8))
    q = rng.integers(-8 if w4 else -128, 8 if w4 else 128,
                     (hk, hk, cx // g, cy)).astype(np.int8)
    if not w4:
        return x, (torch.from_numpy(q),)
    ws = torch.from_numpy(rng.integers(0, 5, cx // g).astype(np.int8))
    return x, (pack_w4(torch.from_numpy(q), 2).contiguous(), ws)


@pytest.mark.parametrize("w4", [False, True], ids=["q8", "w4"])
@pytest.mark.parametrize("knobs,match", [
    (dict(bp=48), "bp must be"), (dict(bp=512), "bp must be"),
    (dict(bp=True), "bp must be"), (dict(q=12), "q must be"),
    (dict(q=2), "q must be"), (dict(bp=64.0), "bp must be")], ids=str)
def test_conv_wrappers_reject_bad_tiles(w4, knobs, match):
    x, wts = _conv_args(w4=w4)
    fn = C.conv2d_w4 if w4 else C.conv2d_q8
    with pytest.raises(ValueError, match=match):
        fn(x, *wts, requant_shift=7, **knobs)


@pytest.mark.parametrize("w4", [False, True], ids=["q8", "w4"])
def test_conv_wrappers_take_every_tile_on_the_host(w4):
    """On host tensors every tile runs the plain version: same output."""
    x, wts = _conv_args(w4=w4)
    fn = C.conv2d_w4 if w4 else C.conv2d_q8
    want = fn(x, *wts, requant_shift=7, act="relu")
    for bp in (32, 96, 256):
        for q in C.CONV_Q:
            assert torch.equal(fn(x, *wts, requant_shift=7, act="relu",
                                  bp=bp, q=q), want)


# Cx = 512 at 64x64: a 256-pixel block spans 4 rows, a 6 x 66 x 516-byte
# window plus its tiles, over the 232,448 bytes a block can use
WIDE = (1, 64, 64, 512, 64, 3, 1)


def test_tile_over_shared_memory_is_rejected():
    assert C.conv_plan(*WIDE, 256, 16)["smem"] > C.MAX_DYNAMIC_SMEM
    assert not C.tile_errors(C.conv_plan(*WIDE, 32, 16))
    x = torch.zeros(WIDE[:4], dtype=torch.int8)
    w = torch.zeros((3, 3, 512, 64), dtype=torch.int8)
    with pytest.raises(ValueError, match="shared memory"):
        C.conv2d_q8(x, w, bp=256, q=16)
    sig = tune.sig_conv2d(*WIDE)
    errs = tune.space.launch_errors(sig, {"bp": 256, "q": 16}, "int8")
    assert errs and "shared memory" in errs[0]
    cands = list(tune.candidates(sig, "int8"))
    assert {"bp": 256, "q": 16} not in cands and {"bp": 32, "q": 16} in cands
    # the default falls back to a tile that fits
    assert not tune.space.launch_errors(
        sig, tune.default_config("conv2d", sig, "int8"), "int8")
    with pytest.raises(ValueError, match="cannot launch"):
        tune.check_config(sig, {"bp": 256, "q": 4}, "int8")


def test_matmul_f_rejects_tiles_it_has_no_instantiation_for():
    a, b = torch.zeros((4, 4)), torch.zeros((4, 4))
    with pytest.raises(ValueError, match="not one of"):
        M.matmul_f(a, b, bm=48)
    with pytest.raises(ValueError, match="not one of"):
        M.matmul_f(a, b, bm=16, bn=32, tm=4, tn=4)
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((37, 45)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((45, 33)).astype(np.float32))
    want = M.matmul_f_plain(a, b, act="relu")
    for tile in M.MMF_TILES:
        got = M.matmul_f(a, b, act="relu", **dict(zip(M.MMF_KNOBS, tile)))
        assert torch.equal(got, want)


def test_float_matmul_footprint_check(monkeypatch):
    """A tile past the 232,448 bytes of shared memory a block can use or
    1,024 threads is rejected with its reasons, here a 256 x 512 block of
    8 x 8 tiles."""
    big = (256, 512, 8, 8)
    monkeypatch.setattr(M, "MMF_TILES", M.MMF_TILES + (big,))
    sig = tune.sig_matmul(512, 64, 512)
    errs = tune.space.launch_errors(sig, dict(zip(M.MMF_KNOBS, big)),
                                    "float32")
    assert any("shared memory" in e for e in errs)
    assert any("2048 threads" in e for e in errs)
    assert not tune.space.launch_errors(
        sig, dict(zip(M.MMF_KNOBS, M.MMF_TILES[0])), "bfloat16")


# ------------------------------------------------------ the shift conv --

S = importlib.import_module("repro_torch.kernels.conv_shift")

# (n, h, w, c, cy, d), bp, q -> (grid, threads, k_words, window, smem,
# block channels), counted by hand: the implicit GEMM of a (2d+1)-wide
# window over K = C, each channel gathered at its own displacement
SHIFT_PLANS = [
    # shift1 at B=256: a block is one 16x16 image, window 18 x 18 x 20
    ((256, 16, 16, 16, 32, 1), 256, 16,
     ((256, 1), 256, 4, 18 * 18 * 20,
      6480 + 4 * (4 * 256 + 4 * 32 + 16 + 256), 32)),
    # shift2 at B=256: 128-pixel blocks over 8x8 images, window 10x10x36
    ((256, 8, 8, 32, 64, 1), 128, 16,
     ((256, 1), 256, 8, 10 * 10 * 36,
      3600 + 4 * (8 * 128 + 8 * 64 + 32 + 128), 64)),
    # Table-2's job at d = 2: two rows of 32 and a halo of 2
    ((1, 32, 32, 64, 64, 2), 64, 8,
     ((16, 1), 128, 16, 6 * 36 * 68,
      14688 + 4 * (16 * 64 + 16 * 64 + 64 + 64), 64)),
    # d = 3: one row of 32 and a halo of 3, 18,088 bytes rounded to 16
    ((1, 32, 32, 64, 64, 3), 32, 4,
     ((32, 1), 128, 16, 18096, 18096 + 4 * (16 * 32 + 16 * 64 + 64 + 32),
      64)),
    # odd C = 19: bytes, no pad; runs of 64 span at most 6 rows of 13
    ((2, 15, 13, 19, 8, 2), 64, 8,
     ((8, 1), 128, 5, 3232, 3232 + 4 * (5 * 64 + 5 * 8 + 20 + 64), 8)),
]


@pytest.mark.parametrize("shape,bp,q,want", SHIFT_PLANS, ids=str)
def test_shift_plan_counts(shape, bp, q, want):
    grid, threads, k_words, window, smem, bn = want
    p = S.shift_plan(*shape, bp, q)
    assert p["grid"] == grid and p["threads"] == threads
    assert p["k_words"] == k_words and p["window"] == window
    assert p["smem"] == smem and p["block_channels"] == bn


@pytest.mark.parametrize("shape,bp,q,want", [
    # Table-2: 32 pixels x 4 threads of 4 channels, 128 blocks; chunks of
    # 64 channels, the staged rows padded to 33 floats
    ((1, 32, 32, 64, 64), 32, 4,
     ((32, 4), 128, 4 * (64 * 33 + 64 * 16 + 4 * 32 + 2 * 64), 16)),
    # 256 pixels a block: one thread of 16 channels each, a row pitch of 257
    ((256, 16, 16, 16, 32), 256, 16,
     ((256, 2), 256, 4 * (64 * 257 + 64 * 16 + 4 * 256 + 2 * 64), 16)),
    # Cy = 37 off every q: 3 channel blocks of 16
    ((2, 9, 7, 5, 37), 64, 8, ((2, 3), 128, 4 * (64 * 65 + 64 * 16 + 256
                                                  + 128), 16)),
], ids=str)
def test_shift_f_plan_counts(shape, bp, q, want):
    grid, threads, smem, bn = want
    assert S.shift_f_plan(*shape, bp, q) == dict(
        grid=grid, threads=threads, smem=smem, block_channels=bn)


@pytest.mark.parametrize("shape", [
    (2, 16, 16, 16, 32, 1), (2, 8, 8, 32, 64, 1), (1, 32, 32, 64, 64, 2),
    (1, 32, 32, 64, 64, 3), (2, 15, 13, 19, 8, 2), (1, 12, 11, 9, 24, 3),
    (2, 33, 70, 4, 4, 2)], ids=str)
@pytest.mark.parametrize("bp", [32, 64, 96, 128, 256])
def test_shift_plan_window_holds_every_shifted_read(shape, bp):
    """The window the plan sizes shared memory for holds every block's
    window, and every pixel's read at every displacement (a, b) with
    |a|, |b| <= d lies inside it."""
    n, h, w, c, cy, d = shape
    hk = 2 * d + 1
    p = S.shift_plan(*shape, bp, 16)
    ps = c + 4 if c % 4 == 0 else c
    for whb, wwb, pixels in _blocks(n, h, w, c, cy, hk, 1, bp):
        assert whb * wwb * ps <= p["window"]
        for pr, pc in pixels:
            for a in range(-d, d + 1):
                assert 0 <= pr + a + d < whb
                assert 0 <= pc + a + d < wwb


def test_default_shift_tiles():
    # the integer modes: default_tile's rule on the shift plan (shift1: one
    # image a block; shift2: twice an 8x8 image, 256 blocks); the float
    # mode: 32 pixels x 4 channels
    assert S.default_shift_tile(256, 16, 16, 16, 32, 1) == {"bp": 256,
                                                            "q": 16}
    assert S.default_shift_tile(256, 8, 8, 32, 64, 1) == {"bp": 128, "q": 16}
    assert S.default_shift_tile(1, 32, 32, 64, 64, 1) == {"bp": 32, "q": 16}
    assert S.default_shift_tile(2, 9, 7, 12, 8, 2) == {"bp": 32, "q": 8}
    assert S.default_shift_tile(1, 32, 32, 64, 64, 1, integer=False) == \
        {"bp": 32, "q": 4}


def _shift_args(mode, c=8, cy=8):
    rng = np.random.default_rng(8)
    table = torch.from_numpy(np.array(
        [[(i % 3) - 1, ((i // 3) % 3) - 1] for i in range(c)], np.int32))
    if mode == "f":
        x = torch.from_numpy(rng.standard_normal((2, 6, 6, c))
                             .astype(np.float32))
        w = torch.from_numpy(rng.standard_normal((c, cy)).astype(np.float32))
        return S.shift_conv2d_f, (x, table, w), dict(act="relu")
    x = torch.from_numpy(rng.integers(-128, 128, (2, 6, 6, c))
                         .astype(np.int8))
    if mode == "q8":
        w = torch.from_numpy(rng.integers(-128, 128, (c, cy)).astype(np.int8))
        return S.shift_conv2d_q8, (x, table, w), dict(requant_shift=7,
                                                      act="relu")
    q = torch.from_numpy(rng.integers(-8, 8, (c, cy)).astype(np.int8))
    ws = torch.from_numpy(rng.integers(0, 5, c).astype(np.int8))
    return (S.shift_conv2d_w4, (x, table, pack_w4(q, 0).contiguous(), ws),
            dict(requant_shift=7, act="relu"))


@pytest.mark.parametrize("mode", ["q8", "w4", "f"])
@pytest.mark.parametrize("knobs,match", [
    (dict(bp=48), "bp must be"), (dict(bp=512), "bp must be"),
    (dict(bp=True), "bp must be"), (dict(q=12), "q must be"),
    (dict(q=2), "q must be"), (dict(bp=64.0), "bp must be"),
    (dict(max_shift=-1), "max_shift"), (dict(max_shift=1.5), "max_shift"),
    (dict(threads=256), "threads")], ids=str)
def test_shift_wrappers_reject_bad_tiles(mode, knobs, match):
    fn, args, kw = _shift_args(mode)
    with pytest.raises((ValueError, TypeError), match=match):
        fn(*args, **kw, **knobs)


@pytest.mark.parametrize("mode", ["q8", "w4", "f"])
def test_shift_wrappers_take_every_tile_on_the_host(mode):
    """On host tensors every tile of the space runs the plain version, with
    or without max_shift: the default's output."""
    fn, args, kw = _shift_args(mode)
    want = fn(*args, **kw)
    for bp in C.CONV_BP:
        for q in C.CONV_Q:
            for d in (None, 1, 2):
                assert torch.equal(fn(*args, **kw, bp=bp, q=q, max_shift=d),
                                   want)


# C = 512 at 64x64 with d = 3: a 256-pixel block's 10 x 70 x 516-byte window
# is over the 232,448 bytes a block can use
WIDE_SHIFT = (1, 64, 64, 512, 64, 3)


def test_shift_tile_over_shared_memory_is_rejected():
    assert S.shift_plan(*WIDE_SHIFT, 256, 16)["smem"] > C.MAX_DYNAMIC_SMEM
    assert not C.tile_errors(S.shift_plan(*WIDE_SHIFT, 32, 16))
    x = torch.zeros(WIDE_SHIFT[:4], dtype=torch.int8)
    table = torch.zeros((512, 2), dtype=torch.int32)
    w = torch.zeros((512, 64), dtype=torch.int8)
    with pytest.raises(ValueError, match="shared memory"):
        S.shift_conv2d_q8(x, table, w, max_shift=3, bp=256, q=16)
    sig = tune.sig_shift_conv2d(*WIDE_SHIFT)
    errs = tune.space.launch_errors(sig, {"bp": 256, "q": 16}, "int8")
    assert errs and "shared memory" in errs[0]
    cands = list(tune.candidates(sig, "int8"))
    assert {"bp": 256, "q": 16} not in cands and {"bp": 32, "q": 16} in cands
    assert not tune.space.launch_errors(
        sig, tune.default_config("shift_conv2d", sig, "int8"), "int8")
    with pytest.raises(ValueError, match="cannot launch"):
        tune.check_config(sig, {"bp": 256, "q": 4}, "w4a8")
    # the float mode stages no window: every tile fits
    assert len(list(tune.candidates(sig, "float32"))) == 12


def test_shift_sig_keys_its_window_bound():
    """d is keyed where it is not 1 (the JAX package's key otherwise), and
    the tuner's space, checks and defaults read it."""
    d1 = tune.sig_shift_conv2d(8, 32, 32, 64, 64)
    assert d1 == tune.sig_shift_conv2d(8, 32, 32, 64, 64, 1)
    d2 = tune.sig_shift_conv2d(8, 32, 32, 64, 64, 2)
    assert d2.key() == d1.key() + "_d2"
    assert tune.space.shift_shape(d2) == (8, 32, 32, 64, 64, 2)
    for dt in ("int8", "w4a8", "float32", "bfloat16"):
        assert tune.space.knobs("shift_conv2d", dt) == ("bp", "q")
        assert set(tune.default_config("shift_conv2d", d2, dt)) == {"bp", "q"}
    assert tune.space.tile_plan(d2, 64, 8, "int8") == \
        S.shift_plan(8, 32, 32, 64, 64, 2, 64, 8)
    assert tune.space.tile_plan(d2, 64, 8, "float32") == \
        S.shift_f_plan(8, 32, 32, 64, 64, 64, 8)


# ------------------------------------ the float conv and float add conv --

A = importlib.import_module("repro_torch.kernels.conv_add")

# (n, h, w, cx, cy, hk, groups), bp, q -> (grid, threads, window, smem,
# block channels, K chunk), counted by hand from the float implicit GEMM's
# layout: a block of bp pixels x (at most 128 / bp below bp = 128, else 1)
# groups of q channels; the window (rows spanned + HK-1 padding rows for
# each image boundary crossed + HK-1) x (columns + HK-1) x (Cx/g | 1)
# floats, rounded to 4 floats; then a chunk's weights (min(128, 8 bp / q)
# K elements x the block's channels), its K offsets, the pixel bases and
# the window rows' input offsets, 4 bytes each
F_PLANS = [
    # Table-2 ci=128, g=1 at 10^2, n=1: 32 pixels span at most 5 rows of
    # 10, no image boundary; 4 x 4 blocks of 128 threads, one pixel each;
    # all 1,152 K elements' weights (16 channels) and offsets resident
    ((1, 10, 10, 128, 64, 3, 1), 32, 4,
     ((4, 4), 128, 4 * 7 * 12 * 129, 4 * (7 * 12 * 129 + 1152 * 16 + 1152
                                          + 32 + 7), 16, 1152, 1)),
    # the same with 16 channels a thread: 64 channels a block, and 1,152 x
    # 64 weights do not fit, so chunks of 8 x 32 / 16 = 16 K elements
    ((1, 10, 10, 128, 64, 3, 1), 32, 16,
     ((4, 1), 128, 4 * 7 * 12 * 129, 4 * (7 * 12 * 129 + 16 * 64 + 16 + 32
                                          + 7), 64, 16, 1)),
    # the same, grouped g=4: 32 channels a group, 16 outputs, one block
    # of 16 channels a group
    ((1, 10, 10, 128, 64, 3, 4), 32, 4,
     ((4, 4), 128, 4 * 7 * 12 * 33, 4 * (7 * 12 * 33 + 288 * 16 + 288 + 32
                                         + 7), 16, 288, 1)),
    # standard conv1 at B=256, 256 pixels (2 a thread, 16 channels): 16
    # whole rows of 16 that may cross one image boundary (2 padding rows)
    ((256, 16, 16, 16, 32, 3, 1), 256, 16,
     ((256, 2), 128, 4 * 20 * 18 * 17, 4 * (20 * 18 * 17 + 144 * 16 + 144
                                            + 256 + 20), 16, 144, 2)),
    # conv0 / add0 at B=256: 8 rows of 32, 3 channels (ps 3), K = 27
    ((256, 32, 32, 3, 16, 3, 1), 256, 16,
     ((1024, 1), 128, 4 * 12 * 34 * 3, 4 * (12 * 34 * 3 + 27 * 16 + 27
                                            + 256 + 12), 16, 27, 2)),
    # conv2 at B=256, 128 pixels (4 a thread, 8 channels): 16 rows of 8, up
    # to 2 image boundaries; 4 channel groups (32 channels) a block
    ((256, 8, 8, 32, 64, 3, 1), 128, 8,
     ((128, 2), 128, 4 * 22 * 10 * 33, 4 * (22 * 10 * 33 + 288 * 32 + 288
                                            + 128 + 22), 32, 288, 4)),
    # pointwise: one row of 65,536 pixels, no halo
    ((256, 16, 16, 16, 32, 1, 1), 128, 8,
     ((512, 1), 128, 4 * 128 * 17, 4 * (128 * 17 + 16 * 32 + 16 + 128 + 1),
      32, 16, 4)),
    # odd everything: runs of 64 (2 a thread) span at most 6 rows of 13
    # and one image boundary; 750 floats rounded to 752
    ((2, 15, 13, 5, 8, 3, 1), 64, 8,
     ((7, 1), 32, 4 * 752, 4 * (752 + 45 * 8 + 45 + 64 + 10), 8, 45, 2)),
]


@pytest.mark.parametrize("shape,bp,q,want", F_PLANS, ids=str)
def test_conv_f_plan_counts(shape, bp, q, want):
    grid, threads, window, smem, bn, kc, pt = want
    assert C.conv_f_plan(*shape, bp, q) == dict(
        grid=grid, threads=threads, smem=smem, window=window,
        block_channels=bn, k_chunk=kc, pixels=pt)


@pytest.mark.parametrize("shape,bp,q,want", [
    # Table-2's add job, 1x10x10, 16->16, k=3: all 144 K resident
    ((1, 10, 10, 16, 16, 3), 32, 4,
     ((4, 1), 128, 4 * 7 * 12 * 17, 4 * (7 * 12 * 17 + 144 * 16 + 144 + 32
                                         + 7), 16, 144, 1)),
    # add1 at B=256 (the standard conv1's geometry)
    ((256, 16, 16, 16, 32, 3), 256, 16,
     ((256, 2), 128, 4 * 20 * 18 * 17, 4 * (20 * 18 * 17 + 144 * 16 + 144
                                            + 256 + 20), 16, 144, 2)),
    # add2 at B=256, 64-pixel blocks (2 a thread): one 8x8 image, but the
    # plan allows for one boundary; 4 groups of 16 channels, 128 threads
    ((256, 8, 8, 32, 64, 3), 64, 16,
     ((256, 1), 128, 4 * 12 * 10 * 33, 4 * (12 * 10 * 33 + 288 * 64 + 288
                                           + 64 + 12), 64, 288, 2)),
], ids=str)
def test_add_f_plan_counts(shape, bp, q, want):
    grid, threads, window, smem, bn, kc, pt = want
    assert A.add_f_plan(*shape, bp, q) == dict(
        grid=grid, threads=threads, smem=smem, window=window,
        block_channels=bn, k_chunk=kc, pixels=pt)
    assert A.add_f_plan(*shape, bp, q) == C.conv_f_plan(*shape, 1, bp, q)


def _f_blocks(n, h, w, hk, bp):
    """Each block of the float implicit GEMM as the kernel computes it
    from blockIdx: (window rows, window columns, the first window row's
    padded row, the first window column's input column, [(image, row,
    column, window row, window column) of each pixel])."""
    if hk == 1:
        n, h, w = 1, 1, n * h * w
    hw, hp, total = h * w, h + hk - 1, n * h * w
    for p0 in range(0, total, bp):
        p1 = min(p0 + bp, total)
        b0, y0 = p0 // hw, (p0 % hw) // w
        b1, y1 = (p1 - 1) // hw, ((p1 - 1) % hw) // w
        one_row = b0 == b1 and y0 == y1
        cmin = p0 % hw - y0 * w if one_row else 0
        wwb = p1 - p0 + hk - 1 if one_row else w + hk - 1
        prow0 = b0 * hp + y0
        whb = b1 * hp + y1 - prow0 + hk
        pixels = []
        for pi in range(p0, p1):
            b, y, x = pi // hw, (pi % hw) // w, pi % w
            pixels.append((b, y, x, b * hp + y - prow0, x - cmin))
        yield whb, wwb, prow0, cmin, pixels


@pytest.mark.parametrize("shape", [
    (1, 10, 10, 128, 64, 3, 4), (2, 15, 13, 5, 8, 3, 1),
    (3, 5, 40, 8, 20, 3, 1), (1, 12, 11, 8, 12, 7, 2),
    (2, 6, 7, 4, 8, 2, 1), (4, 3, 4, 6, 10, 5, 1), (5, 8, 8, 32, 64, 3, 1),
    (2, 8, 8, 5, 7, 1, 1), (3, 2, 33, 3, 16, 4, 1), (2, 33, 70, 4, 4, 6, 1)],
    ids=str)
@pytest.mark.parametrize("bp", [32, 64, 96, 128, 256])
def test_f_plan_window_holds_every_tap(shape, bp):
    """The window the float plan sizes shared memory for holds every
    block's window; every tap of every pixel lies inside it, on a padded
    row of the pixel's own image, at the input row and column the TPU
    kernels' (HK//2, (HK-1)//2) padding gives (even HK and HK = 7
    included)."""
    n, h, w, cx, cy, hk, g = shape
    p = C.conv_f_plan(*shape, bp, 4)
    ps = (cx // g) | 1
    hw_ = (1, 1) if hk == 1 else (h, w)
    hp, pad = hw_[0] + hk - 1, hk // 2
    for whb, wwb, prow0, cmin, pixels in _f_blocks(n, h, w, hk, bp):
        assert whb * wwb * ps * 4 <= p["window"]
        for b, y, x, wr, wc in pixels:
            assert 0 <= wr and wr + hk - 1 < whb
            assert 0 <= wc and wc + hk - 1 < wwb
            for i in range(hk):
                pr = prow0 + wr + i
                assert pr // hp == b                     # its own image
                assert pr % hp - pad == y + i - pad      # its input row
            for j in range(hk):
                assert cmin + wc + j - pad == x + j - pad


def test_default_f_tiles():
    # Table-2's n = 1 jobs: no tile's grid holds 128 blocks, so 32 pixels
    # x 4 channels, the most blocks and threads (the ci=128 job: 16 blocks
    # of 128 threads); the B=256 layers: 16 channels a thread and the
    # largest block of at most 128 pixels whose grid holds 128 blocks
    for s in ((1, 10, 10, 128, 64, 3, 1), (1, 10, 10, 128, 64, 3, 4),
              (1, 32, 32, 16, 16, 3, 1), (1, 32, 32, 16, 16, 7, 1),
              (1, 8, 8, 16, 16, 3, 1), (1, 32, 32, 32, 32, 3, 1)):
        assert C.default_f_tile(*s) == {"bp": 32, "q": 4}, s
    assert C.conv_f_plan(1, 10, 10, 128, 64, 3, 1, 32, 4)["grid"] == (4, 4)
    for s in ((256, 32, 32, 3, 16, 3, 1), (256, 16, 16, 16, 32, 3, 1),
              (256, 8, 8, 32, 64, 3, 1), (256, 16, 16, 16, 32, 1, 1)):
        assert C.default_f_tile(*s) == {"bp": 128, "q": 16}, s
    # narrow groups: 8 channels a thread (128 blocks of 32 pixels), or 4
    # for 3 channels a group (64-pixel blocks, 64 x 2 of them); a small
    # job of 16 blocks at best falls back to 32 x 4
    assert C.default_f_tile(64, 8, 8, 8, 8, 3, 1) == {"bp": 32, "q": 8}
    assert C.default_f_tile(64, 8, 8, 6, 6, 3, 2) == {"bp": 64, "q": 4}
    assert C.default_f_tile(8, 8, 8, 8, 8, 3, 1) == {"bp": 32, "q": 4}
    # the float add conv's: the float conv's at groups=1
    assert C.default_f_tile(1, 10, 10, 16, 16, 3, 1) == {"bp": 32, "q": 4}
    assert C.default_f_tile(256, 16, 16, 16, 32, 3, 1) == {"bp": 128,
                                                           "q": 16}


def _f_args(add, cx=6, cy=10, hk=3, g=2):
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((2, 7, 6, cx))
                         .astype(np.float32))
    if add:
        w = torch.from_numpy(rng.standard_normal((hk, hk, cx, cy))
                             .astype(np.float32))
        return A.add_conv2d_f, (x, w), dict(act="relu")
    w = torch.from_numpy(rng.standard_normal((hk, hk, cx // g, cy))
                         .astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(cy).astype(np.float32))
    return C.conv2d_f, (x, w, b), dict(groups=g, act="relu")


@pytest.mark.parametrize("add", [False, True], ids=["conv", "add"])
@pytest.mark.parametrize("knobs,match", [
    (dict(bp=48), "bp must be"), (dict(bp=512), "bp must be"),
    (dict(bp=True), "bp must be"), (dict(q=12), "q must be"),
    (dict(q=2), "q must be"), (dict(bp=64.0), "bp must be"),
    (dict(threads=256), "threads")], ids=str)
def test_float_wrappers_reject_bad_tiles(add, knobs, match):
    fn, args, kw = _f_args(add)
    with pytest.raises((ValueError, TypeError), match=match):
        fn(*args, **kw, **knobs)


@pytest.mark.parametrize("add", [False, True], ids=["conv", "add"])
def test_float_wrappers_take_every_tile_on_the_host(add):
    """On host tensors every tile of the space (and bp = 96) runs the plain
    version: the default's output."""
    fn, args, kw = _f_args(add)
    want = fn(*args, **kw)
    for bp in C.CONV_BP + (96,):
        for q in C.CONV_Q:
            assert torch.equal(fn(*args, **kw, bp=bp, q=q), want)


def test_float_tile_over_shared_memory_is_rejected():
    """Cx = 512 at 64x64: a 256-pixel block's 6 x 66 x 513-float window is
    over the 232,448 bytes a block can use; 32-pixel blocks fit, and the
    default falls back to one."""
    assert C.conv_f_plan(*WIDE, 256, 16)["smem"] > C.MAX_DYNAMIC_SMEM
    assert not C.tile_errors(C.conv_f_plan(*WIDE, 32, 16))
    x = torch.zeros(WIDE[:4])
    w = torch.zeros((3, 3, 512, 64))
    with pytest.raises(ValueError, match="shared memory"):
        C.conv2d_f(x, w, bp=256, q=16)
    with pytest.raises(ValueError, match="shared memory"):
        A.add_conv2d_f(x, w, bp=256, q=16)
    assert C.default_f_tile(*WIDE) == {"bp": 32, "q": 16}
    for sig, dt in ((tune.sig_conv2d(*WIDE), "float32"),
                    (tune.sig_add_conv2d(*WIDE[:6]), "bfloat16")):
        errs = tune.space.launch_errors(sig, {"bp": 256, "q": 16}, dt)
        assert errs and "shared memory" in errs[0]
        cands = list(tune.candidates(sig, dt))
        assert {"bp": 256, "q": 16} not in cands
        assert {"bp": 32, "q": 16} in cands
        assert not tune.space.launch_errors(
            sig, tune.default_config(sig.kernel, sig, dt), dt)
        with pytest.raises(ValueError, match="cannot launch"):
            tune.check_config(sig, {"bp": 128, "q": 4}, dt)


def test_float_conv_and_add_sigs_take_tiles():
    """The float conv2d and add_conv2d are tiled (the integer add takes the
    same tile), and the tuner's plans are the wrappers'."""
    csig = tune.sig_conv2d(8, 16, 16, 16, 32, 3, 2)
    asig = tune.sig_add_conv2d(8, 16, 16, 16, 32, 3)
    for dt in ("float32", "bfloat16"):
        assert tune.space.knobs("conv2d", dt) == ("bp", "q")
        assert tune.space.knobs("add_conv2d", dt) == ("bp", "q")
        assert tune.space.tiled("add_conv2d", dt)
        assert tune.space.tile_plan(csig, 64, 8, dt) == \
            C.conv_f_plan(8, 16, 16, 16, 32, 3, 2, 64, 8)
        assert tune.space.tile_plan(asig, 64, 8, dt) == \
            A.add_f_plan(8, 16, 16, 16, 32, 3, 64, 8)
        assert tune.default_config("add_conv2d", asig, dt) == \
            C.default_f_tile(8, 16, 16, 16, 32, 3, 1)
        assert len(list(tune.candidates(asig, dt))) == 12
    for dt in ("int8", "w4a8"):
        assert tune.space.knobs("add_conv2d", dt) == ("bp", "q")
        assert tune.space.tile_plan(asig, 64, 8, dt) == \
            A.add_f_plan(8, 16, 16, 16, 32, 3, 64, 8)
        assert tune.default_config("add_conv2d", asig, dt) == \
            C.default_f_tile(8, 16, 16, 16, 32, 3, 1)


# ---------------------------------------------- the integer add conv --

# (n, h, w, cx, cy, hk), bp, q -> (grid, threads, window, smem, block
# channels, K chunk, pixels a thread), counted by hand as F_PLANS: the
# integer add stages x << xp and w << wp as 4-byte elements, so its plan is
# the float implicit GEMM's at groups = 1
INT_ADD_PLANS = [
    # add0 at B=256 on its default tile: 128 pixels, 2 a thread (64
    # threads, one group of 16 channels); runs of 4 rows of 32 that may
    # cross one image boundary: 4 + 2 + 2 rows of 34 x 3 (ps 3); K = 27
    ((256, 32, 32, 3, 16, 3), 128, 16,
     ((2048, 1), 64, 4 * 816, 4 * (816 + 27 * 16 + 27 + 128 + 8), 16, 27,
      2)),
    # add2 at B=256 on its default tile: 16 rows of 8 (2 images) a block,
    # the plan allowing for 2 image boundaries (4 padding rows); 2 groups
    # of 16 channels, 288 K x 32 channels resident
    ((256, 8, 8, 32, 64, 3), 128, 16,
     ((128, 2), 128, 4 * 22 * 10 * 33, 4 * (22 * 10 * 33 + 288 * 32 + 288
                                            + 128 + 22), 32, 288, 2)),
    # W4's odd Cx = 7 at HK = 5 (ps 7): 64 pixels span all 9 rows of 9,
    # 2 groups of 8 channels; 1,183 window elements rounded to 1,184
    ((1, 9, 9, 7, 12, 5), 64, 8,
     ((2, 1), 64, 4 * 1184, 4 * (1184 + 175 * 16 + 175 + 64 + 13), 16, 175,
      2)),
    # HK = 1: one row of 65,536 pixels, 4 a thread, 4 groups of 8
    ((256, 16, 16, 16, 32, 1), 128, 8,
     ((512, 1), 128, 4 * 128 * 17, 4 * (128 * 17 + 16 * 32 + 16 + 128 + 1),
      32, 16, 4)),
    # even HK = 2 (pads 1 and 0): runs of 32 span at most 6 rows of 7 and
    # one image boundary (1 padding row): 8 rows of 8 x 5
    ((2, 6, 7, 4, 8, 2), 32, 4,
     ((3, 1), 64, 4 * 320, 4 * (320 + 16 * 8 + 16 + 32 + 8), 8, 16, 1)),
]


@pytest.mark.parametrize("shape,bp,q,want", INT_ADD_PLANS, ids=str)
def test_int_add_plan_counts(shape, bp, q, want):
    grid, threads, window, smem, bn, kc, pt = want
    assert A.add_f_plan(*shape, bp, q) == dict(
        grid=grid, threads=threads, smem=smem, window=window,
        block_channels=bn, k_chunk=kc, pixels=pt)
    for dt in ("int8", "w4a8"):
        assert tune.space.tile_plan(tune.sig_add_conv2d(*shape), bp, q,
                                    dt) == A.add_f_plan(*shape, bp, q)


def _int_add_args(w4, cx=5, cy=10, hk=3):
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.integers(-128, 128, (2, 7, 6, cx))
                         .astype(np.int8))
    b = torch.from_numpy(rng.integers(-500, 500, cy).astype(np.int32))
    kw = dict(requant_shift=9, x_preshift=2, w_preshift=1, act="relu")
    if w4:
        q = rng.integers(-8, 8, (hk, hk, cx, cy)).astype(np.int8)
        wp = pack_w4(torch.from_numpy(q), 2).contiguous()
        ws = torch.from_numpy(rng.integers(0, 5, cx).astype(np.int8))
        return A.add_conv2d_w4, (x, wp, ws, b), kw
    w = torch.from_numpy(rng.integers(-128, 128, (hk, hk, cx, cy))
                         .astype(np.int8))
    return A.add_conv2d_q8, (x, w, b), kw


@pytest.mark.parametrize("w4", [False, True], ids=["q8", "w4"])
@pytest.mark.parametrize("knobs,match", [
    (dict(bp=48), "bp must be"), (dict(bp=512), "bp must be"),
    (dict(bp=True), "bp must be"), (dict(q=12), "q must be"),
    (dict(q=2), "q must be"), (dict(threads=256), "threads")], ids=str)
def test_int_add_wrappers_reject_bad_tiles(w4, knobs, match):
    fn, args, kw = _int_add_args(w4)
    with pytest.raises((ValueError, TypeError), match=match):
        fn(*args, **kw, **knobs)


@pytest.mark.parametrize("w4", [False, True], ids=["q8", "w4"])
def test_int_add_wrappers_take_every_tile_on_the_host(w4):
    """On host tensors every tile of the space (and bp = 96) runs the plain
    version: the default's output."""
    fn, args, kw = _int_add_args(w4)
    want = fn(*args, **kw)
    for bp in C.CONV_BP + (96,):
        for q in C.CONV_Q:
            assert torch.equal(fn(*args, **kw, bp=bp, q=q), want)


def test_int_add_default_tiles_and_footprint():
    """The integer add's default tile is the float add's; a window over the
    232,448 bytes a block can use is refused by the wrapper and the tuner
    alike (Cx = 512 at 64 x 64, as for the float GEMM)."""
    for s in ((256, 32, 32, 3, 16, 3), (256, 16, 16, 16, 32, 3),
              (256, 8, 8, 32, 64, 3), (1, 10, 10, 16, 16, 3)):
        for dt in ("int8", "w4a8"):
            assert tune.default_config("add_conv2d", tune.sig_add_conv2d(*s),
                                       dt) == C.default_f_tile(*s, 1)
    assert C.default_f_tile(1, 10, 10, 16, 16, 3, 1) == {"bp": 32, "q": 4}
    assert C.default_f_tile(256, 8, 8, 32, 64, 3, 1) == {"bp": 128, "q": 16}
    x = torch.zeros(WIDE[:4], dtype=torch.int8)
    w = torch.zeros((3, 3, 512, 64), dtype=torch.int8)
    with pytest.raises(ValueError, match="shared memory"):
        A.add_conv2d_q8(x, w, requant_shift=9, bp=256, q=16)
    sig = tune.sig_add_conv2d(*WIDE[:6])
    errs = tune.space.launch_errors(sig, {"bp": 256, "q": 16}, "int8")
    assert errs and "shared memory" in errs[0]
    assert {"bp": 256, "q": 16} not in list(tune.candidates(sig, "w4a8"))


# ------------------------------------------------ the depthwise conv --

D = importlib.import_module("repro_torch.kernels.conv_dw")

# (n, h, w, c, hk), esize, pt, rows -> (grid, threads, window, smem), counted
# by hand from the staged-row layout: a block of min(rows, H) rows x the
# row's ceil(W / pt) column groups (runs of 256 // rows where the row alone
# is over 256) x as many 4-channel vectors as keep it at most 128 threads
# (at least one); the window (rows + HK-1) x (columns + HK-1) x 4 x vectors
# elements of esize bytes, rounded to 16 bytes, then HK^2 x the slab's
# channels of weights (int8, or float32 for the float modes)
DW_PLANS = [
    # dws dw1 at B=256, int8, 1 x 8: 16 groups x 8 rows = 128 threads of one
    # vector; 10 x 18 x 4 bytes
    ((256, 16, 16, 16, 3), 1, 1, 8, ((512, 4), 128, 720, 720 + 9 * 4)),
    # dw1, 2 pixels a thread x 2 rows: 8 x 2 groups x all 4 vectors
    ((256, 16, 16, 16, 3), 1, 2, 2,
     ((2048, 1), 64, 4 * 18 * 16, 4 * 18 * 16 + 9 * 16)),
    # dws dw2 at B=256: one 8 x 8 image a block, 2 vectors (8 channels)
    ((256, 8, 8, 32, 3), 1, 1, 8, ((256, 4), 128, 800, 800 + 9 * 8)),
    # Table-2 1x32x32x64 float32, 1 x 4: 32 x 4 groups, one vector, 16
    # slabs; weights as float32
    ((1, 32, 32, 64, 3), 4, 1, 4,
     ((8, 16), 128, 6 * 34 * 4 * 4, 6 * 34 * 16 + 9 * 4 * 4)),
    # the same in bfloat16, 2 x 1: 16 groups x 8 vectors (32 channels)
    ((1, 32, 32, 64, 3), 2, 2, 1,
     ((32, 2), 128, 3 * 34 * 32 * 2, 3 * 34 * 64 + 9 * 32 * 4)),
    # a row of 300 columns: runs of 256 // 2 = 128 columns, 3 a row
    ((1, 3, 300, 8, 3), 1, 1, 2,
     ((6, 2), 256, 4 * 130 * 4, 4 * 130 * 4 + 9 * 4)),
    # C = 19 (5 vectors, the last with 3 channels) at HK = 5, 4 x 4
    ((2, 15, 13, 19, 5), 1, 4, 4,
     ((8, 1), 80, 8 * 20 * 20, 8 * 20 * 20 + 25 * 20)),
    # HK = 7 float32, 2 x 8: 6 groups x 8 rows x 2 vectors
    ((1, 12, 11, 8, 7), 4, 2, 8,
     ((2, 1), 96, 14 * 18 * 8 * 4, 14 * 18 * 32 + 49 * 8 * 4)),
    # HK = 1 bfloat16: no halo
    ((2, 8, 8, 7, 1), 2, 1, 8, ((2, 1), 128, 8 * 8 * 8 * 2, 1024 + 8 * 4)),
    # even HK = 2 (pads 1 and 0): 5 x 15 x 8 bytes rounded to 608
    ((2, 5, 13, 7, 2), 1, 2, 4, ((4, 1), 56, 608, 608 + 4 * 8)),
    # rows capped at H = 3
    ((4, 3, 5, 16, 3), 1, 1, 8, ((4, 1), 60, 5 * 7 * 16, 560 + 9 * 16)),
]


@pytest.mark.parametrize("shape,esize,pt,rows,want", DW_PLANS, ids=str)
def test_dw_plan_counts(shape, esize, pt, rows, want):
    grid, threads, window, smem = want
    p = D.dw_plan(*shape, esize, pt, rows)
    assert (p["grid"], p["threads"], p["window"], p["smem"]) == want
    assert p["threads"] <= D.DW_MAX_THREADS and not D.dw_tile_errors(p)


def _dw_blocks(n, h, w, c, hk, esize, pt, rows):
    """Each block and thread of the staged-row kernel as the source maps
    them from blockIdx and threadIdx: (window rows, window columns, the
    window's first input row and column, [(row, column, channel) of each
    output the thread owns, and its window row and column])."""
    p = D.dw_plan(n, h, w, c, hk, esize, pt, rows)
    r, bw, ps = p["rows"], p["columns"], p["channels"]
    csv, cg = ps // 4, bw // pt
    rb, cb = -(-h // r), -(-w // bw)
    for bx in range(p["grid"][0]):
        b, rem = divmod(bx, rb * cb)
        ry, cx_ = divmod(rem, cb)
        y0, x0 = ry * r, cx_ * bw
        for by in range(p["grid"][1]):
            c0 = by * ps
            outs = []
            for tid in range(p["threads"]):
                cv, t2 = tid % csv, tid // csv
                tc, tr = t2 % cg, t2 // cg
                for q in range(pt):
                    for e in range(4):
                        oy, ox, ch = y0 + tr, x0 + tc * pt + q, c0 + 4 * cv + e
                        if oy < h and ox < w and ch < c:
                            outs.append((b, oy, ox, ch, tr, tc * pt + q))
            yield r + hk - 1, bw + hk - 1, y0 - hk // 2, x0 - hk // 2, outs


@pytest.mark.parametrize("shape", [
    (2, 9, 11, 16, 3), (1, 8, 8, 32, 3), (2, 7, 6, 19, 5), (2, 5, 13, 7, 2),
    (1, 6, 5, 12, 1), (1, 12, 11, 8, 7), (1, 3, 300, 8, 3)], ids=str)
@pytest.mark.parametrize("pt,rows", [(1, 1), (2, 4), (4, 8), (4, 2)])
def test_dw_plan_window_holds_every_tap(shape, pt, rows):
    """Every output is owned by exactly one thread; every tap it reads lies
    inside its block's staged window, at the input row and column the TPU
    kernels' (HK//2, (HK-1)//2) padding gives (even HK and HK = 7
    included), and the window fits the bytes the plan sizes."""
    n, h, w, c, hk = shape
    owned = set()
    p = D.dw_plan(*shape, 1, pt, rows)
    for wr, wc, iy0, ix0, outs in _dw_blocks(*shape, 1, pt, rows):
        assert wr * wc * p["channels"] <= p["window"]
        for b, oy, ox, ch, r, col in outs:
            assert (b, oy, ox, ch) not in owned
            owned.add((b, oy, ox, ch))
            for i in range(hk):
                for j in range(hk):
                    assert r + i < wr and col + j < wc
                    assert iy0 + r + i == oy + i - hk // 2
                    assert ix0 + col + j == ox + j - hk // 2
    assert len(owned) == n * h * w * c


def test_default_dw_tiles():
    """The most pixels a thread whose grid holds 128 blocks, then the most
    rows that keep two channel vectors a block: the dws rows at B=256 take
    4 x 8 (dw1: 512 blocks of all 16 channels), Table-2's n = 1 job 1 x 2
    (128 blocks of 8 channels; 1 x 4 holds 128 blocks too, of 4
    channels); a job too small for 128 blocks at any tile takes 1 x 1."""
    for es in (1, 2, 4):
        assert D.default_dw_tile(256, 16, 16, 16, 3, es) == \
            {"pt": 4, "rows": 8}
        assert D.default_dw_tile(256, 8, 8, 32, 3, es) == \
            {"pt": 4, "rows": 8}
        assert D.default_dw_tile(1, 32, 32, 64, 3, es) == \
            {"pt": 1, "rows": 2}
    assert D.dw_plan(256, 16, 16, 16, 3, 1, 4, 8)["grid"] == (512, 1)
    p = D.dw_plan(1, 32, 32, 64, 3, 4, 1, 4)
    assert p["grid"] == (8, 16) and p["channels"] == 4
    assert D.default_dw_tile(1, 8, 8, 8, 3, 1) == {"pt": 1, "rows": 1}
    for dt, es in (("int8", 1), ("w4a8", 1), ("float32", 4),
                   ("bfloat16", 2)):
        sig = tune.sig_depthwise2d(1, 32, 32, 64, 3)
        assert tune.default_config("depthwise2d", sig, dt) == \
            D.default_dw_tile(1, 32, 32, 64, 3, es)


def _dw_args(mode, c=6, hk=3):
    rng = np.random.default_rng(12)
    if mode == "f":
        x = torch.from_numpy(rng.standard_normal((2, 7, 6, c))
                             .astype(np.float32))
        w = torch.from_numpy(rng.standard_normal((hk, hk, c))
                             .astype(np.float32))
        return D.depthwise2d_f, (x, w), dict(act="relu")
    x = torch.from_numpy(rng.integers(-128, 128, (2, 7, 6, c))
                         .astype(np.int8))
    kw = dict(requant_shift=7, act="relu")
    if mode == "w4":
        q = rng.integers(-8, 8, (hk, hk, c)).astype(np.int8)
        wp = pack_w4(torch.from_numpy(q), 0).contiguous()
        ws = torch.from_numpy(rng.integers(0, 5, hk).astype(np.int8))
        return D.depthwise2d_w4, (x, wp, ws), kw
    w = torch.from_numpy(rng.integers(-128, 128, (hk, hk, c))
                         .astype(np.int8))
    return D.depthwise2d_q8, (x, w), kw


@pytest.mark.parametrize("mode", ["q8", "w4", "f"])
@pytest.mark.parametrize("knobs,match", [
    (dict(pt=3), "pt must be"), (dict(pt=8), "pt must be"),
    (dict(pt=True), "pt must be"), (dict(rows=3), "rows must be"),
    (dict(rows=16), "rows must be"), (dict(rows=2.0), "rows must be"),
    (dict(threads=256), "threads")], ids=str)
def test_dw_wrappers_reject_bad_tiles(mode, knobs, match):
    fn, args, kw = _dw_args(mode)
    with pytest.raises((ValueError, TypeError), match=match):
        fn(*args, **kw, **knobs)


@pytest.mark.parametrize("mode", ["q8", "w4", "f"])
def test_dw_wrappers_take_every_tile_on_the_host(mode):
    """On host tensors every tile of the space runs the plain version: the
    default's output."""
    fn, args, kw = _dw_args(mode)
    want = fn(*args, **kw)
    for pt in D.DW_PT:
        for rows in D.DW_ROWS:
            assert torch.equal(fn(*args, **kw, pt=pt, rows=rows), want)


def test_dw_tile_over_shared_memory_is_rejected():
    """HK = 181 on a 4 x 4 image: even one row's window (181 x 184 pixels
    of 4 float32 channels) is over the 232,448 bytes a block can use, so
    every tile is refused, by the wrapper and the tuner."""
    p = D.dw_plan(1, 4, 4, 4, 181, 4, 1, 1)
    assert p["window"] == 181 * 184 * 16
    assert D.dw_tile_errors(p)
    x = torch.zeros((1, 4, 4, 4))
    w = torch.zeros((181, 181, 4))
    with pytest.raises(ValueError, match="shared memory"):
        D.depthwise2d_f(x, w)
    sig = tune.sig_depthwise2d(1, 4, 4, 4, 181)
    errs = tune.space.launch_errors(sig, {"pt": 1, "rows": 1}, "float32")
    assert errs and "shared memory" in errs[0]
    # a wide image is cut into runs of columns, so it always fits
    assert not D.dw_tile_errors(D.dw_plan(1, 2, 100000, 64, 3, 4, 4, 8))


def test_dw_sigs_take_tiles():
    """depthwise2d's knobs are (pt, rows) in every mode; the tuner's plan
    and footprint check read dw_plan at the mode's element size."""
    sig = tune.sig_depthwise2d(256, 16, 16, 16, 3)
    for dt in ("int8", "w4a8", "float32", "bfloat16"):
        assert tune.space.knobs("depthwise2d", dt) == ("pt", "rows")
        assert not tune.space.threaded("depthwise2d", dt)
        assert len(list(tune.candidates(sig, dt))) == 12
    # the analytic model (what a plan launches with no tuned cache) picks
    # the default tile at the dws rows and Table-2's float32 job
    for s, dt in (((256, 16, 16, 16, 3), "int8"), ((256, 8, 8, 32, 3), "w4a8"),
                  ((1, 32, 32, 64, 3), "float32")):
        ds = tune.sig_depthwise2d(*s)
        assert tune.analytic_config(ds, dt) == \
            tune.default_config("depthwise2d", ds, dt)
    with pytest.raises(ValueError, match="cannot launch|outside|unknown"):
        tune.check_config(sig, {"threads": 256}, "int8")
    with pytest.raises(ValueError, match="cannot launch"):
        tune.check_config(sig, {"pt": 3, "rows": 2}, "int8")
