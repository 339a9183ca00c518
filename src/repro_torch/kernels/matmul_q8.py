"""int8 and W4A8 matmul with the Algorithm-1 epilogue, and the float
matmul: the CUDA kernel wrappers, their plain PyTorch versions and their
launch counters.

Replaces the TPU kernel ``repro/kernels/matmul_q8.py`` (``matmul`` /
``_matmul``) in all its modes; the source is ``csrc/matmul_q8.cu``.
The LM's integer FFN (``models/blocks.qmlp``) runs its three projections
through it. What bounds it on an H100: at decode (8 rows) each launch reads
one whole 896x4864 weight, 4.36 MB in int8 and 2.18 MB in W4, for 70 M
operations, so device-memory bytes set the floor (about 1.3 us and 0.65 us
at 3.35 TB/s), and at prefill (32-128 rows) the int8 tensor cores keep the
operations below it; the design is in the source's header, its distance
from that floor in PERF.md.

Both modes take ``a`` (M, K) int8 codes; :func:`matmul_q8` takes ``b`` (K,
N) int8, :func:`matmul_w4` takes ``b`` nibble-packed along K, (ceil(K/2),
N), with one int8 group shift per K element (``core.quantize.QTensorW4``'s
``q`` and ``shifts``). Each returns (M, N) int8: the exact int32 products,
relu at accumulator scale if asked, ``rshift_round(requant_shift)`` and a
clip to int8.

The plain versions contract in int32 on the host and in float64 on a card,
which has no int32 matmul; float64 is exact here, since |sum| <=
K * 128 * 128 < 2^31 < 2^53 for every K the wrappers accept.

The integer modes are one launch a product: a block of eight warps (four
past 16 rows) owns ``bn`` output columns x ``bm`` rows of ``a``, the
64-deep K stages are dealt to the warps of a thread-block cluster of
``cluster`` blocks, each warp streams its stages through a private
``cp.async`` ring in 16-byte copies and sums them on the int8 tensor
cores (``mma.sync`` m16n8k32, the weights as the mma's 16-row side), and
the partial tiles are summed on chip: the block's warps through shared memory, the cluster's blocks
through distributed shared memory into the leader block, which applies
the epilogue. No workspace, atomics or second kernel. The tile
(``bn``, ``bm``) is one of :data:`MMQ_TILES` (template instantiations) and
``cluster`` one of :data:`MMQ_CLUSTERS`: the tuner's knobs, defaulting to
:func:`default_mmq_config`; :func:`mmq_plan` is the launch arithmetic,
held equal to the source's ``repro_matmul_q8_plan``. No knob changes an
output: integer sums do not depend on order.

The float mode (:func:`matmul_f`, float32 or bfloat16) is a register-tiled
GEMM bound by operations: a block owns a ``bm`` x ``bn`` output tile, each
thread a ``tm`` x ``tn`` register tile, A and B staged in shared memory in
64-deep K stages with ``cp.async``, a ring of three stages with two in
flight. The tile is one of
:data:`MMF_TILES` (template instantiations, the tuner's knobs;
:func:`mmf_plan` is its launch arithmetic, :func:`default_mmf_tile` the
wrapper's choice). Every accumulator sums K strictly in order in float32
from +0, one rounded multiply and one rounded add per element, with no
FMA, no K split and no tensor core, so its plain version, which repeats
that order one multiply and one add at a time, is bitwise equal to it; the
cost is a float32 ceiling at half the card's FMA rate.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.quantize import expand_w4

from ._build import check_launch, library
from .common import acc_dtype, apply_act, apply_requant, cdiv, float_code
from .conv_im2col import (MAX_CONTRACTION, MAX_DYNAMIC_SMEM, MAX_GRID_Y,
                          check_act, check_cuda_operand, check_elements,
                          check_shift, check_w4)

#: the integer modes' tiles (bn, bm), csrc/matmul_q8.cu's MMQ_TILES in its
#: order: a block of bn output columns x bm rows of a
MMQ_TILES = ((32, 8), (64, 8), (128, 8), (32, 16), (64, 16), (128, 16),
             (32, 32), (64, 32), (128, 32), (32, 64), (64, 64))
#: the integer modes' knobs, in a config's order, and the cluster sizes
#: (blocks that split K; 8 is the portable limit)
MMQ_KNOBS = ("bn", "bm", "cluster")
MMQ_CLUSTERS = (1, 2, 4, 8)
#: K elements a warp stage and bytes a staged row of a (csrc QBK, QAP)
MMQ_BK, MMQ_APITCH = 64, 80
#: the float mode's tiles (bm, bn, tm, tn), csrc/matmul_q8.cu's MMF_TILES in
#: its order: a block of bm x bn outputs, a thread of tm x tn
MMF_TILES = ((16, 32, 2, 2), (16, 64, 2, 4), (32, 32, 2, 2), (32, 32, 2, 4),
             (32, 64, 2, 4), (32, 64, 4, 4), (64, 64, 4, 4), (64, 64, 8, 4))
#: the float mode's tile knobs, in a config's order
MMF_KNOBS = ("bm", "bn", "tm", "tn")
#: K elements per float stage and stages in its shared ring (csrc FBK,
#: FNS); the ring is dynamic shared memory (above 48 KB after
#: cudaFuncSetAttribute, which the source calls)
MMF_BK, MMF_STAGES = 64, 3
#: the float default tiles: the large one where its grid holds about a
#: block per SM of an H100 (MMF_BLOCKS), else the small one (PERF.md)
MMF_LARGE, MMF_SMALL, MMF_BLOCKS = (32, 64, 2, 4), (16, 32, 2, 2), 128


def _contract(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``a @ b`` of two int8 (or int8-valued) operands."""
    if a.device.type == "cpu":
        return torch.mm(a.to(torch.int32), b.to(torch.int32))
    return torch.mm(a.to(torch.float64), b.to(torch.float64)).to(torch.int32)


def matmul_q8_plain(a, b, *, requant_shift: int = 0, act=None):
    """Plain PyTorch version: exact int32 contraction, the common
    epilogue."""
    acc = apply_act(_contract(a, b), act)
    return apply_requant(acc, requant_shift).to(torch.int8)


def matmul_w4_plain(a, b_p, w_shifts, *, requant_shift: int = 0, act=None):
    """Plain W4 version: the weight codes expanded (``expand_w4`` along K),
    then :func:`matmul_q8_plain` unchanged."""
    b = expand_w4(b_p, w_shifts, a.shape[-1], 0)
    return matmul_q8_plain(a, b, requant_shift=requant_shift, act=act)


def mmq_warps(bm: int) -> int:
    """Warps a block (csrc QTile::WARPS): 8 for the decode tiles (bm <=
    16), 4 for the taller ones."""
    return 8 if bm <= 16 else 4


def mmq_ring(bm: int) -> int:
    """Stages in a warp's ring (csrc QTile::RING): 4 for the decode tiles
    (bm <= 16), 3 for the taller ones."""
    return 4 if bm <= 16 else 3


def _mmq_stage(bn: int, bm: int, w4: bool) -> int:
    """Bytes of one warp stage: b's 64 rows (W4: 32 packed) x bn, a's bm
    padded rows and, in W4, the stage's 64 group shifts."""
    return ((MMQ_BK // 2 if w4 else MMQ_BK) * bn + bm * MMQ_APITCH
            + (MMQ_BK if w4 else 0))


def mmq_plan(m: int, k: int, n: int, bn: int, bm: int, cluster: int,
             w4: bool = False) -> dict:
    """The integer modes' launch arithmetic, as ``launch_q`` in
    ``csrc/matmul_q8.cu`` computes it: ``grid`` (x: column tiles x the
    cluster, y: row tiles), ``cluster``, ``threads`` (:func:`mmq_warps`),
    ``smem`` (dynamic shared bytes: the warps' rings of ``ring`` stages, or
    their int32 partial tiles if larger, then the leader's inbox of
    cluster - 1 partial tiles) and ``stages`` (the 64-deep K stages of the
    busiest warp)."""
    warps, ring = mmq_warps(bm), mmq_ring(bm)
    tile = bm * bn * 4
    smem = (max(warps * ring * _mmq_stage(bn, bm, w4), warps * tile)
            + (cluster - 1) * tile)
    return dict(grid=(cdiv(n, bn) * cluster, cdiv(m, bm)), cluster=cluster,
                threads=32 * warps, smem=smem,
                stages=cdiv(cdiv(k, MMQ_BK), cluster * warps), ring=ring)


def mmq_bm_cap(m: int) -> int:
    """The tallest ``bm`` worth launching for M rows: the least power of
    two from 8 that holds them, at most 64."""
    bm = 8
    while bm < min(m, 64):
        bm *= 2
    return bm


def mmq_cluster_cap(k: int, bm: int) -> int:
    """The largest cluster whose every warp, of a block ``bm`` rows tall,
    gets a K stage (1 at least)."""
    stages = cdiv(k, MMQ_BK)
    return max(c for c in MMQ_CLUSTERS
               if c == 1 or mmq_warps(bm) * c <= stages)


def default_mmq_config(m: int, k: int, n: int, sms: int = 132) -> dict:
    """The integer wrappers' own launch, the fastest config at Qwen2-0.5B's
    FFN shapes and Table-2's on an H100 (PERF.md,
    ``scripts/torch_matmul_tiles.py``). ``bm`` the least of
    :data:`MMQ_TILES`' heights that holds M, at most 32 for M <= 64, else
    64. A decode tile (bm <= 16, 8 warps a block) takes 64 columns with no
    cluster where that gives at least ``sms / 2`` blocks (as many warps as
    ``sms`` blocks of 4), else 32 columns on the smallest cluster that does
    (decode: gate/up 64 x 8, 76 blocks; down 32 x 8 x 4, 112). A taller
    tile (4 warps) takes 32 columns, at 64 rows 64 x 64 first and then 32 x
    32, on the smallest cluster that gives ``sms`` blocks. Where none does,
    the one with the most blocks; no cluster leaves a warp without a K
    stage."""
    bm = min(mmq_bm_cap(m), 32) if m <= 64 else 64
    if bm <= 16:
        want = cdiv(sms, 2)
        tries = [(64, bm, 1)] + [(32, bm, c) for c in MMQ_CLUSTERS]
    else:
        want = sms
        tries = [(bm, bm, c) for c in MMQ_CLUSTERS]
        if bm == 64:
            tries += [(32, 32, c) for c in MMQ_CLUSTERS]
    tries = [t for t in tries if t[2] <= mmq_cluster_cap(k, t[1])]

    def blocks(t):
        return cdiv(n, t[0]) * cdiv(m, t[1]) * t[2]
    bn, bm, c = next((t for t in tries if blocks(t) >= want),
                     max(tries, key=blocks))
    return dict(bn=bn, bm=bm, cluster=c)


def mmq_config_errors(m: int, k: int, n: int, cfg: dict,
                      w4: bool = False) -> list:
    """Why an integer config cannot launch on an H100: a tile with no
    instantiation, a cluster size other than 1, 2, 4 or 8 (8 is the
    portable limit), shared bytes over the limit or a grid too large.
    Empty if it can."""
    bn, bm, c = (cfg.get(x) for x in MMQ_KNOBS)
    errs = []
    if (bn, bm) not in MMQ_TILES:
        errs.append(f"tile bn={bn!r} bm={bm!r} is not one of the "
                    f"instantiated {MMQ_TILES}")
    if c not in MMQ_CLUSTERS:
        errs.append(f"cluster={c!r} is not one of {MMQ_CLUSTERS} (a "
                    "portable cluster holds at most 8 blocks)")
    if errs and not (isinstance(bn, int) and isinstance(bm, int)
                     and isinstance(c, int) and bn > 0 and bm > 0 and c > 0):
        return errs
    plan = mmq_plan(m, k, n, bn, bm, c, w4)
    if plan["smem"] > MAX_DYNAMIC_SMEM:
        errs.append(f"{plan['smem']} bytes of shared memory exceed the "
                    f"{MAX_DYNAMIC_SMEM} a block can use")
    if plan["grid"][1] > MAX_GRID_Y:
        errs.append(f"M / bm = {plan['grid'][1]} exceeds the grid's y limit")
    if plan["grid"][0] > 2 ** 31 - 1:
        errs.append(f"{plan['grid'][0]} column blocks exceed the grid")
    return errs


def check_mmq_config(name: str, m: int, k: int, n: int, w4: bool,
                     **knobs) -> tuple:
    """The (bn, bm, cluster) an integer call launches: the knobs given, the
    rest from :func:`default_mmq_config` on the card the call runs on;
    raises if it cannot launch."""
    d = default_mmq_config(m, k, n, knobs.pop("sms"))
    cfg = {x: d[x] if knobs[x] is None else knobs[x] for x in MMQ_KNOBS}
    errs = mmq_config_errors(m, k, n, cfg, w4)
    if errs:
        raise ValueError(f"{name}: " + "; ".join(errs))
    return tuple(cfg[x] for x in MMQ_KNOBS)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_mm(name, a, k, n_rows_b, n, requant_shift, act):
    if a.dim() != 2:
        raise ValueError(f"{name}: a must be (M, K), got {tuple(a.shape)}")
    if a.shape[1] != k:
        raise ValueError(f"{name}: a {tuple(a.shape)} and b of K={k} do "
                         "not contract")
    if k > MAX_CONTRACTION:
        raise ValueError(f"{name}: K={k} could overflow the int32 "
                         "accumulator")
    check_shift(name, requant_shift)
    check_act(name, act)
    check_elements(name, a.shape, (n_rows_b, n), (a.shape[0], n))


def _launch(name, fn, a, operands, n, requant_shift, act, w4, knobs):
    """Allocate the output and launch ``fn`` with the config of
    ``knobs``."""
    m, k = a.shape
    tile = check_mmq_config(name, m, k, n, w4,
                            sms=_sm_count(a.device.index or 0), **knobs)
    y = torch.empty((m, n), dtype=torch.int8, device=a.device)
    with torch.cuda.device(a.device):
        rc = fn(a.data_ptr(), *(t.data_ptr() for t in operands),
                y.data_ptr(), m, k, n, *tile, requant_shift,
                int(act == "relu"), torch.cuda.current_stream().cuda_stream)
    check_launch(name, rc)
    return y


def matmul_q8(a, b, *, requant_shift: int = 0, act=None, bn=None, bm=None,
              cluster=None):
    """a (M,K) int8 @ b (K,N) int8 -> (M,N) int8. ``bn``, ``bm`` and
    ``cluster`` default to :func:`default_mmq_config`."""
    if b.dim() != 2:
        raise ValueError(f"matmul_q8: b must be (K, N), got "
                         f"{tuple(b.shape)}")
    k, n = b.shape
    _check_mm("matmul_q8", a, k, k, n, requant_shift, act)
    if a.device.type == "cpu":
        return matmul_q8_plain(a, b, requant_shift=requant_shift, act=act)
    for t in (a, b):
        check_cuda_operand("matmul_q8", t, a.device, torch.int8)
    y = _launch("matmul_q8", library().repro_matmul_q8, a, (b,), n,
                requant_shift, act, False,
                dict(bn=bn, bm=bm, cluster=cluster))
    matmul_q8.launches += 1
    return y


matmul_q8.launches = 0


def matmul_w4(a, b_p, w_shifts, *, requant_shift=None, act=None, bn=None,
              bm=None, cluster=None):
    """a (M,K) int8 @ b_p (ceil(K/2),N) int8 nibble-packed along K, with
    w_shifts (K,) int8 -> (M,N) int8."""
    if a.dim() != 2 or b_p.dim() != 2:
        raise ValueError(f"matmul_w4: a and b must be 2-D, got "
                         f"{tuple(a.shape)} and {tuple(b_p.shape)}")
    k = a.shape[1]
    check_w4("matmul_w4", b_p, 0, k, w_shifts, requant_shift)
    n = b_p.shape[1]
    _check_mm("matmul_w4", a, k, b_p.shape[0], n, requant_shift, act)
    if a.device.type == "cpu":
        return matmul_w4_plain(a, b_p, w_shifts, requant_shift=requant_shift,
                               act=act)
    for t in (a, b_p, w_shifts):
        check_cuda_operand("matmul_w4", t, a.device, torch.int8)
    y = _launch("matmul_w4", library().repro_matmul_w4, a, (b_p, w_shifts),
                n, requant_shift, act, True,
                dict(bn=bn, bm=bm, cluster=cluster))
    matmul_w4.launches += 1
    return y


matmul_w4.launches = 0


def mmf_plan(m: int, n: int, tile, esize: int = 4) -> dict:
    """The float mode's launch arithmetic for an (M, N) output and a tile
    (bm, bn, tm, tn), as ``launch_f`` in ``csrc/matmul_q8.cu`` computes it:
    ``grid`` (x, y), ``threads`` and ``smem`` (dynamic shared bytes: the
    ring's stages of A as words, k-major, and of B) for ``esize``-byte
    elements."""
    bm, bn, tm, tn = tile
    epw = 4 // esize
    smem = MMF_STAGES * ((MMF_BK // epw) * (bm + 4) * 4
                         + MMF_BK * bn * esize)
    return dict(grid=(cdiv(n, bn), cdiv(m, bm)),
                threads=(bm // tm) * (bn // tn), smem=smem)


def mmf_tile_errors(m: int, n: int, tile, esize: int = 4) -> list:
    """Why a float tile cannot launch on an H100: not instantiated, its
    shared bytes, threads or grid. Empty if it can."""
    if tuple(tile) not in MMF_TILES:
        return [f"tile {dict(zip(MMF_KNOBS, tile))} is not one of the "
                f"instantiated {MMF_TILES}"]
    plan = mmf_plan(m, n, tile, esize)
    errs = []
    if plan["smem"] > MAX_DYNAMIC_SMEM:
        errs.append(f"{plan['smem']} bytes of shared memory exceed the "
                    f"{MAX_DYNAMIC_SMEM} a block can use")
    if plan["threads"] > 1024:
        errs.append(f"{plan['threads']} threads a block exceed 1024")
    if plan["grid"][1] > MAX_GRID_Y:
        errs.append(f"M / bm = {plan['grid'][1]} exceeds the grid's y limit")
    return errs


def default_mmf_tile(m: int, n: int) -> dict:
    """The float wrapper's own tile: 32 x 64 blocks of 2 x 4 thread tiles
    where that grid holds ``MMF_BLOCKS`` blocks (512^2: 128), else 16 x 32
    blocks of 2 x 2 (256^2: 128 blocks); the fastest at Table-2's two
    shapes on an H100 (PERF.md)."""
    return dict(zip(MMF_KNOBS, _default_mmf_tile(m, n)))


def _default_mmf_tile(m: int, n: int) -> tuple:
    large = cdiv(m, MMF_LARGE[0]) * cdiv(n, MMF_LARGE[1]) >= MMF_BLOCKS
    return MMF_LARGE if large else MMF_SMALL


def check_mmf_tile(name: str, m: int, n: int, esize: int, **knobs) -> tuple:
    """The tile a float call launches: the knobs given, the rest from
    :func:`default_mmf_tile`; raises if it cannot launch."""
    d = _default_mmf_tile(m, n)
    tile = tuple(dv if knobs[k] is None else knobs[k]
                 for k, dv in zip(MMF_KNOBS, d))
    errs = mmf_tile_errors(m, n, tile, esize)
    if errs:
        raise ValueError(f"{name}: " + "; ".join(errs))
    return tile


def matmul_f_plain(a, b, *, act=None):
    """Plain float version in the kernel's order: float32 products and sums
    as separate operations from a zero accumulator, K in order; relu; one
    rounding to a's dtype."""
    a32, b32 = a.to(torch.float32), b.to(torch.float32)
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=acc_dtype(a.dtype),
                      device=a.device)
    for kk in range(a.shape[1]):
        acc = acc + a32[:, kk:kk + 1] * b32[kk]
    return apply_act(acc, act).to(a.dtype)


def matmul_f(a, b, *, act=None, bm=None, bn=None, tm=None, tn=None):
    """a (M,K) @ b (K,N), float32 or bfloat16 (one dtype) -> (M,N) in a's
    dtype. The tile (``bm``, ``bn``, ``tm``, ``tn``), one of
    :data:`MMF_TILES`, defaults knob by knob to :func:`default_mmf_tile`."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul_f: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} do not contract")
    m, k = a.shape
    n = b.shape[1]
    tile = check_mmf_tile("matmul_f", m, n,
                          2 if a.dtype == torch.bfloat16 else 4, bm=bm,
                          bn=bn, tm=tm, tn=tn)
    check_act("matmul_f", act)
    check_elements("matmul_f", a.shape, b.shape, (m, n))
    if a.device.type == "cpu":
        return matmul_f_plain(a, b, act=act)
    code = float_code("matmul_f", a)
    for t in (a, b):
        check_cuda_operand("matmul_f", t, a.device, a.dtype)
    y = torch.empty((m, n), dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        rc = library().repro_matmul_f(
            a.data_ptr(), b.data_ptr(), y.data_ptr(), m, k, n, *tile,
            int(act == "relu"), code, torch.cuda.current_stream().cuda_stream)
    check_launch("matmul_f", rc)
    matmul_f.launches += 1
    return y


matmul_f.launches = 0
