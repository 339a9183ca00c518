"""Analytical memory-access and MCU latency / power / energy models (paper
Figs 2-4, Tables 1 and 3).

Port of the MCU half of ``repro/core/energy.py``. The paper measures a
Cortex-M4 (STM32F401RE at 3.3 V) with a scope and a current shunt; these
models carry the same structure, calibrated to the paper's own Table 3:

  * theoretical MACs per primitive            -> Table 1 (``ConvSpec``)
  * memory accesses, direct vs im2col-blocked -> Fig 3 ratio
  * MCU latency and power vs frequency        -> Fig 4 / Table 3
  * energy = P(f) * latency                   -> Fig 2 c/e

They reproduce the paper's headline readings inside the model: energy
linear in the theoretical MACs without SIMD, latency the better predictor
with SIMD. Pure Python on :class:`~repro_torch.core.primitives.ConvSpec`;
every expression repeats the reference's, so both packages give the same
integers and the same floats.

:class:`H100` is the card's model, the counterpart of the JAX package's
``TPUv5e``: the one place the port keeps the card's peaks (the roofline
count, the tuner's cost model and ``chip_smoke.py``'s bounds read them).
"""
from __future__ import annotations

import dataclasses

from .primitives import ConvSpec

# --------------------------------------------------------------------------
# Memory-access model (element accesses for the scalar path, 32-bit word
# accesses for the SIMD path: what the Cortex-M issues).
# --------------------------------------------------------------------------


def patch_len(spec: ConvSpec) -> int:
    """im2col column length K of the primitive's matmul stage."""
    if spec.primitive in ("standard", "add"):
        return spec.kernel_size ** 2 * spec.in_channels
    if spec.primitive == "grouped":
        return spec.kernel_size ** 2 * (spec.in_channels // spec.groups)
    if spec.primitive in ("dws", "shift"):
        return spec.in_channels          # pointwise stage
    raise AssertionError


def accesses_direct(spec: ConvSpec, out_width: int) -> int:
    """Scalar loop: 2 loads per MAC + 1 store per output element. The
    depthwise stage of dws also stores its intermediate map; the shift
    stage of shift is 1 load + 1 store per input element."""
    hy2 = out_width ** 2
    macs = spec.mac_count(out_width)
    stores = hy2 * spec.out_channels
    extra = 0
    if spec.primitive == "dws":
        stores += hy2 * spec.in_channels           # intermediate map
    if spec.primitive == "shift":
        extra = 2 * hy2 * spec.in_channels         # shift copy in/out
    return 2 * macs + stores + extra


def accesses_im2col(spec: ConvSpec, out_width: int) -> float:
    """CMSIS-NN blocked path: per 2-column x 2-filter tile of the matmul,
    2K word loads produce 4K MACs (0.5 word/MAC), the data reuse the paper
    credits for the SIMD speedup. Patch construction costs K loads + K
    stores per output pixel. Add-conv has no SIMD path."""
    if spec.primitive == "add":
        return float(accesses_direct(spec, out_width))
    hy2 = out_width ** 2
    k = patch_len(spec)
    groups = spec.groups if spec.primitive == "grouped" else 1
    cy = spec.out_channels
    build = 0.0
    if spec.primitive in ("standard", "grouped", "shift"):
        # shift: the construction gathers with per-channel offsets, the
        # same volume
        build = (2.0 * k * hy2 * groups if spec.primitive == "grouped"
                 else 2.0 * k * hy2)
    matmul_macs = hy2 * cy * k * (groups if spec.primitive == "grouped"
                                  else 1) / max(groups, 1)
    matmul_words = 0.5 * matmul_macs
    stores = hy2 * cy
    if spec.primitive == "dws":
        # the depthwise stage stays scalar (the paper keeps NNoM's dw); the
        # pointwise stage needs no patch construction (K = Cx columns are
        # the input rows)
        dw = spec.in_channels * (2 * spec.kernel_size ** 2 * hy2 + hy2)
        return dw + matmul_words + stores
    return build + matmul_words + stores


def reuse_ratio(spec: ConvSpec, out_width: int) -> float:
    """Fig 3: (accesses without SIMD) / (accesses with SIMD), per MAC."""
    macs = spec.mac_count(out_width)
    return ((accesses_direct(spec, out_width) / macs)
            / (accesses_im2col(spec, out_width) / macs))


# --------------------------------------------------------------------------
# MCU latency / power / energy model (STM32F401RE at 3.3 V)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MCUModel:
    # P(f) = p_static + p_per_mhz * f, fit to the paper's Table 3
    p_static_mw: float = 11.0
    p_per_mhz_scalar: float = 0.513
    p_per_mhz_simd: float = 0.645
    # cycle model: a scalar MAC ~ 5 cycles (ldr, ldr, mla, address
    # arithmetic); SMLAD does 2 MACs a cycle with word loads amortized
    # over the 2x2 tile
    cycles_per_mac_scalar: float = 5.0
    cycles_per_mac_simd: float = 0.9
    cycles_per_access: float = 1.4       # the paper's memory-access gaps
    o0_penalty_scalar: float = 1.52      # Table 4's optimization speedups
    o0_penalty_simd: float = 9.81

    def latency_s(self, spec: ConvSpec, out_width: int, *, simd: bool,
                  f_mhz: float = 84.0, opt: str = "Os") -> float:
        macs = spec.mac_count(out_width)
        if simd and spec.primitive != "add":
            cyc = (self.cycles_per_mac_simd * macs
                   + self.cycles_per_access * accesses_im2col(spec, out_width))
            if opt == "O0":
                cyc *= self.o0_penalty_simd
        else:
            cyc = (self.cycles_per_mac_scalar * macs
                   + self.cycles_per_access * accesses_direct(spec, out_width))
            if opt == "O0":
                cyc *= self.o0_penalty_scalar
        return cyc / (f_mhz * 1e6)

    def power_mw(self, *, simd: bool, f_mhz: float = 84.0) -> float:
        slope = self.p_per_mhz_simd if simd else self.p_per_mhz_scalar
        return self.p_static_mw + slope * f_mhz

    def energy_mj(self, spec: ConvSpec, out_width: int, *, simd: bool,
                  f_mhz: float = 84.0, opt: str = "Os") -> float:
        return self.power_mw(simd=simd, f_mhz=f_mhz) * self.latency_s(
            spec, out_width, simd=simd, f_mhz=f_mhz, opt=opt)


# --------------------------------------------------------------------------
# NVIDIA H100 first-order peaks (roofline terms)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class H100:
    """An H100's dense peaks. Defaults: the SXM5 80 GB card (NVIDIA H100
    Tensor Core GPU data sheet); :data:`H100_PCIE` is the PCIe card. The
    data sheet's tensor-core figures are with sparsity: the dense peaks
    are half of them (bf16 1,979 -> 989 TFLOP/s, int8 3,958 -> 1,979
    TOP/s on SXM; 1,513 -> 756 and 3,026 -> 1,513 on PCIe). The CUDA
    cores' rates are SMs x lanes x boost clock: float32 132 x 128 x 1,980
    MHz = 33.45 T operations/s, 66.91 TFLOP/s as FMAs (the data sheet
    rounds to 67); int32 132 x 64 x 1,980 MHz = 16.73 T operations/s."""
    name: str = "H100 SXM5 80GB"
    sms: int = 132
    boost_hz: float = 1.98e9
    #: HBM3 bandwidth, bytes/s (data sheet: 3.35 TB/s)
    hbm_bps: float = 3.35e12
    bf16_tc_flops: float = 989e12
    int8_tc_ops: float = 1979e12
    f32_lanes_per_sm: int = 128
    int32_lanes_per_sm: int = 64
    #: device memory (data sheet: 80 GB) and shared memory an SM (228 KB,
    #: the Hopper tuning guide; 227 KB of it a block)
    hbm_bytes: int = 80 * 10 ** 9
    smem_per_sm: int = 228 * 1024

    @property
    def f32_ops(self) -> float:
        """float32 operations/s with no FMA form (subtract, add, max)."""
        return self.sms * self.f32_lanes_per_sm * self.boost_hz

    @property
    def f32_fma_flops(self) -> float:
        """float32 FLOP/s as FMAs, 2 a multiply-add."""
        return 2 * self.f32_ops

    @property
    def int32_ops(self) -> float:
        return self.sms * self.int32_lanes_per_sm * self.boost_hz

    def peak(self, kind: str) -> float:
        """The peak of one kind of work: ``"bf16"`` (tensor-core FLOPs,
        float16 too), ``"int8"`` (tensor-core operations), ``"f32"``
        (float32 FLOPs on the CUDA cores, 2 a multiply-add), ``"f32_op"``
        (float32 operations with no FMA form) or ``"int32"``."""
        peaks = {"bf16": self.bf16_tc_flops, "int8": self.int8_tc_ops,
                 "f32": self.f32_fma_flops, "f32_op": self.f32_ops,
                 "int32": self.int32_ops}
        if kind not in peaks:
            raise KeyError(f"no H100 peak for work of kind {kind!r}; kinds: "
                           f"{sorted(peaks)}")
        return peaks[kind]

    def roofline_terms(self, flops_by_kind: dict, nbytes: float) -> dict:
        """Seconds each bottleneck alone would take: ``memory_s`` (the
        bytes at HBM bandwidth) and ``<kind>_s`` for every kind of work in
        ``flops_by_kind`` (its count at its peak)."""
        terms = {"memory_s": nbytes / self.hbm_bps}
        for kind, n in sorted(flops_by_kind.items()):
            terms[f"{kind}_s"] = n / self.peak(kind)
        return terms

    def energy_j(self, seconds: float, power_limit_w: float) -> float:
        """An upper bound on the energy of ``seconds`` of card time: the
        power limit (what ``nvidia-smi --query-gpu=power.limit`` reads)
        times the time. No energy per operation was ever measured for
        this card, so there is no dynamic term."""
        return power_limit_w * seconds


H100_SXM = H100()
H100_PCIE = H100(name="H100 PCIe 80GB", sms=114, boost_hz=1.755e9,
                 hbm_bps=2.0e12, bf16_tc_flops=756e12, int8_tc_ops=1513e12)


def h100_for(device_name: str) -> H100:
    """The model of the card ``torch.cuda.get_device_name`` names: the
    PCIe card's where the name says PCIe, else the SXM card's."""
    return H100_PCIE if "PCIe" in device_name else H100_SXM
