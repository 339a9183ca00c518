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
