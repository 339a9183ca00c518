#!/usr/bin/env python3
"""Time the integer shift conv's two im2col gathers on one NVIDIA card.

    python3 scripts/torch_shift_gather.py        (from the repository root)

``shift_conv2d_q8`` (``src/repro_torch/kernels/csrc/conv_shift.cu``) runs
the implicit GEMM of ``csrc/igemm.cuh``: a block stages its pixels' input
window with a halo of d once, then gathers each pixel's im2col words from
it, four bytes a word at the channels' displacements. The other design
keeps no window: each im2col byte is read from device memory at its
channel's displacement, with the bounds check there (the paper's
"modified sampling step" taken literally). This script builds that
variant from the same header (its staging, filter words, ``__dp4a`` sums
and epilogue; int8, Q = 16) with ``nvcc`` into ``build/``, checks it
bitwise against the plain version, and prints the device time
(``torch.profiler``, ``repro_torch.tune.device_us``) of both on the shift
plan's rows at B=256, in turns (kept, variant, variant, kept), each with
the default tile. It needs a card and ``nvcc``; it is not on any path of
the port.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
BUILD = ROOT / "build" / "shift_gather"
#: the shift plan's rows at B=256: (n, h, w, c, cy), d = 1
ROWS = (("shift1 16->32 16^2", (256, 16, 16, 16, 32)),
        ("shift2 32->64 8^2", (256, 8, 8, 32, 64)))

VARIANT = r"""
#include "igemm.cuh"

namespace {

// The implicit GEMM with no window: pixel p's im2col byte of channel c is
// x[img, oy + a_c, ox + b_c, c], read from device memory (zero outside).
template <int Q>
__global__ void __launch_bounds__(MAX_THREADS) direct_kernel(
    const int8_t* __restrict__ x, const int32_t* __restrict__ shifts,
    const int8_t* __restrict__ w, const int32_t* __restrict__ bias,
    int8_t* __restrict__ y, const IgemmGeo g) {
  constexpr int PT = 32 / Q;
  extern __shared__ __align__(16) unsigned char smem[];
  int* As = reinterpret_cast<int*>(smem);
  int* Bs = As + g.kcw * g.bp;
  int* ka = Bs + g.kcw * g.bn;
  int* kb = ka + 4 * g.kcw;
  int* py = kb + 4 * g.kcw;
  int* px = py + g.bp;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int npx = g.bp / PT;
  const int tp = tid % npx, tq = tid / npx;
  const bool sums = tq < g.bn / Q;
  const int img = blockIdx.x / g.bpi, blk = blockIdx.x - img * g.bpi;
  const int cb = blockIdx.y * g.bn;
  const int hw = g.h * g.wd;
  const int p0 = blk * g.bp, p1 = min(p0 + g.bp, hw);
  const int8_t* xi = x + (size_t)img * hw * g.cx;
  for (int p = tid; p < g.bp; p += nthr) {
    const int pi = p0 + p;
    py[p] = pi < p1 ? pi / g.wd : -1;
    px[p] = pi < p1 ? pi - (pi / g.wd) * g.wd : 0;
  }
  int acc[PT][Q];
#pragma unroll
  for (int i = 0; i < PT; ++i)
#pragma unroll
    for (int j = 0; j < Q; ++j) acc[i][j] = 0;
  for (int kc0 = 0; kc0 < g.kw; kc0 += KC) {
    const int nkw = min(KC, g.kw - kc0);
    for (int t = tid; t < 4 * nkw; t += nthr) {
      const int c = 4 * kc0 + t;
      ka[t] = c < g.kk ? shifts[2 * c] : -(1 << 20);
      kb[t] = c < g.kk ? shifts[2 * c + 1] : 0;
    }
    for (int t = tid; t < nkw * g.bn; t += nthr) {
      const int wi = t / g.bn, nn = t - wi * g.bn;
      uint32_t word = 0;
      if (cb + nn < g.ng) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 4 * (kc0 + wi) + e;
          if (c >= g.kk) break;
          word |= (uint32_t)(w[c * g.cy + cb + nn] & 0xff) << (8 * e);
        }
      }
      Bs[t] = (int)word;
    }
    __syncthreads();
    for (int t = tid; t < nkw * g.bp; t += nthr) {
      const int wi = t / g.bp, p = t - wi * g.bp;
      uint32_t word = 0;
      if (py[p] >= 0) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int iy = py[p] + ka[4 * wi + e];
          const int ix = px[p] + kb[4 * wi + e];
          if (iy >= 0 && iy < g.h && ix >= 0 && ix < g.wd)
            word |= (uint32_t)(unsigned char)
                        xi[(iy * g.wd + ix) * g.cx + 4 * (kc0 + wi) + e]
                    << (8 * e);
        }
      }
      As[t] = (int)word;
    }
    __syncthreads();
    for (int wi = 0; sums && wi < nkw; ++wi) {
      int av[PT];
      uint32_t bw[Q];
#pragma unroll
      for (int i = 0; i < PT; ++i) av[i] = As[wi * g.bp + tp + i * npx];
#pragma unroll
      for (int j = 0; j < Q / 4; ++j) {
        const uint4 v =
            reinterpret_cast<const uint4*>(Bs + wi * g.bn + tq * Q)[j];
        bw[4 * j] = v.x, bw[4 * j + 1] = v.y, bw[4 * j + 2] = v.z,
               bw[4 * j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < PT; ++i)
#pragma unroll
        for (int j = 0; j < Q; ++j)
          acc[i][j] = __dp4a(av[i], (int)bw[j], acc[i][j]);
    }
    __syncthreads();
  }
  const int c0 = cb + tq * Q;
  if (!sums || c0 >= g.ng) return;
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const int pi = p0 + tp + i * npx;
    if (pi >= p1) break;
    int8_t* yp = y + ((size_t)img * hw + pi) * g.cy + c0;
    alignas(16) int8_t out[Q];
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      int32_t v = acc[i][j];
      if (bias != nullptr) v = wrap_add(v, bias[c0 + j]);
      out[j] = requant_epilogue(v, g.relu, g.shift);
    }
    *reinterpret_cast<uint4*>(yp) = *reinterpret_cast<const uint4*>(out);
  }
}

}  // namespace

// Q = 16, Cy a multiple of 16 and y 16-byte aligned only.
extern "C" int shift_direct_q8(const void* x, const void* shifts,
                               const void* w, const void* bias, void* y,
                               int n, int h, int wd, int c, int cy, int d,
                               int shift, int relu, int bp, void* stream) {
  IgemmGeo g;
  int gx, gy, threads;
  if (cy % 16 || !igemm_plan(g, &gx, &gy, &threads, n, h, wd, c, cy,
                             2 * d + 1, 1, c, bp, 16))
    return (int)cudaErrorInvalidValue;
  g.shift = shift, g.relu = relu;
  const int smem = 4 * (g.kcw * bp + g.kcw * g.bn + 8 * g.kcw + 2 * bp);
  direct_kernel<16><<<dim3(gx, gy), threads, smem, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int32_t*)shifts, (const int8_t*)w,
      (const int32_t*)bias, (int8_t*)y, g);
  return (int)cudaGetLastError();
}
"""


def build() -> ctypes.CDLL:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    BUILD.mkdir(parents=True, exist_ok=True)
    src, lib = BUILD / "shift_direct.cu", BUILD / "libshift_direct.so"
    src.write_text(VARIANT)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                    str(CSRC), "-o", str(lib), str(src)], check=True)
    dll = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    dll.shift_direct_q8.argtypes = [P] * 5 + [I] * 9 + [P]
    dll.shift_direct_q8.restype = I
    return dll


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    dll = build()
    from repro_torch import kernels as K
    from repro_torch import tune
    from repro_torch.kernels.conv_shift import default_shift_tile
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    for label, (n, h, w, c, cy) in ROWS:
        grid = [(a, b) for a in (-1, 0, 1) for b in (-1, 0, 1)]
        table = torch.tensor([grid[i % 9] for i in range(c)],
                             dtype=torch.int32, device=dev)
        x = torch.from_numpy(rng.integers(-128, 128, (n, h, w, c))
                             .astype(np.int8)).to(dev)
        wt = torch.from_numpy(rng.integers(-128, 128, (c, cy))
                              .astype(np.int8)).to(dev)
        b = torch.from_numpy(rng.integers(-4096, 4096, cy)
                             .astype(np.int32)).to(dev)
        tile = default_shift_tile(n, h, w, c, cy, 1)
        kw = dict(requant_shift=7, act="relu", max_shift=1)
        y = torch.empty((n, h, w, cy), dtype=torch.int8, device=dev)

        def kept():
            return K.shift_conv2d_q8(x, table, wt, b, **kw, **tile)

        def variant():
            rc = dll.shift_direct_q8(
                x.data_ptr(), table.data_ptr(), wt.data_ptr(), b.data_ptr(),
                y.data_ptr(), n, h, w, c, cy, 1, 7, 1, tile["bp"],
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"shift_direct_q8: CUDA error {rc}")
            return y

        want = K.shift_conv2d_q8_plain(x, table, wt, b, **kw)
        for fn in (kept, variant):
            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                print(f"FAIL: {label} {fn.__name__} differs from the plain "
                      "version", file=sys.stderr)
                return 1
        times = {"kept": [], "variant": []}
        for fn in (kept, variant, variant, kept):
            times[fn.__name__].append(tune.device_us(fn, reps=50))
        print(f"[gather] {label} B={n} tile {tile}: window (kept) "
              f"{times['kept'][0]:.2f} / {times['kept'][1]:.2f} us, direct "
              f"(variant) {times['variant'][0]:.2f} / "
              f"{times['variant'][1]:.2f} us, both bitwise equal to the "
              f"plain version; card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
