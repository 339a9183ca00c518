// The integer implicit GEMM shared by the int8 / W4A8 standard conv
// (conv_im2col.cu) and the int8 / W4A8 shift conv (conv_shift.cu).
//
// M = output pixels, N = output channels of a group, K = the contraction.
// A block owns a run of BP output pixels of one image (inside one image
// row, or whole rows) x BN output channels of one group, and
//  - stages once in shared memory the input window its pixels read (the
//    rows they span plus HK-1 halo rows, their columns plus HK-1 halo
//    columns, x Cx/g channels), zero outside the image: the TPU kernels'
//    (HK/2, (HK-1)/2) padding; 16-byte loads where a pixel's Cx/g channels
//    are a multiple of 16 and aligned, 4-byte words where they are a
//    multiple of 4 (in shared memory each pixel is padded by a word against
//    bank conflicts), else bytes. A window of HK = 1 has no halo and runs
//    as one image of one row of N*H*W pixels;
//  - builds, per chunk of KC K words, each K element's byte offset in the
//    window from a pixel's base (the K-offset builder, a template argument:
//    a conv's (tap row, tap column, channel), or a shift conv's channel at
//    its own displacement read from the device shift table);
//  - stages the group's filter chunk K-major as 32-bit words of four
//    K-consecutive int8 codes, K padded to a multiple of 4 with zeros (W4:
//    each nibble unpacked and shifted here, once per block, w4.cuh);
//  - builds from the window each pixel's im2col words of the chunk once,
//    shared by every thread that owns the pixel: one aligned word load where
//    four K-consecutive elements are contiguous in the window (a conv whose
//    Cx/g is a multiple of 4), else four byte loads at their offsets;
//  - sums with __dp4a: each thread owns PT = 32/Q pixels x Q consecutive
//    channels, 32 int32 accumulators, and per K word reads PT pixel words
//    (consecutive across the warp) and Q filter words (one vector load,
//    broadcast across the warp).
// Integer sums are exact, so every tiling and order gives the plain
// versions' result bit for bit. Then the bias (wrap_add), relu, the
// round-to-nearest shift and the clip to int8 (epilogue.cuh); a thread's Q
// output bytes are one vector store where Cy/g and Cy are multiples of Q.
// The block's pixels (BP, a multiple of 32 up to 256) and a thread's
// channels (Q: 4, 8 or 16) are the tuner's knobs; Q is a template argument.
//
// Index arithmetic is 32-bit (the wrappers keep every tensor below 2^31
// elements).
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

#include "epilogue.cuh"
#include "tile.cuh"
#include "w4.cuh"

namespace {

constexpr int KC = 32;            // K words (of four int8) per staged chunk
constexpr int MAX_THREADS = 256;  // threads per block, at most
constexpr int MIN_THREADS = 128;  // and at least: the ones past the tile's
                                  // threads only stage

// Launch geometry of one implicit GEMM, computed on the host (igemm_plan)
// and passed by value.
struct IgemmGeo {
  int h, wd, cx, cy, hk, cxg, ng;  // image (after the HK = 1 remap), widths
  int kk, kw, kcw;                 // K, its words, words a chunk
  int bp, bpi, bn, cblk;           // pixels a block, blocks an image,
                                   // channels a block, blocks a group
  int ps;                          // window bytes per pixel
  int win_bytes, smem;             // window and total shared bytes
  int fast;                        // Cx/g, Cx, x all 4-byte aligned
  int vec16;                       // and 16-byte aligned: 16-byte loads
  int words;                       // im2col words are aligned window words
  int y_vec;                       // Q output bytes as one store
  int shift, relu;
};

// The launch arithmetic (repro_torch.kernels.conv_im2col.igemm_plan
// mirrors it) of a window of HK x HK taps and a contraction of kk K
// elements: returns false if the tile does not fit.
bool igemm_plan(IgemmGeo& g, int* grid_x, int* grid_y, int* threads, int n,
                int h, int wd, int cx, int cy, int hk, int groups, int kk,
                int bp, int q) {
  if (hk == 1) wd = n * h * wd, h = 1, n = 1;
  const int pt = 32 / q;
  g.h = h, g.wd = wd, g.cx = cx, g.cy = cy, g.hk = hk;
  g.cxg = cx / groups, g.ng = cy / groups;
  g.kk = kk, g.kw = (kk + 3) / 4, g.kcw = imin(KC, g.kw);
  g.bp = bp, g.bpi = (h * wd + bp - 1) / bp;
  const int ct = imin((g.ng + q - 1) / q, MAX_THREADS / (bp / pt));
  g.bn = ct * q, g.cblk = (g.ng + g.bn - 1) / g.bn;
  g.fast = g.cxg % 4 == 0 && cx % 4 == 0;
  g.ps = g.fast ? g.cxg + 4 : g.cxg;
  // rows a run of bp pixels (starting at a multiple of bp) spans, and the
  // window's width
  int rows, ww;
  if (h == 1 || wd % bp == 0) {
    rows = 1, ww = imin(bp, wd) + hk - 1;
  } else if (bp % wd == 0) {
    rows = imin(h, bp / wd), ww = wd + hk - 1;
  } else {
    rows = imin(h, bp / wd + 2), ww = wd + hk - 1;
  }
  g.win_bytes = round16((rows + hk - 1) * ww * g.ps);
  g.smem = g.win_bytes + 4 * (g.kcw * bp + g.kcw * g.bn + 4 * g.kcw + bp);
  *grid_x = n * g.bpi, *grid_y = groups * g.cblk;
  *threads = (bp / pt) * ct > MIN_THREADS ? (bp / pt) * ct : MIN_THREADS;
  return g.smem <= 232448 && *grid_y <= 65535;
}

// A block: a run of BP output pixels of one image (within one image row, or
// whole rows) x BN output channels of one group. Each of its first
// (BP/PT) x (BN/Q) threads owns PT pixels (strided by BP/PT) x Q consecutive
// channels; a small tile's block is padded to MIN_THREADS threads, which
// share the staging and own no outputs. KOff(g, k, wwb) is K element k's
// byte offset in the window from a pixel's base (wwb: the window's width),
// or -1 for a zero.
template <bool W4, int Q, class KOff>
__global__ void __launch_bounds__(MAX_THREADS) igemm_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    const int8_t* __restrict__ ws, const int32_t* __restrict__ bias,
    int8_t* __restrict__ y, const IgemmGeo g, const KOff k_offset) {
  constexpr int PT = 32 / Q;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* win = smem;                                  // input window
  int* As = reinterpret_cast<int*>(smem + g.win_bytes);       // [k word][px]
  int* Bs = As + g.kcw * g.bp;                                // [k word][co]
  int* koff = Bs + g.kcw * g.bn;                              // per K element
  int* pbase = koff + 4 * g.kcw;                              // per pixel

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int npx = g.bp / PT;
  const int tp = tid % npx, tq = tid / npx;
  const bool sums = tq < g.bn / Q;             // else this thread only stages
  const int img = blockIdx.x / g.bpi, blk = blockIdx.x - img * g.bpi;
  const int grp = blockIdx.y / g.cblk;
  const int cb = (blockIdx.y - grp * g.cblk) * g.bn;         // in the group
  const int hw = g.h * g.wd, pad = g.hk / 2;
  const int p0 = blk * g.bp, p1 = min(p0 + g.bp, hw);
  const int r0 = p0 / g.wd, r1 = (p1 - 1) / g.wd;
  const bool one_row = r0 == r1;
  const int cmin = one_row ? p0 - r0 * g.wd : 0;
  const int wwb = one_row ? p1 - p0 + g.hk - 1 : g.wd + g.hk - 1;
  const int whb = r1 - r0 + g.hk;
  // window row wr, column wc hold input row r0 - pad + wr, column
  // cmin - pad + wc (zeros outside the image)
  const int8_t* xi = x + (size_t)img * hw * g.cx + grp * g.cxg;

  for (int p = tid; p < g.bp; p += nthr) {
    const int pi = p0 + p;
    int v = -1;
    if (pi < p1) {
      const int oy = pi / g.wd, ox = pi - oy * g.wd;
      v = ((oy - r0) * wwb + ox - cmin) * g.ps;
    }
    pbase[p] = v;
  }
  if (g.vec16) {                    // 16-byte loads of 16 channels
    const int c16 = g.cxg / 16, row16 = wwb * c16;
    for (int e = tid; e < whb * row16; e += nthr) {
      const int wr = e / row16, er = e - wr * row16;
      const int wc = er / c16, qd = er - wc * c16;
      const int iy = r0 - pad + wr, ix = cmin - pad + wc;
      int4 v = make_int4(0, 0, 0, 0);
      if (iy >= 0 && iy < g.h && ix >= 0 && ix < g.wd)
        v = *reinterpret_cast<const int4*>(xi + (iy * g.wd + ix) * g.cx +
                                           16 * qd);
      // a window pixel is padded by 4 bytes: 4-byte stores
      int* dst = reinterpret_cast<int*>(win + (wr * wwb + wc) * g.ps +
                                        16 * qd);
      dst[0] = v.x, dst[1] = v.y, dst[2] = v.z, dst[3] = v.w;
    }
  } else if (g.fast) {              // 4-byte words of four channels
    const int cw = g.cxg / 4, roww = wwb * cw;
    for (int e = tid; e < whb * roww; e += nthr) {
      const int wr = e / roww, er = e - wr * roww;
      const int wc = er / cw, qd = er - wc * cw;
      const int iy = r0 - pad + wr, ix = cmin - pad + wc;
      int v = 0;
      if (iy >= 0 && iy < g.h && ix >= 0 && ix < g.wd)
        v = *reinterpret_cast<const int*>(xi + (iy * g.wd + ix) * g.cx +
                                          4 * qd);
      *reinterpret_cast<int*>(win + (wr * wwb + wc) * g.ps + 4 * qd) = v;
    }
  } else {                          // bytes
    const int rowb = wwb * g.cxg;
    for (int e = tid; e < whb * rowb; e += nthr) {
      const int wr = e / rowb, er = e - wr * rowb;
      const int wc = er / g.cxg, c = er - wc * g.cxg;
      const int iy = r0 - pad + wr, ix = cmin - pad + wc;
      int8_t v = 0;
      if (iy >= 0 && iy < g.h && ix >= 0 && ix < g.wd)
        v = xi[(iy * g.wd + ix) * g.cx + c];
      win[(wr * wwb + wc) * g.ps + c] = (unsigned char)v;
    }
  }

  int acc[PT][Q];
#pragma unroll
  for (int i = 0; i < PT; ++i)
#pragma unroll
    for (int j = 0; j < Q; ++j) acc[i][j] = 0;

  const int cxh = W4 ? (g.cxg + 1) / 2 : g.cxg;   // weight rows per tap
  for (int kc0 = 0; kc0 < g.kw; kc0 += KC) {
    const int nkw = min(KC, g.kw - kc0);
    // each K element's offset in the window from a pixel's base (-1: a
    // zero, K's pad to a whole word)
    for (int t = tid; t < 4 * nkw; t += nthr) {
      const int kap = 4 * kc0 + t;
      koff[t] = kap < g.kk ? k_offset(g, kap, wwb) : -1;
    }
    // the filter chunk, words of four K-consecutive int8 codes (W4: each
    // nibble unpacked and shifted here, once per block)
    for (int t = tid; t < nkw * g.bn; t += nthr) {
      const int wi = t / g.bn, nn = t - wi * g.bn;
      const int co = grp * g.ng + cb + nn;
      uint32_t word = 0;
      if (cb + nn < g.ng) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kap = 4 * (kc0 + wi) + e;
          if (kap >= g.kk) break;
          int32_t v;
          if constexpr (W4) {
            const int tap = kap / g.cxg, c = kap - tap * g.cxg;
            v = w4_code(w[(tap * cxh + (c >> 1)) * g.cy + co], c & 1, ws[c]);
          } else {
            v = w[kap * g.cy + co];
          }
          word |= (uint32_t)(v & 0xff) << (8 * e);
        }
      }
      Bs[t] = (int)word;
    }
    __syncthreads();
    // the pixels' im2col words of the chunk, from the window
    for (int t = tid; t < nkw * g.bp; t += nthr) {
      const int wi = t / g.bp, p = t - wi * g.bp;
      const int pb = pbase[p];
      uint32_t word = 0;
      if (pb >= 0) {
        if (g.words) {
          word = *reinterpret_cast<const uint32_t*>(win + pb + koff[4 * wi]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int o = koff[4 * wi + e];
            if (o >= 0) word |= (uint32_t)win[pb + o] << (8 * e);
          }
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

  const int c0 = cb + tq * Q;                         // in the group
  if (!sums || c0 >= g.ng) return;
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const int pi = p0 + tp + i * npx;
    if (pi >= p1) break;
    int8_t* yp = y + ((size_t)img * hw + pi) * g.cy + grp * g.ng + c0;
    const int32_t* bp_ = bias == nullptr ? nullptr : bias + grp * g.ng + c0;
    if (g.y_vec && c0 + Q <= g.ng) {
      alignas(16) int8_t out[Q];
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        int32_t v = acc[i][j];
        if (bp_ != nullptr) v = wrap_add(v, bp_[j]);
        out[j] = requant_epilogue(v, g.relu, g.shift);
      }
      if constexpr (Q == 16) {
        *reinterpret_cast<uint4*>(yp) = *reinterpret_cast<const uint4*>(out);
      } else if constexpr (Q == 8) {
        *reinterpret_cast<uint2*>(yp) = *reinterpret_cast<const uint2*>(out);
      } else {
        *reinterpret_cast<uint32_t*>(yp) =
            *reinterpret_cast<const uint32_t*>(out);
      }
    } else {
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        if (c0 + j >= g.ng) break;
        int32_t v = acc[i][j];
        if (bp_ != nullptr) v = wrap_add(v, bp_[j]);
        yp[j] = requant_epilogue(v, g.relu, g.shift);
      }
    }
  }
}

template <bool W4, int Q, class KOff>
int igemm_launch_q(const IgemmGeo& g, int gx, int gy, int threads,
                   const void* x, const void* w, const void* ws,
                   const void* bias, void* y, const KOff& k_offset,
                   cudaStream_t st) {
  auto kern = igemm_kernel<W4, Q, KOff>;
  if (g.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(gx, gy), threads, g.smem, st>>>(
      (const int8_t*)x, (const int8_t*)w, (const int8_t*)ws,
      (const int32_t*)bias, (int8_t*)y, g, k_offset);
  return (int)cudaGetLastError();
}

// Launch a planned implicit GEMM: the alignment-dependent load and store
// widths are set here, from the operands' addresses. `words`: four
// K-consecutive elements are contiguous in the window wherever the window
// is staged in words (a conv's taps; not a shift conv's channels, each at
// its own displacement).
template <bool W4, class KOff>
int igemm_launch(IgemmGeo& g, int gx, int gy, int threads, bool words,
                 const void* x, const void* w, const void* ws,
                 const void* bias, void* y, int shift, int relu, int q,
                 const KOff& k_offset, void* stream) {
  g.fast = g.fast && (uintptr_t)x % 4 == 0;
  g.vec16 = g.fast && g.cxg % 16 == 0 && g.cx % 16 == 0 &&
            (uintptr_t)x % 16 == 0;
  g.words = words && g.fast;
  g.y_vec = g.cy % q == 0 && g.ng % q == 0 && (uintptr_t)y % 16 == 0;
  g.shift = shift, g.relu = relu;
  const cudaStream_t st = (cudaStream_t)stream;
  if (q == 4)
    return igemm_launch_q<W4, 4>(g, gx, gy, threads, x, w, ws, bias, y,
                                 k_offset, st);
  if (q == 8)
    return igemm_launch_q<W4, 8>(g, gx, gy, threads, x, w, ws, bias, y,
                                 k_offset, st);
  return igemm_launch_q<W4, 16>(g, gx, gy, threads, x, w, ws, bias, y,
                                k_offset, st);
}

}  // namespace
