// The register-tiled implicit GEMM over a staged input window shared by
// the float32 / bfloat16 standard and grouped conv (conv_im2col.cu,
// repro_conv2d_f: acc + x * w), the float add conv (conv_add.cu,
// repro_add_conv2d_f: acc - |x - w|) and the int8 / W4A8 add conv
// (conv_add.cu, repro_add_conv2d_q8 / _w4: acc + |(x << xp) - (w << wp)|
// in wrapping uint32). The mode (a policy class: FloatMode<T, Term> or
// IntAddMode<W4>) says how an operand is loaded and staged, what a term
// is and how an output is finished; everything else is one body.
//
// M = output pixels of all images (N*H*W), N = Cy/g, K = HK*HK*Cx/g in the
// order tap row i, tap column j, channel c. A block owns a run of BP
// consecutive output pixels (it may cross image rows and images) x BN
// output channels of one group, and
//  - stages once in shared memory, as 32-bit elements (float32, or the
//    integer add's pre-shifted uint32 x << xp), the input window its
//    pixels read: the padded rows they span (each image padded by the TPU
//    kernels' (HK/2, (HK-1)/2) zero rows and columns, so a run that
//    crosses an image boundary stages that boundary's HK-1 padding rows
//    too) x the padded columns x the group's Cx/g channels, a pixel's
//    channels at a stride of ps = (Cx/g) | 1 elements (odd: a warp's 32
//    consecutive pixels read 32 banks). A window of HK = 1 has no halo and
//    runs as one image of one row of N*H*W pixels;
//  - builds once a table of each staged K element's window offset from a
//    pixel's base (the K-offset builder, a template argument: the conv's
//    TapOffsets, (i * ww + j) * ps + c), so the sums index the window
//    without dividing;
//  - stages the block's weights [k][co] as 32-bit elements (float32, or
//    the integer add's w << wp; W4: each nibble unpacked and group-shifted
//    first, w4.cuh, then shifted, in the TPU kernel's order): all K of
//    them once, where they fit beside the window (then the sums run with
//    no barrier and no load from device memory), else chunk by chunk, each
//    thread fetching its at most FG_UW weights of the next chunk into
//    registers before it sums the current one;
//  - sums in registers: each thread owns PT pixels x Q consecutive
//    channels and per K element reads PT window values and Q/4 4-vector
//    weights (a broadcast across the warp, whose 32 threads share their
//    channels) and takes PT x Q steps of the mode's term. A broadcast
//    16-byte load still delivers 512 bytes to a warp, so a step costs the
//    shared memory PT + Q cycles of its 128 bytes a cycle against PT x Q
//    x 2 (float) or 3 (integer add) instructions: PT > 1 keeps the B=256
//    layers on the arithmetic lanes, PT = 1 gives Table-2's n = 1 jobs the
//    most threads.
// Float: every accumulator starts at +0 and sums K in order, with no K
// split, each step rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn:
// no FMA), then the bias in float32 (conv), relu and one rounding to the
// output's type (float_io.cuh): the plain versions' order, so they are
// bitwise equal. Integer add: d = (x << xp) - (w << wp) and |d| taken of
// the WRAPPED 32-bit difference ((int32)d < 0 ? -d : d), summed in
// uint32, which is associative, so any tile and order gives the plain
// version's bits; then acc = 0 - l1, the bias (wrap_add), relu, the
// round-to-nearest shift and the clip to int8 (epilogue.cuh). A tap
// outside the image reads a staged zero, as the plain versions' zero-padded
// input does (the add conv then adds |0 - w|; the conv adds 0 * w, which
// leaves the sum unchanged for finite w).
//
// Staging walks its elements without divisions (tile.cuh Walk / Walk3;
// the W4 weights divide once per staged weight to find its channel).
// float32 operands are copied with cp.async (4 bytes, zero-filled outside
// the image), so a thread keeps all its copies in flight at once; bfloat16
// and int8 ones are widened (or shifted) in registers, FG_UX window loads
// issued before any is stored. A chunked block's weights go through the
// registers in every mode.
//
// The block's pixels (BP, a multiple of 32 up to 256) and a thread's
// channels (Q: 4, 8 or 16) are the tuner's knobs; a thread's pixels PT
// follow from them (pixels_a_thread), and PT and Q are template arguments.
// No knob changes an output. Where a channel group has fewer than 128
// threads, a block has at most FG_THREADS (more, smaller blocks at
// Table-2's n = 1 jobs). fgemm_plan is the launch arithmetic
// (repro_torch.kernels.conv_im2col.fgemm_plan mirrors it); it is the same
// for every mode, each staged element being 4 bytes. A tile whose window
// does not fit the 232,448 bytes a block can use is refused.
//
// Index arithmetic is 32-bit (the wrappers keep every tensor below 2^31
// elements).
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

#include "epilogue.cuh"
#include "float_io.cuh"
#include "tile.cuh"
#include "w4.cuh"

namespace {

constexpr int FG_THREADS = 128;   // threads a block, at most, where a
                                  // channel group has fewer
constexpr int FG_KC = 128;        // K elements a staged chunk, at most
constexpr int FG_UW = 8;          // weights a thread stages a chunk, at most
constexpr int FG_UX = 16;         // window loads a thread has in flight

// Launch geometry of one implicit GEMM, computed on the host (fgemm_plan)
// and passed by value.
struct FgemmGeo {
  int h, wd, cx, cy, hk, cxg, ng;  // image (after the HK = 1 remap), widths
  int hp;                          // padded rows an image: h + hk - 1
  int total;                       // output pixels of all images
  int kk, kc;                      // K, K elements a chunk (kk: all
                                   // resident)
  int bp, bn, cblk;                // pixels a block, channels a block,
                                   // channel blocks a group
  int pt, npx;                     // pixels a thread, threads a channel
                                   // group (bp / pt)
  int ps, wrows, ww;               // window: elements a pixel, rows and
                                   // pixels a row (at most)
  int win, smem;                   // window elements (a multiple of 4),
                                   // shared bytes
  int relu, y_vec;
  int xp, wp, shift;               // the integer add's pre-shifts and
                                   // requant shift
};

// A thread's pixels PT: the largest power of two that divides bp / 32 and
// keeps PT x Q at most 32 accumulators (1 at bp = 32: the most threads for
// Table-2's small jobs; 8 x 4, 4 x 8 or 2 x 16 at bp = 256, where a warp
// step's PT window loads and Q / 4 broadcast 16-byte weight loads, PT + Q
// cycles of shared-memory bandwidth, no longer outweigh its PT x Q x 2
// or 3 instructions).
int pixels_a_thread(int bp, int q) {
  int pt = 1;
  while ((bp / 32) % (2 * pt) == 0 && 2 * pt * q <= 32) pt *= 2;
  return pt;
}

// The launch arithmetic: returns false if the tile does not fit.
bool fgemm_plan(FgemmGeo& g, int* grid_x, int* grid_y, int* threads, int n,
                int h, int wd, int cx, int cy, int hk, int groups, int bp,
                int q) {
  if (hk == 1) wd = n * h * wd, h = 1, n = 1;
  g.h = h, g.wd = wd, g.cx = cx, g.cy = cy, g.hk = hk;
  g.cxg = cx / groups, g.ng = cy / groups;
  g.hp = h + hk - 1, g.total = n * h * wd;
  g.pt = pixels_a_thread(bp, q), g.npx = bp / g.pt;
  g.kk = hk * hk * g.cxg;
  const int ct = imin((g.ng + q - 1) / q,
                      g.npx < FG_THREADS ? FG_THREADS / g.npx : 1);
  g.bp = bp, g.bn = ct * q, g.cblk = (g.ng + g.bn - 1) / g.bn;
  g.ps = g.cxg | 1;
  // output rows a run of bp pixels (starting at a multiple of bp) spans,
  // the image boundaries they cross (each adds HK-1 padding rows), and the
  // window's width
  const int nh = n * h;
  int rows;
  if (nh == 1 || wd % bp == 0) {
    rows = 1, g.ww = imin(bp, wd) + hk - 1;
  } else if (bp % wd == 0) {
    rows = imin(nh, bp / wd), g.ww = wd + hk - 1;
  } else {
    rows = imin(nh, bp / wd + 2), g.ww = wd + hk - 1;
  }
  const int cross = imin(n - 1, (rows - 1 + h - 1) / h);
  g.wrows = rows + cross * (hk - 1) + hk - 1;
  g.win = (g.wrows * g.ww * g.ps + 3) & ~3;
  // all K elements' weights and offsets resident where they fit, else
  // chunks of at most FG_UW weights a thread
  const int fixed = g.win + bp + g.wrows;
  g.kc = 4 * (fixed + g.kk * g.bn + g.kk) <= MAX_SMEM
             ? g.kk
             : imin(FG_KC, FG_UW * g.npx / q);
  g.smem = 4 * (fixed + g.kc * g.bn + g.kc);
  *grid_x = (g.total + bp - 1) / bp, *grid_y = groups * g.cblk;
  *threads = g.npx * ct;
  return g.smem <= MAX_SMEM && *grid_y <= MAX_GRID_Y;
}

// The conv's term: acc + x * w.
struct MulAdd {
  static __device__ __forceinline__ float step(float acc, float x, float w) {
    return __fadd_rn(acc, __fmul_rn(x, w));
  }
};

// The float add conv's term: acc - |x - w| (fabsf is exact).
struct NegL1 {
  static __device__ __forceinline__ float step(float acc, float x, float w) {
    return __fsub_rn(acc, fabsf(__fsub_rn(x, w)));
  }
};

// A launch's operands; ws (the W4 group shifts) and bias may be null.
struct GemmArgs {
  const void* x;
  const void* w;
  const void* ws;
  const void* bias;
  void* y;
};

// The float modes: T (float or __nv_bfloat16) in device memory, float32
// staged and summed, Term a step above.
template <typename T, class Term>
struct FloatMode {
  using E = float;
  using V4 = float4;
  using Out = T;
  static constexpr bool kInt = false;
  static constexpr bool kAsync = sizeof(T) == 4;   // cp.async copies
  static __device__ __forceinline__ E load_x(const GemmArgs& a,
                                             const FgemmGeo&, int i) {
    return load_f32((const T*)a.x + i);
  }
  // weight of K element k, output channel co
  static __device__ __forceinline__ E load_w(const GemmArgs& a,
                                             const FgemmGeo& g, int k,
                                             int co) {
    return load_f32((const T*)a.w + k * g.cy + co);
  }
  static __device__ __forceinline__ E load_bias(const GemmArgs& a,
                                                int co) {
    return load_f32((const T*)a.bias + co);
  }
  static __device__ __forceinline__ E step(E acc, E x, E w) {
    return Term::step(acc, x, w);
  }
};

// The integer add conv: int8 x and bias int32 in device memory, x << xp
// and w << wp staged as uint32, acc + |d| in uint32 on the wrapped
// difference d. W4: w (HK,HK,ceil(Cx/2),Cy) packed along Cx, ws (Cx,).
template <bool W4>
struct IntAddMode {
  using E = uint32_t;
  using V4 = uint4;
  using Out = int8_t;
  static constexpr bool kInt = true;
  static constexpr bool kAsync = false;
  static __device__ __forceinline__ E load_x(const GemmArgs& a,
                                             const FgemmGeo& g, int i) {
    return (uint32_t)(int32_t)((const int8_t*)a.x)[i] << g.xp;
  }
  static __device__ __forceinline__ E load_w(const GemmArgs& a,
                                             const FgemmGeo& g, int k,
                                             int co) {
    int32_t v;
    if constexpr (W4) {
      const int tap = k / g.cx, c = k - tap * g.cx;
      v = w4_code(((const int8_t*)a.w)[(tap * ((g.cx + 1) >> 1) + (c >> 1)) *
                                           g.cy + co],
                  c & 1, ((const int8_t*)a.ws)[c]);
    } else {
      v = ((const int8_t*)a.w)[k * g.cy + co];
    }
    return (uint32_t)v << g.wp;
  }
  static __device__ __forceinline__ E load_bias(const GemmArgs& a,
                                                int co) {
    return (uint32_t)((const int32_t*)a.bias)[co];
  }
  static __device__ __forceinline__ E step(E acc, E x, E w) {
    const uint32_t d = x - w;
    return acc + ((int32_t)d < 0 ? 0u - d : d);
  }
};

// A thread's weights of the chunk at K element k0 (nk of them): element
// (k, nn) of the [k][co] chunk is output channel co0 + nn's, zero past the
// group's channels.
template <class M>
__device__ __forceinline__ void fetch_weights(typename M::E (&v)[FG_UW],
                                              const Walk& w0,
                                              const GemmArgs& a,
                                              const FgemmGeo& g, int cb,
                                              int co0, int k0, int nk) {
  Walk sw = w0;
#pragma unroll
  for (int u = 0; u < FG_UW; ++u) {
    v[u] = 0;
    if (sw.r < nk && cb + sw.c < g.ng)
      v[u] = M::load_w(a, g, k0 + sw.r, co0 + sw.c);
    sw.next();
  }
}

// A 4-byte copy from global to shared memory that bypasses the registers
// (cp.async), zero-filled where !valid (src is then not read, but must
// still be an address of the tensor).
__device__ __forceinline__ void copy4_async(float* dst, const float* src,
                                            bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// One K element's PT x Q terms: PT window values at offset o from the
// thread's pixels' bases, Q weights at wk (Q / 4 16-byte loads).
template <class M, int PT, int Q>
__device__ __forceinline__ void fgemm_step(
    typename M::E (&acc)[PT][Q], const typename M::E* const (&xw)[PT], int o,
    const typename M::E* wk) {
  using E = typename M::E;
  using V4 = typename M::V4;
  E xv[PT];
#pragma unroll
  for (int i = 0; i < PT; ++i) xv[i] = xw[i][o];
#pragma unroll
  for (int j4 = 0; j4 < Q / 4; ++j4) {
    const V4 wv = reinterpret_cast<const V4*>(wk)[j4];
#pragma unroll
    for (int i = 0; i < PT; ++i) {
      acc[i][4 * j4] = M::step(acc[i][4 * j4], xv[i], wv.x);
      acc[i][4 * j4 + 1] = M::step(acc[i][4 * j4 + 1], xv[i], wv.y);
      acc[i][4 * j4 + 2] = M::step(acc[i][4 * j4 + 2], xv[i], wv.z);
      acc[i][4 * j4 + 3] = M::step(acc[i][4 * j4 + 3], xv[i], wv.w);
    }
  }
}

// The terms of nk staged K elements (wk: the first one's weights, koff:
// their window offsets), four a step of the loop, two steps unrolled so
// that the second step's loads are issued ahead of the first step's sums.
template <class M, int PT, int Q>
__device__ __forceinline__ void fgemm_sum(
    typename M::E (&acc)[PT][Q], const typename M::E* const (&xw)[PT],
    const typename M::E* wk, const int* koff, const FgemmGeo& g, int nk) {
  int k = 0;
#pragma unroll 2
  for (; k + 4 <= nk; k += 4) {
    const int4 o = *reinterpret_cast<const int4*>(koff + k);
    fgemm_step<M, PT, Q>(acc, xw, o.x, wk + k * g.bn);
    fgemm_step<M, PT, Q>(acc, xw, o.y, wk + (k + 1) * g.bn);
    fgemm_step<M, PT, Q>(acc, xw, o.z, wk + (k + 2) * g.bn);
    fgemm_step<M, PT, Q>(acc, xw, o.w, wk + (k + 3) * g.bn);
  }
  for (; k < nk; ++k)
    fgemm_step<M, PT, Q>(acc, xw, koff[k], wk + k * g.bn);
}

// One pixel's Q outputs of a float mode: the bias in float32 (bv, read
// once a thread), relu, one rounding to T; a vector store where the plan
// allows it.
template <typename T, int Q>
__device__ __forceinline__ void store_float(float (&acc)[Q],
                                            const float (&bv)[Q], bool bias,
                                            T* yp, const FgemmGeo& g,
                                            int c0) {
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    if (bias) acc[j] = __fadd_rn(acc[j], bv[j]);
    if (g.relu && acc[j] < 0.0f) acc[j] = 0.0f;
  }
  if (g.y_vec && c0 + Q <= g.ng) {
#pragma unroll
    for (int j4 = 0; j4 < Q / 4; ++j4) {
      if constexpr (sizeof(T) == 4) {
        reinterpret_cast<float4*>(yp)[j4] =
            make_float4(acc[4 * j4], acc[4 * j4 + 1], acc[4 * j4 + 2],
                        acc[4 * j4 + 3]);
      } else {
        alignas(8) T out[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) store_f32(out + e, acc[4 * j4 + e]);
        reinterpret_cast<uint2*>(yp)[j4] =
            *reinterpret_cast<const uint2*>(out);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < Q; ++j)
      if (c0 + j < g.ng) store_f32(yp + j, acc[j]);
  }
}

// One pixel's Q outputs of the integer add: acc = 0 - l1 plus the bias bv
// (wrap_add's bits: bv - l1 in uint32), relu, the requant shift and clip;
// Q bytes as one store where the plan allows it.
template <int Q>
__device__ __forceinline__ void store_int(const uint32_t (&l1)[Q],
                                          const uint32_t (&bv)[Q], int8_t* yp,
                                          const FgemmGeo& g, int c0) {
  alignas(16) int8_t out[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j)
    out[j] = requant_epilogue((int32_t)(bv[j] - l1[j]), g.relu, g.shift);
  if (g.y_vec && c0 + Q <= g.ng) {
    if constexpr (Q == 4) {
      *reinterpret_cast<uint32_t*>(yp) = *reinterpret_cast<uint32_t*>(out);
    } else if constexpr (Q == 8) {
      *reinterpret_cast<uint2*>(yp) = *reinterpret_cast<uint2*>(out);
    } else {
      *reinterpret_cast<uint4*>(yp) = *reinterpret_cast<uint4*>(out);
    }
  } else {
#pragma unroll
    for (int j = 0; j < Q; ++j)
      if (c0 + j < g.ng) yp[j] = out[j];
  }
}

// A block: BP consecutive output pixels (of all images) x BN output
// channels of one group; thread (tp, tq) owns the PT pixels tp + i * NPX
// (a warp's 32 threads read 32 consecutive pixels) x channels
// tq*Q .. tq*Q+Q-1 of the block. KOff(g, k, ww) is K element k's window
// offset from a pixel's base.
template <class M, int PT, int Q, class KOff>
__global__ void __launch_bounds__(256) fgemm_kernel(const GemmArgs a,
                                                    const FgemmGeo g,
                                                    const KOff k_offset) {
  using E = typename M::E;
  extern __shared__ __align__(16) uint32_t fsm[];
  E* win = reinterpret_cast<E*>(fsm);       // [row][pixel][channel]
  E* wsm = win + g.win;                     // weights [k][co]: K or a chunk
  int* koff = reinterpret_cast<int*>(wsm + g.kc * g.bn);   // per K element
  int* pbase = koff + g.kc;                 // per pixel
  int* rowoff = pbase + g.bp;               // per window row

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int tp = tid % g.npx, tq = tid / g.npx;
  const int grp = blockIdx.y / g.cblk;
  const int cb = (blockIdx.y - grp * g.cblk) * g.bn;         // in the group
  const int co0 = grp * g.ng + cb;          // the block's first channel
  const int hw = g.h * g.wd, pad = g.hk / 2;
  const int p0 = blockIdx.x * g.bp, p1 = min(p0 + g.bp, g.total);
  // the first and the last pixel's image and row; window row wr holds
  // padded row P0 + wr of the images laid end to end (each h + hk - 1
  // rows), window column wc input column cmin - pad + wc
  const int b0 = p0 / hw, y0 = (p0 - b0 * hw) / g.wd;
  const int b1 = (p1 - 1) / hw, y1 = (p1 - 1 - b1 * hw) / g.wd;
  const bool one_row = b0 == b1 && y0 == y1;
  const int cmin = one_row ? p0 - b0 * hw - y0 * g.wd : 0;
  const int wwb = one_row ? p1 - p0 + g.hk - 1 : g.wd + g.hk - 1;
  const int prow0 = b0 * g.hp + y0;
  const int whb = b1 * g.hp + y1 - prow0 + g.hk;
  const int xg = grp * g.cxg;               // the group's first channel
  // all K resident (the plan's choice where they fit): one stage, no
  // chunk loop; else chunks whose next one is fetched during the sums
  const bool resident = g.kc == g.kk;

  const Walk w0(tid, nthr, g.bn);
  E pw[FG_UW];
  if (resident) {
    // every weight of the block's channels, [k][co], zero past the
    // group's channels
    Walk sw = w0;
    if constexpr (M::kAsync) {
      const float* wf = (const float*)a.w;
      while (sw.r < g.kk) {
        const bool in = cb + sw.c < g.ng;
        copy4_async(reinterpret_cast<float*>(wsm) + sw.r * g.bn + sw.c,
                    wf + (in ? sw.r * g.cy + co0 + sw.c : 0), in);
        sw.next();
      }
    } else {
      while (sw.r < g.kk) {
        const Walk s0 = sw;
        fetch_weights<M>(pw, sw, a, g, cb, co0, 0, g.kk);
#pragma unroll
        for (int u = 0; u < FG_UW; ++u) sw.next();
        Walk sd = s0;
#pragma unroll
        for (int u = 0; u < FG_UW; ++u) {
          if (sd.r < g.kk) wsm[sd.r * g.bn + sd.c] = pw[u];
          sd.next();
        }
      }
    }
  } else {
    // the first chunk's weights, in flight while the window is staged
    fetch_weights<M>(pw, w0, a, g, cb, co0, 0, min(g.kc, g.kk));
  }
  for (int r = tid; r < whb; r += nthr) {
    const int pr = prow0 + r, b = pr / g.hp, iy = pr - b * g.hp - pad;
    rowoff[r] = iy >= 0 && iy < g.h ? (b * g.h + iy) * g.wd * g.cx : -1;
  }
  for (int p = tid; p < g.bp; p += nthr) {
    const int pi = p0 + p;
    int v = 0;                   // past the last pixel: read, never stored
    if (pi < p1) {
      const int b = pi / hw, r = pi - b * hw, oy = r / g.wd;
      v = ((b * g.hp + oy - prow0) * wwb + r - oy * g.wd - cmin) * g.ps;
    }
    pbase[p] = v;
  }
  __syncthreads();

  // the window, walked [row][column][channel] (a warp reads a pixel's
  // channels), zeros outside the image
  {
    Walk3 sx(tid, nthr, wwb, g.cxg);
    if constexpr (M::kAsync) {
      const float* xf = (const float*)a.x + xg;
      while (sx.r < whb) {
        const int ro = rowoff[sx.r], ix = cmin + sx.c - pad;
        const bool in = ro >= 0 && (unsigned)ix < (unsigned)g.wd;
        copy4_async(reinterpret_cast<float*>(win) +
                        (sx.r * wwb + sx.c) * g.ps + sx.ch,
                    xf + (in ? ro + ix * g.cx + sx.ch : 0), in);
        sx.next();
      }
      copies_wait();
    } else {
      while (sx.r < whb) {
        const Walk3 s0 = sx;
        E v[FG_UX];
#pragma unroll
        for (int u = 0; u < FG_UX; ++u) {
          v[u] = 0;
          if (sx.r < whb) {
            const int ro = rowoff[sx.r], ix = cmin + sx.c - pad;
            if (ro >= 0 && (unsigned)ix < (unsigned)g.wd)
              v[u] = M::load_x(a, g, xg + ro + ix * g.cx + sx.ch);
          }
          sx.next();
        }
        Walk3 sd = s0;
#pragma unroll
        for (int u = 0; u < FG_UX; ++u) {
          if (sd.r < whb) win[(sd.r * wwb + sd.c) * g.ps + sd.ch] = v[u];
          sd.next();
        }
      }
    }
  }

  E acc[PT][Q];
#pragma unroll
  for (int i = 0; i < PT; ++i)
#pragma unroll
    for (int j = 0; j < Q; ++j) acc[i][j] = 0;
  const E* xw[PT];
#pragma unroll
  for (int i = 0; i < PT; ++i) xw[i] = win + pbase[tp + i * g.npx];
  const E* wr = wsm + tq * Q;

  if (resident) {
    for (int t = tid; t < g.kk; t += nthr) koff[t] = k_offset(g, t, wwb);
    __syncthreads();
    fgemm_sum<M, PT, Q>(acc, xw, wr, koff, g, g.kk);
  } else {
    for (int k0 = 0; k0 < g.kk; k0 += g.kc) {
      const int nk = min(g.kc, g.kk - k0);
      // publish the fetched chunk and its K offsets
      Walk sw = w0;
#pragma unroll
      for (int u = 0; u < FG_UW; ++u) {
        if (sw.r < nk) wsm[sw.r * g.bn + sw.c] = pw[u];
        sw.next();
      }
      for (int t = tid; t < nk; t += nthr)
        koff[t] = k_offset(g, k0 + t, wwb);
      __syncthreads();
      const int k1 = k0 + g.kc;
      if (k1 < g.kk)
        fetch_weights<M>(pw, w0, a, g, cb, co0, k1, min(g.kc, g.kk - k1));
      fgemm_sum<M, PT, Q>(acc, xw, wr, koff, g, nk);
      __syncthreads();
    }
  }

  const int c0 = cb + tq * Q;                       // in the group
  if (c0 >= g.ng) return;
  const int co = grp * g.ng + c0;
  using T = typename M::Out;
  E bv[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j)
    bv[j] = a.bias != nullptr && c0 + j < g.ng ? M::load_bias(a, co + j) : 0;
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const int pi = p0 + tp + i * g.npx;
    if (pi >= p1) break;
    T* yp = (T*)a.y + pi * g.cy + co;
    if constexpr (M::kInt) {
      store_int<Q>(acc[i], bv, yp, g, c0);
    } else {
      store_float<T, Q>(acc[i], bv, a.bias != nullptr, yp, g, c0);
    }
  }
}

template <class M, int PT, int Q, class KOff>
int fgemm_launch_q(const FgemmGeo& g, int gx, int gy, int threads,
                   const GemmArgs& a, const KOff& k_offset, cudaStream_t st) {
  auto kern = fgemm_kernel<M, PT, Q, KOff>;
  if (g.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(gx, gy), threads, g.smem, st>>>(a, g, k_offset);
  return (int)cudaGetLastError();
}

// One instantiation per (PT, Q) that pixels_a_thread gives.
template <class M, class KOff>
int fgemm_launch(const FgemmGeo& g, int gx, int gy, int threads,
                 const GemmArgs& a, int q, const KOff& k_offset,
                 cudaStream_t st) {
#define FGEMM_CASE(PT_, Q_)                                             \
  if (g.pt == PT_ && q == Q_)                                           \
    return fgemm_launch_q<M, PT_, Q_>(g, gx, gy, threads, a, k_offset, st);
  FGEMM_CASE(1, 4) FGEMM_CASE(2, 4) FGEMM_CASE(4, 4) FGEMM_CASE(8, 4)
  FGEMM_CASE(1, 8) FGEMM_CASE(2, 8) FGEMM_CASE(4, 8)
  FGEMM_CASE(1, 16) FGEMM_CASE(2, 16)
#undef FGEMM_CASE
  return (int)cudaErrorInvalidValue;
}

// The plan of one launch, refused (false) if the tile is not one of the
// knobs' values or does not fit; y_vec from the output's alignment.
bool fgemm_geo(FgemmGeo& g, int* gx, int* gy, int* threads, const void* y,
               int n, int h, int wd, int cx, int cy, int hk,
               int groups, int relu, int bp, int q) {
  if (!valid_tile(bp, q) ||
      !fgemm_plan(g, gx, gy, threads, n, h, wd, cx, cy, hk, groups, bp, q))
    return false;
  g.relu = relu, g.xp = g.wp = g.shift = 0;
  g.y_vec = g.cy % 4 == 0 && g.ng % 4 == 0 && (uintptr_t)y % 16 == 0;
  return true;
}

// Plan and launch one float implicit GEMM: dtype 0 float32, 1 bfloat16
// (x, w, bias and y alike); bias may be null.
template <class Term, class KOff>
int fgemm_run(const void* x, const void* w, const void* bias, void* y,
              int n, int h, int wd, int cx, int cy, int hk, int groups,
              int relu, int dtype, int bp, int q, const KOff& k_offset,
              void* stream) {
  if (!valid_tile(bp, q) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (n * h * wd * cy == 0) return (int)cudaSuccess;
  FgemmGeo g;
  int gx, gy, threads;
  if (!fgemm_geo(g, &gx, &gy, &threads, y, n, h, wd, cx, cy, hk, groups,
                 relu, bp, q))
    return (int)cudaErrorInvalidValue;
  const GemmArgs a{x, w, nullptr, bias, y};
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return fgemm_launch<FloatMode<float, Term>>(g, gx, gy, threads, a, q,
                                                k_offset, st);
  return fgemm_launch<FloatMode<__nv_bfloat16, Term>>(g, gx, gy, threads, a,
                                                      q, k_offset, st);
}

// Plan and launch one integer add conv (groups 1): x int8 (N,H,W,Cx), w
// int8 (HK,HK,Cx,Cy) or W4 (HK,HK,ceil(Cx/2),Cy) with ws (Cx,), bias int32
// (Cy,) or null, y int8 (N,H,W,Cy).
template <bool W4>
int fgemm_run_add_int(const void* x, const void* w, const void* ws,
                      const void* bias, void* y, int n, int h, int wd,
                      int cx, int cy, int hk, int xp, int wp, int shift,
                      int relu, int bp, int q, void* stream) {
  if (!valid_tile(bp, q)) return (int)cudaErrorInvalidValue;
  if (n * h * wd * cy == 0) return (int)cudaSuccess;
  FgemmGeo g;
  int gx, gy, threads;
  if (!fgemm_geo(g, &gx, &gy, &threads, y, n, h, wd, cx, cy, hk, 1, relu, bp,
                 q))
    return (int)cudaErrorInvalidValue;
  g.xp = xp, g.wp = wp, g.shift = shift;
  g.y_vec = g.cy % q == 0 && (uintptr_t)y % 16 == 0;
  const GemmArgs a{x, w, ws, bias, y};
  return fgemm_launch<IntAddMode<W4>>(g, gx, gy, threads, a, q,
                                      TapOffsets{}, (cudaStream_t)stream);
}

// The launch arithmetic as an int array: plan[0..4] = grid x, grid y,
// threads, shared bytes, window bytes. Returns non-zero if the tile is not
// one of the knobs' values or does not fit (plan still filled).
int fgemm_plan_out(int* plan, int n, int h, int wd, int cx, int cy, int hk,
                   int groups, int bp, int q) {
  if (!valid_tile(bp, q)) return (int)cudaErrorInvalidValue;
  FgemmGeo g;
  const bool fits = fgemm_plan(g, plan, plan + 1, plan + 2, n, h, wd, cx, cy,
                               hk, groups, bp, q);
  plan[3] = g.smem, plan[4] = 4 * g.win;
  return fits ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
}

}  // namespace
