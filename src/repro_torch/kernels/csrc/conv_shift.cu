// int8, W4A8 and float32 / bfloat16 shift convolution for sm_90a: a
// per-channel spatial shift fused into the pointwise contraction.
//
// Replaces the TPU kernel repro/kernels/conv_shift.py (shift_conv2d, all
// modes): y[n,y,x,co] = sum_c x[n, y+a_c, x+b_c, c] * w_pw[c,co], a
// read outside the image being zero, accumulated in int32; then the optional
// int32 bias at accumulator scale, relu, round-to-nearest shift and clip to
// int8 (epilogue.cuh). x (N,H,W,C) int8 NHWC, shifts (C,2) int32 (a, b) on
// the device, w_pw (C,Cy) int8, y (N,H,W,Cy) int8.
//
// The paper's shift primitive is im2col whose sampling step reads each
// channel at its own offset. The TPU wrapper sorts channels into groups of
// one shift so that each group is one matrix-unit product; the int32 sum
// does not depend on the order of its terms, so here no sort is needed.
//
// Integer modes (repro_shift_conv2d_q8, repro_shift_conv2d_w4): the integer
// conv's implicit GEMM (igemm.cuh) with M = N*H*W output pixels, N = Cy and
// K = C. A shift with |a|, |b| <= d has the geometry of an HK = 2d+1 SAME
// conv whose filter has one non-zero tap per input channel, at (a_c + d,
// b_c + d), and the TPU kernels pad an odd HK by (d, d), the shift's own
// halo: so a block stages its pixels' window with a halo of d as the conv
// does, and the K-offset builder puts channel c at window offset
// ((a_c + d) * wwb + b_c + d) * ps + c, read from the device shift table
// once a block (never read back on the host). Four K-consecutive channels
// sit at four displacements (the paper's assignment goes round the
// (2d+1)^2 grid channel by channel), so each im2col word is gathered as four
// bytes from the window. The window's extent depends on d = max_shift,
// which the wrapper requires on the card: the table's bound is checked once
// on the host when a plan is built, and an entry past d is read as a zero,
// never outside the window. What bounds it on an H100: a few MB and well
// under a GFLOP per launch at the model's shapes, so HBM time of about a
// microsecond; the staging of the window, the filter and the im2col words
// costs as much as the sums.
//
// W4 mode (repro_shift_conv2d_w4): w_pw is (ceil(C/2),Cy), two int4 codes
// per byte along C (K's order, so nothing is re-packed), with an int8
// group shift per channel (ws, length C), unpacked and shifted once per
// block while the filter chunk is staged (w4.cuh). Only the C real channels
// are read, so the pad nibble of an odd C never is.
//
// Float mode (repro_shift_conv2d_f): x and w_pw in float32 or bfloat16. A
// block owns BP output pixels (a run over all images' N*H*W pixels) x BN
// output channels; per chunk of 64 input channels it stages the pixels'
// shifted inputs in shared memory as float32 (each channel read at its own
// displacement, a zero outside the image) and the weight slice, and each
// thread sums one pixel x Q channels in registers: a float32 accumulator
// from +0 over c = 0..C-1 in index order with __fmul_rn / __fadd_rn (no FMA,
// no K split, no tensor cores), then relu and one rounding to x's dtype
// (float_io.cuh), the plain version's order, so the two are bitwise equal
// (a staged zero times a finite weight adds +-0, which leaves the sum as
// the plain version's zero-filled product does). The TPU kernel sums per
// shift group on its matrix unit, another order, so the float mode agrees
// with the JAX package within a tolerance only. At Table-2's 1x32x32,
// 64->64 job (65,536 outputs) the launch and load latency bound it, so the
// thread tile is small, a block has at most 128 threads at BP < 256 (blocks
// for every SM), and a thread's staging loads are issued together.
//
// Every mode takes the tile (bp: pixels a block, a multiple of 32 up to 256;
// q: channels a thread, 4, 8 or 16), the tuner's knobs; they change only
// the launch shape. repro_shift_conv2d_i8_plan / _f_plan export the launch
// arithmetic (repro_torch.kernels.conv_shift.shift_plan / shift_f_plan
// mirror it).
//
// Index arithmetic is 32-bit (the wrapper keeps every tensor below 2^31
// elements).
#include <cstdint>
#include <cuda_runtime.h>

#include "float_io.cuh"
#include "igemm.cuh"

namespace {

// A shift conv's K element c (an input channel) lies at window offset
// ((a_c + d) * wwb + b_c + d) * ps + c from its pixel's base, d = HK / 2;
// an entry past d (outside the contract) reads a zero.
struct ShiftOffsets {
  const int32_t* shifts;
  __device__ int operator()(const IgemmGeo& g, int c, int wwb) const {
    const int d = g.hk / 2;
    const int i = shifts[2 * c] + d, j = shifts[2 * c + 1] + d;
    if (i < 0 || i >= g.hk || j < 0 || j >= g.hk) return -1;
    return (i * wwb + j) * g.ps + c;
  }
};

// The integer modes' plan: the implicit GEMM of an HK = 2d+1 window over
// K = C.
bool shift_i8_plan(IgemmGeo& g, int* gx, int* gy, int* threads, int n, int h,
                   int wd, int c, int cy, int d, int bp, int q) {
  return d >= 1 && igemm_plan(g, gx, gy, threads, n, h, wd, c, cy,
                              2 * d + 1, 1, c, bp, q);
}

template <bool W4>
int launch_int(const void* x, const void* shifts, const void* w,
               const void* ws, const void* bias, void* y, int n, int h,
               int wd, int c, int cy, int d, int shift, int relu, int bp,
               int q, void* stream) {
  if (!valid_tile(bp, q)) return (int)cudaErrorInvalidValue;
  if (n * h * wd * cy == 0) return (int)cudaSuccess;
  IgemmGeo g;
  int gx, gy, threads;
  if (!shift_i8_plan(g, &gx, &gy, &threads, n, h, wd, c, cy, d, bp, q))
    return (int)cudaErrorInvalidValue;
  return igemm_launch<W4>(g, gx, gy, threads, false, x, w, ws, bias, y,
                          shift, relu, q,
                          ShiftOffsets{(const int32_t*)shifts}, stream);
}

constexpr int FKC = 64;              // input channels a staged chunk
constexpr int F_THREADS = 128;       // threads a block below BP = 256
// staged weights and inputs a thread has in flight at once
constexpr int FUW = 8, FUX = 16;

// Launch geometry of the float mode, computed on the host (shift_f_plan).
struct ShiftFGeo {
  int h, wd, c, cy, total;   // image, channels, pixels of all images
  int bp, bn, cblk;          // pixels a block, channels a block, their blocks
  int pitch;                 // staged floats per channel row (bp + 1)
  int smem, y_vec, relu;
};

// The float mode's launch arithmetic: returns false if it does not fit.
bool shift_f_plan(ShiftFGeo& g, int* gx, int* gy, int* threads, int n,
                  int h, int wd, int c, int cy, int bp, int q) {
  g.h = h, g.wd = wd, g.c = c, g.cy = cy, g.total = n * h * wd;
  const int ct = imin((cy + q - 1) / q, bp < F_THREADS ? F_THREADS / bp : 1);
  g.bp = bp, g.bn = ct * q, g.cblk = (cy + g.bn - 1) / g.bn;
  g.pitch = bp + 1;
  // the shifted inputs [channel][pixel], the weights [channel][co], each
  // pixel's (row, column, image offset) as an int4, the chunk's shift pairs
  g.smem = 4 * (FKC * g.pitch + FKC * g.bn + 4 * bp + 2 * FKC);
  *gx = (g.total + bp - 1) / bp, *gy = g.cblk, *threads = bp * ct;
  return g.smem <= 232448 && *gy <= 65535;
}

// A block: BP consecutive output pixels (of all images) x BN output
// channels; thread (tp, tq) owns pixel tp x channels tq*Q .. tq*Q+Q-1.
// With one warp a scheduler at Table-2's small job, instructions and
// latency bound it: a thread walks its staging elements without divisions
// and issues FUW weight and FUX input loads before it stores any, and the
// next chunk's shift pairs are fetched during the sums.
template <typename T, int Q>
__global__ void __launch_bounds__(256) shift_conv2d_f_kernel(
    const T* __restrict__ x, const int2* __restrict__ shifts,
    const T* __restrict__ w, T* __restrict__ y, const ShiftFGeo g) {
  extern __shared__ __align__(16) float fsm[];
  float* xs = fsm;                                  // [channel][pixel]
  float* wsm = xs + FKC * g.pitch;                  // [channel][co]
  int4* pinfo = reinterpret_cast<int4*>(wsm + FKC * g.bn);
  int2* sab = reinterpret_cast<int2*>(pinfo + g.bp);   // the chunk's (a, b)

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int tp = tid % g.bp, tq = tid / g.bp;
  const int p0 = blockIdx.x * g.bp, cb = blockIdx.y * g.bn;
  const int hw = g.h * g.wd;
  for (int p = tid; p < g.bp; p += nthr) {
    const int pi = p0 + p;
    int4 v = make_int4(-(1 << 29), 0, 0, 0);      // past the last: no row
    if (pi < g.total) {
      const int b = pi / hw, r = pi - b * hw;
      v.x = r / g.wd, v.y = r - v.x * g.wd, v.z = b * hw * g.c;
    }
    pinfo[p] = v;
  }
  for (int t = tid; t < min(FKC, g.c); t += nthr) sab[t] = shifts[t];
  __syncthreads();

  float acc[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) acc[j] = 0.0f;

  for (int c0 = 0; c0 < g.c; c0 += FKC) {
    const int nk = min(FKC, g.c - c0);
    // the weight chunk [ci][nn] and the shifted inputs, walked [p][ci] with
    // the channel fastest (a warp reads one pixel's channels, each at its
    // own displacement) and stored [ci][p]
    Walk sw(tid, nthr, g.bn), sx(tid, nthr, nk);
    while (sw.r < nk || sx.r < g.bp) {
      float vw[FUW], vx[FUX];
      int dw[FUW], dx[FUX];
#pragma unroll
      for (int u = 0; u < FUW; ++u) {
        vw[u] = 0.0f, dw[u] = -1;
        if (sw.r < nk) {
          dw[u] = sw.r * g.bn + sw.c;
          if (cb + sw.c < g.cy)
            vw[u] = load_f32(w + (c0 + sw.r) * g.cy + cb + sw.c);
        }
        sw.next();
      }
#pragma unroll
      for (int u = 0; u < FUX; ++u) {
        vx[u] = 0.0f, dx[u] = -1;
        if (sx.r < g.bp) {
          const int4 pv = pinfo[sx.r];
          const int2 ab = sab[sx.c];
          const int iy = pv.x + ab.x, ix = pv.y + ab.y;
          dx[u] = sx.c * g.pitch + sx.r;
          if ((unsigned)iy < (unsigned)g.h && (unsigned)ix < (unsigned)g.wd)
            vx[u] = load_f32(x + pv.z + (iy * g.wd + ix) * g.c + c0 + sx.c);
        }
        sx.next();
      }
#pragma unroll
      for (int u = 0; u < FUW; ++u)
        if (dw[u] >= 0) wsm[dw[u]] = vw[u];
#pragma unroll
      for (int u = 0; u < FUX; ++u)
        if (dx[u] >= 0) xs[dx[u]] = vx[u];
    }
    __syncthreads();
    // the next chunk's shift pairs: sab is read by the staging only
    const int c1 = c0 + FKC;
    for (int t = tid; t < min(FKC, g.c - c1); t += nthr)
      sab[t] = shifts[c1 + t];
    const float* wr = wsm + tq * Q;
#pragma unroll 4
    for (int ci = 0; ci < nk; ++ci) {
      const float xv = xs[ci * g.pitch + tp];
#pragma unroll
      for (int j4 = 0; j4 < Q / 4; ++j4) {
        const float4 wv =
            reinterpret_cast<const float4*>(wr + ci * g.bn)[j4];
        acc[4 * j4] = __fadd_rn(acc[4 * j4], __fmul_rn(xv, wv.x));
        acc[4 * j4 + 1] = __fadd_rn(acc[4 * j4 + 1], __fmul_rn(xv, wv.y));
        acc[4 * j4 + 2] = __fadd_rn(acc[4 * j4 + 2], __fmul_rn(xv, wv.z));
        acc[4 * j4 + 3] = __fadd_rn(acc[4 * j4 + 3], __fmul_rn(xv, wv.w));
      }
    }
    __syncthreads();
  }

  const int pi = p0 + tp, co0 = cb + tq * Q;
  if (pi >= g.total || co0 >= g.cy) return;
  T* yp = y + pi * g.cy + co0;
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    if (g.relu && acc[j] < 0.0f) acc[j] = 0.0f;
  }
  if (g.y_vec && co0 + Q <= g.cy) {
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
      if (co0 + j < g.cy) store_f32(yp + j, acc[j]);
  }
}

template <typename T, int Q>
int launch_f_q(const ShiftFGeo& g, int gx, int gy, int threads,
               const void* x, const void* shifts, const void* w, void* y,
               cudaStream_t st) {
  auto kern = shift_conv2d_f_kernel<T, Q>;
  if (g.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(gx, gy), threads, g.smem, st>>>(
      (const T*)x, (const int2*)shifts, (const T*)w, (T*)y, g);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_f(ShiftFGeo& g, int gx, int gy, int threads, const void* x,
             const void* shifts, const void* w, void* y, int q,
             cudaStream_t st) {
  if (q == 4) return launch_f_q<T, 4>(g, gx, gy, threads, x, shifts, w, y, st);
  if (q == 8) return launch_f_q<T, 8>(g, gx, gy, threads, x, shifts, w, y, st);
  return launch_f_q<T, 16>(g, gx, gy, threads, x, shifts, w, y, st);
}

}  // namespace

// d: the table's bound (max_shift), at least 1; bp and q: the tile.
extern "C" int repro_shift_conv2d_q8(const void* x, const void* shifts,
                                     const void* w, const void* bias, void* y,
                                     int n, int h, int wd, int c, int cy,
                                     int d, int shift, int relu, int bp,
                                     int q, void* stream) {
  return launch_int<false>(x, shifts, w, nullptr, bias, y, n, h, wd, c, cy,
                           d, shift, relu, bp, q, stream);
}

extern "C" int repro_shift_conv2d_w4(const void* x, const void* shifts,
                                     const void* w, const void* ws,
                                     const void* bias, void* y, int n, int h,
                                     int wd, int c, int cy, int d, int shift,
                                     int relu, int bp, int q, void* stream) {
  return launch_int<true>(x, shifts, w, ws, bias, y, n, h, wd, c, cy, d,
                          shift, relu, bp, q, stream);
}

// The integer modes' launch arithmetic: plan[0..5] = grid x, grid y,
// threads, shared bytes, K words, window bytes. Returns non-zero if the
// tile is not one of the knobs' values or does not fit (plan still filled).
extern "C" int repro_shift_conv2d_i8_plan(int* plan, int n, int h, int wd,
                                          int c, int cy, int d, int bp,
                                          int q) {
  if (!valid_tile(bp, q) || d < 1) return (int)cudaErrorInvalidValue;
  IgemmGeo g;
  const bool fits = shift_i8_plan(g, plan, plan + 1, plan + 2, n, h, wd, c,
                                  cy, d, bp, q);
  plan[3] = g.smem, plan[4] = g.kw, plan[5] = g.win_bytes;
  return fits ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
}

// dtype: 0 float32, 1 bfloat16 (x, w and y alike; shifts int32).
extern "C" int repro_shift_conv2d_f(const void* x, const void* shifts,
                                    const void* w, void* y, int n, int h,
                                    int wd, int c, int cy, int relu, int dtype,
                                    int bp, int q, void* stream) {
  if (!valid_tile(bp, q) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (n * h * wd * cy == 0) return (int)cudaSuccess;
  ShiftFGeo g;
  int gx, gy, threads;
  if (!shift_f_plan(g, &gx, &gy, &threads, n, h, wd, c, cy, bp, q))
    return (int)cudaErrorInvalidValue;
  g.relu = relu;
  g.y_vec = cy % 4 == 0 && (uintptr_t)y % 16 == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_f<float>(g, gx, gy, threads, x, shifts, w, y, q, st);
  return launch_f<__nv_bfloat16>(g, gx, gy, threads, x, shifts, w, y, q, st);
}

// The float mode's launch arithmetic: plan[0..3] = grid x, grid y,
// threads, shared bytes. Returns non-zero if the tile is not one of the
// knobs' values or does not fit (plan still filled).
extern "C" int repro_shift_conv2d_f_plan(int* plan, int n, int h, int wd,
                                         int c, int cy, int bp, int q) {
  if (!valid_tile(bp, q)) return (int)cudaErrorInvalidValue;
  ShiftFGeo g;
  const bool fits =
      shift_f_plan(g, plan, plan + 1, plan + 2, n, h, wd, c, cy, bp, q);
  plan[3] = g.smem;
  return fits ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
}
