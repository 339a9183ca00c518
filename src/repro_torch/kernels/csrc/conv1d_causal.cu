// Depthwise causal conv1d (float32 or bfloat16) for sm_90a.
//
// Replaces the TPU kernel repro/kernels/conv1d_causal.py (causal_conv1d /
// _causal_conv1d): x (B,L,D), w (K,D) in the same dtype,
//   out[b,l,d] = sum_k w[k,d] * x[b, l-K+1+k, d],  zero history before l=0,
// summed in float32 from a zero accumulator, taps in order k = 0..K-1, then
// an optional relu and ONE rounding to x's dtype. Every product and sum is
// __fmul_rn / __fadd_rn, so the compiler cannot contract them into FMAs:
// the plain PyTorch version multiplies and adds as separate float32
// operations, and the two stay bitwise equal.
//
// x's channel axis is contiguous; its rows (positions) lie `rs` elements
// apart and its batch rows L * rs apart, so Mamba's x half of the in_proj
// output (the (B, L, 2D) product's first D columns, rs = 2D) is read where
// it lies, with no copy. The output is contiguous (B, L, D).
//
// What bounds it on an H100: 2K flops per output against one element read
// and one written, so bytes (x once, out once, w). At Falcon-Mamba's
// prefill shapes (1 x L x 8192 bf16, L = 16..256) that is 0.3-8 MB, a
// microsecond or less of HBM time, and x was written by in_proj just
// before, so it sits in the 50 MB L2. The kernel is bound by latency (one
// trip to L2 for every thread's loads, then its sums) and by issue slots
// (the loads and stores a warp issues), not by HBM.
//
// The design answers that with 16-byte accesses and all of a thread's loads
// in flight at once. Vector path (x, w, y and the row stride 16-byte
// aligned, D * elsize a multiple of 16): a thread owns one 16-byte vector
// of channels (4 float32 or 8 bf16) and a run of R positions of one batch
// row; it issues its K-1 halo rows and its R rows as R + K - 1 16-byte
// loads before its first sum, sums every lane from registers, and writes
// one 16-byte store a position. A warp moves 512 bytes a load instruction
// (the first design: 64). R (1, 2, 4 or 8) and the block size (64, 128 or
// 256 threads) are template arguments, the tuner's knobs; the wrapper's
// default picks R so that a served shape launches at least two blocks an
// SM where L allows (1 x 96 x 8192 bf16: 1,024 vectors x 48 runs of 2).
// A run re-reads its K-1 halo rows from L2: (R + K - 1) / R loads an
// output row. Scalar path (any other D or alignment: D = 100, x at an odd
// address): the first design, a thread a channel and a run of 32
// positions, the same arithmetic. repro_causal_conv1d_plan exports the
// choice and the grid.
#include <cstdint>
#include <cuda_runtime.h>

#include "float_io.cuh"

namespace {

constexpr int SCALAR_RUN = 32;   // positions per thread on the scalar path
constexpr int MAX_K = 8;

// 16 bytes of one element type: float32 lanes as they are, bfloat16 lanes
// as raw bits widened exactly by a 16-bit shift.
template <typename T> struct Lanes;
template <> struct Lanes<float> {
  static constexpr int N = 4;
  union V { uint4 u; float e[4]; };
  static __device__ __forceinline__ float get(const V& v, int i) {
    return v.e[i];
  }
  static __device__ __forceinline__ void set(V& v, int i, float f) {
    v.e[i] = f;
  }
};
template <> struct Lanes<__nv_bfloat16> {
  static constexpr int N = 8;
  union V { uint4 u; unsigned short e[8]; };
  static __device__ __forceinline__ float get(const V& v, int i) {
    return __uint_as_float((unsigned)v.e[i] << 16);
  }
  static __device__ __forceinline__ void set(V& v, int i, float f) {
    v.e[i] = __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
};

template <typename T, int K, int R, int THREADS>
__global__ void __launch_bounds__(THREADS) causal_conv1d_vec_kernel(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
    int L, int D, int64_t rs, int relu) {
  using LV = Lanes<T>;
  constexpr int N = LV::N;
  const int c = (blockIdx.x * THREADS + threadIdx.x) * N;   // first channel
  if (c >= D) return;
  const int l0 = blockIdx.y * R;
  const int64_t xrow = (int64_t)blockIdx.z * L;
  // raw[j] = x[l0 - (K-1) + j]: the halo, then the run (0 outside [0, L));
  // every load is issued before the first sum
  typename LV::V raw[R + K - 1];
#pragma unroll
  for (int j = 0; j < R + K - 1; ++j) {
    const int l = l0 - (K - 1) + j;
    raw[j].u = l >= 0 && l < L
        ? __ldg((const uint4*)(x + (xrow + l) * rs + c))
        : make_uint4(0u, 0u, 0u, 0u);
  }
  typename LV::V wv[K];
#pragma unroll
  for (int k = 0; k < K; ++k)
    wv[k].u = __ldg((const uint4*)(w + (int64_t)k * D + c));
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (l0 + i >= L) break;
    typename LV::V out;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k)
        acc = __fadd_rn(acc, __fmul_rn(LV::get(raw[i + k], e),
                                       LV::get(wv[k], e)));
      if (relu && acc < 0.0f) acc = 0.0f;
      LV::set(out, e, acc);
    }
    *(uint4*)(y + (xrow + l0 + i) * D + c) = out.u;
  }
}

template <typename T, int K, int THREADS>
__global__ void __launch_bounds__(THREADS) causal_conv1d_kernel(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
    int L, int D, int64_t rs, int relu) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  if (d >= D) return;
  const int l0 = blockIdx.y * SCALAR_RUN;
  const int64_t row = (int64_t)blockIdx.z * L;
  float wk[K];
#pragma unroll
  for (int k = 0; k < K; ++k) wk[k] = load_f32(w + (int64_t)k * D + d);
  // hist[j] = x[l0 - (K-1) + j], the halo before the run (0 before l = 0);
  // xs[i] = x[l0 + i]. Every load is issued before the first sum.
  float hist[K > 1 ? K - 1 : 1];
#pragma unroll
  for (int j = 0; j < K - 1; ++j) {
    const int l = l0 - (K - 1) + j;
    hist[j] = l >= 0 ? load_f32(x + (row + l) * rs + d) : 0.0f;
  }
  float xs[SCALAR_RUN];
#pragma unroll
  for (int i = 0; i < SCALAR_RUN; ++i) {
    const int l = l0 + i;
    xs[i] = l < L ? load_f32(x + (row + l) * rs + d) : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < SCALAR_RUN; ++i) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = i - (K - 1) + k;   // compile-time after unrolling
      const float xv = j >= 0 ? xs[j >= 0 ? j : 0]
                              : hist[j >= 0 ? 0 : j + K - 1];
      acc = __fadd_rn(acc, __fmul_rn(xv, wk[k]));
    }
    if (relu && acc < 0.0f) acc = 0.0f;
    if (l0 + i < L) store_f32(y + (row + l0 + i) * D + d, acc);
  }
}

// The launch: plan[0..5] = grid x, y, z, threads, positions a thread, 1 for
// the vector path (0: scalar). `aligned`: x, w and y 16-byte aligned and
// the row stride a whole number of 16-byte vectors.
int c1d_plan(int* plan, int b, int l, int d, int esize, int aligned, int run,
             int threads) {
  if ((esize != 2 && esize != 4) || (run != 1 && run != 2 && run != 4 &&
                                     run != 8) ||
      (threads != 64 && threads != 128 && threads != 256))
    return (int)cudaErrorInvalidValue;
  const int vec = aligned && ((int64_t)d * esize) % 16 == 0;
  const int lanes = vec ? 16 / esize : 1;
  const int r = vec ? run : SCALAR_RUN;
  plan[0] = (d / lanes + threads - 1) / threads;
  plan[1] = (l + r - 1) / r;
  plan[2] = b;
  plan[3] = threads, plan[4] = r, plan[5] = vec;
  return (int)cudaSuccess;
}

template <typename T, int K, int THREADS>
void launch_k(const dim3& grid, int run, int vec, const T* x, const T* w,
              T* y, int l, int d, int64_t rs, int relu, cudaStream_t s) {
  if (!vec) {
    causal_conv1d_kernel<T, K, THREADS><<<grid, THREADS, 0, s>>>(
        x, w, y, l, d, rs, relu);
    return;
  }
  switch (run) {
#define REPRO_C1D_RUN(RR)                                                    \
  case RR:                                                                   \
    causal_conv1d_vec_kernel<T, K, RR, THREADS><<<grid, THREADS, 0, s>>>(    \
        x, w, y, l, d, rs, relu);                                            \
    break;
    REPRO_C1D_RUN(1)
    REPRO_C1D_RUN(2)
    REPRO_C1D_RUN(4)
    REPRO_C1D_RUN(8)
#undef REPRO_C1D_RUN
  }
}

template <typename T, int THREADS>
void launch_t(const dim3& grid, int run, int vec, const void* x,
              const void* w, void* y, int l, int d, int64_t rs, int k,
              int relu, cudaStream_t s) {
  const T* xp = (const T*)x;
  const T* wp = (const T*)w;
  T* yp = (T*)y;
  switch (k) {
#define REPRO_C1D_CASE(KK)                                                   \
  case KK:                                                                   \
    launch_k<T, KK, THREADS>(grid, run, vec, xp, wp, yp, l, d, rs, relu, s); \
    break;
    REPRO_C1D_CASE(1)
    REPRO_C1D_CASE(2)
    REPRO_C1D_CASE(3)
    REPRO_C1D_CASE(4)
    REPRO_C1D_CASE(5)
    REPRO_C1D_CASE(6)
    REPRO_C1D_CASE(7)
    REPRO_C1D_CASE(8)
#undef REPRO_C1D_CASE
  }
}

template <typename T>
int launch(const void* x, const void* w, void* y, int b, int l, int d,
           int rs, int k, int relu, int run, int threads, void* stream) {
  if (k < 1 || k > MAX_K || rs < d) return (int)cudaErrorInvalidValue;
  const int esize = (int)sizeof(T);
  const int aligned = (uintptr_t)x % 16 == 0 && (uintptr_t)w % 16 == 0 &&
                      (uintptr_t)y % 16 == 0 && ((int64_t)rs * esize) % 16 == 0;
  int plan[6];
  const int rc = c1d_plan(plan, b, l, d, esize, aligned, run, threads);
  if (rc != (int)cudaSuccess) return rc;
  if (b == 0 || l == 0 || d == 0) return (int)cudaSuccess;
  const dim3 grid(plan[0], plan[1], plan[2]);
  cudaStream_t s = (cudaStream_t)stream;
  // the block size is a template argument: each is its own instantiation
  if (threads == 64)
    launch_t<T, 64>(grid, run, plan[5], x, w, y, l, d, rs, k, relu, s);
  else if (threads == 128)
    launch_t<T, 128>(grid, run, plan[5], x, w, y, l, d, rs, k, relu, s);
  else
    launch_t<T, 256>(grid, run, plan[5], x, w, y, l, d, rs, k, relu, s);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; rs: x's row stride in elements (at least
// d; x's batch rows l * rs apart); run: positions a thread on the vector
// path, 1, 2, 4 or 8; threads: threads a block, 64, 128 or 256.
extern "C" int repro_causal_conv1d(const void* x, const void* w, void* y,
                                   int b, int l, int d, int rs, int k,
                                   int relu, int dtype, int run, int threads,
                                   void* stream) {
  if (dtype == 0)
    return launch<float>(x, w, y, b, l, d, rs, k, relu, run, threads, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, y, b, l, d, rs, k, relu, run, threads,
                                 stream);
  return (int)cudaErrorInvalidValue;
}

// The launch arithmetic (see c1d_plan); nothing is launched.
extern "C" int repro_causal_conv1d_plan(int* plan, int b, int l, int d,
                                        int esize, int aligned, int run,
                                        int threads) {
  return c1d_plan(plan, b, l, d, esize, aligned, run, threads);
}
