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
// What bounds it on an H100: 2K flops per output against one element read
// and one written, so bytes (x once, out once, w) over HBM bandwidth; at
// Falcon-Mamba's prefill shapes (1 x L x 8192, bf16) that is about a
// microsecond, and a launch of this size is latency-bound. The design: a
// thread owns one channel d and a run of RUN consecutive positions of one
// batch row. Threads run along D, so a warp's loads of one position are
// consecutive elements. A thread loads its whole run and the K-1 inputs
// before it into registers first, so all its loads are in flight at once,
// then sums from registers (the Pallas kernel's halo from the next block
// becomes K-1 extra loads per run, which hit L2): each input is read from
// HBM once; no shared memory. K is a template argument (1..MAX_K) and RUN a
// constant, so both loops unroll and every register index is static. The
// block size (THREADS channels: 64, 128 or 256, the tuner's knob; 128 by
// default) is a template argument too, one instantiation each; it changes
// only the launch shape.
#include <cstdint>
#include <cuda_runtime.h>

#include "float_io.cuh"

namespace {

constexpr int RUN = 32;        // positions per thread
constexpr int MAX_K = 8;

template <typename T, int K, int THREADS>
__global__ void __launch_bounds__(THREADS) causal_conv1d_kernel(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, int L,
    int D, int relu) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  if (d >= D) return;
  const int l0 = blockIdx.y * RUN;
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
    hist[j] = l >= 0 ? load_f32(x + (row + l) * D + d) : 0.0f;
  }
  float xs[RUN];
#pragma unroll
  for (int i = 0; i < RUN; ++i) {
    const int l = l0 + i;
    xs[i] = l < L ? load_f32(x + (row + l) * D + d) : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < RUN; ++i) {
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

template <typename T, int THREADS>
int launch_k(const void* x, const void* w, void* y, int b, int l, int d,
             int k, int relu, cudaStream_t s) {
  const dim3 grid((d + THREADS - 1) / THREADS, (l + RUN - 1) / RUN, b);
  const T* xp = (const T*)x;
  const T* wp = (const T*)w;
  T* yp = (T*)y;
  switch (k) {
#define REPRO_C1D_CASE(KK)                                                   \
  case KK:                                                                   \
    causal_conv1d_kernel<T, KK, THREADS><<<grid, THREADS, 0, s>>>(           \
        xp, wp, yp, l, d, relu);                                             \
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
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* w, void* y, int b, int l, int d, int k,
           int relu, int threads, void* stream) {
  if (b == 0 || l == 0 || d == 0) return (int)cudaSuccess;
  if (k < 1 || k > MAX_K) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // the block size is a template argument: each is its own instantiation
  if (threads == 64) return launch_k<T, 64>(x, w, y, b, l, d, k, relu, s);
  if (threads == 128) return launch_k<T, 128>(x, w, y, b, l, d, k, relu, s);
  if (threads == 256) return launch_k<T, 256>(x, w, y, b, l, d, k, relu, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; threads: channels per block, 64, 128 or 256.
extern "C" int repro_causal_conv1d(const void* x, const void* w, void* y,
                                   int b, int l, int d, int k, int relu,
                                   int dtype, int threads, void* stream) {
  if (dtype == 0)
    return launch<float>(x, w, y, b, l, d, k, relu, threads, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, y, b, l, d, k, relu, threads, stream);
  return (int)cudaErrorInvalidValue;
}
