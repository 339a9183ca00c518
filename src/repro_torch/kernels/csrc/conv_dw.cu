// int8, W4A8 and float32 / bfloat16 SAME stride-1 depthwise convolution for
// sm_90a.
//
// Replaces the TPU kernel repro/kernels/conv_dw.py (depthwise2d /
// _depthwise2d, all modes): x (N,H,W,C) int8 NHWC, w (HK,HK,C) int8
// (the (HK,HK,C,1) layout is the same bytes), per-channel HK x HK
// multiply-add in int32, then relu, round-to-nearest shift and clip to int8
// (epilogue.cuh). Zero padding (HK/2, (HK-1)/2) comes from bounds checks.
//
// W4 mode (repro_depthwise2d_w4): w is (ceil(HK/2),HK,C), packed along the
// tap-row axis so that channels stay the contiguous axis: tap row i is nibble
// i & 1 of byte row i >> 1, and its group shift ws[i] (length HK) is the same
// for every channel. Each nibble is unpacked and shifted in registers
// (w4.cuh); from there the int8 body runs unchanged.
//
// Float mode (repro_depthwise2d_f): x and w in float32 or bfloat16, a
// float32 accumulator from zero summed over taps (i, j) in order with
// __fmul_rn / __fadd_rn, relu, one rounding to x's dtype (float_io.cuh). A tap
// outside the image is skipped, which for finite weights equals the plain
// version's zero-padded product.
//
// Every entry point takes the block size (`threads`, the tuner's knob); it
// changes only the launch shape.
//
// Index arithmetic is 32-bit (the wrapper keeps every tensor below 2^31
// elements): 64-bit division and modulo are emulated on the GPU.
//
// One thread per output element (n, y, x, c), c fastest, so a warp's loads
// of one tap are consecutive bytes of one pixel. Depthwise has no channel
// contraction (HK*HK MACs per output), so its floor is the bytes it moves;
// this kernel reloads each input byte HK*HK times as a one-byte load, and a
// shared-memory tile with vector loads is the next step.
#include <cstdint>
#include <cuda_runtime.h>

#include "epilogue.cuh"
#include "float_io.cuh"
#include "w4.cuh"

template <bool W4>
__global__ void __launch_bounds__(1024) depthwise2d_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    const int8_t* __restrict__ ws, int8_t* __restrict__ y, int n, int h,
    int wd, int c, int hk, int shift, int relu) {
  const int total = n * h * wd * c;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int ch = idx % c;
  int t = idx / c;
  const int ox = t % wd;
  t /= wd;
  const int oy = t % h;
  const int b = t / h;
  const int pad = hk / 2;
  int32_t acc = 0;
  for (int i = 0; i < hk; ++i) {
    const int iy = oy + i - pad;
    if (iy < 0 || iy >= h) continue;
    const int8_t* wrow = w + (W4 ? (i >> 1) : i) * hk * c + ch;
    for (int j = 0; j < hk; ++j) {
      const int ix = ox + j - pad;
      if (ix < 0 || ix >= wd) continue;
      const int32_t wv = W4 ? w4_code(wrow[j * c], i & 1, ws[i])
                            : (int32_t)wrow[j * c];
      acc += (int32_t)x[((b * h + iy) * wd + ix) * c + ch] * wv;
    }
  }
  y[idx] = requant_epilogue(acc, relu, shift);
}

template <typename T>
__global__ void __launch_bounds__(1024) depthwise2d_f_kernel(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
    int n, int h, int wd, int c, int hk, int relu) {
  const int total = n * h * wd * c;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int ch = idx % c;
  int t = idx / c;
  const int ox = t % wd;
  t /= wd;
  const int oy = t % h;
  const int b = t / h;
  const int pad = hk / 2;
  float acc = 0.0f;
  for (int i = 0; i < hk; ++i) {
    const int iy = oy + i - pad;
    if (iy < 0 || iy >= h) continue;
    for (int j = 0; j < hk; ++j) {
      const int ix = ox + j - pad;
      if (ix < 0 || ix >= wd) continue;
      acc = __fadd_rn(acc, __fmul_rn(
          load_f32(x + ((b * h + iy) * wd + ix) * c + ch),
          load_f32(w + (i * hk + j) * c + ch)));
    }
  }
  if (relu && acc < 0.0f) acc = 0.0f;
  store_f32(y + idx, acc);
}

extern "C" int repro_depthwise2d_q8(const void* x, const void* w, void* y,
                                    int n, int h, int wd, int c, int hk,
                                    int shift, int relu, int threads,
                                    void* stream) {
  const int total = n * h * wd * c;
  if (total == 0) return (int)cudaSuccess;
  if (!valid_threads(threads)) return (int)cudaErrorInvalidValue;
  const int blocks = (total + threads - 1) / threads;
  depthwise2d_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)w, nullptr, (int8_t*)y, n, h, wd, c,
      hk, shift, relu);
  return (int)cudaGetLastError();
}

extern "C" int repro_depthwise2d_w4(const void* x, const void* w,
                                    const void* ws, void* y, int n, int h,
                                    int wd, int c, int hk, int shift, int relu,
                                    int threads, void* stream) {
  const int total = n * h * wd * c;
  if (total == 0) return (int)cudaSuccess;
  if (!valid_threads(threads)) return (int)cudaErrorInvalidValue;
  const int blocks = (total + threads - 1) / threads;
  depthwise2d_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)w, (const int8_t*)ws, (int8_t*)y, n, h,
      wd, c, hk, shift, relu);
  return (int)cudaGetLastError();
}

// dtype: 0 float32, 1 bfloat16 (x, w and y alike).
extern "C" int repro_depthwise2d_f(const void* x, const void* w, void* y,
                                   int n, int h, int wd, int c, int hk,
                                   int relu, int dtype, int threads,
                                   void* stream) {
  const int total = n * h * wd * c;
  if (total == 0) return (int)cudaSuccess;
  if (!valid_threads(threads)) return (int)cudaErrorInvalidValue;
  const int blocks = (total + threads - 1) / threads;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    depthwise2d_f_kernel<float><<<blocks, threads, 0, st>>>(
        (const float*)x, (const float*)w, (float*)y, n, h, wd, c, hk, relu);
  } else if (dtype == 1) {
    depthwise2d_f_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (__nv_bfloat16*)y,
        n, h, wd, c, hk, relu);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
