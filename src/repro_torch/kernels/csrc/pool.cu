// int8 and float32 / bfloat16 VALID max-pool for sm_90a.
//
// Replaces the TPU kernel repro/kernels/pool.py (maxpool2d / _maxpool2d,
// int8 and float modes): x (N,H,W,C) NHWC, any window and stride, output
// ((H-win)/stride+1, (W-win)/stride+1). Max commutes with the positive
// power-of-two scale, so pooling the int8 codes is exact. The float mode is
// exact too (a max rounds nothing): it takes the window's taps in row-major
// order and a NaN tap makes the output NaN, as jnp.max and torch.maximum do.
//
// Both entry points take the block size (`threads`, the tuner's knob); it
// changes only the launch shape.
//
// Index arithmetic is 32-bit (the wrapper keeps every tensor below 2^31
// elements): 64-bit division and modulo are emulated on the GPU.
//
// One thread per output element (n, y, x, c), c fastest, so a warp's loads
// of one window tap are consecutive bytes. A pure data-movement kernel:
// bound by the bytes it moves, and at the model's shapes (a few MB) by the
// fixed cost of a launch as much as by HBM.
#include <cstdint>
#include <cuda_runtime.h>

#include "float_io.cuh"

// The launch-shape check: a block of `threads` threads, a whole number of
// warps, at most 1024 (the kernels are compiled with
// __launch_bounds__(1024), so every such block fits an SM).
static inline bool valid_threads(int threads) {
  return threads >= 32 && threads <= 1024 && threads % 32 == 0;
}

__global__ void __launch_bounds__(1024) maxpool2d_s8_kernel(const int8_t* __restrict__ x,
                                    int8_t* __restrict__ y, int n, int h,
                                    int wd, int c, int hout, int wout, int win,
                                    int stride) {
  const int total = n * hout * wout * c;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int ch = idx % c;
  int t = idx / c;
  const int ox = t % wout;
  t /= wout;
  const int oy = t % hout;
  const int b = t / hout;
  int m = -128;
  for (int i = 0; i < win; ++i) {
    const int row = (b * h + oy * stride + i) * wd;
    for (int j = 0; j < win; ++j) {
      const int v = x[(row + ox * stride + j) * c + ch];
      m = v > m ? v : m;
    }
  }
  y[idx] = (int8_t)m;
}

template <typename T>
__global__ void __launch_bounds__(1024) maxpool2d_f_kernel(
    const T* __restrict__ x, T* __restrict__ y, int n, int h, int wd, int c,
    int hout, int wout, int win, int stride) {
  const int total = n * hout * wout * c;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int ch = idx % c;
  int t = idx / c;
  const int ox = t % wout;
  t /= wout;
  const int oy = t % hout;
  const int b = t / hout;
  float m = load_f32(x + ((b * h + oy * stride) * wd + ox * stride) * c + ch);
  for (int i = 0; i < win; ++i) {
    const int row = (b * h + oy * stride + i) * wd;
    for (int j = 0; j < win; ++j) {
      const float v = load_f32(x + (row + ox * stride + j) * c + ch);
      // a NaN tap wins and stays: v > NaN and NaN > m are both false
      m = (v > m || v != v) && m == m ? v : m;
    }
  }
  store_f32(y + idx, m);
}

extern "C" int repro_maxpool2d_s8(const void* x, void* y, int n, int h, int wd,
                                  int c, int hout, int wout, int win,
                                  int stride, int threads, void* stream) {
  const int total = n * hout * wout * c;
  if (total == 0) return (int)cudaSuccess;
  if (!valid_threads(threads)) return (int)cudaErrorInvalidValue;
  const int blocks = (total + threads - 1) / threads;
  maxpool2d_s8_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (int8_t*)y, n, h, wd, c, hout, wout, win, stride);
  return (int)cudaGetLastError();
}

// dtype: 0 float32, 1 bfloat16 (x and y alike).
extern "C" int repro_maxpool2d_f(const void* x, void* y, int n, int h, int wd,
                                 int c, int hout, int wout, int win,
                                 int stride, int dtype, int threads,
                                 void* stream) {
  const int total = n * hout * wout * c;
  if (total == 0) return (int)cudaSuccess;
  if (!valid_threads(threads)) return (int)cudaErrorInvalidValue;
  const int blocks = (total + threads - 1) / threads;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    maxpool2d_f_kernel<float><<<blocks, threads, 0, st>>>(
        (const float*)x, (float*)y, n, h, wd, c, hout, wout, win, stride);
  } else if (dtype == 1) {
    maxpool2d_f_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        (const __nv_bfloat16*)x, (__nv_bfloat16*)y, n, h, wd, c, hout, wout,
        win, stride);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
