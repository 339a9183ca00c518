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
// A pure data-movement kernel: bound by the bytes it moves (the input read
// once, a quarter of it written for 2x2/2), and at the model's shapes (a few
// MB) by the fixed cost of a launch as much as by HBM. The int8 mode's
// vector path (maxpool2d_s8_vec_kernel, where C is a multiple of 16 and x
// and y are 16-byte aligned, every CNN pool) gives a thread 16 channels of
// one output pixel: one 16-byte load a window tap, a signed bytewise max of
// four words (__vmaxs4), one 16-byte store, and the index arithmetic once
// per 16 channels, so a warp moves 512 bytes a load instead of 32. Other C
// or alignments take the scalar kernel, one thread per output byte, c
// fastest. repro_maxpool2d_s8_plan exports the choice and the grid. The
// float mode is one thread per output element.
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

// 16 channels a thread: x and y as uint4, C16 = C / 16 vectors a pixel.
__global__ void __launch_bounds__(1024) maxpool2d_s8_vec_kernel(
    const uint4* __restrict__ x, uint4* __restrict__ y, int total, int h,
    int wd, int c16, int hout, int wout, int win, int stride) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int cv = idx % c16;
  int t = idx / c16;
  const int ox = t % wout;
  t /= wout;
  const int oy = t % hout;
  const int b = t / hout;
  uint4 m = make_uint4(0x80808080u, 0x80808080u, 0x80808080u, 0x80808080u);
  for (int i = 0; i < win; ++i) {
    const int row = (b * h + oy * stride + i) * wd + ox * stride;
    for (int j = 0; j < win; ++j) {
      const uint4 v = __ldg(x + (row + j) * c16 + cv);
      m.x = __vmaxs4(m.x, v.x);
      m.y = __vmaxs4(m.y, v.y);
      m.z = __vmaxs4(m.z, v.z);
      m.w = __vmaxs4(m.w, v.w);
    }
  }
  y[idx] = m;
}

// The int8 launch: plan[0..2] = blocks, threads, 1 for the 16-channel
// vector path (0: one thread per byte). `aligned`: x and y both 16-byte
// aligned.
static int maxpool2d_s8_plan(int* plan, int n, int hout, int wout, int c,
                             int aligned, int threads) {
  if (!valid_threads(threads)) return (int)cudaErrorInvalidValue;
  const int vec = c % 16 == 0 && aligned;
  const int total = n * hout * wout * (vec ? c / 16 : c);
  plan[0] = (total + threads - 1) / threads, plan[1] = threads,
  plan[2] = vec;
  return (int)cudaSuccess;
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
  int plan[3];
  const int aligned = (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0;
  const int rc = maxpool2d_s8_plan(plan, n, hout, wout, c, aligned, threads);
  if (rc != (int)cudaSuccess) return rc;
  if (n * hout * wout * c == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  if (plan[2]) {
    maxpool2d_s8_vec_kernel<<<plan[0], threads, 0, st>>>(
        (const uint4*)x, (uint4*)y, n * hout * wout * (c / 16), h, wd,
        c / 16, hout, wout, win, stride);
  } else {
    maxpool2d_s8_kernel<<<plan[0], threads, 0, st>>>(
        (const int8_t*)x, (int8_t*)y, n, h, wd, c, hout, wout, win, stride);
  }
  return (int)cudaGetLastError();
}

// The int8 mode's launch arithmetic (see maxpool2d_s8_plan); nothing is
// launched.
extern "C" int repro_maxpool2d_s8_plan(int* plan, int n, int hout, int wout,
                                       int c, int aligned, int threads) {
  return maxpool2d_s8_plan(plan, n, hout, wout, c, aligned, threads);
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
