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
// MB) by the fixed cost of a launch as much as by HBM. Both modes have a
// vector path where a pixel's channels are a whole number of 16-byte
// vectors and x and y are 16-byte aligned: a thread owns one vector of one
// output pixel, does one 16-byte load a window tap and one 16-byte store,
// and its index arithmetic once per vector, so a warp moves 512 bytes a
// load instead of 32 (int8) or 128 (float32). The int8 mode
// (maxpool2d_s8_vec_kernel, every CNN pool: C a multiple of 16) takes a
// signed bytewise max of four words (__vmaxs4). The float mode
// (maxpool2d_f_vec_kernel, C a multiple of 4 in float32 or of 8 in
// bfloat16; the tuner's pool job) keeps each lane's select exactly as the
// scalar kernel does it; its 2x2 and 3x3 windows are template arguments,
// so a thread issues all its taps' loads before the first select and waits
// on one trip to memory. Other C or alignments take the scalar kernels,
// one thread per output element, channels fastest.
// repro_maxpool2d_s8_plan and repro_maxpool2d_f_plan export the choice and
// the grid.
//
// The float select: taps in row-major order from the first; a tap replaces
// the running max where it is larger or NaN, unless the running max is
// already NaN, so the first NaN tap wins and stays. The winner is kept as
// the tap's own bits (a bfloat16 is compared as its exact float32 value and
// never rounded back), which is what torch.maximum returns: the output is
// bitwise that of maxpool2d_plain, NaN payloads included. (fmaxf and
// __hmax2_nan return other NaN bits.)
#include <cstdint>
#include <cuda_runtime.h>

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

// A float tap's value: float32 as it is, bfloat16 widened exactly from its
// raw bits by a 16-bit shift.
static __device__ __forceinline__ float tap_value(float v) { return v; }
static __device__ __forceinline__ float tap_value(unsigned short v) {
  return __uint_as_float((unsigned)v << 16);
}

// The running max (bits m, value mv) after tap (bits v, value vv): the
// tap where it is larger or NaN, unless the max is already NaN.
template <typename R>
static __device__ __forceinline__ void take_max(R& m, float& mv, R v) {
  const float vv = tap_value(v);
  if ((vv > mv || vv != vv) && mv == mv) m = v, mv = vv;
}

// R: float32 lanes as float, bfloat16 lanes as their raw 16 bits.
template <typename R>
__global__ void __launch_bounds__(1024) maxpool2d_f_kernel(
    const R* __restrict__ x, R* __restrict__ y, int n, int h, int wd, int c,
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
  R m = x[((b * h + oy * stride) * wd + ox * stride) * c + ch];
  float mv = tap_value(m);
  for (int i = 0; i < win; ++i) {
    const int row = (b * h + oy * stride + i) * wd;
    for (int j = 0; j < win; ++j)
      take_max(m, mv, x[(row + ox * stride + j) * c + ch]);
  }
  y[idx] = m;
}

// One 16-byte vector a thread: CV = C * elsize / 16 vectors a pixel, LANES
// elements a vector, every lane the scalar kernel's select. WIN > 0 is the
// window as a template argument (2 and 3, every pool of the CNN plans and
// the tuner): all WIN x WIN loads are issued before the first select, so a
// thread waits on one trip to memory, not WIN x WIN. WIN = 0 takes the
// window from `win` and loads tap by tap.
template <typename R, int WIN>
__global__ void __launch_bounds__(1024) maxpool2d_f_vec_kernel(
    const uint4* __restrict__ x, uint4* __restrict__ y, int total, int h,
    int wd, int cv, int hout, int wout, int win, int stride) {
  constexpr int LANES = 16 / sizeof(R);
  union V { uint4 u; R e[LANES]; };
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int v = idx % cv;
  int t = idx / cv;
  const int ox = t % wout;
  t /= wout;
  const int oy = t % hout;
  const int b = t / hout;
  const int first = (b * h + oy * stride) * wd + ox * stride;
  V m;
  float mv[LANES];
  if constexpr (WIN > 0) {
    V tap[WIN * WIN];
#pragma unroll
    for (int i = 0; i < WIN; ++i)
#pragma unroll
      for (int j = 0; j < WIN; ++j)
        tap[i * WIN + j].u = __ldg(x + (first + i * wd + j) * cv + v);
    m = tap[0];
#pragma unroll
    for (int e = 0; e < LANES; ++e) mv[e] = tap_value(m.e[e]);
#pragma unroll
    for (int q = 1; q < WIN * WIN; ++q)
#pragma unroll
      for (int e = 0; e < LANES; ++e) take_max(m.e[e], mv[e], tap[q].e[e]);
  } else {
    m.u = __ldg(x + first * cv + v);
#pragma unroll
    for (int e = 0; e < LANES; ++e) mv[e] = tap_value(m.e[e]);
    for (int i = 0; i < win; ++i) {
      const int row = first + i * wd;
      for (int j = 0; j < win; ++j) {
        V tap;
        tap.u = __ldg(x + (row + j) * cv + v);
#pragma unroll
        for (int e = 0; e < LANES; ++e)
          take_max(m.e[e], mv[e], tap.e[e]);
      }
    }
  }
  y[idx] = m.u;
}

template <typename R>
void launch_f_vec(int blocks, int threads, cudaStream_t st, const void* x,
                  void* y, int total, int h, int wd, int cv, int hout,
                  int wout, int win, int stride) {
  const uint4* xp = (const uint4*)x;
  uint4* yp = (uint4*)y;
  if (win == 2)
    maxpool2d_f_vec_kernel<R, 2><<<blocks, threads, 0, st>>>(
        xp, yp, total, h, wd, cv, hout, wout, win, stride);
  else if (win == 3)
    maxpool2d_f_vec_kernel<R, 3><<<blocks, threads, 0, st>>>(
        xp, yp, total, h, wd, cv, hout, wout, win, stride);
  else
    maxpool2d_f_vec_kernel<R, 0><<<blocks, threads, 0, st>>>(
        xp, yp, total, h, wd, cv, hout, wout, win, stride);
}

// The float launch: plan[0..2] = blocks, threads, 1 for the 16-byte vector
// path (0: one thread per element). `aligned`: x and y both 16-byte
// aligned.
static int maxpool2d_f_plan(int* plan, int n, int hout, int wout, int c,
                            int esize, int aligned, int threads) {
  if (!valid_threads(threads) || (esize != 2 && esize != 4))
    return (int)cudaErrorInvalidValue;
  const int vec = (c * esize) % 16 == 0 && aligned;
  const int total = n * hout * wout * (vec ? c * esize / 16 : c);
  plan[0] = (total + threads - 1) / threads, plan[1] = threads,
  plan[2] = vec;
  return (int)cudaSuccess;
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
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const int esize = dtype == 0 ? 4 : 2;
  int plan[3];
  const int aligned = (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0;
  const int rc = maxpool2d_f_plan(plan, n, hout, wout, c, esize, aligned,
                                  threads);
  if (rc != (int)cudaSuccess) return rc;
  if (n * hout * wout * c == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  if (plan[2]) {
    const int cv = c * esize / 16;
    if (dtype == 0)
      launch_f_vec<float>(plan[0], threads, st, x, y, n * hout * wout * cv,
                          h, wd, cv, hout, wout, win, stride);
    else
      launch_f_vec<unsigned short>(plan[0], threads, st, x, y,
                                   n * hout * wout * cv, h, wd, cv, hout,
                                   wout, win, stride);
  } else if (dtype == 0) {
    maxpool2d_f_kernel<float><<<plan[0], threads, 0, st>>>(
        (const float*)x, (float*)y, n, h, wd, c, hout, wout, win, stride);
  } else {
    maxpool2d_f_kernel<unsigned short><<<plan[0], threads, 0, st>>>(
        (const unsigned short*)x, (unsigned short*)y, n, h, wd, c, hout,
        wout, win, stride);
  }
  return (int)cudaGetLastError();
}

// The float mode's launch arithmetic (see maxpool2d_f_plan); nothing is
// launched.
extern "C" int repro_maxpool2d_f_plan(int* plan, int n, int hout, int wout,
                                      int c, int esize, int aligned,
                                      int threads) {
  return maxpool2d_f_plan(plan, n, hout, wout, c, esize, aligned, threads);
}
