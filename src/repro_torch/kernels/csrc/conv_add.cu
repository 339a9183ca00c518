// int8, W4A8 and float32 / bfloat16 add (AdderNet) convolution for sm_90a.
//
// Replaces the TPU kernel repro/kernels/conv_add.py (add_conv2d /
// _add_conv2d, all modes):
// y = -sum_{i,j,c} |(x << xp) - (w << wp)| over the HK x HK window and all
// Cx input channels, SAME padding (HK/2, (HK-1)/2), then the optional int32
// bias at accumulator scale, relu, round-to-nearest shift and clip to int8
// (epilogue.cuh). x (N,H,W,Cx) int8 NHWC, w (HK,HK,Cx,Cy) int8 HWIO, y
// (N,H,W,Cy) int8. xp and wp are the Algorithm-1 (right) pre-shifts that
// put both operands on one scale.
//
// A padded zero is not neutral under L1: a tap outside the image still adds
// |0 - (w << wp)|, so out-of-bounds taps read x = 0 instead of being skipped.
// The pre-shifts, differences, absolute values, sum and negation are done in
// uint32_t and cast back, so they wrap exactly as JAX's int32 arithmetic does
// (signed overflow and a left shift of a negative value are undefined in
// C++); |INT32_MIN| stays INT32_MIN, as in JAX.
//
// W4 mode (repro_add_conv2d_w4): w is (HK,HK,ceil(Cx/2),Cy), two int4 codes
// per byte along Cx, with an int8 group shift per input channel (ws, length
// Cx). The group shift comes first (w4.cuh: it lands on the base scale,
// within int8), then << wp in uint32_t, as the TPU kernel orders them; the
// other order wraps differently at large pre-shifts. The loop runs over the
// Cx real channels only: the pad nibble of an odd Cx is a zero weight, and a
// zero weight is not neutral under L1.
//
// Float mode (repro_add_conv2d_f): x and w in float32 or bfloat16, no
// pre-shifts and no bias, on the float implicit GEMM shared with the float
// conv (fgemm.cuh), whose term here is acc = acc - |x - w| in float32 from
// +0, over taps (i, j) and then input channels c in order, every
// subtraction rounded on its own (__fsub_rn; fabsf is exact); relu; one
// rounding to x's dtype (float_io.cuh). An out-of-image tap reads a staged
// x = 0, as in the integer modes. A block stages its run of pixels' input
// window and its weights once and each thread sums PT pixels x Q channels
// in registers, so a weight is read from shared memory once for PT pixels
// and an input once for Q channels. It takes the tile (bp, q), the
// tuner's knobs; repro_add_conv2d_f_plan exports its launch arithmetic.
// The TPU kernel sums each tap's channels first and then subtracts, another
// order, so the float mode agrees with the JAX package within a tolerance.
//
// The integer entry points take the block size (`threads`, the tuner's
// knob); it changes only the launch shape.
//
// Index arithmetic is 32-bit (the wrapper keeps every tensor below 2^31
// elements).
//
// L1 distance is not a sum of products, so there is no tensor-core form (as
// there is no MXU form on the TPU): the work runs on the CUDA cores' int32
// lanes (float32 lanes in the float mode), and at the model's shapes it is
// bound by operations (one |x - w| accumulate per tap, channel and filter,
// two instructions in float32), not by the bytes it moves. The integer
// modes run one thread per output element (n, y, x, co), co fastest: the
// input byte is a broadcast across the warp and consecutive filters'
// weights one coalesced row. Moving them onto a register-tiled body, as
// the float mode is, is the next step.
#include <cstdint>
#include <cuda_runtime.h>

#include "epilogue.cuh"
#include "fgemm.cuh"
#include "float_io.cuh"
#include "w4.cuh"

template <bool W4>
__global__ void __launch_bounds__(1024) add_conv2d_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    const int8_t* __restrict__ ws, const int32_t* __restrict__ bias,
    int8_t* __restrict__ y, int n, int h, int wd, int cx, int cy, int hk,
    int xp, int wp, int shift, int relu) {
  const int total = n * h * wd * cy;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int co = idx % cy;
  int t = idx / cy;
  const int ox = t % wd;
  t /= wd;
  const int oy = t % h;
  const int b = t / h;
  const int wrows = W4 ? (cx + 1) / 2 : cx;  // weight rows per tap
  const int pad = hk / 2;
  uint32_t l1 = 0;
  for (int i = 0; i < hk; ++i) {
    const int iy = oy + i - pad;
    const bool row_in = iy >= 0 && iy < h;
    for (int j = 0; j < hk; ++j) {
      const int ix = ox + j - pad;
      const bool in = row_in && ix >= 0 && ix < wd;
      const int8_t* xq =
          x + ((b * h + (in ? iy : 0)) * wd + (in ? ix : 0)) * cx;
      const int8_t* wq = w + (i * hk + j) * wrows * cy + co;
      for (int c = 0; c < cx; ++c) {
        const int32_t wc = W4 ? w4_code(wq[(c >> 1) * cy], c & 1, ws[c])
                              : (int32_t)wq[c * cy];
        const uint32_t xv = in ? (uint32_t)(int32_t)xq[c] << xp : 0u;
        const uint32_t wv = (uint32_t)wc << wp;
        const uint32_t d = xv - wv;
        l1 += ((int32_t)d < 0) ? 0u - d : d;
      }
    }
  }
  int32_t acc = (int32_t)(0u - l1);
  if (bias != nullptr) acc = wrap_add(acc, bias[co]);
  y[idx] = requant_epilogue(acc, relu, shift);
}

extern "C" int repro_add_conv2d_q8(const void* x, const void* w,
                                   const void* bias, void* y, int n, int h,
                                   int wd, int cx, int cy, int hk, int xp,
                                   int wp, int shift, int relu, int threads,
                                   void* stream) {
  const int total = n * h * wd * cy;
  if (total == 0) return (int)cudaSuccess;
  if (!valid_threads(threads)) return (int)cudaErrorInvalidValue;
  const int blocks = (total + threads - 1) / threads;
  add_conv2d_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)w, nullptr, (const int32_t*)bias,
      (int8_t*)y, n, h, wd, cx, cy, hk, xp, wp, shift, relu);
  return (int)cudaGetLastError();
}

extern "C" int repro_add_conv2d_w4(const void* x, const void* w,
                                   const void* ws, const void* bias, void* y,
                                   int n, int h, int wd, int cx, int cy,
                                   int hk, int xp, int wp, int shift, int relu,
                                   int threads, void* stream) {
  const int total = n * h * wd * cy;
  if (total == 0) return (int)cudaSuccess;
  if (!valid_threads(threads)) return (int)cudaErrorInvalidValue;
  const int blocks = (total + threads - 1) / threads;
  add_conv2d_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)w, (const int8_t*)ws,
      (const int32_t*)bias, (int8_t*)y, n, h, wd, cx, cy, hk, xp, wp, shift,
      relu);
  return (int)cudaGetLastError();
}

// dtype: 0 float32, 1 bfloat16 (x, w and y alike); bp and q: the tile.
extern "C" int repro_add_conv2d_f(const void* x, const void* w, void* y,
                                  int n, int h, int wd, int cx, int cy, int hk,
                                  int relu, int dtype, int bp, int q,
                                  void* stream) {
  return fgemm_run<NegL1>(x, w, nullptr, y, n, h, wd, cx, cy, hk, 1, relu,
                          dtype, bp, q, TapOffsets{}, stream);
}

// The float mode's launch arithmetic: plan[0..4] = grid x, grid y,
// threads, shared bytes, window bytes. Returns non-zero if the tile is not
// one of the knobs' values or does not fit (plan still filled).
extern "C" int repro_add_conv2d_f_plan(int* plan, int n, int h, int wd,
                                       int cx, int cy, int hk, int bp,
                                       int q) {
  return fgemm_plan_out(plan, n, h, wd, cx, cy, hk, 1, bp, q);
}
