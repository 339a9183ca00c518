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
// and an input once for Q channels. The TPU kernel sums each tap's channels first and then subtracts, another
// order, so the float mode agrees with the JAX package within a tolerance.
//
// Every entry point takes the tile (bp, q), the tuner's knobs; they change
// only the launch shape. repro_add_conv2d_f_plan exports the launch
// arithmetic, which the integer modes share (their staged elements are 4
// bytes, as float32's are).
//
// Index arithmetic is 32-bit (the wrapper keeps every tensor below 2^31
// elements).
//
// L1 distance is not a sum of products, so there is no tensor-core form (as
// there is no MXU form on the TPU): the work runs on the CUDA cores' int32
// lanes (float32 lanes in the float mode), and at the model's shapes it is
// bound by operations (one |x - w| accumulate per tap, channel and filter:
// at least three int32 instructions, a subtract, an absolute value and an
// add, or two float32 ones), not by the bytes it moves. The integer modes
// run the implicit GEMM of fgemm.cuh as the float mode does (IntAddMode):
// a block stages its pixels' window once with x already shifted (x << xp
// in uint32, a padded tap the staged zero, which still adds |0 - (w <<
// wp)|) and its weights once already shifted (W4: unpacked and
// group-shifted first), each thread sums PT pixels x Q channels in uint32
// registers, |d| of the wrapped difference; the uint32 sum is associative,
// so every tile gives the plain version's bits. Only the Cx real channels
// are K elements: the pad nibble of an odd Cx is never a term.
#include <cstdint>
#include <cuda_runtime.h>

#include "fgemm.cuh"

extern "C" int repro_add_conv2d_q8(const void* x, const void* w,
                                   const void* bias, void* y, int n, int h,
                                   int wd, int cx, int cy, int hk, int xp,
                                   int wp, int shift, int relu, int bp, int q,
                                   void* stream) {
  return fgemm_run_add_int<false>(x, w, nullptr, bias, y, n, h, wd, cx, cy,
                                  hk, xp, wp, shift, relu, bp, q, stream);
}

extern "C" int repro_add_conv2d_w4(const void* x, const void* w,
                                   const void* ws, const void* bias, void* y,
                                   int n, int h, int wd, int cx, int cy,
                                   int hk, int xp, int wp, int shift, int relu,
                                   int bp, int q, void* stream) {
  return fgemm_run_add_int<true>(x, w, ws, bias, y, n, h, wd, cx, cy, hk, xp,
                                 wp, shift, relu, bp, q, stream);
}

// dtype: 0 float32, 1 bfloat16 (x, w and y alike); bp and q: the tile.
extern "C" int repro_add_conv2d_f(const void* x, const void* w, void* y,
                                  int n, int h, int wd, int cx, int cy, int hk,
                                  int relu, int dtype, int bp, int q,
                                  void* stream) {
  return fgemm_run<NegL1>(x, w, nullptr, y, n, h, wd, cx, cy, hk, 1, relu,
                          dtype, bp, q, TapOffsets{}, stream);
}

// Every mode's launch arithmetic: plan[0..4] = grid x, grid y, threads,
// shared bytes, window bytes. Returns non-zero if the tile is not
// one of the knobs' values or does not fit (plan still filled).
extern "C" int repro_add_conv2d_f_plan(int* plan, int n, int h, int wd,
                                       int cx, int cy, int hk, int bp,
                                       int q) {
  return fgemm_plan_out(plan, n, h, wd, cx, cy, hk, 1, bp, q);
}
