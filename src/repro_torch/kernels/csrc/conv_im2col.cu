// int8, W4A8 and float32 / bfloat16 SAME stride-1 standard / grouped
// convolution for sm_90a.
//
// Replaces the TPU kernel repro/kernels/conv_im2col.py (conv2d_im2col /
// _conv2d_im2col, all modes): x (N,H,W,Cx) int8 NHWC, w
// (HK,HK,Cx/g,Cy) int8 HWIO, optional int32 bias at accumulator scale, then
// relu, round-to-nearest shift and clip to int8 (epilogue.cuh). Zero padding
// is (HK/2, (HK-1)/2) rows/cols before/after, as the TPU kernel pads; it
// comes from bounds checks, with no padded copy.
//
// Integer modes (repro_conv2d_q8, repro_conv2d_w4): an implicit GEMM per
// group, M = output pixels, N = Cy/g, K = HK*HK*Cx/g, on the body shared
// with the integer shift conv (igemm.cuh), whose K-offset builder here is a
// tap's: K element (i, j, c) lies at window offset (i * wwb + j) * ps + c.
// What bounds it on an H100 is bytes: at the model's shapes (B=256) a
// launch moves 1.5-5 MB and does at most 0.23 G int8 operations, so its
// floor is one or two microseconds of HBM time. A block stages its pixels'
// input window and the group's filter slice once (as words of four
// K-consecutive int8 codes; the stem's K = 27 is 7 words), builds each
// pixel's im2col words once (one aligned word load from the window where
// Cx/g is a multiple of 4, else four bytes), and each thread sums PT = 32/Q
// pixels x Q channels with __dp4a. __dp4a and not mma.sync.m16n8k32.s8: the
// layers are so narrow (N = Cy/g of 16-64, K of 16-27 at the stem and the
// pointwise layers) that an mma tile would be mostly padding, the window
// staging and the epilogue take as much time as the sums, and dp4a keeps
// one body for every K and N. The block's pixels (BP) and a thread's
// channels (Q) are the tuner's knobs.
//
// W4 mode (repro_conv2d_w4): w is (HK,HK,ceil(Cx/g/2),Cy), two int4 codes per
// byte along Cx/g, with an int8 group shift per input channel (ws, length
// Cx/g). Each nibble is unpacked and shifted (w4.cuh) once per block, while
// the filter chunk is staged; from there the W4 body is the int8 body. Only
// the Cx/g real channels are staged, so the pad nibble of an odd Cx/g is
// never read.
//
// Float mode (repro_conv2d_f): x, w and the optional bias in float32 or
// bfloat16 (one dtype for all three), on the float implicit GEMM shared
// with the float add conv (fgemm.cuh), whose term here is a multiply and an
// add: a float32 accumulator from +0 summed tap row i, tap column j, then
// input channel c of the group, each product and sum rounded on its own
// (__fmul_rn / __fadd_rn, float_io.cuh), then the bias in float32, relu,
// and one rounding to x's dtype: the Pallas body's order of epilogue steps
// (sum, + bias, relu, cast). A block stages its run of pixels' input
// window once (zeros outside the image: the plain version's zero-padded
// product, the same float32 value as a skipped tap for finite weights,
// since the accumulator starts at +0 and never becomes -0) and its
// weights, and each thread sums PT pixels x Q channels in registers. What
// bounds it on an H100:
// operations, at the CUDA cores' float32 rate, since a multiply and an add
// that may not contract into an FMA are two instructions (Table-2's ci=128
// job is 7.4 M of them), and at Table-2's n = 1 jobs the few outputs (a
// chain of up to 1,152 dependent adds each) leave latency in the way, so
// those tiles' blocks are small and their weights resident: the sums run
// with no barrier and no load from device memory.
//
// Every mode takes the tile (bp: pixels a block, a multiple of 32 up to
// 256; q: channels a thread, 4, 8 or 16), the tuner's knobs; they change
// only the launch shape, never the value of an output. The plan entry
// points (repro_conv2d_i8_plan, repro_conv2d_f_plan) export the launch
// arithmetic.
//
// Index arithmetic is 32-bit (the wrapper keeps every tensor below 2^31
// elements): 64-bit division and modulo are emulated on the GPU.
#include <cstdint>
#include <cuda_runtime.h>

#include "fgemm.cuh"
#include "float_io.cuh"
#include "igemm.cuh"

namespace {

template <bool W4>
int launch_int(const void* x, const void* w, const void* ws,
               const void* bias, void* y, int n, int h, int wd, int cx,
               int cy, int hk, int groups, int shift, int relu, int bp,
               int q, void* stream) {
  if (!valid_tile(bp, q)) return (int)cudaErrorInvalidValue;
  if (n * h * wd * cy == 0) return (int)cudaSuccess;
  IgemmGeo g;
  int gx, gy, threads;
  if (!igemm_plan(g, &gx, &gy, &threads, n, h, wd, cx, cy, hk, groups,
                  hk * hk * (cx / groups), bp, q))
    return (int)cudaErrorInvalidValue;
  return igemm_launch<W4>(g, gx, gy, threads, true, x, w, ws, bias, y, shift,
                          relu, q, TapOffsets{}, stream);
}

}  // namespace

// bp (pixels a block) and q (channels a thread) are the tuner's knobs; they
// change only the launch shape.
extern "C" int repro_conv2d_q8(const void* x, const void* w, const void* bias,
                               void* y, int n, int h, int wd, int cx, int cy,
                               int hk, int groups, int shift, int relu, int bp,
                               int q, void* stream) {
  return launch_int<false>(x, w, nullptr, bias, y, n, h, wd, cx, cy, hk,
                           groups, shift, relu, bp, q, stream);
}

extern "C" int repro_conv2d_w4(const void* x, const void* w, const void* ws,
                               const void* bias, void* y, int n, int h, int wd,
                               int cx, int cy, int hk, int groups, int shift,
                               int relu, int bp, int q, void* stream) {
  return launch_int<true>(x, w, ws, bias, y, n, h, wd, cx, cy, hk, groups,
                          shift, relu, bp, q, stream);
}

// The integer modes' launch arithmetic: plan[0..5] = grid x, grid y,
// threads, shared bytes, K words, window bytes. Returns non-zero if the
// tile is not one of the knobs' values or does not fit (plan still filled).
extern "C" int repro_conv2d_i8_plan(int* plan, int n, int h, int wd, int cx,
                                    int cy, int hk, int groups, int bp,
                                    int q) {
  if (!valid_tile(bp, q)) return (int)cudaErrorInvalidValue;
  IgemmGeo g;
  const bool fits = igemm_plan(g, plan, plan + 1, plan + 2, n, h, wd, cx, cy,
                               hk, groups, hk * hk * (cx / groups), bp, q);
  plan[3] = g.smem, plan[4] = g.kw, plan[5] = g.win_bytes;
  return fits ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
}

// dtype: 0 float32, 1 bfloat16 (x, w, bias and y alike); bp and q: the
// tile.
extern "C" int repro_conv2d_f(const void* x, const void* w, const void* bias,
                              void* y, int n, int h, int wd, int cx, int cy,
                              int hk, int groups, int relu, int dtype, int bp,
                              int q, void* stream) {
  return fgemm_run<MulAdd>(x, w, bias, y, n, h, wd, cx, cy, hk, groups, relu,
                           dtype, bp, q, TapOffsets{}, stream);
}

// The float mode's launch arithmetic: plan[0..4] = grid x, grid y,
// threads, shared bytes, window bytes. Returns non-zero if the tile is not
// one of the knobs' values or does not fit (plan still filled).
extern "C" int repro_conv2d_f_plan(int* plan, int n, int h, int wd, int cx,
                                   int cy, int hk, int groups, int bp,
                                   int q) {
  return fgemm_plan_out(plan, n, h, wd, cx, cy, hk, groups, bp, q);
}
