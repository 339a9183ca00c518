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
// W4 mode (repro_conv2d_w4): w is (HK,HK,ceil(Cx/g/2),Cy), two int4 codes per
// byte along Cx/g, with an int8 group shift per input channel (ws, length
// Cx/g). Each nibble is unpacked and shifted in registers (w4.cuh), so only
// the packed bytes are read; from there the int8 body runs unchanged. The
// loop runs over the Cx/g real channels, so the pad nibble of an odd Cx/g is
// never read.
//
// Float mode (repro_conv2d_f): x, w and the optional bias in float32 or
// bfloat16 (one dtype for all three), a float32 accumulator from zero summed
// tap row i, tap column j, then input channel c, each product and sum
// rounded on its own (__fmul_rn / __fadd_rn, float_io.cuh), then the bias in
// float32, relu, and one rounding to x's dtype: the Pallas body's order of
// epilogue steps (sum, + bias, relu, cast). A tap outside the image is
// skipped; the plain version adds the zero-padded product instead, which is
// the same float32 value for finite weights (the accumulator starts at +0
// and never becomes -0, so adding +-0 leaves it unchanged).
//
// Every entry point takes the block size (`threads`, a whole number of warps
// up to 1024, the tuner's knob): it changes only the launch shape, never the
// value of an output.
//
// Index arithmetic is 32-bit (the wrapper keeps every tensor below 2^31
// elements): 64-bit division and modulo are emulated on the GPU.
//
// One thread per output element (n, y, x, co), co fastest: a warp reads one
// pixel's Cx/g input bytes as a broadcast and consecutive filters' weights as
// one coalesced row. The work is far below the card's int8 rate, but every
// multiply-add costs two one-byte loads and nothing is reused in registers,
// so load-instruction throughput bounds this kernel, not HBM. Register
// blocking over output channels, tensor cores (int8 mma / wgmma) and a
// shared-memory tile of the input are the next steps, not this one.
#include <cstdint>
#include <cuda_runtime.h>

#include "epilogue.cuh"
#include "float_io.cuh"
#include "w4.cuh"

template <bool W4>
__global__ void __launch_bounds__(1024) conv2d_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    const int8_t* __restrict__ ws, const int32_t* __restrict__ bias,
    int8_t* __restrict__ y, int n, int h, int wd, int cx, int cy, int hk,
    int groups, int shift, int relu) {
  const int total = n * h * wd * cy;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int co = idx % cy;
  int t = idx / cy;
  const int ox = t % wd;
  t /= wd;
  const int oy = t % h;
  const int b = t / h;
  const int cxg = cx / groups;
  const int wrows = W4 ? (cxg + 1) / 2 : cxg;  // weight rows per tap
  const int g = co / (cy / groups);
  const int pad = hk / 2;
  int32_t acc = 0;
  for (int i = 0; i < hk; ++i) {
    const int iy = oy + i - pad;
    if (iy < 0 || iy >= h) continue;
    for (int j = 0; j < hk; ++j) {
      const int ix = ox + j - pad;
      if (ix < 0 || ix >= wd) continue;
      const int8_t* xp = x + ((b * h + iy) * wd + ix) * cx + g * cxg;
      const int8_t* wp = w + (i * hk + j) * wrows * cy + co;
      for (int c = 0; c < cxg; ++c) {
        const int32_t wv = W4 ? w4_code(wp[(c >> 1) * cy], c & 1, ws[c])
                              : (int32_t)wp[c * cy];
        acc += (int32_t)xp[c] * wv;
      }
    }
  }
  if (bias != nullptr) acc = wrap_add(acc, bias[co]);
  y[idx] = requant_epilogue(acc, relu, shift);
}

template <typename T>
__global__ void __launch_bounds__(1024) conv2d_f_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const T* __restrict__ bias, T* __restrict__ y, int n, int h, int wd,
    int cx, int cy, int hk, int groups, int relu) {
  const int total = n * h * wd * cy;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int co = idx % cy;
  int t = idx / cy;
  const int ox = t % wd;
  t /= wd;
  const int oy = t % h;
  const int b = t / h;
  const int cxg = cx / groups;
  const int g = co / (cy / groups);
  const int pad = hk / 2;
  float acc = 0.0f;
  for (int i = 0; i < hk; ++i) {
    const int iy = oy + i - pad;
    if (iy < 0 || iy >= h) continue;
    for (int j = 0; j < hk; ++j) {
      const int ix = ox + j - pad;
      if (ix < 0 || ix >= wd) continue;
      const T* xp = x + ((b * h + iy) * wd + ix) * cx + g * cxg;
      const T* wp = w + (i * hk + j) * cxg * cy + co;
      for (int c = 0; c < cxg; ++c)
        acc = __fadd_rn(acc, __fmul_rn(load_f32(xp + c), load_f32(wp + c * cy)));
    }
  }
  if (bias != nullptr) acc = __fadd_rn(acc, load_f32(bias + co));
  if (relu && acc < 0.0f) acc = 0.0f;
  store_f32(y + idx, acc);
}

extern "C" int repro_conv2d_q8(const void* x, const void* w, const void* bias,
                               void* y, int n, int h, int wd, int cx, int cy,
                               int hk, int groups, int shift, int relu,
                               int threads, void* stream) {
  const int total = n * h * wd * cy;
  if (total == 0) return (int)cudaSuccess;
  if (!valid_threads(threads)) return (int)cudaErrorInvalidValue;
  const int blocks = (total + threads - 1) / threads;
  conv2d_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)w, nullptr, (const int32_t*)bias,
      (int8_t*)y, n, h, wd, cx, cy, hk, groups, shift, relu);
  return (int)cudaGetLastError();
}

extern "C" int repro_conv2d_w4(const void* x, const void* w, const void* ws,
                               const void* bias, void* y, int n, int h, int wd,
                               int cx, int cy, int hk, int groups, int shift,
                               int relu, int threads, void* stream) {
  const int total = n * h * wd * cy;
  if (total == 0) return (int)cudaSuccess;
  if (!valid_threads(threads)) return (int)cudaErrorInvalidValue;
  const int blocks = (total + threads - 1) / threads;
  conv2d_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)w, (const int8_t*)ws,
      (const int32_t*)bias, (int8_t*)y, n, h, wd, cx, cy, hk, groups, shift,
      relu);
  return (int)cudaGetLastError();
}

// dtype: 0 float32, 1 bfloat16 (x, w, bias and y alike).
extern "C" int repro_conv2d_f(const void* x, const void* w, const void* bias,
                              void* y, int n, int h, int wd, int cx, int cy,
                              int hk, int groups, int relu, int dtype,
                              int threads, void* stream) {
  const int total = n * h * wd * cy;
  if (total == 0) return (int)cudaSuccess;
  if (!valid_threads(threads)) return (int)cudaErrorInvalidValue;
  const int blocks = (total + threads - 1) / threads;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    conv2d_f_kernel<float><<<blocks, threads, 0, st>>>(
        (const float*)x, (const float*)w, (const float*)bias, (float*)y, n, h,
        wd, cx, cy, hk, groups, relu);
  } else if (dtype == 1) {
    conv2d_f_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)w,
        (const __nv_bfloat16*)bias, (__nv_bfloat16*)y, n, h, wd, cx, cy, hk,
        groups, relu);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
