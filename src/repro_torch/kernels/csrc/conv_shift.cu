// int8, W4A8 and float32 / bfloat16 shift convolution for sm_90a: a
// per-channel spatial shift fused into the pointwise contraction.
//
// Replaces the TPU kernel repro/kernels/conv_shift.py (shift_conv2d, all
// modes): y[n,y,x,co] = sum_c x[n, y+a_c, x+b_c, c] * w_pw[c,co], a
// read outside the image being zero, accumulated in int32; then the optional
// int32 bias at accumulator scale, relu, round-to-nearest shift and clip to
// int8 (epilogue.cuh). x (N,H,W,C) int8 NHWC, shifts (C,2) int32 (a, b) on
// the device, w_pw (C,Cy) int8, y (N,H,W,Cy) int8.
//
// The TPU wrapper sorts channels into groups of one shift so that each group
// is one matrix-unit product; the int32 sum does not depend on the order of
// its terms, so here each channel is simply read at its own displacement.
// The bounds checks make the result exact for any displacement: the table's
// bound is checked once on the host when a plan is built, and never read back
// per call.
//
// W4 mode (repro_shift_conv2d_w4): w_pw is (ceil(C/2),Cy), two int4 codes
// per byte along C, with an int8 group shift per channel (ws, length C),
// unpacked and shifted in registers (w4.cuh). The TPU wrapper re-packs the
// nibbles along its channel sort; with no sort there is nothing to re-pack.
//
// Float mode (repro_shift_conv2d_f): x and w_pw in float32 or bfloat16, a
// float32 accumulator from zero summed over the input channels c in index
// order, each read at its own shift, with __fmul_rn / __fadd_rn; relu; one
// rounding to x's dtype (float_io.cuh). A read outside the image is skipped,
// which for finite weights equals the plain version's zero-filled product.
// The TPU kernel sums per shift group on its matrix unit, another order, so
// the float mode agrees with the JAX package within a tolerance only (its own
// batched and looped float results differ too).
//
// Every entry point takes the block size (`threads`, the tuner's knob); it
// changes only the launch shape.
//
// Index arithmetic is 32-bit (the wrapper keeps every tensor below 2^31
// elements): 64-bit division and modulo are emulated on the GPU.
//
// One thread per output element (n, y, x, co), co fastest: a warp reads one
// channel's shift pair and one input byte as broadcasts and consecutive
// filters' weights as one coalesced row. At the model's shapes a launch moves
// a few MB for well under a GFLOP, so HBM bounds it at about a microsecond;
// like conv2d_q8 this first kernel is held back by one-byte loads with no
// register reuse. Blocking over output channels and tensor cores come later.
#include <cstdint>
#include <cuda_runtime.h>

#include "epilogue.cuh"
#include "float_io.cuh"
#include "w4.cuh"

template <bool W4>
__global__ void __launch_bounds__(1024) shift_conv2d_kernel(
    const int8_t* __restrict__ x, const int32_t* __restrict__ shifts,
    const int8_t* __restrict__ w, const int8_t* __restrict__ ws,
    const int32_t* __restrict__ bias, int8_t* __restrict__ y, int n, int h,
    int wd, int c, int cy, int shift, int relu) {
  const int total = n * h * wd * cy;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int co = idx % cy;
  int t = idx / cy;
  const int ox = t % wd;
  t /= wd;
  const int oy = t % h;
  const int b = t / h;
  const int8_t* xb = x + b * h * wd * c;
  int32_t acc = 0;
  for (int ch = 0; ch < c; ++ch) {
    const int iy = oy + shifts[2 * ch];
    const int ix = ox + shifts[2 * ch + 1];
    if (iy < 0 || iy >= h || ix < 0 || ix >= wd) continue;
    const int32_t wv = W4 ? w4_code(w[(ch >> 1) * cy + co], ch & 1, ws[ch])
                          : (int32_t)w[ch * cy + co];
    acc += (int32_t)xb[(iy * wd + ix) * c + ch] * wv;
  }
  if (bias != nullptr) acc = wrap_add(acc, bias[co]);
  y[idx] = requant_epilogue(acc, relu, shift);
}

template <typename T>
__global__ void __launch_bounds__(1024) shift_conv2d_f_kernel(
    const T* __restrict__ x, const int32_t* __restrict__ shifts,
    const T* __restrict__ w, T* __restrict__ y, int n, int h, int wd, int c,
    int cy, int relu) {
  const int total = n * h * wd * cy;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int co = idx % cy;
  int t = idx / cy;
  const int ox = t % wd;
  t /= wd;
  const int oy = t % h;
  const int b = t / h;
  const T* xb = x + b * h * wd * c;
  float acc = 0.0f;
  for (int ch = 0; ch < c; ++ch) {
    const int iy = oy + shifts[2 * ch];
    const int ix = ox + shifts[2 * ch + 1];
    if (iy < 0 || iy >= h || ix < 0 || ix >= wd) continue;
    acc = __fadd_rn(acc, __fmul_rn(load_f32(xb + (iy * wd + ix) * c + ch),
                                   load_f32(w + ch * cy + co)));
  }
  if (relu && acc < 0.0f) acc = 0.0f;
  store_f32(y + idx, acc);
}

extern "C" int repro_shift_conv2d_q8(const void* x, const void* shifts,
                                     const void* w, const void* bias, void* y,
                                     int n, int h, int wd, int c, int cy,
                                     int shift, int relu, int threads,
                                     void* stream) {
  const int total = n * h * wd * cy;
  if (total == 0) return (int)cudaSuccess;
  if (!valid_threads(threads)) return (int)cudaErrorInvalidValue;
  const int blocks = (total + threads - 1) / threads;
  shift_conv2d_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int32_t*)shifts, (const int8_t*)w, nullptr,
      (const int32_t*)bias, (int8_t*)y, n, h, wd, c, cy, shift, relu);
  return (int)cudaGetLastError();
}

extern "C" int repro_shift_conv2d_w4(const void* x, const void* shifts,
                                     const void* w, const void* ws,
                                     const void* bias, void* y, int n, int h,
                                     int wd, int c, int cy, int shift,
                                     int relu, int threads, void* stream) {
  const int total = n * h * wd * cy;
  if (total == 0) return (int)cudaSuccess;
  if (!valid_threads(threads)) return (int)cudaErrorInvalidValue;
  const int blocks = (total + threads - 1) / threads;
  shift_conv2d_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int32_t*)shifts, (const int8_t*)w,
      (const int8_t*)ws, (const int32_t*)bias, (int8_t*)y, n, h, wd, c, cy,
      shift, relu);
  return (int)cudaGetLastError();
}

// dtype: 0 float32, 1 bfloat16 (x, w and y alike; shifts int32).
extern "C" int repro_shift_conv2d_f(const void* x, const void* shifts,
                                    const void* w, void* y, int n, int h,
                                    int wd, int c, int cy, int relu, int dtype,
                                    int threads, void* stream) {
  const int total = n * h * wd * cy;
  if (total == 0) return (int)cudaSuccess;
  if (!valid_threads(threads)) return (int)cudaErrorInvalidValue;
  const int blocks = (total + threads - 1) / threads;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    shift_conv2d_f_kernel<float><<<blocks, threads, 0, st>>>(
        (const float*)x, (const int32_t*)shifts, (const float*)w, (float*)y,
        n, h, wd, c, cy, relu);
  } else if (dtype == 1) {
    shift_conv2d_f_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        (const __nv_bfloat16*)x, (const int32_t*)shifts,
        (const __nv_bfloat16*)w, (__nv_bfloat16*)y, n, h, wd, c, cy, relu);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
