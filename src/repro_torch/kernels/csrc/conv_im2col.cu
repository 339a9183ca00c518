// int8 and W4A8 SAME stride-1 standard / grouped convolution for sm_90a.
//
// Replaces the TPU kernel repro/kernels/conv_im2col.py (conv2d_im2col /
// _conv2d_im2col, int8 and W4 modes): x (N,H,W,Cx) int8 NHWC, w
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
#include "w4.cuh"

template <bool W4>
__global__ void conv2d_kernel(
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

extern "C" int repro_conv2d_q8(const void* x, const void* w, const void* bias,
                               void* y, int n, int h, int wd, int cx, int cy,
                               int hk, int groups, int shift, int relu,
                               void* stream) {
  const int total = n * h * wd * cy;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  const int blocks = (total + threads - 1) / threads;
  conv2d_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)w, nullptr, (const int32_t*)bias,
      (int8_t*)y, n, h, wd, cx, cy, hk, groups, shift, relu);
  return (int)cudaGetLastError();
}

extern "C" int repro_conv2d_w4(const void* x, const void* w, const void* ws,
                               const void* bias, void* y, int n, int h, int wd,
                               int cx, int cy, int hk, int groups, int shift,
                               int relu, void* stream) {
  const int total = n * h * wd * cy;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  const int blocks = (total + threads - 1) / threads;
  conv2d_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)w, (const int8_t*)ws,
      (const int32_t*)bias, (int8_t*)y, n, h, wd, cx, cy, hk, groups, shift,
      relu);
  return (int)cudaGetLastError();
}
