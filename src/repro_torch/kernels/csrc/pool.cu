// int8 VALID max-pool for sm_90a.
//
// Replaces the TPU kernel repro/kernels/pool.py (maxpool2d / _maxpool2d,
// int8 mode): x (N,H,W,C) int8 NHWC, any window and stride, output
// ((H-win)/stride+1, (W-win)/stride+1). Max commutes with the positive
// power-of-two scale, so pooling the int8 codes is exact.
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

__global__ void maxpool2d_s8_kernel(const int8_t* __restrict__ x,
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

extern "C" int repro_maxpool2d_s8(const void* x, void* y, int n, int h, int wd,
                                  int c, int hout, int wout, int win,
                                  int stride, void* stream) {
  const int total = n * hout * wout * c;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  const int blocks = (total + threads - 1) / threads;
  maxpool2d_s8_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (int8_t*)y, n, h, wd, c, hout, wout, win, stride);
  return (int)cudaGetLastError();
}
