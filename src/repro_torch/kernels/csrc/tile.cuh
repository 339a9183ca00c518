// Helpers shared by the tiled kernels: the integer implicit GEMM
// (igemm.cuh), the float implicit GEMM (fgemm.cuh) and the float shift conv
// (conv_shift.cu): the tile knobs' check, the conv's K-offset builder and
// the division-free walks their staging loops use.
#pragma once

namespace {

// the shared memory a block can use on an H100 (dynamic, past 48 KB after
// cudaFuncSetAttribute) and the grid's y limit
constexpr int MAX_SMEM = 232448;
constexpr int MAX_GRID_Y = 65535;

int round16(int v) { return (v + 15) & ~15; }
int imin(int a, int b) { return a < b ? a : b; }

// A tile the kernels take: bp (pixels a block) a multiple of 32 up to 256
// (the tuner tries 32, 64, 128 and 256); q (channels a thread) 4, 8 or 16.
bool valid_tile(int bp, int q) {
  return bp >= 32 && bp <= 256 && bp % 32 == 0 &&
         (q == 4 || q == 8 || q == 16);
}

// A conv's K element k = (tap row i, tap column j, channel c of the group)
// lies at window offset (i * ww + j) * ps + c from its pixel's base (ww:
// the window's width in pixels, ps: a staged pixel's stride). Geo is the
// integer or the float GEMM's geometry (both carry cxg, hk and ps).
struct TapOffsets {
  template <class Geo>
  __device__ int operator()(const Geo& g, int k, int ww) const {
    const int tap = k / g.cxg, c = k - tap * g.cxg;
    const int i = tap / g.hk, j = tap - i * g.hk;
    return (i * ww + j) * g.ps + c;
  }
};

// Element tid + k * nthr of a row-major [rows][cols] array, walked without
// divisions: (r, c) advances by (nthr / cols, nthr % cols) a step.
struct Walk {
  int r, c, dr, dc, cols;
  __device__ Walk(int tid, int nthr, int cols_) : cols(cols_) {
    r = tid / cols, c = tid - r * cols;
    dr = nthr / cols, dc = nthr - dr * cols;
  }
  __device__ void next() {
    r += dr, c += dc;
    if (c >= cols) c -= cols, ++r;
  }
};

// The same over a row-major [rows][cols][chans] array: (r, c, ch).
struct Walk3 {
  int r, c, ch, dr, dc, dch, cols, chans;
  __device__ Walk3(int tid, int nthr, int cols_, int chans_)
      : cols(cols_), chans(chans_) {
    const int t = tid / chans, s = nthr / chans;
    ch = tid - t * chans, r = t / cols, c = t - r * cols;
    dch = nthr - s * chans, dr = s / cols, dc = s - dr * cols;
  }
  __device__ void next() {
    ch += dch;
    if (ch >= chans) ch -= chans, ++c;
    c += dc;
    if (c >= cols) c -= cols, ++r;
    r += dr;
  }
};

}  // namespace
