// int8, W4A8 and float32 / bfloat16 SAME stride-1 depthwise convolution for
// sm_90a.
//
// Replaces the TPU kernel repro/kernels/conv_dw.py (depthwise2d /
// _depthwise2d, all modes): x (N,H,W,C) NHWC, w (HK,HK,C) (the (HK,HK,C,1)
// layout is the same bytes), per-channel HK x HK sum of products over the
// TPU kernel's zero padding (HK/2, (HK-1)/2), then relu and, in the integer
// modes, the round-to-nearest shift and clip to int8 (epilogue.cuh).
//
// W4 mode (repro_depthwise2d_w4): w is (ceil(HK/2),HK,C), packed along the
// tap-row axis so that channels stay the contiguous axis: tap row i is nibble
// i & 1 of byte row i >> 1, and its group shift ws[i] (length HK) is the same
// for every channel. Each nibble is unpacked and shifted once a block, while
// the weights are staged (w4.cuh); from there the int8 body runs unchanged.
//
// Float mode (repro_depthwise2d_f): x and w in float32 or bfloat16, a
// float32 accumulator from +0 summed over taps (i, j) in order with
// __fmul_rn / __fadd_rn, relu, one rounding to x's dtype (float_io.cuh).
// A tap outside the image reads a staged zero, which is the plain version's
// zero padding for every weight (inf and nan included).
//
// What bounds it: HK^2 multiply-adds an output and no channel contraction,
// so the floor is the bytes it moves (each input read once, each output
// written once), a microsecond or less at the model's shapes; what is left
// is latency: one round trip from device memory, the sums, one store. The
// design, a staged-row kernel: a block owns `rows` output rows of one image
// x a run of columns (the whole row where it fits) x a slab of channels,
// and stages its input rows plus the HK-1 halo rows and columns once in
// shared memory, raw (int8 and bfloat16 are widened on the read: cp.async
// cannot widen), zero outside the image, with cp.async copies of 16, 8 or 4
// bytes (a pixel's channels of the slab are whole copies and x is aligned
// to them), else element loads through the registers. Its weights [tap]
// [channel] are staged beside them (W4 unpacked there). A thread owns PT
// consecutive output pixels of one row x 4 consecutive channels (one 32-bit
// word of int8, a float4, or 8 bytes of bfloat16). At the models' HK = 3
// (a template argument) it keeps its 9 x 4 weights in registers and for
// each tap row reads PT + 2 staged pixels once and slides along them, so a
// staged input is read once a tap row rather than 9 times; any other HK
// reads each tap's weights and inputs from shared memory. No division or
// modulo in the sums; staging walks its elements with tile.cuh's Walk /
// Walk3.
//
// The tile is the tuner's knob: PT (pixels a thread, 1, 2 or 4) and rows
// (output rows a block, 1, 2, 4 or 8, at most H). A block has at most
// DW_MAX_THREADS threads: its whole row of PT-pixel column groups x rows,
// times as many channel vectors as keep it at most DW_THREADS; where the
// row alone is over DW_MAX_THREADS, runs of columns. No knob changes an
// output. dw_plan is the launch arithmetic (repro_torch.kernels.conv_dw.
// dw_plan mirrors it; repro_depthwise2d_plan exports it); a tile whose
// window does not fit the 232,448 bytes a block can use is refused.
//
// Index arithmetic is 32-bit (the wrapper keeps every tensor below 2^31
// elements).
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "epilogue.cuh"
#include "float_io.cuh"
#include "tile.cuh"
#include "w4.cuh"

namespace {

constexpr int DW_THREADS = 128;       // a block's threads where channel
                                      // vectors are added to fill it
constexpr int DW_MAX_THREADS = 256;   // a block's threads, at most
constexpr int DW_UX = 8;              // element loads a thread has in flight

// Launch geometry of one depthwise launch, computed on the host (dw_plan)
// and passed by value.
struct DwGeo {
  int n, h, wd, c, hk, pad;
  int rows, cg, csv, bw;   // output rows, PT-pixel column groups, 4-channel
                           // vectors and columns a block
  int rb, cb;              // row blocks an image, column blocks a row
  int ps;                  // staged elements a pixel (4 x csv)
  int wr, wc;              // window rows and columns
  int win_bytes, smem;     // window and shared bytes
  int cp;                  // bytes a staging copy (16, 8, 4), 0: elements
  int relu, shift, y_vec;
};

// A tile the kernel takes: PT 1, 2 or 4 pixels a thread, 1, 2, 4 or 8
// rows a block.
bool valid_dw_tile(int pt, int rows) {
  return (pt == 1 || pt == 2 || pt == 4) &&
         (rows == 1 || rows == 2 || rows == 4 || rows == 8);
}

// The launch arithmetic for elements of esize bytes (1 int8, 2 bfloat16,
// 4 float32; the weights staged as int8 or float32): returns false if the
// tile does not fit.
bool dw_plan(DwGeo& g, int* grid_x, int* grid_y, int* threads, int n, int h,
             int wd, int c, int hk, int esize, int pt, int rows) {
  g.n = n, g.h = h, g.wd = wd, g.c = c, g.hk = hk, g.pad = hk / 2;
  g.rows = imin(rows, h);
  const int cvec = (c + 3) / 4, cgw = (wd + pt - 1) / pt;
  if (g.rows * cgw <= DW_MAX_THREADS) {
    g.cg = cgw;
    g.csv = imin(cvec, DW_THREADS / (g.rows * cgw) > 1
                           ? DW_THREADS / (g.rows * cgw) : 1);
  } else {
    g.cg = DW_MAX_THREADS / g.rows, g.csv = 1;
  }
  g.bw = g.cg * pt;
  g.rb = (h + g.rows - 1) / g.rows, g.cb = (wd + g.bw - 1) / g.bw;
  g.ps = 4 * g.csv;
  g.wr = g.rows + hk - 1, g.wc = g.bw + hk - 1;
  g.win_bytes = round16(g.wr * g.wc * g.ps * esize);
  g.smem = g.win_bytes + hk * hk * g.ps * (esize == 1 ? 1 : 4);
  const int slabs = (cvec + g.csv - 1) / g.csv;
  *grid_x = n * g.rb * g.cb, *grid_y = slabs;
  *threads = g.csv * g.cg * g.rows;
  return g.smem <= MAX_SMEM && slabs <= MAX_GRID_Y;
}

// A launch's operands; ws (the W4 group shifts) is null in the other modes.
struct DwArgs {
  const void* x;
  const void* w;
  const void* ws;
  void* y;
};

// The integer modes: int8 x staged raw, weights staged as int8 (W4:
// unpacked and shifted), int32 sums.
struct DwInt {
  using X = int8_t;     // a staged input element
  using WS = int8_t;    // a staged weight
  using A = int32_t;    // the accumulator
  // the weight of tap t (= i * hk + j), channel ch
  static __device__ __forceinline__ WS load_w(const DwArgs& a,
                                              const DwGeo& g, int t,
                                              int ch) {
    const int8_t* w = (const int8_t*)a.w;
    if (a.ws == nullptr) return w[t * g.c + ch];
    const int i = t / g.hk, j = t - i * g.hk;
    return (int8_t)w4_code(w[((i >> 1) * g.hk + j) * g.c + ch], i & 1,
                           ((const int8_t*)a.ws)[i]);
  }
  // 4 consecutive staged elements (one aligned word), sign-extended
  static __device__ __forceinline__ void load4(const int8_t* p, A (&v)[4]) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = (int32_t)(int8_t)(u >> (8 * e));
  }
  static __device__ __forceinline__ A mac(A acc, A x, A w) {
    return acc + x * w;
  }
  // a pixel's 4 outputs from channel ch (nc of them real)
  static __device__ __forceinline__ void store(const DwArgs& a,
                                               const DwGeo& g, int idx,
                                               A (&acc)[4], int nc) {
    alignas(4) int8_t out[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[e] = requant_epilogue(acc[e], g.relu, g.shift);
    int8_t* y = (int8_t*)a.y + idx;
    if (g.y_vec) {
      *reinterpret_cast<uint32_t*>(y) = *reinterpret_cast<uint32_t*>(out);
    } else {
      for (int e = 0; e < nc; ++e) y[e] = out[e];
    }
  }
};

// The float modes: T float (staged raw as float) or __nv_bfloat16 (staged
// raw as its 16 bits, widened on the read), weights staged as float32,
// float32 sums.
template <typename T>
struct DwFloat {
  using X = typename std::conditional<sizeof(T) == 4, float, uint16_t>::type;
  using WS = float;
  using A = float;
  static __device__ __forceinline__ WS load_w(const DwArgs& a,
                                              const DwGeo& g, int t,
                                              int ch) {
    return load_f32((const T*)a.w + t * g.c + ch);
  }
  static __device__ __forceinline__ void load4(const X* p, A (&v)[4]) {
    if constexpr (sizeof(T) == 4) {
      const float4 u = *reinterpret_cast<const float4*>(p);
      v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      v[0] = __uint_as_float(u.x << 16), v[1] = __uint_as_float(u.x & ~0xffffu);
      v[2] = __uint_as_float(u.y << 16), v[3] = __uint_as_float(u.y & ~0xffffu);
    }
  }
  static __device__ __forceinline__ A mac(A acc, A x, A w) {
    return __fadd_rn(acc, __fmul_rn(x, w));
  }
  static __device__ __forceinline__ void store(const DwArgs& a,
                                               const DwGeo& g, int idx,
                                               A (&acc)[4], int nc) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (g.relu && acc[e] < 0.0f) acc[e] = 0.0f;
    T* y = (T*)a.y + idx;
    if (g.y_vec) {
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float4*>(y) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
      } else {
        alignas(8) T out[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) store_f32(out + e, acc[e]);
        *reinterpret_cast<uint2*>(y) = *reinterpret_cast<const uint2*>(out);
      }
    } else {
      for (int e = 0; e < nc; ++e) store_f32(y + e, acc[e]);
    }
  }
};

// An n-byte copy (4, 8 or 16) from global to shared memory that bypasses
// the registers, zero-filled where !valid (src must still be an address
// of the tensor).
template <int NB>
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "n"(NB), "r"(valid ? NB : 0));
}

// The window staged with NB-byte copies: [row][column][ps elements],
// zero outside the image and past the slab's nb real bytes a pixel.
template <int NB, typename X>
__device__ __forceinline__ void stage_async(X* win, const X* xb,
                                            const DwGeo& g, int iy0, int ix0,
                                            int nb) {
  const int per = g.ps * (int)sizeof(X) / NB;      // copies a pixel
  Walk3 s(threadIdx.x, blockDim.x, g.wc, per);
  const unsigned char* src0 = (const unsigned char*)xb;
  unsigned char* dst0 = (unsigned char*)win;
  while (s.r < g.wr) {
    const int iy = iy0 + s.r, ix = ix0 + s.c;
    const bool in = (unsigned)iy < (unsigned)g.h &&
                    (unsigned)ix < (unsigned)g.wd && s.ch * NB < nb;
    copy_async<NB>(
        dst0 + (s.r * g.wc + s.c) * g.ps * (int)sizeof(X) + s.ch * NB,
        src0 + (in ? (iy * g.wd + ix) * g.c * (int)sizeof(X) + s.ch * NB
                   : 0),
        in);
    s.next();
  }
  asm volatile("cp.async.wait_all;\n" ::);
}

// A block: `rows` output rows of one image x bw columns x ps channels;
// thread (cv, tc, tr) owns the PT pixels tc*PT .. tc*PT+PT-1 of the
// block's row tr x channels 4cv .. 4cv+3 of the slab. HKT: 3 where HK is
// 3 (its weights in registers), else 0 (HK read from the geometry).
template <class M, int PT, int HKT>
__global__ void __launch_bounds__(DW_MAX_THREADS) depthwise2d_kernel(
    const DwArgs a, const DwGeo g) {
  using X = typename M::X;
  using WS = typename M::WS;
  using A = typename M::A;
  extern __shared__ __align__(16) unsigned char dsm[];
  X* win = reinterpret_cast<X*>(dsm);                  // [row][col][ch]
  WS* wsm = reinterpret_cast<WS*>(dsm + g.win_bytes);  // [tap][ch]
  const int hk = HKT > 0 ? HKT : g.hk;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int per_img = g.rb * g.cb;
  const int b = blockIdx.x / per_img, rem = blockIdx.x - b * per_img;
  const int ry = rem / g.cb;
  const int y0 = ry * g.rows, x0 = (rem - ry * g.cb) * g.bw;
  const int c0 = blockIdx.y * g.ps;
  const int nc = min(g.ps, g.c - c0);          // the slab's real channels

  {
    Walk sw(tid, nthr, g.ps);
    while (sw.r < hk * hk) {
      wsm[sw.r * g.ps + sw.c] =
          sw.c < nc ? M::load_w(a, g, sw.r, c0 + sw.c) : (WS)0;
      sw.next();
    }
  }
  const X* xb = (const X*)a.x + b * g.h * g.wd * g.c + c0;
  const int iy0 = y0 - g.pad, ix0 = x0 - g.pad;
  if (g.cp == 16) {
    stage_async<16>(win, xb, g, iy0, ix0, nc * (int)sizeof(X));
  } else if (g.cp == 8) {
    stage_async<8>(win, xb, g, iy0, ix0, nc * (int)sizeof(X));
  } else if (g.cp == 4) {
    stage_async<4>(win, xb, g, iy0, ix0, nc * (int)sizeof(X));
  } else {
    Walk3 s(tid, nthr, g.wc, g.ps);
    while (s.r < g.wr) {
      const Walk3 s0 = s;
      X v[DW_UX];
#pragma unroll
      for (int u = 0; u < DW_UX; ++u) {
        const int iy = iy0 + s.r, ix = ix0 + s.c;
        v[u] = 0;
        if (s.r < g.wr && (unsigned)iy < (unsigned)g.h &&
            (unsigned)ix < (unsigned)g.wd && s.ch < nc)
          v[u] = xb[(iy * g.wd + ix) * g.c + s.ch];
        s.next();
      }
      Walk3 sd = s0;
#pragma unroll
      for (int u = 0; u < DW_UX; ++u) {
        if (sd.r < g.wr) win[(sd.r * g.wc + sd.c) * g.ps + sd.ch] = v[u];
        sd.next();
      }
    }
  }
  __syncthreads();

  const int cv = tid % g.csv, t2 = tid / g.csv;
  const int tc = t2 % g.cg, tr = t2 / g.cg;
  A acc[PT][4];
#pragma unroll
  for (int p = 0; p < PT; ++p)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[p][e] = 0;
  const X* xr = win + (tr * g.wc + tc * PT) * g.ps + 4 * cv;
  const WS* wv0 = wsm + 4 * cv;
  if constexpr (HKT > 0) {
    A wr[HKT * HKT][4];
#pragma unroll
    for (int t = 0; t < HKT * HKT; ++t) {
      if constexpr (sizeof(WS) == 1) {
        M::load4(wv0 + t * g.ps, wr[t]);
      } else {
        const float4 u = *reinterpret_cast<const float4*>(wv0 + t * g.ps);
        wr[t][0] = u.x, wr[t][1] = u.y, wr[t][2] = u.z, wr[t][3] = u.w;
      }
    }
#pragma unroll
    for (int i = 0; i < HKT; ++i) {
      A xv[PT + HKT - 1][4];
#pragma unroll
      for (int u = 0; u < PT + HKT - 1; ++u)
        M::load4(xr + (i * g.wc + u) * g.ps, xv[u]);
#pragma unroll
      for (int j = 0; j < HKT; ++j)
#pragma unroll
        for (int p = 0; p < PT; ++p)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[p][e] = M::mac(acc[p][e], xv[p + j][e], wr[i * HKT + j][e]);
    }
  } else {
    for (int i = 0; i < hk; ++i) {
      for (int j = 0; j < hk; ++j) {
        A w4v[4];
        if constexpr (sizeof(WS) == 1) {
          M::load4(wv0 + (i * hk + j) * g.ps, w4v);
        } else {
          const float4 u =
              *reinterpret_cast<const float4*>(wv0 + (i * hk + j) * g.ps);
          w4v[0] = u.x, w4v[1] = u.y, w4v[2] = u.z, w4v[3] = u.w;
        }
#pragma unroll
        for (int p = 0; p < PT; ++p) {
          A xv[4];
          M::load4(xr + (i * g.wc + p + j) * g.ps, xv);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[p][e] = M::mac(acc[p][e], xv[e], w4v[e]);
        }
      }
    }
  }

  const int oy = y0 + tr, ch = c0 + 4 * cv;
  if (oy >= g.h || ch >= g.c) return;
  const int left = min(4, g.c - ch);
#pragma unroll
  for (int p = 0; p < PT; ++p) {
    const int ox = x0 + tc * PT + p;
    if (ox >= g.wd) break;
    M::store(a, g, ((b * g.h + oy) * g.wd + ox) * g.c + ch, acc[p], left);
  }
}

template <class M, int PT, int HKT>
int dw_launch_k(const DwGeo& g, int gx, int gy, int threads,
                const DwArgs& a, cudaStream_t st) {
  auto kern = depthwise2d_kernel<M, PT, HKT>;
  if (g.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(gx, gy), threads, g.smem, st>>>(a, g);
  return (int)cudaGetLastError();
}

template <class M, int PT>
int dw_launch_pt(const DwGeo& g, int gx, int gy, int threads,
                 const DwArgs& a, cudaStream_t st) {
  if (g.hk == 3) return dw_launch_k<M, PT, 3>(g, gx, gy, threads, a, st);
  return dw_launch_k<M, PT, 0>(g, gx, gy, threads, a, st);
}

// Plan and launch one depthwise conv: esize 1 (int8 / W4), 2 (bfloat16) or
// 4 (float32).
template <class M>
int dw_run(const DwArgs& a, int n, int h, int wd, int c, int hk, int esize,
           int shift, int relu, int pt, int rows, void* stream) {
  if (!valid_dw_tile(pt, rows)) return (int)cudaErrorInvalidValue;
  if (n * h * wd * c == 0) return (int)cudaSuccess;
  DwGeo g;
  int gx, gy, threads;
  if (!dw_plan(g, &gx, &gy, &threads, n, h, wd, c, hk, esize, pt, rows))
    return (int)cudaErrorInvalidValue;
  g.relu = relu, g.shift = shift;
  g.y_vec = c % 4 == 0 && (uintptr_t)a.y % 16 == 0;
  g.cp = 0;
  for (int nb = 16; nb >= 4; nb /= 2) {
    if ((g.ps * esize) % nb == 0 && (c * esize) % nb == 0 &&
        (uintptr_t)a.x % nb == 0) {
      g.cp = nb;
      break;
    }
  }
  const cudaStream_t st = (cudaStream_t)stream;
  if (pt == 1) return dw_launch_pt<M, 1>(g, gx, gy, threads, a, st);
  if (pt == 2) return dw_launch_pt<M, 2>(g, gx, gy, threads, a, st);
  return dw_launch_pt<M, 4>(g, gx, gy, threads, a, st);
}

}  // namespace

// pt (pixels a thread) and rows (output rows a block) are the tuner's
// knobs; they change only the launch shape.
extern "C" int repro_depthwise2d_q8(const void* x, const void* w, void* y,
                                    int n, int h, int wd, int c, int hk,
                                    int shift, int relu, int pt, int rows,
                                    void* stream) {
  return dw_run<DwInt>(DwArgs{x, w, nullptr, y}, n, h, wd, c, hk, 1, shift,
                       relu, pt, rows, stream);
}

extern "C" int repro_depthwise2d_w4(const void* x, const void* w,
                                    const void* ws, void* y, int n, int h,
                                    int wd, int c, int hk, int shift, int relu,
                                    int pt, int rows, void* stream) {
  return dw_run<DwInt>(DwArgs{x, w, ws, y}, n, h, wd, c, hk, 1, shift, relu,
                       pt, rows, stream);
}

// dtype: 0 float32, 1 bfloat16 (x, w and y alike).
extern "C" int repro_depthwise2d_f(const void* x, const void* w, void* y,
                                   int n, int h, int wd, int c, int hk,
                                   int relu, int dtype, int pt, int rows,
                                   void* stream) {
  const DwArgs a{x, w, nullptr, y};
  if (dtype == 0)
    return dw_run<DwFloat<float>>(a, n, h, wd, c, hk, 4, 0, relu, pt, rows,
                                  stream);
  if (dtype == 1)
    return dw_run<DwFloat<__nv_bfloat16>>(a, n, h, wd, c, hk, 2, 0, relu, pt,
                                          rows, stream);
  return (int)cudaErrorInvalidValue;
}

// The launch arithmetic for elements of esize bytes (1: int8 and W4, 2:
// bfloat16, 4: float32): plan[0..4] = grid x, grid y, threads, shared
// bytes, window bytes. Returns non-zero if the tile is not one of the
// knobs' values or does not fit (plan still filled).
extern "C" int repro_depthwise2d_plan(int* plan, int n, int h, int wd, int c,
                                      int hk, int esize, int pt, int rows) {
  if (!valid_dw_tile(pt, rows)) return (int)cudaErrorInvalidValue;
  DwGeo g;
  const bool fits = dw_plan(g, plan, plan + 1, plan + 2, n, h, wd, c, hk,
                            esize, pt, rows);
  plan[3] = g.smem, plan[4] = g.win_bytes;
  return fits ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
}
