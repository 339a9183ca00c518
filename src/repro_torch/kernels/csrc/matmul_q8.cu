// int8, W4A8 and float32 / bfloat16 matmul for sm_90a, the integer modes
// with the Algorithm-1 epilogue.
//
// Replaces the TPU kernel repro/kernels/matmul_q8.py (matmul / _matmul,
// all modes): a (M,K) int8 @ b (K,N) int8 -> exact int32 sums ->
// optional relu at accumulator scale -> round-to-nearest shift (a negative
// shift is a left shift) -> clip to int8 (epilogue.cuh). The LM's integer FFN
// (models/blocks.qmlp) runs its gate, up and down projections through it.
//
// W4 mode (repro_matmul_w4): b is (ceil(K/2),N), two int4 codes per byte along
// K (element 2i in the low nibble of byte row i), with an int8 group shift per
// K element (ws, length K). The packed bytes are what a block stages in
// shared memory; each nibble is unpacked and shifted in registers (w4.cuh) as
// the dot products read it, so the weight bytes read from device memory and
// held on chip are half the int8 mode's.
//
// What bounds it on an H100: at decode (M = 8 rows, one per slot) each launch
// reads a whole 896x4864 weight (4.36 MB int8, 2.18 MB W4) to do 70 M
// operations, so device-memory bytes set the floor (about 1.3 us int8 at
// 3.35 TB/s); at prefill (M up to 128) it is still below the card's int8
// ridge. The design: a block owns a BM x 256 output tile (BM = 16 for
// M <= 32, else 64: on an H100 the 16-row tile is 1.15x faster at M = 32 and
// 1.2-1.3x slower at M = 64 and 128, PERF.md) and walks K in stages of 32; a
// stage stages A's rows and B's columns in shared memory as 32-bit words of
// four K-consecutive int8s (W4: 16 bits of packed bytes per word), and each
// of the 256 threads owns one column and all BM rows of the tile: it reads
// its column's word once per stage word (unpacking a W4 word once, not once
// per row group) and takes __dp4a with the BM row words, which every thread
// reads at the same address (a shared-memory broadcast). A decode-shaped
// product has too few output tiles to fill 132 SMs, so the wrapper splits K
// across gridDim.z: each split adds its int32 partial sums into a zeroed
// workspace with atomicAdd, and a second kernel applies the epilogue.
// Integer sums do not depend on order, so every tiling and split gives the
// plain version's result bit for bit. The tile height (BM, 16 or 64) and the
// number of K splits are arguments (the tuner's knobs); the wrapper's own
// choice is the default.
//
// Float mode (repro_matmul_f): a (M,K) and b (K,N) in float32 or bfloat16,
// the same block shape (256 columns, one per thread, and BM rows), A's stage
// of 32 K elements staged in shared memory as float32 (broadcast reads), B's
// element of the thread's column read straight from device memory (coalesced
// across the warp). Each thread sums its BM rows in float32 from zero with K
// strictly in order (__fmul_rn / __fadd_rn), so there is no K split: float
// atomics would make the sum depend on the order the splits land in. Only the
// K real elements are summed. Then relu and one rounding to a's dtype
// (float_io.cuh). The TPU kernel sums K in MXU blocks, another order, so the
// float mode agrees with the JAX package within a tolerance.
// Tensor cores (mma.sync s8 / wgmma) and TMA are the next steps, not this one.
//
// Index arithmetic is 32-bit (the wrapper keeps every tensor below 2^31
// elements). Elements past K are read as zero from A, so a pad nibble or a
// ragged stage of B never reaches a sum.
#include <cstdint>
#include <cuda_runtime.h>

#include "epilogue.cuh"
#include "float_io.cuh"
#include "w4.cuh"

namespace {

constexpr int BN = 256;        // output columns per block, one per thread
constexpr int BK = 32;         // K elements per shared-memory stage
constexpr int KW = BK / 4;     // 32-bit words of four int8 per row per stage
constexpr int THREADS = BN;

// Four int8 values (in the low bytes of ints) as one dp4a operand, the first
// in the low byte.
__device__ __forceinline__ int pack4(int v0, int v1, int v2, int v3) {
  return (int)((uint32_t)(v0 & 0xff) | ((uint32_t)(v1 & 0xff) << 8) |
               ((uint32_t)(v2 & 0xff) << 16) | ((uint32_t)(v3 & 0xff) << 24));
}

template <int BM, bool W4>
__global__ void __launch_bounds__(THREADS) matmul_kernel(
    const int8_t* __restrict__ a, const int8_t* __restrict__ b,
    const int8_t* __restrict__ ws, int32_t* __restrict__ part,
    int8_t* __restrict__ y, int m, int k, int n, int steps_per_split,
    int a_vec, int shift, int relu) {
  __shared__ __align__(16) int as[KW][BM];   // A words, [k word][row]
  __shared__ int bs[W4 ? 1 : KW][BN];        // int8 B words, [k word][col]
  __shared__ uint16_t bp[W4 ? KW : 1][BN];   // W4: two packed bytes per word
  __shared__ int8_t ss[W4 ? BK : 1];         // W4: the stage's group shifts

  const int c = threadIdx.x;                 // this thread's column
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int nsteps = (k + BK - 1) / BK;
  const int s0 = blockIdx.z * steps_per_split;
  const int s1 = min(nsteps, s0 + steps_per_split);
  const int kp = (k + 1) / 2;                // W4: packed rows

  int acc[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) acc[i] = 0;

  for (int s = s0; s < s1; ++s) {
    const int k0 = s * BK;
    for (int t = threadIdx.x; t < BM * KW; t += THREADS) {
      const int r = t / KW, w = t % KW;
      const int gr = row0 + r, gk = k0 + 4 * w;
      int word = 0;
      if (gr < m) {
        const int8_t* p = a + gr * k + gk;
        if (a_vec && gk + 3 < k) {
          word = *reinterpret_cast<const int*>(p);   // 4-byte aligned
        } else {
          word = pack4(gk < k ? p[0] : 0, gk + 1 < k ? p[1] : 0,
                       gk + 2 < k ? p[2] : 0, gk + 3 < k ? p[3] : 0);
        }
      }
      as[w][r] = word;
    }
    for (int t = threadIdx.x; t < KW * BN; t += THREADS) {
      const int w = t / BN, cc = t % BN;
      const int gc = col0 + cc, gk = k0 + 4 * w;
      if constexpr (W4) {
        const int p0 = gk / 2;                 // packed rows p0, p0 + 1
        uint32_t h = 0;
        if (gc < n) {
          if (p0 < kp) h = (uint8_t)b[p0 * n + gc];
          if (p0 + 1 < kp) h |= (uint32_t)(uint8_t)b[(p0 + 1) * n + gc] << 8;
        }
        bp[w][cc] = (uint16_t)h;
      } else {
        int word = 0;
        if (gc < n) {
          word = pack4(gk < k ? b[gk * n + gc] : 0,
                       gk + 1 < k ? b[(gk + 1) * n + gc] : 0,
                       gk + 2 < k ? b[(gk + 2) * n + gc] : 0,
                       gk + 3 < k ? b[(gk + 3) * n + gc] : 0);
        }
        bs[w][cc] = word;
      }
    }
    if constexpr (W4) {
      const int t = threadIdx.x;
      if (t < BK) ss[t] = k0 + t < k ? ws[k0 + t] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      int bv;
      if constexpr (W4) {
        const uint32_t h = bp[w][c];
        const int8_t lo = (int8_t)(h & 0xff), hi = (int8_t)(h >> 8);
        bv = pack4(w4_code(lo, 0, ss[4 * w]), w4_code(lo, 1, ss[4 * w + 1]),
                   w4_code(hi, 0, ss[4 * w + 2]), w4_code(hi, 1, ss[4 * w + 3]));
      } else {
        bv = bs[w][c];
      }
#pragma unroll
      for (int i = 0; i < BM; ++i) acc[i] = __dp4a(as[w][i], bv, acc[i]);
    }
    __syncthreads();
  }

  const int gc = col0 + c;
  if (gc >= n) return;
#pragma unroll
  for (int i = 0; i < BM; ++i) {
    const int r = row0 + i;
    if (r >= m) break;
    if (part != nullptr) {
      atomicAdd(part + r * n + gc, acc[i]);
    } else {
      y[r * n + gc] = requant_epilogue(acc[i], relu, shift);
    }
  }
}

__global__ void epilogue_kernel(const int32_t* __restrict__ part,
                                int8_t* __restrict__ y, int total, int shift,
                                int relu) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < total) y[i] = requant_epilogue(part[i], relu, shift);
}

template <int BM, typename T>
__global__ void __launch_bounds__(THREADS) matmul_f_kernel(
    const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ y,
    int m, int k, int n, int relu) {
  __shared__ float as[BK][BM];               // A's stage, [k][row]
  const int c = threadIdx.x;
  const int row0 = blockIdx.y * BM;
  const int gc = blockIdx.x * BN + c;
  float acc[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) acc[i] = 0.0f;
  for (int k0 = 0; k0 < k; k0 += BK) {
    for (int t = threadIdx.x; t < BM * BK; t += THREADS) {
      const int r = t / BK, kk = t % BK;
      const int gr = row0 + r, gk = k0 + kk;
      as[kk][r] = gr < m && gk < k ? load_f32(a + gr * k + gk) : 0.0f;
    }
    __syncthreads();
    const int kn = min(BK, k - k0);
    if (gc < n) {
      for (int kk = 0; kk < kn; ++kk) {
        const float bv = load_f32(b + (k0 + kk) * n + gc);
#pragma unroll
        for (int i = 0; i < BM; ++i)
          acc[i] = __fadd_rn(acc[i], __fmul_rn(as[kk][i], bv));
      }
    }
    __syncthreads();
  }
  if (gc >= n) return;
#pragma unroll
  for (int i = 0; i < BM; ++i) {
    const int r = row0 + i;
    if (r >= m) break;
    float v = acc[i];
    if (relu && v < 0.0f) v = 0.0f;
    store_f32(y + r * n + gc, v);
  }
}

template <bool W4>
int launch(const void* a, const void* b, const void* ws, void* part, void* y,
           int m, int k, int n, int bm, int splits, int steps_per_split,
           int shift, int relu, void* stream) {
  if (m == 0 || n == 0) return (int)cudaSuccess;
  if (splits < 1 || steps_per_split < 1 || (splits > 1 && part == nullptr) ||
      (bm != 16 && bm != 64))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int32_t* p = splits > 1 ? (int32_t*)part : nullptr;
  if (p != nullptr) {
    const cudaError_t e =
        cudaMemsetAsync(p, 0, (size_t)m * n * sizeof(int32_t), st);
    if (e != cudaSuccess) return (int)e;
  }
  const int a_vec = (k % 4 == 0) && ((uintptr_t)a % 4 == 0);
  const dim3 grid((n + BN - 1) / BN, (m + bm - 1) / bm, splits);
  if (bm == 16) {
    matmul_kernel<16, W4><<<grid, THREADS, 0, st>>>(
        (const int8_t*)a, (const int8_t*)b, (const int8_t*)ws, p, (int8_t*)y,
        m, k, n, steps_per_split, a_vec, shift, relu);
  } else {
    matmul_kernel<64, W4><<<grid, THREADS, 0, st>>>(
        (const int8_t*)a, (const int8_t*)b, (const int8_t*)ws, p, (int8_t*)y,
        m, k, n, steps_per_split, a_vec, shift, relu);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p == nullptr) return (int)e;
  const int total = m * n;
  epilogue_kernel<<<(total + 255) / 256, 256, 0, st>>>(p, (int8_t*)y, total,
                                                       shift, relu);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_f(const void* a, const void* b, void* y, int m, int k, int n,
             int bm, int relu, void* stream) {
  if (m == 0 || n == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((n + BN - 1) / BN, (m + bm - 1) / bm);
  if (bm == 16) {
    matmul_f_kernel<16, T><<<grid, THREADS, 0, st>>>(
        (const T*)a, (const T*)b, (T*)y, m, k, n, relu);
  } else if (bm == 64) {
    matmul_f_kernel<64, T><<<grid, THREADS, 0, st>>>(
        (const T*)a, (const T*)b, (T*)y, m, k, n, relu);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_matmul_q8(const void* a, const void* b, void* part,
                               void* y, int m, int k, int n, int bm,
                               int splits, int steps_per_split, int shift,
                               int relu, void* stream) {
  return launch<false>(a, b, nullptr, part, y, m, k, n, bm, splits,
                       steps_per_split, shift, relu, stream);
}

extern "C" int repro_matmul_w4(const void* a, const void* b, const void* ws,
                               void* part, void* y, int m, int k, int n,
                               int bm, int splits, int steps_per_split,
                               int shift, int relu, void* stream) {
  return launch<true>(a, b, ws, part, y, m, k, n, bm, splits, steps_per_split,
                      shift, relu, stream);
}

// dtype: 0 float32, 1 bfloat16 (a, b and y alike).
extern "C" int repro_matmul_f(const void* a, const void* b, void* y, int m,
                              int k, int n, int bm, int relu, int dtype,
                              void* stream) {
  if (dtype == 0) return launch_f<float>(a, b, y, m, k, n, bm, relu, stream);
  if (dtype == 1)
    return launch_f<__nv_bfloat16>(a, b, y, m, k, n, bm, relu, stream);
  return (int)cudaErrorInvalidValue;
}
