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
// a register-tiled SIMT GEMM. What bounds it on an H100 is operations: at
// Table-2's 256x512x256 and 512^3 a float32 product does 34 M and 134 M
// multiply-adds against 0.6 MB and 3 MB of operands. The design: a block
// owns a BM x BN output tile and each of its (BM/TM) x (BN/TN) threads a
// TM x TN register tile. A and B are staged in (dynamic) shared memory in
// 64-deep K stages, a ring of three with two in flight, by cp.async: A as
// 4-byte copies into a k-major, padded layout, so that a thread reads its TM
// A values of one k as one vector load; B as 16-byte copies of whole rows,
// read TN at a time as one vector load. A thread reads the operands of 8 k
// into registers before it sums them, so one shared-memory latency covers
// 8 k. On an H100 the loads were what held back a first, double-buffered
// version with 16-deep stages (PERF.md). A ragged M, N or K edge is
// zero-filled by the copies' source size; an operand whose rows are not
// 4-byte (A) or 16-byte (B) aligned (an odd K in bfloat16, N off a multiple
// of 4 or 8, an offset view) is staged by plain loads instead. bfloat16 is
// staged as its raw bytes (A as words of two K-consecutive values) and
// widened to float32 on the shared-memory read; a product of two bfloat16
// values is exact in float32. The tile (BM, BN, TM, TN) is a template
// argument, one instantiation per entry of MMF_TILES, and the tuner's knob;
// the wrapper picks one by the shape.
//
// The order rule, which keeps the kernel bitwise equal to its plain version
// (matmul_f_plain): every accumulator starts at +0.0f and sums k = 0..K-1
// strictly in order as __fadd_rn(acc, __fmul_rn(a, b)). So there is no FMA
// (nvcc would round the product once less), no K split (float atomics would
// make the sum depend on the order the splits land in) and no tensor core
// (TF32 and bfloat16 mma / wgmma accumulate in another order and
// precision). The cost: a multiply-add takes two CUDA-core instructions, so
// the float32 ceiling is half the 66.91 TFLOP/s FMA peak and the Table-2
// pair cannot take less than about 0.0100 ms. Elements past K are staged as
// zeros in both operands: each adds +0 * +0 = +0, and the accumulator,
// which starts at +0 and never becomes -0, does not change. Then relu and
// one rounding to a's dtype (float_io.cuh). The TPU kernel sums K in MXU
// blocks, another order, so the float mode agrees with the JAX package
// within a tolerance.
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

// ---------------------------------------------------------------- float --

constexpr int FBK = 64;                    // K elements per float stage
constexpr int FNS = 3;                     // stages in the shared ring
constexpr int FKH = 8;                     // k whose operands a thread loads
                                           // into registers at once

// The tiles the float mode is instantiated for, (BM, BN, TM, TN): the
// tuner's candidates (repro_torch.kernels.matmul_q8.MMF_TILES, same order).
#define MMF_TILES(X)                                                        \
  X(16, 32, 2, 2) X(16, 64, 2, 4) X(32, 32, 2, 2) X(32, 32, 2, 4)           \
  X(32, 64, 2, 4) X(32, 64, 4, 4) X(64, 64, 4, 4) X(64, 64, 8, 4)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// cp.async of `bytes` (4 or 16) with a source size: the bytes past
// `src_bytes` are written as zeros, and none is read when it is 0.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(src_bytes));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy BYTES (4, 8, 16 or 32) of shared memory into words, as vector loads.
template <int BYTES>
__device__ __forceinline__ void lds(const void* p, uint32_t* out) {
  if constexpr (BYTES == 4) {
    out[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (BYTES == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    out[0] = v.x, out[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[i];
      out[4 * i] = v.x, out[4 * i + 1] = v.y, out[4 * i + 2] = v.z,
                  out[4 * i + 3] = v.w;
    }
  }
}

// The raw 16 bits of a bfloat16 and the float32 of a raw bfloat16 (exact).
__device__ __forceinline__ uint32_t raw16(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}
__device__ __forceinline__ float widen(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

template <typename T, int BM, int BN, int TM, int TN>
struct FTile {
  static constexpr int EPW = 4 / (int)sizeof(T);   // elements per A word
  static constexpr int KW = FBK / EPW;             // A words per row, stage
  static constexpr int AS = BM + 4;                // A words per k-word row
  static constexpr int CH = 16 / (int)sizeof(T);   // B elements per copy
  static constexpr int THREADS = (BM / TM) * (BN / TN);
  static constexpr int A_BYTES = KW * AS * 4;     // one stage of A
  static constexpr int SMEM = FNS * (A_BYTES + FBK * BN * (int)sizeof(T));
};

template <typename T, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(FTile<T, BM, BN, TM, TN>::THREADS)
    matmul_f_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    T* __restrict__ y, int m, int k, int n, int relu,
                    int a_async, int b_async, int y_vec) {
  using F = FTile<T, BM, BN, TM, TN>;
  constexpr int EPW = F::EPW, KW = F::KW, AS = F::AS, CH = F::CH;
  constexpr int THREADS = F::THREADS, NT = BN / TN;
  extern __shared__ __align__(16) unsigned char fsmem[];
  // the ring: FNS stages of A as words, [k word][row], then of B, [k][col]
  auto As = reinterpret_cast<uint32_t (*)[KW][AS]>(fsmem);
  auto Bs = reinterpret_cast<T (*)[FBK][BN]>(fsmem + FNS * F::A_BYTES);

  const int tid = threadIdx.x;
  const int tx = tid % NT, ty = tid / NT;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int stages = (k + FBK - 1) / FBK;

  auto stage = [&](int s, int buf) {
    const int k0 = s * FBK;
    for (int e = tid; e < BM * KW; e += THREADS) {
      const int r = e / KW, w = e % KW;
      const int gr = row0 + r, gk = k0 + w * EPW;
      uint32_t* dst = &As[buf][w][r];
      if (a_async) {
        const int left = gr < m ? (k - gk) * (int)sizeof(T) : 0;
        cp_async<4>(dst, left > 0 ? (const void*)(a + gr * k + gk) : a,
                    left > 0 ? min(left, 4) : 0);
      } else {
        uint32_t word = 0;
        if (gr < m) {
          if constexpr (EPW == 1) {
            if (gk < k) word = __float_as_uint(load_f32(a + gr * k + gk));
          } else {
            if (gk < k) word = raw16(a + gr * k + gk);
            if (gk + 1 < k) word |= raw16(a + gr * k + gk + 1) << 16;
          }
        }
        *dst = word;
      }
    }
    for (int e = tid; e < FBK * (BN / CH); e += THREADS) {
      const int kk = e / (BN / CH), c = (e % (BN / CH)) * CH;
      const int gk = k0 + kk, gc = col0 + c;
      T* dst = &Bs[buf][kk][c];
      if (b_async) {
        const int left = gk < k ? (n - gc) * (int)sizeof(T) : 0;
        cp_async<16>(dst, left > 0 ? (const void*)(b + gk * n + gc) : b,
                     left > 0 ? min(left, 16) : 0);
      } else {
#pragma unroll
        for (int i = 0; i < CH; ++i)
          dst[i] = gk < k && gc + i < n ? b[gk * n + gc + i] : T(0.0f);
      }
    }
    cp_async_commit();
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  // A ring of FNS stages, FNS - 1 in flight: every iteration commits one
  // copy group (empty past the last stage), so waiting until at most
  // FNS - 2 are pending means stage s has landed. The stage issued at s
  // refills the buffer computed at s - 1, which every thread has left by
  // the barrier.
  for (int s = 0; s < FNS - 1; ++s) {
    if (s < stages) stage(s, s);
    else cp_async_commit();
  }
  for (int s = 0; s < stages; ++s) {
    const int buf = s % FNS;
    cp_async_wait<FNS - 2>();
    __syncthreads();
    if (s + FNS - 1 < stages) stage(s + FNS - 1, (s + FNS - 1) % FNS);
    else cp_async_commit();
    // FKH k at a time: every operand of the FKH k read into registers
    // first, then the products and sums, k strictly in order
#pragma unroll
    for (int h0 = 0; h0 < FBK; h0 += FKH) {
      float av[FKH][TM], bv[FKH][TN];
#pragma unroll
      for (int q = 0; q < FKH; ++q) {
        const int kk = h0 + q, h = kk % EPW;     // k = word * EPW + h
        uint32_t aw[TM];
        lds<4 * TM>(&As[buf][kk / EPW][ty * TM], aw);
#pragma unroll
        for (int i = 0; i < TM; ++i)
          av[q][i] = EPW == 1 ? __uint_as_float(aw[i])
                              : widen(h ? aw[i] >> 16 : aw[i] & 0xffff);
        if constexpr (EPW == 1) {
          uint32_t bw[TN];
          lds<4 * TN>(&Bs[buf][kk][tx * TN], bw);
#pragma unroll
          for (int j = 0; j < TN; ++j) bv[q][j] = __uint_as_float(bw[j]);
        } else {
          uint32_t bw[(TN + 1) / 2];
          lds<2 * TN>(&Bs[buf][kk][tx * TN], bw);
#pragma unroll
          for (int j = 0; j < TN; ++j)
            bv[q][j] = widen(j & 1 ? bw[j / 2] >> 16 : bw[j / 2] & 0xffff);
        }
      }
#pragma unroll
      for (int q = 0; q < FKH; ++q)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(av[q][i], bv[q][j]));
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= m) break;
    const int c0 = col0 + tx * TN;
    T* yp = y + r * n + c0;
    if (y_vec && c0 + TN <= n) {
      alignas(16) T out[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float v = acc[i][j];
        if (relu && v < 0.0f) v = 0.0f;
        store_f32(out + j, v);
      }
      if constexpr (TN * sizeof(T) % 16 == 0) {
#pragma unroll
        for (int q = 0; q < (int)(TN * sizeof(T) / 16); ++q)
          reinterpret_cast<uint4*>(yp)[q] =
              reinterpret_cast<const uint4*>(out)[q];
      } else if constexpr (TN * sizeof(T) == 8) {
        *reinterpret_cast<uint2*>(yp) = *reinterpret_cast<const uint2*>(out);
      } else {
        *reinterpret_cast<uint32_t*>(yp) =
            *reinterpret_cast<const uint32_t*>(out);
      }
    } else {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        if (c0 + j >= n) break;
        float v = acc[i][j];
        if (relu && v < 0.0f) v = 0.0f;
        store_f32(yp + j, v);
      }
    }
  }
}

// The launch of one float tile: grid, threads and dynamic shared bytes
// (plan[0..3]); what repro_torch.kernels.matmul_q8.mmf_plan computes.
template <typename T, int BM, int BN, int TM, int TN>
int launch_f(const void* a, const void* b, void* y, int m, int k, int n,
             int relu, cudaStream_t st, int* plan) {
  using F = FTile<T, BM, BN, TM, TN>;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  if (plan != nullptr) {
    plan[0] = (int)grid.x, plan[1] = (int)grid.y, plan[2] = F::THREADS,
    plan[3] = F::SMEM;
    return (int)cudaSuccess;
  }
  if (m == 0 || n == 0) return (int)cudaSuccess;
  const int esz = (int)sizeof(T);
  // A's 4-byte words: float32 always; bfloat16 with an even K and a 4-byte
  // aligned a. B's 16-byte copies: rows of a multiple of 16 bytes, b aligned.
  const int a_async = (k * esz) % 4 == 0 && (uintptr_t)a % 4 == 0;
  const int b_async = (n * esz) % 16 == 0 && (uintptr_t)b % 16 == 0;
  const int y_vec = (n * esz) % (TN * esz > 16 ? 16 : TN * esz) == 0 &&
                    (uintptr_t)y % 16 == 0;
  auto kern = matmul_f_kernel<T, BM, BN, TM, TN>;
  if (F::SMEM > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, F::SMEM);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, F::THREADS, F::SMEM, st>>>(
      (const T*)a, (const T*)b, (T*)y, m, k, n, relu, a_async, b_async,
      y_vec);
  return (int)cudaGetLastError();
}

// Dispatch on (bm, bn, tm, tn) to the instantiated tile; `plan` non-null
// asks for the launch arithmetic only.
template <typename T>
int dispatch_f(const void* a, const void* b, void* y, int m, int k, int n,
               int bm, int bn, int tm, int tn, int relu, cudaStream_t st,
               int* plan) {
#define MMF_CASE(BM, BN, TM, TN)                                         \
  if (bm == BM && bn == BN && tm == TM && tn == TN)                      \
    return launch_f<T, BM, BN, TM, TN>(a, b, y, m, k, n, relu, st, plan);
  MMF_TILES(MMF_CASE)
#undef MMF_CASE
  return (int)cudaErrorInvalidValue;
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

// dtype: 0 float32, 1 bfloat16 (a, b and y alike). (bm, bn, tm, tn) must be
// one of MMF_TILES.
extern "C" int repro_matmul_f(const void* a, const void* b, void* y, int m,
                              int k, int n, int bm, int bn, int tm, int tn,
                              int relu, int dtype, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_f<float>(a, b, y, m, k, n, bm, bn, tm, tn, relu, st,
                             nullptr);
  if (dtype == 1)
    return dispatch_f<__nv_bfloat16>(a, b, y, m, k, n, bm, bn, tm, tn, relu,
                                     st, nullptr);
  return (int)cudaErrorInvalidValue;
}

// The float mode's launch arithmetic for (m, n) and a tile: plan[0..3] =
// grid x, grid y, threads, shared bytes. Nothing is launched.
extern "C" int repro_matmul_f_plan(int* plan, int m, int n, int bm, int bn,
                                   int tm, int tn, int dtype) {
  if (dtype == 0)
    return dispatch_f<float>(nullptr, nullptr, nullptr, m, 0, n, bm, bn, tm,
                             tn, 0, nullptr, plan);
  if (dtype == 1)
    return dispatch_f<__nv_bfloat16>(nullptr, nullptr, nullptr, m, 0, n, bm,
                                     bn, tm, tn, 0, nullptr, plan);
  return (int)cudaErrorInvalidValue;
}
