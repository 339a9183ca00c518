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
// K element (ws, length K). The packed bytes are what a block reads and
// stages; each word of four columns is unpacked and shifted in registers
// (w4.cuh's w4_codes4, four codes at once) as the fragments are built, so the
// weight bytes read from device memory and held on chip are half the int8
// mode's.
//
// What bounds it on an H100: at decode (M = 8 rows, one per slot) each launch
// reads a whole 896x4864 weight (4.36 MB int8, 2.18 MB W4) to do 70 M
// operations, so device-memory bytes set the floor (about 1.3 us int8 and
// 0.65 us W4 at 3.35 TB/s), and with so little work a launch is over in a
// few trips to device memory: what counts is how many bytes are in flight
// at once and how few steps follow the last load. At prefill (M = 32-128)
// the operations grow with M while the weight bytes do not, and the int8
// tensor cores (1,979 T ops/s) keep them below the byte floor.
//
// The design (repro_matmul_q8 / repro_matmul_w4, matmul_q_kernel): one
// launch a product, no workspace. A block owns BN output columns x BM rows
// of a; the K stages (64 deep) are dealt round-robin to its warps (8 for
// the decode tiles, BM <= 16, else 4) and to those of a thread-block cluster
// of cs blocks (1, 2, 4 or 8, x-major in the grid), so a decode-shaped
// product whose column tiles are too few to fill 132 SMs still spreads its
// weight over the card (down: 28 tiles of 32 columns x 4 blocks). Each warp
// streams its stages through a private ring in shared memory (4 stages for
// the decode tiles, 3 for the taller ones), all but one in flight, by
// 16-byte cp.async copies of b's rows (W4: packed rows) and a's rows, so a
// decode warp's whole share of the weight is requested at once and no
// block-wide barrier stalls the stream. The sums run on the int8 tensor
// cores (mma.sync m16n8k32) with the operands swapped: the weights are the
// mma's A, 16 output columns, and a's rows its B, 8 tokens, so a decode
// step's 8 rows fill the mma's narrow side. b is N-major and the mma wants
// K-major words: a thread reads 4 x 4 byte blocks of a stage as words (a
// swizzle puts the four rows it reads at once in distinct banks) and
// transposes them with __byte_perm. At the end each warp's int32 partial
// tile goes to shared memory and the block sums its warps; the cluster's
// other blocks store their sums into the leader block's shared memory
// (distributed shared memory, map_shared_rank) before one cluster barrier,
// and the leader adds them, applies the epilogue and stores int8. Integer
// sums do not depend on order, so every tile and cluster size gives the
// plain version's result bit for bit. The tile (BN, BM) is a template
// argument, one instantiation per entry of MMQ_TILES; the tile and the
// cluster size are the tuner's knobs, the wrapper's own choice the default.
// What is left on an H100 (PERF.md): a decode launch still takes about 3x
// its byte floor, a fixed 2-2.5 us (the launch and one trip to device
// memory) plus each warp's chain of stages; a cluster adds about 1 us, and
// W4's unpack lengthens the chain more than its halved bytes save.
//
// Edges: elements past K are staged as zeros (the copies' source size, or
// the bytewise staging's guard), so a pad nibble of an odd K meets a zero
// of a and a ragged stage adds nothing; columns past N and rows past M are
// staged as zeros and never stored. b, a or ws off a 16-byte boundary, or N
// (b) or K (a, ws) off a multiple of 16, are staged byte by byte.
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
// elements).
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "epilogue.cuh"
#include "float_io.cuh"
#include "w4.cuh"

namespace cg = cooperative_groups;

namespace {

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

// ------------------------------------------------------------- integer --
//
// int8 and W4 weights, int8 activations, exact int32 sums on the int8
// tensor cores (mma.sync m16n8k32), one launch a product. See the header.

constexpr int QBK = 64;            // K elements of one warp stage
constexpr int QAP = QBK + 16;      // bytes a staged row of a (padded: the
                                   // eight rows a fragment load reads fall
                                   // in eight distinct bank quads)

// The tiles the integer modes are instantiated for, (BN, BM): a block of
// BN output columns x BM rows of a (tokens). The tuner's candidates
// (repro_torch.kernels.matmul_q8.MMQ_TILES, same order).
#define MMQ_TILES(X)                                                       \
  X(32, 8) X(64, 8) X(128, 8) X(32, 16) X(64, 16) X(128, 16) X(32, 32)     \
  X(64, 32) X(128, 32) X(32, 64) X(64, 64)

template <int BN, int BM, bool W4>
struct QTile {
  static constexpr int NO = BN / 32;             // 32-column chunks
  static constexpr int NT = BM / 8;              // the mma's 8-token tiles
  static constexpr int WROWS = W4 ? QBK / 2 : QBK;   // staged rows of b
  static constexpr int WBYTES = WROWS * BN;
  static constexpr int ABYTES = BM * QAP;
  static constexpr int SBYTES = W4 ? QBK : 0;    // the stage's group shifts
  static constexpr int STAGE = WBYTES + ABYTES + SBYTES;
  // Warps a block, each with its own K stages, and stages in a warp's
  // ring, RING - 1 in flight. The decode tiles (BM <= 16) take 8 warps of
  // 4 stages: a warp's chain of stages is its latency (one warp a
  // scheduler leaves each load and transpose waiting), so twice the warps
  // with half the stages each; 4 stages hold a decode warp's share of the
  // weight. The taller tiles take 4 warps of 3 stages, so more blocks fit
  // an SM.
  static constexpr int WARPS = BM <= 16 ? 8 : 4;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int RING = BM <= 16 ? 4 : 3;
  static constexpr int RBYTES = RING * STAGE;    // one warp's ring
  static constexpr int RED = WARPS * BM * BN * 4;    // the warps' partials
  // the block's own bytes; a cluster's leader also takes an inbox of
  // (cs - 1) x BM x BN int32 partial tiles past them
  static constexpr int SMEM = WARPS * RBYTES > RED ? WARPS * RBYTES : RED;
  // the swizzle's row shift: the four rows one fragment load reads sit in
  // four distinct 32-byte octets of a 128-byte line (see stage_offset)
  static constexpr int SWZ = (W4 && NO >= 2) ? 1 : 2;
};

// Byte offset, in a stage, of byte `col` (0..BN-1) of staged row `r`: the
// stage is 32-byte octets, row-major, and the low two bits of an octet's
// index are xor'ed with (r >> SWZ) & 3. A fragment load reads one octet of
// each of four rows (int8: rows 4t + j, t = 0..3; W4: packed rows 2t + j),
// and the swizzle puts them in four distinct quarters of the banks. The
// xor changes only bits below the ones it is taken from, so it permutes
// octets within their 128-byte line.
template <int BN, int SWZ>
__device__ __forceinline__ int stage_offset(int r, int col) {
  const int oct = r * (BN / 32) + (col >> 5);
  return ((oct ^ ((r >> SWZ) & 3)) << 5) | (col & 31);
}

// Four rows of four bytes (r[j] = row j, byte i = column i) to four
// K-major words (c[i] = column i, byte j = row j).
__device__ __forceinline__ void transpose4x4(const uint32_t r[4],
                                             uint32_t c[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

// d += A (16 x 32 int8, row) * B (32 x 8 int8, col), int32 accumulators.
__device__ __forceinline__ void mma_s8(int* d, uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3,
                                       const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b[0]), "r"(b[1]));
}

template <int BN, int BM, bool W4>
__global__ void __launch_bounds__(QTile<BN, BM, W4>::THREADS) matmul_q_kernel(
    const int8_t* __restrict__ a, const int8_t* __restrict__ b,
    const int8_t* __restrict__ ws, int8_t* __restrict__ y, int m, int k,
    int n, int cs, int shift, int relu, int b_vec, int a_vec, int s_vec) {
  using Q = QTile<BN, BM, W4>;
  constexpr int NO = Q::NO, NT = Q::NT;
  extern __shared__ __align__(16) unsigned char qsm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;        // the mma's group, thread
  const int rank = (int)(blockIdx.x % cs);      // in the cluster (x-major)
  const int col0 = (int)(blockIdx.x / cs) * BN, row0 = blockIdx.y * BM;
  const int rows_b = W4 ? (k + 1) / 2 : k;
  // The K stages are dealt round-robin to the cs x WARPS warps of the
  // cluster: this warp takes stages q, q + nq, q + 2 nq, ...
  const int nst = (k + QBK - 1) / QBK;
  const int q = rank * Q::WARPS + warp, nq = cs * Q::WARPS;
  const int mine = nst > q ? (nst - q + nq - 1) / nq : 0;
  unsigned char* ring = qsm + warp * Q::RBYTES;

  // Stage the warp's i-th K stage into ring buffer `buf`: b's rows (int8:
  // 64, W4: 32 packed) x BN columns and a's BM rows x 64 in 16-byte
  // cp.async copies (the bytes past an edge zero-filled), the W4 group
  // shifts too; an operand not 16-byte aligned (or N, K off a multiple of
  // 16) is staged byte by byte instead. One commit group a stage.
  auto stage = [&](int i, int buf) {
    const int k0 = (q + i * nq) * QBK;
    const int r0 = W4 ? k0 / 2 : k0;
    unsigned char* sw = ring + buf * Q::STAGE;
    unsigned char* sa = sw + Q::WBYTES;
    constexpr int CPR = BN / 16;                // 16-byte chunks a row
    for (int e = lane; e < Q::WROWS * CPR; e += 32) {
      const int r = e / CPR, c = (e % CPR) * 16;
      const int gr = r0 + r, gc = col0 + c;
      unsigned char* dst = sw + stage_offset<BN, Q::SWZ>(r, c);
      if (b_vec) {
        const bool ok = gr < rows_b && gc < n;
        cp_async<16>(dst, ok ? (const void*)(b + gr * n + gc) : b,
                     ok ? 16 : 0);
      } else {
        uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int x = 0; x < 16; ++x)
          if (gr < rows_b && gc + x < n)
            v[x >> 2] |= (uint32_t)(uint8_t)b[gr * n + gc + x] << (8 * (x & 3));
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    for (int e = lane; e < BM * (QBK / 16); e += 32) {
      const int r = e / (QBK / 16), c = (e % (QBK / 16)) * 16;
      const int gr = row0 + r, gk = k0 + c;
      unsigned char* dst = sa + r * QAP + c;
      if (a_vec) {
        const bool ok = gr < m && gk < k;
        cp_async<16>(dst, ok ? (const void*)(a + gr * k + gk) : a,
                     ok ? 16 : 0);
      } else {
        uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int x = 0; x < 16; ++x)
          if (gr < m && gk + x < k)
            v[x >> 2] |= (uint32_t)(uint8_t)a[gr * k + gk + x] << (8 * (x & 3));
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    if constexpr (W4) {
      unsigned char* ss = sa + Q::ABYTES;
      if (s_vec) {
        if (lane < QBK / 16) {
          const int gk = k0 + lane * 16;
          cp_async<16>(ss + lane * 16, gk < k ? (const void*)(ws + gk) : ws,
                       gk < k ? 16 : 0);
        }
      } else {
        for (int e = lane; e < QBK; e += 32)
          ss[e] = k0 + e < k ? (unsigned char)ws[k0 + e] : 0;
      }
    }
    cp_async_commit();
  };

  int acc[NO][NT][8];
#pragma unroll
  for (int c = 0; c < NO; ++c)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int x = 0; x < 8; ++x) acc[c][j][x] = 0;

  // The sums of one stage. Thread (g, t) of the mma owns, in each 32-column
  // chunk c, columns 32c + 4g .. 32c + 4g + 3 and K groups t and 4 + t of
  // each 32-deep half: it reads their 4 x 4 byte blocks (W4: 2 packed rows
  // x 4, unpacked and shifted) as words and transposes them to K-major
  // words. The weights are the mma's A (its rows: output columns 32c + 4g
  // and + 1 in one mma, + 2 and + 3 in the other), a's rows its B (the
  // tokens: rows 8j + g, K-major as stored), so each 16 x 8 result is 16
  // output columns x 8 tokens.
  auto compute = [&](int buf) {
    const unsigned char* sw = ring + buf * Q::STAGE;
    const unsigned char* sa = sw + Q::WBYTES;
#pragma unroll
    for (int ks = 0; ks < QBK / 32; ++ks) {
      uint32_t bf[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const unsigned char* p = sa + (8 * j + g) * QAP + 32 * ks + 4 * t;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
      // W4: the group shifts of this thread's 2 x 4 K elements (K groups t
      // and 4 + t of the half) and their byte masks, once for every chunk
      uint32_t sh[2][4], keep[2][4];
      if constexpr (W4) {
        const unsigned char* ss = sa + Q::ABYTES + 32 * ks + 4 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t w = *reinterpret_cast<const uint32_t*>(ss + 16 * h);
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            sh[h][x] = (w >> (8 * x)) & 0xffu;
            keep[h][x] = w4_keep(sh[h][x]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < NO; ++c) {
        uint32_t fr[2][4];               // [K half][column 4g + i]
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t rw[4];                // [k of the group][column 4g + i]
          if constexpr (W4) {
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              const int r = 16 * ks + 8 * h + 2 * t + jj;
              const uint32_t pk = *reinterpret_cast<const uint32_t*>(
                  sw + stage_offset<BN, Q::SWZ>(r, 32 * c + 4 * g));
              rw[2 * jj] = w4_codes4(pk & 0x0f0f0f0fu, sh[h][2 * jj],
                                     keep[h][2 * jj]);
              rw[2 * jj + 1] = w4_codes4((pk >> 4) & 0x0f0f0f0fu,
                                         sh[h][2 * jj + 1],
                                         keep[h][2 * jj + 1]);
            }
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int r = 32 * ks + 16 * h + 4 * t + j;
              rw[j] = *reinterpret_cast<const uint32_t*>(
                  sw + stage_offset<BN, Q::SWZ>(r, 32 * c + 4 * g));
            }
          }
          transpose4x4(rw, fr[h]);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          mma_s8(&acc[c][j][0], fr[0][0], fr[0][1], fr[1][0], fr[1][1],
                 bf[j]);
          mma_s8(&acc[c][j][4], fr[0][2], fr[0][3], fr[1][2], fr[1][3],
                 bf[j]);
        }
      }
    }
  };

  // A ring of RING stages, RING - 1 in flight, private to the warp: each
  // iteration commits one copy group (empty past the warp's last stage), so
  // waiting until at most RING - 2 are pending means stage i has landed;
  // __syncwarp makes every lane's copies visible to the others, and the
  // buffer refilled at i was last read at i - 1, before that __syncwarp.
  constexpr int RING = Q::RING;
#pragma unroll
  for (int i = 0; i < RING - 1; ++i) {
    if (i < mine) stage(i, i);
    else cp_async_commit();
  }
  for (int i = 0; i < mine; ++i) {
    cp_async_wait<RING - 2>();
    __syncwarp();
    if (i + RING - 1 < mine) stage(i + RING - 1, (i + RING - 1) % RING);
    else cp_async_commit();
    compute(i % RING);
  }
  cp_async_wait<0>();

  // The K reduction, on chip: each warp's partial tile into shared memory
  // (over the rings, once every warp is done), summed over the block's
  // warps; a cluster's other blocks store their sums into the leader's
  // inbox (distributed shared memory, past the leader's rings, so they may
  // land while it still computes) and arrive at one cluster barrier, whose
  // release / acquire orders those stores before the leader's reads; the
  // leader adds them, applies the epilogue and stores int8.
  __syncthreads();
  int* red = reinterpret_cast<int*>(qsm);
  {
    int* mine_red = red + warp * BM * BN;
#pragma unroll
    for (int c = 0; c < NO; ++c)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        int* p = mine_red + (8 * j + 2 * t) * BN + 32 * c + 4 * g;
        const int* d = acc[c][j];
        *reinterpret_cast<int4*>(p) = make_int4(d[0], d[2], d[4], d[6]);
        *reinterpret_cast<int4*>(p + BN) = make_int4(d[1], d[3], d[5], d[7]);
      }
  }
  __syncthreads();
  constexpr int E = BM * BN;
  int* inbox = reinterpret_cast<int*>(qsm + Q::SMEM);
  cg::cluster_group cluster = cg::this_cluster();
  if (rank > 0) {
    int* dst = cluster.map_shared_rank(inbox, 0) + (rank - 1) * E;
    for (int e = threadIdx.x; e < E; e += Q::THREADS) {
      int s = red[e];
#pragma unroll
      for (int w = 1; w < Q::WARPS; ++w) s += red[w * E + e];
      dst[e] = s;
    }
    cluster.sync();
    return;
  }
  constexpr int PER = (E + Q::THREADS - 1) / Q::THREADS;
  int sums[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = i * Q::THREADS + threadIdx.x;
    int s = 0;
    if (e < E) {
      s = red[e];
#pragma unroll
      for (int w = 1; w < Q::WARPS; ++w) s += red[w * E + e];
    }
    sums[i] = s;
  }
  if (cs > 1) cluster.sync();
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = i * Q::THREADS + threadIdx.x;
    if (e >= E) break;
    int s = sums[i];
    for (int r = 0; r < cs - 1; ++r) s += inbox[r * E + e];
    const int gr = row0 + e / BN, gc = col0 + e % BN;
    if (gr < m && gc < n) y[gr * n + gc] = requant_epilogue(s, relu, shift);
  }
}

// The launch of one integer tile: plan[0..6] = grid x, grid y, cluster
// size, threads, dynamic shared bytes, K stages of the busiest warp, stages
// in a warp's ring (what repro_torch.kernels.matmul_q8.mmq_plan computes);
// with `plan` non-null nothing is launched.
template <int BN, int BM, bool W4>
int launch_q(const void* a, const void* b, const void* ws, void* y, int m,
             int k, int n, int cs, int shift, int relu, cudaStream_t st,
             int* plan) {
  using Q = QTile<BN, BM, W4>;
  if (cs != 1 && cs != 2 && cs != 4 && cs != 8)
    return (int)cudaErrorInvalidValue;
  const int gx = (n + BN - 1) / BN * cs, gy = (m + BM - 1) / BM;
  const int smem = Q::SMEM + (cs - 1) * BM * BN * 4;
  if (plan != nullptr) {
    const int nst = (k + QBK - 1) / QBK;
    plan[0] = gx, plan[1] = gy, plan[2] = cs, plan[3] = Q::THREADS,
    plan[4] = smem, plan[5] = (nst + cs * Q::WARPS - 1) / (cs * Q::WARPS),
    plan[6] = Q::RING;
    return (int)cudaSuccess;
  }
  if (m == 0 || n == 0) return (int)cudaSuccess;
  auto kern = matmul_q_kernel<BN, BM, W4>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int b_vec = n % 16 == 0 && (uintptr_t)b % 16 == 0;
  const int a_vec = k % 16 == 0 && (uintptr_t)a % 16 == 0;
  const int s_vec = k % 16 == 0 && (uintptr_t)ws % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(gx, gy);
  cfg.blockDim = dim3(Q::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, (const int8_t*)a, (const int8_t*)b, (const int8_t*)ws,
      (int8_t*)y, m, k, n, cs, shift, relu, b_vec, a_vec, s_vec);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Dispatch on (bn, bm) to the instantiated tile; `plan` non-null asks for
// the launch arithmetic only.
template <bool W4>
int dispatch_q(const void* a, const void* b, const void* ws, void* y, int m,
               int k, int n, int bn, int bm, int cs, int shift, int relu,
               cudaStream_t st, int* plan) {
#define MMQ_CASE(BN, BM)                                                  \
  if (bn == BN && bm == BM)                                               \
    return launch_q<BN, BM, W4>(a, b, ws, y, m, k, n, cs, shift, relu, st, \
                                plan);
  MMQ_TILES(MMQ_CASE)
#undef MMQ_CASE
  return (int)cudaErrorInvalidValue;
}
}  // namespace

// (bn, bm) must be one of MMQ_TILES and cluster 1, 2, 4 or 8.
extern "C" int repro_matmul_q8(const void* a, const void* b, void* y, int m,
                               int k, int n, int bn, int bm, int cluster,
                               int shift, int relu, void* stream) {
  return dispatch_q<false>(a, b, nullptr, y, m, k, n, bn, bm, cluster, shift,
                           relu, (cudaStream_t)stream, nullptr);
}

extern "C" int repro_matmul_w4(const void* a, const void* b, const void* ws,
                               void* y, int m, int k, int n, int bn, int bm,
                               int cluster, int shift, int relu,
                               void* stream) {
  return dispatch_q<true>(a, b, ws, y, m, k, n, bn, bm, cluster, shift, relu,
                          (cudaStream_t)stream, nullptr);
}

// The integer modes' launch arithmetic for (m, k, n) and a tile and cluster
// size: plan[0..6] = grid x, grid y, cluster size, threads, shared bytes,
// K stages of the busiest warp, stages in a warp's ring; w4: 0 int8, 1 W4.
// Nothing is launched.
extern "C" int repro_matmul_q8_plan(int* plan, int m, int k, int n, int bn,
                                    int bm, int cluster, int w4) {
  if (w4)
    return dispatch_q<true>(nullptr, nullptr, nullptr, nullptr, m, k, n, bn,
                            bm, cluster, 0, 0, nullptr, plan);
  return dispatch_q<false>(nullptr, nullptr, nullptr, nullptr, m, k, n, bn,
                           bm, cluster, 0, 0, nullptr, plan);
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
