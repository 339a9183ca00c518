// float32 / bfloat16 element access for the float kernel modes: every float
// mode reads its operands into float32, sums in float32 and rounds ONCE to
// the output's type on the store (__float2bfloat16_rn for bfloat16).
// Products and sums go through __fmul_rn / __fadd_rn / __fsub_rn in the
// kernels, so nvcc cannot contract them into FMAs and the plain PyTorch
// versions (separate float32 multiplies and adds, in the kernels' order)
// stay bitwise equal to them.
#pragma once
#include <cuda_bf16.h>

static __device__ __forceinline__ float load_f32(const float* p) { return *p; }
static __device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
static __device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
static __device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
