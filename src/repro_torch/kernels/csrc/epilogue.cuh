// Algorithm-1 epilogue shared by the int8 conv kernels: relu at accumulator
// scale, round-to-nearest arithmetic shift to the output scale, clip to int8.
// Bitwise the same as repro_torch.kernels.common.apply_act + apply_requant
// (and repro/kernels/common.py on the TPU side).
//
// Signed overflow and a left shift of a negative value are undefined in C++,
// so the bias add, the rounding add and the left shift go through uint32_t
// and are cast back: the result wraps exactly as int32 does in PyTorch and
// in JAX. The wrapper keeps |shift| <= 31.
#pragma once
#include <cstdint>

static __device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

static __device__ __forceinline__ int8_t requant_epilogue(int32_t acc, int relu,
                                                   int shift) {
  if (relu && acc < 0) acc = 0;
  if (shift > 0) {
    // arithmetic right shift of a signed int32 (two's complement, nvcc)
    acc = wrap_add(acc, (int32_t)(1u << (shift - 1))) >> shift;
  } else if (shift < 0) {
    acc = (int32_t)((uint32_t)acc << (-shift));
  }
  acc = acc < -128 ? -128 : (acc > 127 ? 127 : acc);
  return (int8_t)acc;
}
