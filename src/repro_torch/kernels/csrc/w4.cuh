// In-register unpack of a W4 weight code, shared by the W4 kernel modes.
//
// A W4 weight tensor holds two two's-complement int4 codes per byte along its
// packed axis: element 2i in the low nibble of byte i, element 2i+1 in the
// high nibble (repro_torch.core.quantize.pack_w4). Each element also has a
// group shift s in [0, 4] that brings its code to the tensor's base scale.
// w4_code returns the int8 weight the int8 kernel body would have read:
// (int8)(q4 << s), bitwise the same as expand_w4 (sign extension by the
// int32 shift pair (v << 28) >> 28 / (v << 24) >> 28, then the cast to int8).
// The left shifts go through uint32_t: a left shift of a negative value is
// undefined in C++.
#pragma once
#include <cstdint>

static __device__ __forceinline__ int32_t w4_code(int8_t byte, int high,
                                                  int8_t shift) {
  const uint32_t v = (uint32_t)(int32_t)byte;
  const int32_t q4 = (int32_t)(v << (high ? 24 : 28)) >> 28;
  return (int32_t)(int8_t)((uint32_t)q4 << (shift & 31));
}
