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

// Four W4 codes at once: `nibbles` holds one int4 code in the low half of
// each byte (the high halves zero), all four at one K element, so they take
// one group shift; `keep` is w4_keep(shift). Returns the four int8 weights
// w4_code gives, byte for byte: each nibble sign-extended to a byte (bit 3
// of each byte times 0xf0, or'ed in: the product of a 0/1 byte and 0xf0
// cannot carry into the next byte), then shifted left within its byte (the
// bits a byte pushes into the next one masked off by `keep`).
static __device__ __forceinline__ uint32_t w4_codes4(uint32_t nibbles,
                                                     uint32_t shift,
                                                     uint32_t keep) {
  const uint32_t q = nibbles | (((nibbles >> 3) & 0x01010101u) * 0xf0u);
  return (q << (shift & 31)) & keep;
}

// The bytes of a left shift by `shift` (0..31, as w4_code takes it mod 32)
// that stay in their byte, in all four bytes; none from 8 on, as
// (int8)(q4 << shift) keeps none.
static __device__ __forceinline__ uint32_t w4_keep(uint32_t shift) {
  shift &= 31;
  return shift >= 8 ? 0u : 0x01010101u * ((0xffu << shift) & 0xffu);
}
