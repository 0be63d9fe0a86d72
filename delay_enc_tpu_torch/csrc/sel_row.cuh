// The per-pair body of the selector kernel (csrc/msm.cu pair_sel_kernel).
//
// Scalar i of a commitment is cut into digits of DB bits (DB = 2: base 4,
// 127 planes; DB = 4: base 16, 64 planes), least significant first.  The
// pair of scalars (2i, 2i + 1) gives, in plane p, the selector byte
//     d_even + 2^DB * d_odd,
// the option of the pair table that the plane-sum kernels read for lane i.
// Only the 254 bits of a scalar count: the last base-16 plane takes bits 252
// and 253 (bits 254 and 255 of a canonical scalar are zero, and are masked
// here as the JAX package pads them with zeros).  A digit never crosses a
// word, since DB divides 32.
//
// The functions are __host__ __device__, so a host C++ compiler can build
// them and run the pairs one after another.

#pragma once
#include <stddef.h>

#include "field.cuh"

namespace psel {

constexpr uint32_t SCALAR_BITS = 254;

template <uint32_t DB>
FDEV constexpr uint32_t planes() {
  return (SCALAR_BITS + DB - 1) / DB;
}

// the DB-bit digit of plane p of the 8-word scalar s, bits past 253 masked
template <uint32_t DB>
FDEV uint32_t digit(const uint32_t* s, uint32_t p) {
  const uint32_t bit = p * DB;
  const uint32_t width = SCALAR_BITS - bit < DB ? SCALAR_BITS - bit : DB;
  return (s[bit >> 5] >> (bit & 31u)) & ((1u << width) - 1u);
}

// out[p * stride] = the selector of plane p for the scalars e and o
template <uint32_t DB>
FDEV void pair_sel_row(const uint32_t* e, const uint32_t* o, uint8_t* out, size_t stride) {
#pragma unroll
  for (uint32_t p = 0; p < planes<DB>(); p++) {
    out[p * stride] = (uint8_t)(digit<DB>(e, p) | (digit<DB>(o, p) << DB));
  }
}

}  // namespace psel
