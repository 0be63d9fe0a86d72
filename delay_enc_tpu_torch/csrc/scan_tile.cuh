// The per-thread body of the scan kernel (csrc/scan.cu).
//
// A row of n elements is scanned in tiles of THREADS * ITEMS elements.  In
// scan order, element j of a row lies at index j, or at n - 1 - j for a
// reverse scan.  Thread `tid` of the block that holds tile t owns the ITEMS
// elements from base = (t * THREADS + tid) * ITEMS on; elements from n on
// count as the identity and are never stored.
//
//   thread_load   reads the thread's elements and leaves in x[j] the
//                 combination of x[0..j]; x[ITEMS - 1] is the thread's total.
//   thread_store  takes `pre`, the combination of everything before the
//                 thread's first element, and writes pre * x[j] (inclusive)
//                 or pre * x[j - 1] (exclusive; pre itself for j = 0).
//
// Between the two the kernel scans the threads' totals across the block
// with warp shuffles.  The functions are __host__ __device__, so a host C++
// compiler can build them and do that step with a plain loop.

#pragma once
#include <stddef.h>

#include "field.cuh"

namespace scan {

enum { OP_MUL = 0, OP_ADD = 1 };
enum { EXCLUSIVE = 1, REVERSE = 2, CONSTANT = 4 };  // flag bits
constexpr int ITEMS = 4;

using fld::ld8;
using fld::st8;

// the operator's identity: Montgomery 1 for the product, 0 for the sum
template <int F, int OP>
FDEV void identity(uint32_t r[8]) {
#pragma unroll
  for (int j = 0; j < 8; j++) r[j] = OP == OP_MUL ? fld::onew<F>(j) : 0u;
}

template <int F, int OP>
FDEV void combine(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  if (OP == OP_MUL) {
    fld::mont_mul<F>(r, a, b);
  } else {
    fld::add<F>(r, a, b);
  }
}

// index in the row of element j in scan order
FDEV size_t place(uint32_t j, uint32_t n, uint32_t flags) {
  return (flags & REVERSE) ? (size_t)(n - 1u - j) : (size_t)j;
}

template <int F, int OP>
FDEV void thread_load(uint32_t x[ITEMS][8], const uint32_t* in_row, uint32_t n,
                      uint32_t base, uint32_t flags) {
#pragma unroll
  for (int j = 0; j < ITEMS; j++) {
    if (base < n && (uint32_t)j < n - base) {
      // a constant input is one element, read for every index
      ld8(x[j], (flags & CONSTANT) ? in_row : in_row + place(base + j, n, flags) * 8);
    } else {
      identity<F, OP>(x[j]);
    }
    if (j > 0) combine<F, OP>(x[j], x[j - 1], x[j]);
  }
}

template <int F, int OP>
FDEV void thread_store(const uint32_t x[ITEMS][8], const uint32_t pre[8],
                       uint32_t* out_row, uint32_t n, uint32_t base, uint32_t flags) {
#pragma unroll
  for (int j = 0; j < ITEMS; j++) {
    if (base >= n || (uint32_t)j >= n - base) return;
    uint32_t v[8];
    if (flags & EXCLUSIVE) {
      if (j == 0) {
        fld::copy(v, pre);
      } else {
        combine<F, OP>(v, pre, x[j - 1]);
      }
    } else {
      combine<F, OP>(v, pre, x[j]);
    }
    st8(out_row + place(base + j, n, flags) * 8, v);
  }
}

}  // namespace scan
