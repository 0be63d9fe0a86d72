// The per-tile body of K-b, the multi-stage NTT (csrc/ntt.cu).
//
// A transform of length n = 2^log_n is a few passes.  A pass runs the s
// radix-2 stages t0 .. t0 + s - 1 of the natural-order (Stockham) DIF
// transform on tiles held in shared memory.  Before stage t0 the row is
// viewed as (S, L, m) with S = 2^s, m = 2^t0 and L = n / (S m): element
// (q, r, k) lies at index (q L + r) m + k.  The s stages combine only the
// S elements that share (r, k), and leave result c of them at index
// (r S + c) m + k.  A block takes the C = 2^c_log neighbouring values
// g = r m + k that start at g0 = group * C: a tile of T = S * C elements,
// local row q and column cc at position q * C + cc.
//
// Inside the tile the stages are the in-place DIF butterflies: local stage u
// pairs the rows i and i + half (half = S >> (u + 1)) inside each aligned
// group of 2 half rows,
//     a' = a + b,    b' = w^((i L + r) m 2^u) * (a - b),
// the same twiddle exponent as stage t0 + u of the one-stage-a-launch form.
// That leaves result c in local row bitrev_s(c); the store reads it from
// there, so no pass and no launch is spent on reordering.
//
// The functions are __host__ __device__ and take the thread's index and the
// number of threads, so a host C++ compiler can build them and run the
// "threads" one after another: within one phase no two threads touch the
// same position.  The kernel puts __syncthreads() between the phases.

#pragma once
#include <stddef.h>

#include "field.cuh"

namespace ntt {

enum { OUT_NONE = 0, OUT_CONST = 1, OUT_TABLE = 2 };

struct Pass {
  uint32_t log_n;     // the transform's length is 2^log_n
  uint32_t t0;        // first stage of the pass
  uint32_t s;         // stages of the pass
  uint32_t c_log;     // log2 of the columns a tile holds
  uint32_t n_in;      // elements a source row holds; indices from n_in on read as zero
  uint32_t nz;        // local rows from nz on are zero padding (S when there is none)
  uint32_t out_mode;  // what the store multiplies by: nothing, one constant, a table entry
};

using fld::ld8;
using fld::st8;

// Shared memory holds the tile as eight word planes, so that neighbouring
// positions fall into neighbouring banks whatever word is read.  A position
// is skewed by one word for every 32 and for every 1024 positions, so that
// the bit-reversed rows the store reads also spread over the banks.
FDEV uint32_t skew(uint32_t pos) { return pos + (pos >> 5) + (pos >> 10); }

// words one plane takes for a tile of T positions
FDEV uint32_t plane_words(uint32_t T) { return skew(T - 1) + 1; }

FDEV void sm_get(uint32_t r[8], const uint32_t* sm, uint32_t plane, uint32_t pos) {
  const uint32_t at = skew(pos);
#pragma unroll
  for (int j = 0; j < 8; j++) r[j] = sm[j * plane + at];
}

FDEV void sm_put(uint32_t* sm, uint32_t plane, uint32_t pos, const uint32_t r[8]) {
  const uint32_t at = skew(pos);
#pragma unroll
  for (int j = 0; j < 8; j++) sm[j * plane + at] = r[j];
}

FDEV uint32_t bitrev(uint32_t x, uint32_t bits) {
#ifdef __CUDA_ARCH__
  return bits ? __brev(x) >> (32 - bits) : 0u;
#else
  uint32_t r = 0;
  for (uint32_t j = 0; j < bits; j++) r |= ((x >> j) & 1u) << (bits - 1 - j);
  return r;
#endif
}

// Phase 1: the tile's elements come in, C neighbours at a time; the input
// table, where there is one, is multiplied in, and what lies beyond the
// source row is zero.
FDEV void tile_load(const Pass& P, uint32_t group, uint32_t tid, uint32_t nth,
                    uint32_t* sm, const uint32_t* src_row, const uint32_t* in_tab) {
  const uint32_t T = 1u << (P.s + P.c_log), plane = plane_words(T);
  const uint32_t cmask = (1u << P.c_log) - 1u;
  const uint32_t log_lm = P.log_n - P.s, g0 = group << P.c_log;
  for (uint32_t e = tid; e < T; e += nth) {
    const uint32_t idx = ((e >> P.c_log) << log_lm) + g0 + (e & cmask);
    uint32_t v[8];
    if (idx < P.n_in) {
      ld8(v, src_row + (size_t)idx * 8);
      if (in_tab != nullptr) {
        uint32_t w[8];
        ld8(w, in_tab + (size_t)idx * 8);
        fld::mont_mul<fld::FR>(v, v, w);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; j++) v[j] = 0u;
    }
    sm_put(sm, plane, e, v);
  }
}

// Phase 2, once for each local stage u.  While half >= nz the upper operand
// of every butterfly is padding: rows i >= nz have nothing to do, and the
// others need the product alone (a' = a stays where it is).
FDEV void tile_stage(const Pass& P, uint32_t u, uint32_t group, uint32_t tid,
                     uint32_t nth, uint32_t* sm, const uint32_t* tw) {
  const uint32_t T = 1u << (P.s + P.c_log), plane = plane_words(T);
  const uint32_t cmask = (1u << P.c_log) - 1u;
  const uint32_t log_lm = P.log_n - P.s, g0 = group << P.c_log;
  const uint32_t half_log = P.s - 1u - u, half = 1u << half_log;
  const bool padded = half >= P.nz;
  for (uint32_t b = tid; b < (T >> 1); b += nth) {
    const uint32_t cc = b & cmask, t = b >> P.c_log;
    const uint32_t i = t & (half - 1u), blk = t >> half_log;
    if (padded && i >= P.nz) continue;
    const uint32_t pa = (((blk << (half_log + 1u)) + i) << P.c_log) + cc;
    const uint32_t pb = pa + (half << P.c_log);
    const uint32_t r = (g0 + cc) >> P.t0;
    const uint32_t ex = ((i << (log_lm - P.t0)) + r) << (P.t0 + u);
    uint32_t x[8], y[8], w[8];
    sm_get(x, sm, plane, pa);
    ld8(w, tw + (size_t)ex * 8);
    if (padded) {
      fld::mont_mul<fld::FR>(y, w, x);
      sm_put(sm, plane, pb, y);
    } else {
      uint32_t d[8];
      sm_get(y, sm, plane, pb);
      fld::sub<fld::FR>(d, x, y);
      fld::add<fld::FR>(x, x, y);
      fld::mont_mul<fld::FR>(d, w, d);
      sm_put(sm, plane, pa, x);
      sm_put(sm, plane, pb, d);
    }
  }
}

// Phase 3: result c of column (r, k) goes out to index (r S + c) m + k.
// Threads walk k fastest (as far as a tile's columns share r), then c, so
// that neighbouring threads write neighbouring elements.
FDEV void tile_store(const Pass& P, uint32_t group, uint32_t tid, uint32_t nth,
                     const uint32_t* sm, uint32_t* dst_row, const uint32_t* out_tab) {
  const uint32_t T = 1u << (P.s + P.c_log), plane = plane_words(T);
  const uint32_t g0 = group << P.c_log;
  const uint32_t ck_log = P.c_log < P.t0 ? P.c_log : P.t0;
  const uint32_t kmask = (1u << ck_log) - 1u, smask = (1u << P.s) - 1u;
  const uint32_t mmask = (1u << P.t0) - 1u;
  uint32_t scale[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
  if (P.out_mode == OUT_CONST) ld8(scale, out_tab);
  for (uint32_t e = tid; e < T; e += nth) {
    const uint32_t kl = e & kmask, c = (e >> ck_log) & smask, rl = e >> (ck_log + P.s);
    const uint32_t cc = (rl << ck_log) + kl, g = g0 + cc;
    const uint32_t out = ((((g >> P.t0) << P.s) + c) << P.t0) + (g & mmask);
    uint32_t v[8];
    sm_get(v, sm, plane, (bitrev(c, P.s) << P.c_log) + cc);
    if (P.out_mode == OUT_TABLE) ld8(scale, out_tab + (size_t)out * 8);
    if (P.out_mode != OUT_NONE) fld::mont_mul<fld::FR>(v, v, scale);
    st8(dst_row + (size_t)out * 8, v);
  }
}

}  // namespace ntt
