// The bodies of K7, the openings' two contractions (csrc/open.cu), over a
// table of coefficient rows of up to MAX_POINTS points:
//
//   eval:     out[j] = sum_i c_j[i] x_s^i for every row j, where s is row j's
//             point (plonk/kernels.py _eval_stack);
//   combine:  out[s][i] = z_s^i sum_j v^j c_{s,j}[i], where c_{s,j} is the
//             j-th row of point s (plonk/kernels.py _gwc_witness: the
//             v-weighted sum of its stack, times z^i as divide_by_linear
//             takes it).
//
// The rows are given one address each, so the stacks are never copied
// together.  A launch takes one table an instance (`Tables`), the instance
// from the grid's z; each table's eval partials and tickets lie in its own
// scratch.  An eval block sums one EVAL_CHUNK of one row, each thread every
// EVAL_THREADS-th element of it (`eval_thread`); a combine thread owns one
// column i of one point (`combine_column`).  Sums mod r are exact, so the
// order of the additions does not change a word.  The functions are
// __host__ __device__, so that a host C++ compiler can build them
// (tests/test_torch_open.py), with the block's add tree as a loop.

#pragma once
#include <stddef.h>

#include "field.cuh"

namespace opening {

constexpr int MAX_ROWS = 64;
constexpr int MAX_POINTS = 4;
constexpr unsigned EVAL_THREADS = 256;
constexpr unsigned EVAL_CHUNK = EVAL_THREADS * 16;  // elements of a row one eval block sums

// Filled by the wrapper (plonk/kernels.py _OpenTable, the same layout) and
// passed by value.
struct Table {
  uint64_t row[MAX_ROWS];          // address of each coefficient row: n elements
  uint64_t pows[MAX_POINTS];       // address of each point's powers: n or more
  uint64_t vpows;                  // combine: v^0, v^1, ..., one a row of the largest stack
  uint64_t out;                    // eval: (rows, 8); combine: (points, n, 8)
  uint64_t scratch;                // eval: (rows, chunks, 8) partial sums, a counter a row
  uint32_t first[MAX_POINTS + 1];  // the rows of point s: first[s] .. first[s + 1] - 1
  uint32_t points, n;
};

// Tables one launch takes, one an instance of the batched prover (each with
// its own rows, points, powers of v, output and scratch), by value in one
// kernel parameter of MAX_TABLES tables (above 4 KB: CUDA 12.1 on sm_70 or
// later).  The wrapper splits a larger batch.
constexpr int MAX_TABLES = 16;
struct Tables {
  Table t[MAX_TABLES];
};

FDEV const uint32_t* at(uint64_t address) {
  return reinterpret_cast<const uint32_t*>(static_cast<uintptr_t>(address));
}

FDEV uint32_t rows(const Table& t) { return t.first[t.points]; }

FDEV uint32_t chunks(const Table& t) { return (t.n + EVAL_CHUNK - 1) / EVAL_CHUNK; }

FDEV int point_of(const Table& t, uint32_t r) {
  int s = 0;
  while (r >= t.first[s + 1]) s++;
  return s;
}

FDEV void zero(uint32_t r[8]) {
#pragma unroll
  for (int j = 0; j < 8; j++) r[j] = 0;
}

// eval: the sum thread tid of the block for `chunk` of row r makes
FDEV void eval_thread(uint32_t acc[8], const Table& t, uint32_t r, uint32_t chunk,
                      uint32_t tid) {
  const uint32_t* c = at(t.row[r]);
  const uint32_t* x = at(t.pows[point_of(t, r)]);
  const size_t lo = (size_t)chunk * EVAL_CHUNK;
  const size_t hi = lo + EVAL_CHUNK < t.n ? lo + EVAL_CHUNK : t.n;
  zero(acc);
  for (size_t i = lo + tid; i < hi; i += EVAL_THREADS) {
    uint32_t a[8], b[8];
    fld::ld8(a, c + i * 8);
    fld::ld8(b, x + i * 8);
    fld::mont_mul<fld::FR>(a, a, b);
    fld::add<fld::FR>(acc, acc, a);
  }
}

// combine: column i of point s; vp holds v^0, v^1, ... (8 words each)
FDEV void combine_column(uint32_t out[8], const Table& t, int s, size_t i, const uint32_t* vp) {
  uint32_t acc[8];
  zero(acc);
  for (uint32_t r = t.first[s]; r < t.first[s + 1]; r++) {
    uint32_t a[8], v[8];
    fld::ld8(a, at(t.row[r]) + i * 8);
    fld::ld8(v, vp + (size_t)(r - t.first[s]) * 8);
    fld::mont_mul<fld::FR>(a, a, v);
    fld::add<fld::FR>(acc, acc, a);
  }
  uint32_t z[8];
  fld::ld8(z, at(t.pows[s]) + i * 8);
  fld::mont_mul<fld::FR>(out, acc, z);
}

}  // namespace opening
