// The per-row body of the grand-product fractions kernel (csrc/fracs.cu),
// and what it shares with the quotient's row body (csrc/quotient_row.cuh).
//
// Row i of the row domain gives the numerator and the denominator of each
// of the five grand products: the permutation over the five advice columns
// and the instance column,
//     num = prod_c (col_c + beta delta_c omega^i + gamma),
//     den = prod_c (col_c + beta sigma_c + gamma),
// and the lookup of each tagged wire l,
//     num = (A_l + beta) (S + gamma),   den = (A'_l + beta) (S'_l + gamma),
// with the compressed input A_l = tag_l + theta tag_l adv_l and table
// S = table_tag + theta table_tag table_value.  Rows from `usable` on are
// one in all ten outputs (the grand products skip them).  Each value is one
// reduced field element, so any order of the products gives the words of
// the JAX package.
//
// A launch can serve several instances of one circuit (the batched prover):
// each has its own witness columns and challenges, the key's rows, sigma and
// omega are shared.  `fracs_instance` moves the per-instance pointers to
// instance b of (B, ...) stacks; the row body is the same for every instance.
//
// The functions are __host__ __device__, so a host C++ compiler can build
// them and run the rows one after another.  The loops over columns are kept
// rolled: a Montgomery product is a few hundred instructions, and the
// kernels' code has to stay small enough for the instruction caches.

#pragma once
#include <stddef.h>

#include "field.cuh"

namespace prow {

using fld::FR;
using fld::NW;

// The challenge words both kernels take by value and keep in shared
// memory: Montgomery words of theta, beta, gamma, y, delta^0..5 and
// beta delta^0..5 (plonk/kernels.py challenge_words makes the same rows).
enum { C_THETA = 0, C_BETA = 1, C_GAMMA = 2, C_Y = 3, C_DELTA = 4, C_BETA_DELTA = 10, NCONST = 16 };
struct Consts {
  uint32_t w[NCONST][NW];
};

// Instances one launch of K5 or K6 takes: their challenge blocks go by value
// as one kernel parameter of MAX_INSTANCES * 512 bytes (parameters above 4 KB
// need CUDA 12.1 on sm_70 or later).  The wrappers split a larger batch.
constexpr int MAX_INSTANCES = 16;
struct Batch {
  Consts c[MAX_INSTANCES];
};

constexpr int PERM_COLS = 6;  // 5 advice columns and the instance column
constexpr int LOOKUPS = 4;    // wires a, b, c, d, each against the table

// rows of the key's (24, n, 8) stacks (plonk/keygen.py KEY_ROWS)
enum {
  K_Q_A = 0, K_Q_B, K_Q_C, K_Q_D, K_Q_E, K_Q_MUL_AB, K_Q_MUL_CD, K_Q_E_NEXT, K_Q_CONSTANT,
  K_TAG = 9, K_TABLE_TAG = 13, K_TABLE_VALUE = 14, K_SIGMA = 15, K_L0 = 21, K_L_LAST = 22,
  K_L_BLIND = 23, KEY_ROWS = 24
};

// element `row` of column `col` of a (cols, n, 8) stack
FDEV const uint32_t* at(const uint32_t* stack, int col, size_t n, size_t row) {
  return stack + ((size_t)col * n + row) * NW;
}

FDEV void one(uint32_t r[NW]) {
#pragma unroll
  for (int j = 0; j < NW; j++) r[j] = fld::onew<FR>(j);
}

// r = tag + theta * tag * v (the lookup compression)
FDEV void compress(uint32_t r[NW], const uint32_t tag[NW], const uint32_t v[NW],
                   const uint32_t theta[NW]) {
  uint32_t t[NW];
  fld::mont_mul<FR>(t, tag, v);
  fld::mont_mul<FR>(t, theta, t);
  fld::add<FR>(r, tag, t);
}

// r = col + a * b + gamma (a factor of the permutation's products)
FDEV void perm_factor(uint32_t r[NW], const uint32_t col[NW], const uint32_t a[NW],
                      const uint32_t b[NW], const uint32_t gamma[NW]) {
  uint32_t t[NW];
  fld::mont_mul<FR>(t, a, b);
  fld::add<FR>(t, col, t);
  fld::add<FR>(r, t, gamma);
}

// r = (a + beta) * (s + gamma)
FDEV void lookup_factor(uint32_t r[NW], const uint32_t a[NW], const uint32_t s[NW],
                        const Consts& c) {
  uint32_t t[NW], u[NW];
  fld::add<FR>(t, a, c.w[C_BETA]);
  fld::add<FR>(u, s, c.w[C_GAMMA]);
  fld::mont_mul<FR>(r, t, u);
}

// The inputs of the fractions kernel, each a (rows, n, 8) stack of row
// evaluations: the 5 advice columns and the instance column; the 6 sigmas;
// omega^i; the key's raw stack (only the tags and the table are read); the
// permuted lookup columns A'_a..d then S'_a..d.  num and den are (5, n, 8):
// the permutation, then the lookups a..d.
struct FracsIn {
  const uint32_t* raw6;
  const uint32_t* sigma;
  const uint32_t* omega;
  const uint32_t* key_raw;
  const uint32_t* lk;
  uint32_t* num;
  uint32_t* den;
  size_t n;
  size_t usable;
};

// in's per-instance stacks moved to instance b: raw6 (B, 6, n, 8), lk
// (B, 8, n, 8), num and den (B, 5, n, 8); sigma, omega and the key shared
FDEV FracsIn fracs_instance(const FracsIn& in, size_t b) {
  const size_t col = in.n * NW;
  FracsIn r = in;
  r.raw6 += b * PERM_COLS * col;
  r.lk += b * 2 * LOOKUPS * col;
  r.num += b * (1 + LOOKUPS) * col;
  r.den += b * (1 + LOOKUPS) * col;
  return r;
}

FDEV void fracs_row(size_t i, const FracsIn& in, const Consts& c) {
  const size_t n = in.n;
  uint32_t nu[NW], de[NW], x[NW], col[NW], f[NW];
  if (i >= in.usable) {
    one(nu);
#pragma unroll 1
    for (int g = 0; g < 1 + LOOKUPS; g++) {
      fld::st8(in.num + ((size_t)g * n + i) * NW, nu);
      fld::st8(in.den + ((size_t)g * n + i) * NW, nu);
    }
    return;
  }
  // the permutation
  fld::ld8(x, in.omega + i * NW);
#pragma unroll 1
  for (int k = 0; k < PERM_COLS; k++) {
    fld::ld8(col, at(in.raw6, k, n, i));
    perm_factor(f, col, c.w[C_BETA_DELTA + k], x, c.w[C_GAMMA]);
    if (k == 0) {
      fld::copy(nu, f);
    } else {
      fld::mont_mul<FR>(nu, nu, f);
    }
    uint32_t sig[NW];
    fld::ld8(sig, at(in.sigma, k, n, i));
    perm_factor(f, col, c.w[C_BETA], sig, c.w[C_GAMMA]);
    if (k == 0) {
      fld::copy(de, f);
    } else {
      fld::mont_mul<FR>(de, de, f);
    }
  }
  fld::st8(in.num + i * NW, nu);
  fld::st8(in.den + i * NW, de);
  // the lookups: the table's compressed value is shared by all four
  uint32_t s[NW];
  fld::ld8(x, at(in.key_raw, K_TABLE_TAG, n, i));
  fld::ld8(col, at(in.key_raw, K_TABLE_VALUE, n, i));
  compress(s, x, col, c.w[C_THETA]);
#pragma unroll 1
  for (int l = 0; l < LOOKUPS; l++) {
    fld::ld8(x, at(in.key_raw, K_TAG + l, n, i));
    fld::ld8(col, at(in.raw6, l, n, i));
    compress(f, x, col, c.w[C_THETA]);
    lookup_factor(nu, f, s, c);
    fld::ld8(x, at(in.lk, l, n, i));
    fld::ld8(col, at(in.lk, LOOKUPS + l, n, i));
    lookup_factor(de, x, col, c);
    fld::st8(in.num + ((size_t)(1 + l) * n + i) * NW, nu);
    fld::st8(in.den + ((size_t)(1 + l) * n + i) * NW, de);
  }
}

}  // namespace prow
