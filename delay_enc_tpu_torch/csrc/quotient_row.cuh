// The per-row body of the fused quotient kernel (csrc/quotient.cu).
//
// Row i gives
//     h[i] = (sum_j y^(23 - j) e_j[i]) / Z_H[i],
// the y-folded constraint expressions of delay_enc_tpu/plonk/kernels.py
// _quotient_expr in the verifier's order: the gate, the permutation's three
// terms, then five terms for each lookup a..d.  The fold runs by Horner,
// acc = acc * y + e_j, as each expression is finished, so only the
// accumulator and the few values an expression needs are live.  Every step
// leaves one reduced field element, so the words equal the JAX package's
// weighted sum.
//
// The rows are those of one domain of n rows: the fused extended coset
// (n = n_ext = 8 * 2^k), or one size-2^k coset zeta g^j H of the split
// quotient (K9, delay_enc_tpu/plonk/kernels.py _jit_quotient_coset).  "The
// next row" of the row domain is `rot` rows on, (i + rot) mod n, for e,
// z_perm and the z_l; "the previous row" is (i - rot) mod n for the permuted
// inputs A'_l.  rot is MAX_DEGREE = 8 on the fused coset, which interleaves
// the row domain 8 times, and 1 on a coset of the split quotient.  Both rows
// are read straight from the stacks.  1/Z_H has period rot in i: 8 values on
// the fused coset, one constant on a split coset.  Row i is stored at
// h[i * out_stride + out_offset]: coset j of the split quotient writes its
// places 8i + j of the interleaved extended coset (stride 8, offset j).
//
// The functions are __host__ __device__, so a host C++ compiler can build
// them and run the rows one after another.

#pragma once

#include "fracs_row.cuh"

namespace prow {

// rows of the prover's (19, n, 8) witness stack (plonk/prover.py)
enum { W_ADV = 0, W_INSTANCE = 5, W_Z_PERM = 6, W_Z_L = 7, W_AP = 11, W_SP = 15, WIT_ROWS = 19 };

// The inputs: the witness and key stacks on the domain of n rows, X there,
// the rot values of 1/Z_H, and where h goes.  rot is a power of two <= n.
struct QuotientIn {
  const uint32_t* wit;
  const uint32_t* key;
  const uint32_t* x;
  const uint32_t* zh_inv;
  uint32_t* h;
  size_t n;
  size_t rot;
  size_t out_stride;
  size_t out_offset;
};

// acc = acc * y + e
FDEV void fold(uint32_t acc[NW], const uint32_t e[NW], const Consts& c) {
  fld::mont_mul<FR>(acc, acc, c.w[C_Y]);
  fld::add<FR>(acc, acc, e);
}

// acc += q * v for the selector in key row `q_row`
FDEV void gate_term(uint32_t acc[NW], const QuotientIn& in, int q_row, size_t i,
                    const uint32_t v[NW]) {
  uint32_t q[NW];
  fld::ld8(q, at(in.key, q_row, in.n, i));
  fld::mont_mul<FR>(q, q, v);
  fld::add<FR>(acc, acc, q);
}

// r = l * (z^2 - z) for l = l_last
FDEV void last_term(uint32_t r[NW], const uint32_t l[NW], const uint32_t z[NW]) {
  fld::mont_mul<FR>(r, z, z);
  fld::sub<FR>(r, r, z);
  fld::mont_mul<FR>(r, l, r);
}

// r = l * (1 - z) for l = l0
FDEV void first_term(uint32_t r[NW], const uint32_t l[NW], const uint32_t z[NW]) {
  one(r);
  fld::sub<FR>(r, r, z);
  fld::mont_mul<FR>(r, l, r);
}

FDEV void quotient_row(size_t i, const QuotientIn& in, const Consts& c) {
  const size_t n = in.n, rot = in.rot;
  const size_t next = i + rot < n ? i + rot : i + rot - n;
  const size_t prev = i >= rot ? i - rot : i + n - rot;
  const uint32_t* W = in.wit;
  const uint32_t* K = in.key;
  uint32_t acc[NW], u[NW], v[NW], t[NW];

  // ---- gate: q_a a + q_b b + q_c c + q_d d + q_e e + q_mul_ab a b
  //      + q_mul_cd c d + q_e_next e_next + q_constant
  fld::ld8(acc, at(K, K_Q_CONSTANT, n, i));
#pragma unroll 1
  for (int p = 0; p < 2; p++) {  // (a, b) then (c, d)
    fld::ld8(u, at(W, W_ADV + 2 * p, n, i));
    fld::ld8(v, at(W, W_ADV + 2 * p + 1, n, i));
    gate_term(acc, in, K_Q_A + 2 * p, i, u);
    gate_term(acc, in, K_Q_B + 2 * p, i, v);
    fld::mont_mul<FR>(t, u, v);
    gate_term(acc, in, K_Q_MUL_AB + p, i, t);
  }
  fld::ld8(u, at(W, W_ADV + 4, n, i));
  gate_term(acc, in, K_Q_E, i, u);
  fld::ld8(u, at(W, W_ADV + 4, n, next));
  gate_term(acc, in, K_Q_E_NEXT, i, u);

  // the masks: l0, l_last, and 1 - (l_last + l_blind) for the active rows
  uint32_t l0[NW], ll[NW], mask[NW];
  fld::ld8(l0, at(K, K_L0, n, i));
  fld::ld8(ll, at(K, K_L_LAST, n, i));
  fld::ld8(t, at(K, K_L_BLIND, n, i));
  fld::add<FR>(t, ll, t);
  one(mask);
  fld::sub<FR>(mask, mask, t);

  // ---- permutation: l0 (1 - z), l_last (z^2 - z),
  //      mask (z_next prod_c left_c - z prod_c right_c) with
  //      left_c = col_c + beta sigma_c + gamma, right_c = col_c + beta delta_c X + gamma
  {
    uint32_t z[NW], lp[NW], rp[NW], x[NW];
    fld::ld8(z, at(W, W_Z_PERM, n, i));
    first_term(t, l0, z);
    fold(acc, t, c);
    last_term(t, ll, z);
    fold(acc, t, c);
    fld::ld8(x, in.x + i * NW);
#pragma unroll 1
    for (int k = 0; k < PERM_COLS; k++) {
      fld::ld8(u, at(W, W_ADV + k, n, i));  // W_INSTANCE follows the advice
      fld::ld8(v, at(K, K_SIGMA + k, n, i));
      perm_factor(t, u, c.w[C_BETA], v, c.w[C_GAMMA]);
      if (k == 0) {
        fld::copy(lp, t);
      } else {
        fld::mont_mul<FR>(lp, lp, t);
      }
      perm_factor(t, u, c.w[C_BETA_DELTA + k], x, c.w[C_GAMMA]);
      if (k == 0) {
        fld::copy(rp, t);
      } else {
        fld::mont_mul<FR>(rp, rp, t);
      }
    }
    fld::ld8(t, at(W, W_Z_PERM, n, next));
    fld::mont_mul<FR>(lp, t, lp);
    fld::mont_mul<FR>(rp, z, rp);
    fld::sub<FR>(t, lp, rp);
    fld::mont_mul<FR>(t, mask, t);
    fold(acc, t, c);
  }

  // ---- lookups: for each wire l, l0 (1 - z), l_last (z^2 - z),
  //      mask (z_next (A' + beta)(S' + gamma) - z (A + beta)(S + gamma)),
  //      l0 (A' - S'), mask (A' - S')(A' - A'_prev)
  uint32_t s[NW];
  fld::ld8(u, at(K, K_TABLE_TAG, n, i));
  fld::ld8(v, at(K, K_TABLE_VALUE, n, i));
  compress(s, u, v, c.w[C_THETA]);
#pragma unroll 1
  for (int l = 0; l < LOOKUPS; l++) {
    uint32_t z[NW], d[NW];
    fld::ld8(z, at(W, W_Z_L + l, n, i));
    first_term(t, l0, z);
    fold(acc, t, c);
    last_term(t, ll, z);
    fold(acc, t, c);
    // z (A + beta)(S + gamma), A the compressed input of wire l
    fld::ld8(u, at(K, K_TAG + l, n, i));
    fld::ld8(v, at(W, W_ADV + l, n, i));
    compress(t, u, v, c.w[C_THETA]);
    lookup_factor(t, t, s, c);
    fld::mont_mul<FR>(z, z, t);
    // z_next (A' + beta)(S' + gamma)
    fld::ld8(u, at(W, W_AP + l, n, i));
    fld::ld8(v, at(W, W_SP + l, n, i));
    fld::sub<FR>(d, u, v);  // A' - S'
    lookup_factor(t, u, v, c);
    fld::ld8(v, at(W, W_Z_L + l, n, next));
    fld::mont_mul<FR>(t, v, t);
    fld::sub<FR>(t, t, z);
    fld::mont_mul<FR>(t, mask, t);
    fold(acc, t, c);
    fld::mont_mul<FR>(t, l0, d);
    fold(acc, t, c);
    fld::ld8(v, at(W, W_AP + l, n, prev));
    fld::sub<FR>(t, u, v);
    fld::mont_mul<FR>(t, d, t);
    fld::mont_mul<FR>(t, mask, t);
    fold(acc, t, c);
  }

  // ---- times 1/Z_H, period rot
  fld::ld8(t, in.zh_inv + (i & (rot - 1)) * NW);
  fld::mont_mul<FR>(acc, acc, t);
  fld::st8(in.h + (i * in.out_stride + in.out_offset) * NW, acc);
}

}  // namespace prow
