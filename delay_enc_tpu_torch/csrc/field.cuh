// 256-bit Montgomery arithmetic over the BN254 fields, 8 x 32-bit words.
//
// Replaces the limb chains of delay_enc_tpu/ops/limbs.py: ll_mont_mul
// (:275) and mont_mul (:496), ll_add / ll_sub (:250 / :254), _sub_p_if_ge
// (:346) and _carry_and_mod (:372).  The TPU code carried 16 limbs of 16
// bits in uint32 because the TPU has no 64-bit multiply; here an element
// is 8 little-endian 32-bit words and every product is one 32x32->64
// multiply-add, so a Montgomery product is 128 wide multiplies (CIOS).
//
// Values are in Montgomery form with R = 2^256, exactly as in the JAX
// package, and every result is fully reduced into [0, p): with reduced
// inputs each result is the unique representative, so it is bit-identical
// to the JAX package's.
//
// The functions are __host__ __device__ so that the same arithmetic can be
// compiled by a host C++ compiler and checked against Python integers.

#pragma once
#include <stdint.h>

#ifdef __CUDACC__
#define FDEV __host__ __device__ __forceinline__
#else
#define FDEV inline
#endif

namespace fld {

enum { FR = 0, FQ = 1 };
constexpr int NW = 8;  // 32-bit words per element

// p word i of field F.  A switch rather than an array: after unrolling the
// index is a constant, so each word becomes an immediate operand.
template <int F>
FDEV uint32_t pw(int i);

template <>
FDEV uint32_t pw<FR>(int i) {
  switch (i) {
    case 0: return 0xf0000001u;
    case 1: return 0x43e1f593u;
    case 2: return 0x79b97091u;
    case 3: return 0x2833e848u;
    case 4: return 0x8181585du;
    case 5: return 0xb85045b6u;
    case 6: return 0xe131a029u;
    default: return 0x30644e72u;
  }
}

template <>
FDEV uint32_t pw<FQ>(int i) {
  switch (i) {
    case 0: return 0xd87cfd47u;
    case 1: return 0x3c208c16u;
    case 2: return 0x6871ca8du;
    case 3: return 0x97816a91u;
    case 4: return 0x8181585du;
    case 5: return 0xb85045b6u;
    case 6: return 0xe131a029u;
    default: return 0x30644e72u;
  }
}

// -p^-1 mod 2^32
template <int F>
FDEV uint32_t nprime() {
  return F == FR ? 0xefffffffu : 0xe4866389u;
}

// R mod p word i: the Montgomery form of 1
template <int F>
FDEV uint32_t onew(int i);

template <>
FDEV uint32_t onew<FR>(int i) {
  switch (i) {
    case 0: return 0x4ffffffbu;
    case 1: return 0xac96341cu;
    case 2: return 0x9f60cd29u;
    case 3: return 0x36fc7695u;
    case 4: return 0x7879462eu;
    case 5: return 0x666ea36fu;
    case 6: return 0x9a07df2fu;
    default: return 0x0e0a77c1u;
  }
}

template <>
FDEV uint32_t onew<FQ>(int i) {
  switch (i) {
    case 0: return 0xc58f0d9du;
    case 1: return 0xd35d438du;
    case 2: return 0xf5c70b3du;
    case 3: return 0x0a78eb28u;
    case 4: return 0x7879462cu;
    case 5: return 0x666ea36fu;
    case 6: return 0x9a07df2fu;
    default: return 0x0e0a77c1u;
  }
}

// r = t mod p for a value t + hi * 2^256 < 2p
template <int F>
FDEV void reduce_once(uint32_t r[NW], const uint32_t t[NW], uint32_t hi) {
  uint32_t d[NW];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < NW; j++) {
    uint64_t x = (uint64_t)t[j] - pw<F>(j) - borrow;
    d[j] = (uint32_t)x;
    borrow = (uint32_t)(x >> 63);
  }
  const bool ge = (hi != 0) || (borrow == 0);
#pragma unroll
  for (int j = 0; j < NW; j++) r[j] = ge ? d[j] : t[j];
}

template <int F>
FDEV void add(uint32_t r[NW], const uint32_t a[NW], const uint32_t b[NW]) {
  uint32_t s[NW];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < NW; j++) {
    c = (uint64_t)a[j] + b[j] + (c >> 32);
    s[j] = (uint32_t)c;
  }
  reduce_once<F>(r, s, (uint32_t)(c >> 32));
}

template <int F>
FDEV void sub(uint32_t r[NW], const uint32_t a[NW], const uint32_t b[NW]) {
  uint32_t d[NW];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < NW; j++) {
    uint64_t x = (uint64_t)a[j] - b[j] - borrow;
    d[j] = (uint32_t)x;
    borrow = (uint32_t)(x >> 63);
  }
  // a < b: add p back (mod 2^256)
  const uint32_t mask = 0u - borrow;
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < NW; j++) {
    c = (uint64_t)d[j] + (pw<F>(j) & mask) + (c >> 32);
    r[j] = (uint32_t)c;
  }
}

// CIOS Montgomery product a * b * 2^-256 mod p, fully reduced.
template <int F>
FDEV void mont_mul(uint32_t r[NW], const uint32_t a[NW], const uint32_t b[NW]) {
  uint32_t t[NW + 2];
#pragma unroll
  for (int j = 0; j < NW + 2; j++) t[j] = 0;
#pragma unroll
  for (int i = 0; i < NW; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; j++) {
      c = (uint64_t)a[j] * b[i] + t[j] + (c >> 32);
      t[j] = (uint32_t)c;
    }
    c = (uint64_t)t[NW] + (c >> 32);
    t[NW] = (uint32_t)c;
    t[NW + 1] = (uint32_t)(c >> 32);
    const uint32_t m = t[0] * nprime<F>();
    c = (uint64_t)m * pw<F>(0) + t[0];
#pragma unroll
    for (int j = 1; j < NW; j++) {
      c = (uint64_t)m * pw<F>(j) + t[j] + (c >> 32);
      t[j - 1] = (uint32_t)c;
    }
    c = (uint64_t)t[NW] + (c >> 32);
    t[NW - 1] = (uint32_t)c;
    t[NW] = t[NW + 1] + (uint32_t)(c >> 32);
  }
  reduce_once<F>(r, t, t[NW]);
}

FDEV void copy(uint32_t r[NW], const uint32_t a[NW]) {
#pragma unroll
  for (int j = 0; j < NW; j++) r[j] = a[j];
}

// ---- BN254 G1, projective (X : Y : Z) over Fq, Montgomery words --------

struct G1 {
  uint32_t x[NW], y[NW], z[NW];
};

// identity (0 : 1 : 0), with 1 in Montgomery form (ops/msm.py:51)
FDEV void g1_identity(G1& p) {
#pragma unroll
  for (int j = 0; j < NW; j++) {
    p.x[j] = 0;
    p.y[j] = onew<FQ>(j);
    p.z[j] = 0;
  }
}

// Complete addition on y^2 = x^3 + 3 (b3 = 9): Renes-Costello-Batina 2016
// Algorithm 7, in the operation order of delay_enc_tpu/ops/msm.py
// _ll_complete_add (:129-163).  Handles identity and doubling.
FDEV void g1_add(G1& o, const G1& p, const G1& q) {
  uint32_t t0[NW], t1[NW], t2[NW], t3[NW], t4[NW], u[NW], v[NW], y3[NW], z3[NW];
  mont_mul<FQ>(t0, p.x, q.x);
  mont_mul<FQ>(t1, p.y, q.y);
  mont_mul<FQ>(t2, p.z, q.z);
  add<FQ>(u, p.x, p.y);
  add<FQ>(v, q.x, q.y);
  mont_mul<FQ>(t3, u, v);  // m3
  add<FQ>(u, t0, t1);
  sub<FQ>(t3, t3, u);  // t3 = m3 - (t0 + t1)
  add<FQ>(u, p.y, p.z);
  add<FQ>(v, q.y, q.z);
  mont_mul<FQ>(t4, u, v);  // m4
  add<FQ>(u, t1, t2);
  sub<FQ>(t4, t4, u);  // t4 = m4 - (t1 + t2)
  add<FQ>(u, p.x, p.z);
  add<FQ>(v, q.x, q.z);
  mont_mul<FQ>(y3, u, v);  // m5
  add<FQ>(u, t0, t2);
  sub<FQ>(y3, y3, u);  // y3p = m5 - (t0 + t2)
  // t2_9 = 9 * t2 as 3 * (3 * t2)
  add<FQ>(u, t2, t2);
  add<FQ>(u, u, t2);
  add<FQ>(v, u, u);
  add<FQ>(v, v, u);
  // Y3 = 9 * y3p
  add<FQ>(u, y3, y3);
  add<FQ>(u, u, y3);
  add<FQ>(y3, u, u);
  add<FQ>(y3, y3, u);
  // t0 = 3 * t0
  add<FQ>(u, t0, t0);
  add<FQ>(t0, u, t0);
  add<FQ>(z3, t1, v);  // Z3 = t1 + t2_9
  sub<FQ>(t1, t1, v);  // t1 = t1 - t2_9
  // X3 = t3 * t1 - t4 * Y3
  mont_mul<FQ>(u, t3, t1);
  mont_mul<FQ>(v, t4, y3);
  sub<FQ>(o.x, u, v);
  // Y3 = t1 * Z3 + Y3 * t0   (y3 is read above before o.y is written)
  mont_mul<FQ>(u, t1, z3);
  mont_mul<FQ>(v, y3, t0);
  add<FQ>(o.y, u, v);
  // Z3 = Z3 * t4 + t0 * t3
  mont_mul<FQ>(u, z3, t4);
  mont_mul<FQ>(v, t0, t3);
  add<FQ>(o.z, u, v);
}

}  // namespace fld
