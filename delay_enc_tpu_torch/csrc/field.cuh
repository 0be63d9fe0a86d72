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
//
// reduce_once, add, sub and mont_mul have two bodies.  A host compiler
// takes the portable C++ one.  The device takes PTX carry chains
// (add.cc / addc.cc, sub.cc / subc.cc, mad.lo.cc / madc.hi.cc): the carry
// stays in the flag, each wide product is one multiply-add pair on the same
// operands (one IMAD.WIDE with carry once assembled), and the Montgomery
// product splits its partial products into an even and an odd accumulator
// whose chains are independent of each other.  Both bodies give the same
// fully reduced words.  With FLD_EMULATE_PTX a host compiler takes the
// carry-chain bodies too, over C++ stand-ins for the PTX instructions that
// keep the flag in a variable, so their logic can be tested without a card.
// With FLD_PORTABLE the device takes the portable bodies, so that
// tools/torch_msm_bench.py and tools/torch_ntt_scan_bench.py can time the two
// against each other (csrc/ntt.cu sets it for itself under NTT_PORTABLE).

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

#if (defined(__CUDA_ARCH__) && !defined(FLD_PORTABLE)) || defined(FLD_EMULATE_PTX)

// ---- carry-chain bodies ---------------------------------------------------

// One PTX instruction each, so an output register may share an input's.
// `asm volatile` keeps them in program order, which keeps the flag intact
// from one to the next.
namespace ptx {
#ifdef __CUDA_ARCH__
#define FLD_PTX2(name, ins)                                               \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b) {      \
    uint32_t r;                                                           \
    asm volatile(ins " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));          \
    return r;                                                             \
  }
#define FLD_PTX3(name, ins)                                                   \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b,            \
                                           uint32_t c) {                      \
    uint32_t r;                                                               \
    asm volatile(ins " %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));  \
    return r;                                                                 \
  }
FLD_PTX2(add_cc, "add.cc.u32")
FLD_PTX2(addc_cc, "addc.cc.u32")
FLD_PTX2(addc, "addc.u32")
FLD_PTX2(sub_cc, "sub.cc.u32")
FLD_PTX2(subc_cc, "subc.cc.u32")
FLD_PTX2(subc, "subc.u32")
FLD_PTX2(mul_lo, "mul.lo.u32")
FLD_PTX2(mul_hi, "mul.hi.u32")
FLD_PTX3(mad_lo_cc, "mad.lo.cc.u32")
FLD_PTX3(madc_lo_cc, "madc.lo.cc.u32")
FLD_PTX3(madc_hi_cc, "madc.hi.cc.u32")
FLD_PTX3(madc_hi, "madc.hi.u32")
#undef FLD_PTX2
#undef FLD_PTX3
#else
// Host stand-ins: the same results and the same flag, one variable a thread.
inline uint32_t& cf() {
  static thread_local uint32_t flag = 0;
  return flag;
}
inline uint32_t put(uint64_t x, bool set) {
  if (set) cf() = (uint32_t)(x >> 32) & 1u;
  return (uint32_t)x;
}
inline uint32_t lo32(uint32_t a, uint32_t b) { return (uint32_t)((uint64_t)a * b); }
inline uint32_t hi32(uint32_t a, uint32_t b) { return (uint32_t)(((uint64_t)a * b) >> 32); }
inline uint32_t add_cc(uint32_t a, uint32_t b) { return put((uint64_t)a + b, true); }
inline uint32_t addc_cc(uint32_t a, uint32_t b) { return put((uint64_t)a + b + cf(), true); }
inline uint32_t addc(uint32_t a, uint32_t b) { return put((uint64_t)a + b + cf(), false); }
// a borrow sets bit 32 of the 64-bit difference
inline uint32_t sub_cc(uint32_t a, uint32_t b) { return put((uint64_t)a - b, true); }
inline uint32_t subc_cc(uint32_t a, uint32_t b) { return put((uint64_t)a - b - cf(), true); }
inline uint32_t subc(uint32_t a, uint32_t b) { return put((uint64_t)a - b - cf(), false); }
inline uint32_t mul_lo(uint32_t a, uint32_t b) { return lo32(a, b); }
inline uint32_t mul_hi(uint32_t a, uint32_t b) { return hi32(a, b); }
inline uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  return put((uint64_t)lo32(a, b) + c, true);
}
inline uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  return put((uint64_t)lo32(a, b) + c + cf(), true);
}
inline uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  return put((uint64_t)hi32(a, b) + c + cf(), true);
}
inline uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) {
  return put((uint64_t)hi32(a, b) + c + cf(), false);
}
#endif
}  // namespace ptx

// r = t mod p for a value t + hi * 2^256 < 2p
template <int F>
FDEV void reduce_once(uint32_t r[NW], const uint32_t t[NW], uint32_t hi) {
  uint32_t d[NW];
  d[0] = ptx::sub_cc(t[0], pw<F>(0));
#pragma unroll
  for (int j = 1; j < NW; j++) d[j] = ptx::subc_cc(t[j], pw<F>(j));
  const uint32_t borrow = ptx::subc(0u, 0u);  // all ones when t < p
  const bool ge = (hi != 0) || (borrow == 0);
#pragma unroll
  for (int j = 0; j < NW; j++) r[j] = ge ? d[j] : t[j];
}

template <int F>
FDEV void add(uint32_t r[NW], const uint32_t a[NW], const uint32_t b[NW]) {
  uint32_t s[NW];
  s[0] = ptx::add_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < NW; j++) s[j] = ptx::addc_cc(a[j], b[j]);
  const uint32_t hi = ptx::addc(0u, 0u);
  reduce_once<F>(r, s, hi);
}

// a + b left unreduced: for two reduced operands whose sum (below 2p, so
// below 2^255) only feeds mont_mul, which takes a with a + p <= 2^256 and
// b below 2^256 with a * b < p * 2^256
FDEV void add_unreduced(uint32_t r[NW], const uint32_t a[NW], const uint32_t b[NW]) {
  r[0] = ptx::add_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < NW - 1; j++) r[j] = ptx::addc_cc(a[j], b[j]);
  r[NW - 1] = ptx::addc(a[NW - 1], b[NW - 1]);
}

template <int F>
FDEV void sub(uint32_t r[NW], const uint32_t a[NW], const uint32_t b[NW]) {
  uint32_t d[NW];
  d[0] = ptx::sub_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < NW; j++) d[j] = ptx::subc_cc(a[j], b[j]);
  // a < b: add p back (mod 2^256)
  const uint32_t mask = ptx::subc(0u, 0u);
  r[0] = ptx::add_cc(d[0], pw<F>(0) & mask);
#pragma unroll
  for (int j = 1; j < NW - 1; j++) r[j] = ptx::addc_cc(d[j], pw<F>(j) & mask);
  r[NW - 1] = ptx::addc(d[NW - 1], pw<F>(NW - 1) & mask);
}

// One row of the Montgomery product.  The running value is e + o * 2^32:
// e holds words 0..7, o words 1..8.  The row adds a * bi, the even-indexed
// a[j] into e (their low and high halves fall on words j, j + 1 = 0..7) and
// the odd-indexed into o, each as one carry chain, then m * p the same way
// with m chosen so that e[0] becomes 0.  Dividing by 2^32 then needs no
// move: the next row is called with the two arrays exchanged.  Its o is
// this row's e, whose word 0 is zero, whose word 1 belongs under the new
// e[0], and whose words 2..7 are the new o[0..5].  The running value stays
// below a + p, and below (a + p) * 2^32 <= 2^288 inside a row, for a with
// a + p <= 2^256 (a reduced one, or a sum of two), so the chain of o never
// carries out, and the carry out of e's chain lands in o[7].  An a nearer
// 2^256 overflows it: an operand that may lie anywhere below 2^256 goes in
// b (the portable body, with a word more, takes either).
template <int F, bool FIRST>
FDEV void mont_row(uint32_t e[NW], uint32_t o[NW], const uint32_t a[NW], uint32_t bi) {
  if (FIRST) {
#pragma unroll
    for (int j = 0; j < NW; j += 2) {
      e[j] = ptx::mul_lo(a[j], bi);
      e[j + 1] = ptx::mul_hi(a[j], bi);
      o[j] = ptx::mul_lo(a[j + 1], bi);
      o[j + 1] = ptx::mul_hi(a[j + 1], bi);
    }
  } else {
    e[0] = ptx::add_cc(e[0], o[1]);
#pragma unroll
    for (int j = 0; j < NW - 2; j += 2) {
      o[j] = ptx::madc_lo_cc(a[j + 1], bi, o[j + 2]);
      o[j + 1] = ptx::madc_hi_cc(a[j + 1], bi, o[j + 3]);
    }
    o[NW - 2] = ptx::madc_lo_cc(a[NW - 1], bi, 0u);
    o[NW - 1] = ptx::madc_hi(a[NW - 1], bi, 0u);
    e[0] = ptx::mad_lo_cc(a[0], bi, e[0]);
    e[1] = ptx::madc_hi_cc(a[0], bi, e[1]);
#pragma unroll
    for (int j = 2; j < NW; j += 2) {
      e[j] = ptx::madc_lo_cc(a[j], bi, e[j]);
      e[j + 1] = ptx::madc_hi_cc(a[j], bi, e[j + 1]);
    }
    o[NW - 1] = ptx::addc(o[NW - 1], 0u);
  }
  const uint32_t m = e[0] * nprime<F>();
  o[0] = ptx::mad_lo_cc(m, pw<F>(1), o[0]);
  o[1] = ptx::madc_hi_cc(m, pw<F>(1), o[1]);
#pragma unroll
  for (int j = 2; j < NW - 2; j += 2) {
    o[j] = ptx::madc_lo_cc(m, pw<F>(j + 1), o[j]);
    o[j + 1] = ptx::madc_hi_cc(m, pw<F>(j + 1), o[j + 1]);
  }
  o[NW - 2] = ptx::madc_lo_cc(m, pw<F>(NW - 1), o[NW - 2]);
  o[NW - 1] = ptx::madc_hi(m, pw<F>(NW - 1), o[NW - 1]);
  e[0] = ptx::mad_lo_cc(m, pw<F>(0), e[0]);
  e[1] = ptx::madc_hi_cc(m, pw<F>(0), e[1]);
#pragma unroll
  for (int j = 2; j < NW; j += 2) {
    e[j] = ptx::madc_lo_cc(m, pw<F>(j), e[j]);
    e[j + 1] = ptx::madc_hi_cc(m, pw<F>(j), e[j + 1]);
  }
  o[NW - 1] = ptx::addc(o[NW - 1], 0u);
}

// Montgomery product a * b * 2^-256 mod p, fully reduced: eight rows, then
// the two accumulators are added up and reduced once.
template <int F>
FDEV void mont_mul(uint32_t r[NW], const uint32_t a[NW], const uint32_t b[NW]) {
  uint32_t e[NW], o[NW], t[NW];
  mont_row<F, true>(e, o, a, b[0]);
  mont_row<F, false>(o, e, a, b[1]);
#pragma unroll
  for (int i = 2; i < NW; i += 2) {
    mont_row<F, false>(e, o, a, b[i]);
    mont_row<F, false>(o, e, a, b[i + 1]);
  }
  // the last row ran with the arrays exchanged: o[0] == 0, o[1..7] lie
  // under e[0..6]
  t[0] = ptx::add_cc(e[0], o[1]);
#pragma unroll
  for (int j = 1; j < NW - 1; j++) t[j] = ptx::addc_cc(e[j], o[j + 1]);
  t[NW - 1] = ptx::addc(e[NW - 1], 0u);
  reduce_once<F>(r, t, 0u);
}

#else

// ---- portable bodies --------------------------------------------------------

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

// a + b left unreduced: for two reduced operands whose sum (below 2p, so
// below 2^255) only feeds mont_mul, which takes a with a + p <= 2^256 and
// b below 2^256 with a * b < p * 2^256
FDEV void add_unreduced(uint32_t r[NW], const uint32_t a[NW], const uint32_t b[NW]) {
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < NW; j++) {
    c = (uint64_t)a[j] + b[j] + (c >> 32);
    r[j] = (uint32_t)c;
  }
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

#endif  // carry-chain or portable bodies

FDEV void copy(uint32_t r[NW], const uint32_t a[NW]) {
#pragma unroll
  for (int j = 0; j < NW; j++) r[j] = a[j];
}

// a^e in Montgomery form, fully reduced: MSB-first square-and-multiply over
// mont_mul (which may write over its operands).  e is 8 little-endian words
// whose bit length is nbits (bit nbits - 1 set, or nbits = 0 and e = 0):
// the top bit gives r = a, then nbits - 1 squarings and one product a set
// bit below it.  e = 0 gives 1 (R mod p), also for a = 0.  The word of a
// bit is picked with constant indices, so e stays in registers.  r must
// not be a.
template <int F>
FDEV void mont_pow(uint32_t r[NW], const uint32_t a[NW], const uint32_t e[NW],
                   uint32_t nbits) {
  if (nbits == 0) {
#pragma unroll
    for (int j = 0; j < NW; j++) r[j] = onew<F>(j);
    return;
  }
  copy(r, a);
  for (uint32_t b = nbits - 1; b-- > 0;) {
    uint32_t word = e[0];
#pragma unroll
    for (int j = 1; j < NW; j++) word = (b >> 5) == (uint32_t)j ? e[j] : word;
    mont_mul<F>(r, r, r);
    if ((word >> (b & 31u)) & 1u) mont_mul<F>(r, r, a);
  }
}

// One element from global memory, and back: two 16-byte accesses on the
// device (an element row is 32-byte aligned), a word loop on the host.
FDEV void ld8(uint32_t r[NW], const uint32_t* p) {
#ifdef __CUDA_ARCH__
  const uint4* q = reinterpret_cast<const uint4*>(p);
  const uint4 lo = q[0], hi = q[1];
  r[0] = lo.x; r[1] = lo.y; r[2] = lo.z; r[3] = lo.w;
  r[4] = hi.x; r[5] = hi.y; r[6] = hi.z; r[7] = hi.w;
#else
  for (int j = 0; j < NW; j++) r[j] = p[j];
#endif
}

FDEV void st8(uint32_t* p, const uint32_t r[NW]) {
#ifdef __CUDA_ARCH__
  uint4* q = reinterpret_cast<uint4*>(p);
  q[0] = make_uint4(r[0], r[1], r[2], r[3]);
  q[1] = make_uint4(r[4], r[5], r[6], r[7]);
#else
  for (int j = 0; j < NW; j++) p[j] = r[j];
#endif
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
// _ll_complete_add (:129-163).  Handles identity and doubling.  The six
// operand sums of m3, m4 and m5 go into their products unreduced; the
// products reduce fully, so every word of the result is unchanged.
FDEV void g1_add(G1& o, const G1& p, const G1& q) {
  uint32_t t0[NW], t1[NW], t2[NW], t3[NW], t4[NW], u[NW], v[NW], y3[NW], z3[NW];
  mont_mul<FQ>(t0, p.x, q.x);
  mont_mul<FQ>(t1, p.y, q.y);
  mont_mul<FQ>(t2, p.z, q.z);
  add_unreduced(u, p.x, p.y);
  add_unreduced(v, q.x, q.y);
  mont_mul<FQ>(t3, u, v);  // m3
  add<FQ>(u, t0, t1);
  sub<FQ>(t3, t3, u);  // t3 = m3 - (t0 + t1)
  add_unreduced(u, p.y, p.z);
  add_unreduced(v, q.y, q.z);
  mont_mul<FQ>(t4, u, v);  // m4
  add<FQ>(u, t1, t2);
  sub<FQ>(t4, t4, u);  // t4 = m4 - (t1 + t2)
  add_unreduced(u, p.x, p.z);
  add_unreduced(v, q.x, q.z);
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
