/* Native host-side BN254 G1 elliptic-curve kernels.
 *
 * Two hot host paths use these (both are pure-Python fallbacks otherwise):
 *
 *  1. The prover's MSM plane fold: the device returns per-commitment base-B
 *     digit-plane sums (projective Montgomery points in the (3,16) u16-limb
 *     layout of ops/limbs.py); the Horner combine sum_p B^p S_p is a
 *     sequential ~380-step double/add chain per commitment — microseconds
 *     in C vs ~10 ms in Python bignum per commitment (~30 commitments per
 *     proof, reference pipeline benches/delay_enc.rs:123).
 *  2. The verifier's multi-scalar multiplication over ~75 commitment points
 *     (the GWC combination, halo2_proofs verifier equivalent).
 *
 * Field arithmetic: 4x64-bit Montgomery (CIOS with __uint128_t), same
 * conventions as limbops.c.  Field parameters are passed per call so the
 * binary stays field-agnostic.  Point formulas:
 *   - complete projective add: Renes-Costello-Batina 2016 Alg 7 (a=0,
 *     b3=9), branchless w.r.t. identity/doubling edge cases;
 *   - Jacobian double (dbl-2009-l) + mixed add (madd-2007-bl) for the MSM.
 *
 * Compiled at import time by delay_enc_tpu/native/__init__.py; loaded via
 * ctypes with silent pure-Python fallback.
 */

#include <pthread.h>
#include <stdint.h>
#include <stddef.h>
#include <stdlib.h>
#include <string.h>

typedef unsigned __int128 u128;
typedef struct { uint64_t w[4]; } u256;

typedef struct {
    u256 p;
    u256 r2;      /* R^2 mod p */
    u256 one;     /* R mod p (Montgomery 1) */
    uint64_t n0inv;
    int nocarry;  /* p top word < 2^63: merged single-pass CIOS is valid */
} fctx;

static inline int fe_is_zero(const u256 *a) {
    return (a->w[0] | a->w[1] | a->w[2] | a->w[3]) == 0;
}

static inline int fe_geq(const u256 *a, const u256 *b) {
    for (int i = 3; i >= 0; i--) {
        if (a->w[i] != b->w[i]) return a->w[i] > b->w[i];
    }
    return 1;
}

static inline void fe_sub_raw(u256 *a, const u256 *b) {
    u128 borrow = 0;
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)a->w[i] - b->w[i] - borrow;
        a->w[i] = (uint64_t)d;
        borrow = (d >> 64) & 1;
    }
}

static inline void fe_add(const fctx *c, const u256 *a, const u256 *b, u256 *out) {
    u128 carry = 0;
    u256 r;
    for (int i = 0; i < 4; i++) {
        u128 s = (u128)a->w[i] + b->w[i] + carry;
        r.w[i] = (uint64_t)s;
        carry = s >> 64;
    }
    if (carry || fe_geq(&r, &c->p)) fe_sub_raw(&r, &c->p);
    *out = r;
}

static inline void fe_sub(const fctx *c, const u256 *a, const u256 *b, u256 *out) {
    u256 r = *a;
    u128 borrow = 0;
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)r.w[i] - b->w[i] - borrow;
        r.w[i] = (uint64_t)d;
        borrow = (d >> 64) & 1;
    }
    if (borrow) {
        u128 carry = 0;
        for (int i = 0; i < 4; i++) {
            u128 s = (u128)r.w[i] + c->p.w[i] + carry;
            r.w[i] = (uint64_t)s;
            carry = s >> 64;
        }
    }
    *out = r;
}

/* Two-pass CIOS, valid for any odd 256-bit modulus. */
static inline __attribute__((always_inline)) void
fe_mul_generic(const fctx *c, const u256 *a, const u256 *b, u256 *out) {
    uint64_t t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; i++) {
        u128 carry = 0;
        for (int j = 0; j < 4; j++) {
            u128 cur = (u128)t[j] + (u128)a->w[i] * b->w[j] + carry;
            t[j] = (uint64_t)cur;
            carry = cur >> 64;
        }
        u128 cur = (u128)t[4] + carry;
        t[4] = (uint64_t)cur;
        t[5] = (uint64_t)(cur >> 64);
        uint64_t m = t[0] * c->n0inv;
        carry = 0;
        for (int j = 0; j < 4; j++) {
            u128 c2 = (u128)t[j] + (u128)m * c->p.w[j] + carry;
            if (j > 0) t[j - 1] = (uint64_t)c2;
            carry = c2 >> 64;
        }
        cur = (u128)t[4] + carry;
        t[3] = (uint64_t)cur;
        cur = (u128)t[5] + (cur >> 64);
        t[4] = (uint64_t)cur;
        t[5] = 0;
    }
    u256 r = {{t[0], t[1], t[2], t[3]}};
    if (t[4] || fe_geq(&r, &c->p)) fe_sub_raw(&r, &c->p);
    *out = r;
}

/* Merged single-pass CIOS ("no-carry" optimization): when the modulus'
 * top word is < 2^63 - 1 (both BN254 Fq and Fr qualify), the partial sum
 * never spills past 4 words, so the multiply and reduce passes fuse and
 * the t[4]/t[5] bookkeeping disappears — ~30% fewer adds/carries on the
 * hottest ~40 instructions in the verifier. */
static inline __attribute__((always_inline)) void
fe_mul_nocarry(const fctx *c, const u256 *a, const u256 *b, u256 *out) {
    uint64_t t0 = 0, t1 = 0, t2 = 0, t3 = 0;
    const uint64_t *bw = b->w, *pw = c->p.w;
    for (int i = 0; i < 4; i++) {
        uint64_t ai = a->w[i];
        u128 cur = (u128)t0 + (u128)ai * bw[0];
        uint64_t m = (uint64_t)cur * c->n0inv;
        u128 cur2 = (u128)(uint64_t)cur + (u128)m * pw[0];
        uint64_t C = (uint64_t)(cur >> 64), C2 = (uint64_t)(cur2 >> 64);
        cur = (u128)t1 + (u128)ai * bw[1] + C;
        cur2 = (u128)(uint64_t)cur + (u128)m * pw[1] + C2;
        t0 = (uint64_t)cur2;
        C = (uint64_t)(cur >> 64);
        C2 = (uint64_t)(cur2 >> 64);
        cur = (u128)t2 + (u128)ai * bw[2] + C;
        cur2 = (u128)(uint64_t)cur + (u128)m * pw[2] + C2;
        t1 = (uint64_t)cur2;
        C = (uint64_t)(cur >> 64);
        C2 = (uint64_t)(cur2 >> 64);
        cur = (u128)t3 + (u128)ai * bw[3] + C;
        cur2 = (u128)(uint64_t)cur + (u128)m * pw[3] + C2;
        t2 = (uint64_t)cur2;
        C = (uint64_t)(cur >> 64);
        C2 = (uint64_t)(cur2 >> 64);
        t3 = C + C2;
    }
    u256 r = {{t0, t1, t2, t3}};
    if (fe_geq(&r, &c->p)) fe_sub_raw(&r, &c->p);
    *out = r;
}

static inline __attribute__((always_inline)) void
fe_mul(const fctx *c, const u256 *a, const u256 *b, u256 *out) {
    if (c->nocarry)
        fe_mul_nocarry(c, a, b, out);
    else
        fe_mul_generic(c, a, b, out);
}

/* a^(p-2) (Fermat inverse), Montgomery domain. */
static void fe_inv(const fctx *c, const u256 *a, u256 *out) {
    u256 e = c->p;
    u256 two = {{2, 0, 0, 0}};
    fe_sub_raw(&e, &two);
    u256 r = c->one, base = *a;
    for (int i = 0; i < 256; i++) {
        if ((e.w[i >> 6] >> (i & 63)) & 1) fe_mul(c, &r, &base, &r);
        fe_mul(c, &base, &base, &base);
    }
    *out = r;
}

/* a^e (e canonical u256), Montgomery domain, LSB-first square-and-multiply. */
static void fe_pow(const fctx *c, const u256 *a, const u256 *e, u256 *out) {
    u256 r = c->one, base = *a;
    for (int i = 0; i < 256; i++) {
        if ((e->w[i >> 6] >> (i & 63)) & 1) fe_mul(c, &r, &base, &r);
        fe_mul(c, &base, &base, &base);
    }
    *out = r;
}

static void fctx_init(fctx *c, const uint64_t *p_words, const uint64_t *r2_words,
                      uint64_t n0inv) {
    memcpy(c->p.w, p_words, 32);
    memcpy(c->r2.w, r2_words, 32);
    c->n0inv = n0inv;
    c->nocarry = c->p.w[3] < 0x7FFFFFFFFFFFFFFEull;
    /* Montgomery 1 = R mod p = mont_mul(1, R^2) */
    u256 lit_one = {{1, 0, 0, 0}};
    fe_mul(c, &lit_one, &c->r2, &c->one);
}

/* ------------------------------------------------------------------ */
/* projective points (X:Y:Z), Montgomery-domain coordinates            */

typedef struct { u256 x, y, z; } pproj;

static void pp_identity(const fctx *c, pproj *o) {
    memset(o, 0, sizeof(*o));
    o->y = c->one;
}

/* complete addition, y^2 = x^3 + 3 (b3 = 9): RCB16 Algorithm 7 */
static void pp_add(const fctx *c, const pproj *A, const pproj *B, pproj *O) {
    u256 t0, t1, t2, t3, t4, y3p, s1, s2;
    fe_mul(c, &A->x, &B->x, &t0);
    fe_mul(c, &A->y, &B->y, &t1);
    fe_mul(c, &A->z, &B->z, &t2);
    fe_add(c, &A->x, &A->y, &s1); fe_add(c, &B->x, &B->y, &s2);
    fe_mul(c, &s1, &s2, &t3);
    fe_sub(c, &t3, &t0, &t3); fe_sub(c, &t3, &t1, &t3);
    fe_add(c, &A->y, &A->z, &s1); fe_add(c, &B->y, &B->z, &s2);
    fe_mul(c, &s1, &s2, &t4);
    fe_sub(c, &t4, &t1, &t4); fe_sub(c, &t4, &t2, &t4);
    fe_add(c, &A->x, &A->z, &s1); fe_add(c, &B->x, &B->z, &s2);
    fe_mul(c, &s1, &s2, &y3p);
    fe_sub(c, &y3p, &t0, &y3p); fe_sub(c, &y3p, &t2, &y3p);
    /* Y3 = 9 * y3p ; t2_9 = 9 * t2 ; t0 = 3 * t0 */
    u256 Y3, t2_9, tmp;
    fe_add(c, &y3p, &y3p, &tmp); fe_add(c, &tmp, &y3p, &tmp);       /* 3 y3p */
    fe_add(c, &tmp, &tmp, &Y3);  fe_add(c, &Y3, &tmp, &Y3);         /* 9 y3p */
    fe_add(c, &t2, &t2, &tmp);   fe_add(c, &tmp, &t2, &tmp);        /* 3 t2 */
    fe_add(c, &tmp, &tmp, &t2_9); fe_add(c, &t2_9, &tmp, &t2_9);    /* 9 t2 */
    fe_add(c, &t0, &t0, &tmp);   fe_add(c, &tmp, &t0, &t0);         /* 3 t0 */
    u256 Z3, t1m;
    fe_add(c, &t1, &t2_9, &Z3);
    fe_sub(c, &t1, &t2_9, &t1m);
    u256 r0, r1, r2, r3, r4, r5;
    fe_mul(c, &t3, &t1m, &r0);
    fe_mul(c, &t4, &Y3, &r1);
    fe_mul(c, &t1m, &Z3, &r2);
    fe_mul(c, &Y3, &t0, &r3);
    fe_mul(c, &Z3, &t4, &r4);
    fe_mul(c, &t0, &t3, &r5);
    fe_sub(c, &r0, &r1, &O->x);
    fe_add(c, &r2, &r3, &O->y);
    fe_add(c, &r4, &r5, &O->z);
}

/* u16-limb (16 x uint32) <-> u256 */
static inline void load_u16limbs(const uint32_t *limbs, u256 *out) {
    for (int i = 0; i < 4; i++) {
        uint64_t v = 0;
        for (int j = 3; j >= 0; j--) v = (v << 16) | (uint64_t)(limbs[i * 4 + j] & 0xFFFF);
        out->w[i] = v;
    }
}

/* Fold LSB-first digit-plane sums: result = sum_p base^p planes[p].
 * planes: (np, 3, 16) uint32 u16-limb projective Montgomery points.
 * base_bits: log2(base) (2 for base-4 planes, 3 for base-8, ...).
 * out: 64 bytes canonical affine little-endian x||y.  Returns 0 if the
 * result is the identity (out zeroed), 1 otherwise. */
int g1_fold_planes(const uint32_t *planes, size_t np, int base_bits,
                   const uint64_t *p_words, const uint64_t *r2_words,
                   uint64_t n0inv, uint8_t *out) {
    fctx c;
    fctx_init(&c, p_words, r2_words, n0inv);
    pproj acc;
    pp_identity(&c, &acc);
    for (size_t ip = 0; ip < np; ip++) {
        size_t p = np - 1 - ip;
        if (ip > 0)
            for (int d = 0; d < base_bits; d++) pp_add(&c, &acc, &acc, &acc);
        pproj s;
        load_u16limbs(planes + 48 * p, &s.x);
        load_u16limbs(planes + 48 * p + 16, &s.y);
        load_u16limbs(planes + 48 * p + 32, &s.z);
        pp_add(&c, &acc, &s, &acc);
    }
    memset(out, 0, 64);
    if (fe_is_zero(&acc.z)) return 0;
    /* affine = (X/Z, Y/Z), then out of Montgomery form */
    u256 zi, xa, ya, lit_one = {{1, 0, 0, 0}};
    fe_inv(&c, &acc.z, &zi);
    fe_mul(&c, &acc.x, &zi, &xa);
    fe_mul(&c, &acc.y, &zi, &ya);
    fe_mul(&c, &xa, &lit_one, &xa);  /* -> canonical */
    fe_mul(&c, &ya, &lit_one, &ya);
    memcpy(out, xa.w, 32);
    memcpy(out + 32, ya.w, 32);
    return 1;
}

/* Batched variant: nb independent folds (one per commitment). */
void g1_fold_planes_batch(const uint32_t *planes, size_t nb, size_t np,
                          int base_bits, const uint64_t *p_words,
                          const uint64_t *r2_words, uint64_t n0inv,
                          uint8_t *out, uint8_t *flags) {
    for (size_t b = 0; b < nb; b++)
        flags[b] = (uint8_t)g1_fold_planes(planes + b * np * 48, np, base_bits,
                                           p_words, r2_words, n0inv, out + 64 * b);
}

/* ------------------------------------------------------------------ */
/* Jacobian arithmetic for the verifier MSM                            */

typedef struct { u256 x, y, z; int inf; } pjac;

/* dbl-2009-l */
static void pj_double(const fctx *c, pjac *P) {
    if (P->inf) return;
    u256 A, B, C2, D, E, F, t;
    fe_mul(c, &P->x, &P->x, &A);
    fe_mul(c, &P->y, &P->y, &B);
    fe_mul(c, &B, &B, &C2);
    fe_add(c, &P->x, &B, &D);
    fe_mul(c, &D, &D, &D);
    fe_sub(c, &D, &A, &D);
    fe_sub(c, &D, &C2, &D);
    fe_add(c, &D, &D, &D);
    fe_add(c, &A, &A, &E); fe_add(c, &E, &A, &E);
    fe_mul(c, &E, &E, &F);
    u256 X3, Y3, Z3;
    fe_add(c, &D, &D, &t);
    fe_sub(c, &F, &t, &X3);
    fe_sub(c, &D, &X3, &t);
    fe_mul(c, &E, &t, &Y3);
    u256 c8;
    fe_add(c, &C2, &C2, &c8); fe_add(c, &c8, &c8, &c8); fe_add(c, &c8, &c8, &c8);
    fe_sub(c, &Y3, &c8, &Y3);
    fe_mul(c, &P->y, &P->z, &Z3);
    fe_add(c, &Z3, &Z3, &Z3);
    P->x = X3; P->y = Y3; P->z = Z3;
    if (fe_is_zero(&Z3)) P->inf = 1;
}

/* madd-2007-bl: P (Jacobian) += Q (affine Montgomery) */
static void pj_add_affine(const fctx *c, pjac *P, const u256 *qx, const u256 *qy) {
    if (P->inf) {
        P->x = *qx; P->y = *qy; P->z = c->one; P->inf = 0;
        return;
    }
    u256 Z1Z1, U2, S2, t;
    fe_mul(c, &P->z, &P->z, &Z1Z1);
    fe_mul(c, qx, &Z1Z1, &U2);
    fe_mul(c, qy, &Z1Z1, &t);
    fe_mul(c, &t, &P->z, &S2);
    u256 H, R;
    fe_sub(c, &U2, &P->x, &H);
    fe_sub(c, &S2, &P->y, &R);
    if (fe_is_zero(&H)) {
        if (fe_is_zero(&R)) { pj_double(c, P); return; }
        P->inf = 1; return;
    }
    fe_add(c, &R, &R, &R);
    u256 HH, I, J, V;
    fe_mul(c, &H, &H, &HH);
    fe_add(c, &HH, &HH, &I); fe_add(c, &I, &I, &I);
    fe_mul(c, &H, &I, &J);
    fe_mul(c, &P->x, &I, &V);
    u256 X3, Y3, Z3;
    fe_mul(c, &R, &R, &X3);
    fe_sub(c, &X3, &J, &X3);
    fe_sub(c, &X3, &V, &t); fe_sub(c, &t, &V, &X3);
    fe_sub(c, &V, &X3, &t);
    fe_mul(c, &R, &t, &Y3);
    u256 yj;
    fe_mul(c, &P->y, &J, &yj);
    fe_add(c, &yj, &yj, &yj);
    fe_sub(c, &Y3, &yj, &Y3);
    fe_add(c, &P->z, &H, &Z3);
    fe_mul(c, &Z3, &Z3, &Z3);
    fe_sub(c, &Z3, &Z1Z1, &Z3);
    fe_sub(c, &Z3, &HH, &Z3);
    P->x = X3; P->y = Y3; P->z = Z3;
    if (fe_is_zero(&Z3)) P->inf = 1;
}

/* add-2007-bl: P (Jacobian) += Q (Jacobian) */
static void pj_add(const fctx *c, pjac *P, const pjac *Q) {
    if (Q->inf) return;
    if (P->inf) { *P = *Q; return; }
    u256 Z1Z1, Z2Z2, U1, U2, S1, S2, t;
    fe_mul(c, &P->z, &P->z, &Z1Z1);
    fe_mul(c, &Q->z, &Q->z, &Z2Z2);
    fe_mul(c, &P->x, &Z2Z2, &U1);
    fe_mul(c, &Q->x, &Z1Z1, &U2);
    fe_mul(c, &P->y, &Q->z, &t); fe_mul(c, &t, &Z2Z2, &S1);
    fe_mul(c, &Q->y, &P->z, &t); fe_mul(c, &t, &Z1Z1, &S2);
    u256 H, R;
    fe_sub(c, &U2, &U1, &H);
    fe_sub(c, &S2, &S1, &R);
    if (fe_is_zero(&H)) {
        if (fe_is_zero(&R)) { pj_double(c, P); return; }
        P->inf = 1; return;
    }
    fe_add(c, &R, &R, &R);
    u256 I, J, V;
    fe_add(c, &H, &H, &t);
    fe_mul(c, &t, &t, &I);
    fe_mul(c, &H, &I, &J);
    fe_mul(c, &U1, &I, &V);
    u256 X3, Y3, Z3;
    fe_mul(c, &R, &R, &X3);
    fe_sub(c, &X3, &J, &X3);
    fe_sub(c, &X3, &V, &t); fe_sub(c, &t, &V, &X3);
    fe_sub(c, &V, &X3, &t);
    fe_mul(c, &R, &t, &Y3);
    u256 s1j;
    fe_mul(c, &S1, &J, &s1j);
    fe_add(c, &s1j, &s1j, &s1j);
    fe_sub(c, &Y3, &s1j, &Y3);
    fe_add(c, &P->z, &Q->z, &Z3);
    fe_mul(c, &Z3, &Z3, &Z3);
    fe_sub(c, &Z3, &Z1Z1, &Z3);
    fe_sub(c, &Z3, &Z2Z2, &Z3);
    fe_mul(c, &Z3, &H, &Z3);
    P->x = X3; P->y = Y3; P->z = Z3;
    if (fe_is_zero(&Z3)) P->inf = 1;
}

/* wNAF recoding of a canonical 32-byte LE scalar at window w (2..8):
 * odd digits in [-(2^(w-1)-1), 2^(w-1)-1], at most one nonzero in any w
 * consecutive positions.  Returns the digit count (<= 258).  out must
 * hold 260 entries. */
static int wnaf_rec(const uint8_t *sc, int16_t *out, int w) {
    uint64_t k[5];
    memcpy(k, sc, 32);
    k[4] = 0;
    const uint64_t mask = ((uint64_t)1 << w) - 1;
    const int64_t half = (int64_t)1 << (w - 1);
    int len = 0;
    while (k[0] | k[1] | k[2] | k[3] | k[4]) {
        int64_t d = 0;
        if (k[0] & 1) {
            d = (int64_t)(k[0] & mask);
            if (d >= half) d -= (int64_t)1 << w;
            if (d >= 0) {           /* k -= d */
                uint64_t borrow = (uint64_t)d;
                for (int i = 0; i < 5 && borrow; i++) {
                    uint64_t nw = k[i] - borrow;
                    borrow = nw > k[i];
                    k[i] = nw;
                }
            } else {                /* k += |d| */
                uint64_t carry = (uint64_t)(-d);
                for (int i = 0; i < 5 && carry; i++) {
                    uint64_t nw = k[i] + carry;
                    carry = nw < k[i];
                    k[i] = nw;
                }
            }
        }
        out[len++] = (int16_t)d;
        for (int i = 0; i < 4; i++) k[i] = (k[i] >> 1) | (k[i + 1] << 63);
        k[4] >>= 1;
    }
    return len;
}

/* Build Montgomery-form affine odd-multiple tables {1,3,...,2^(w-1)-1}P
 * for n points (batch-normalized with ONE field inversion).  points:
 * (n, 64) canonical affine LE x||y bytes (all-zero row = identity).
 * out: n * 2^(w-2) * 64 bytes, MONTGOMERY-form affine entries (an
 * identity input writes zero rows).  These tables feed g1_msm_pre: the
 * verifier precomputes them once per verifying key for the fixed
 * commitments (sigma/fixed columns + the generator), which removes both
 * the per-proof table build and lets the fixed points use a wider
 * window.  Returns 0, or -1 on alloc failure / bad w. */
int g1_msm_precompute(const uint8_t *points, size_t n, int w,
                      const uint64_t *p_words, const uint64_t *r2_words,
                      uint64_t n0inv, uint8_t *out) {
    if (w < 2 || w > 8 || n > 8192) return -1;
    const size_t tsz = (size_t)1 << (w - 2);
    fctx c;
    fctx_init(&c, p_words, r2_words, n0inv);
    memset(out, 0, n * tsz * 64);
    pjac *tj = (pjac *)malloc(sizeof(pjac) * tsz);
    u256 *zs = (u256 *)malloc(sizeof(u256) * tsz * n);
    u256 *pre = (u256 *)malloc(sizeof(u256) * tsz * n);
    pjac *alltj = (pjac *)malloc(sizeof(pjac) * tsz * n);
    uint8_t *live = (uint8_t *)malloc(n ? n : 1);
    if (!tj || !zs || !pre || !alltj || !live) {
        free(tj); free(zs); free(pre); free(alltj); free(live);
        return -1;
    }
    size_t m = 0;
    for (size_t i = 0; i < n; i++) {
        u256 x, y;
        memcpy(x.w, points + 64 * i, 32);
        memcpy(y.w, points + 64 * i + 32, 32);
        live[i] = !(fe_is_zero(&x) && fe_is_zero(&y));
        if (!live[i]) continue;
        pjac p2;
        fe_mul(&c, &x, &c.r2, &tj[0].x);
        fe_mul(&c, &y, &c.r2, &tj[0].y);
        tj[0].z = c.one; tj[0].inf = 0;
        p2 = tj[0];
        pj_double(&c, &p2);
        for (size_t j = 1; j < tsz; j++) {
            tj[j] = tj[j - 1];
            pj_add(&c, &tj[j], &p2);
        }
        for (size_t j = 0; j < tsz; j++) {
            alltj[i * tsz + j] = tj[j];
            zs[m++] = tj[j].z;
        }
    }
    if (m) {
        u256 acc_z = c.one, inv, zi, zi2, ax, ay;
        for (size_t t = 0; t < m; t++) {
            pre[t] = acc_z;
            fe_mul(&c, &acc_z, &zs[t], &acc_z);
        }
        fe_inv(&c, &acc_z, &inv);
        size_t t = m;
        for (size_t i = n; i-- > 0;) {
            if (!live[i]) continue;
            for (size_t j = tsz; j-- > 0;) {
                t--;
                fe_mul(&c, &inv, &pre[t], &zi);
                fe_mul(&c, &inv, &zs[t], &inv);
                fe_mul(&c, &zi, &zi, &zi2);
                fe_mul(&c, &alltj[i * tsz + j].x, &zi2, &ax);
                fe_mul(&c, &alltj[i * tsz + j].y, &zi2, &ay);
                fe_mul(&c, &ay, &zi, &ay);
                memcpy(out + (i * tsz + j) * 64, ax.w, 32);
                memcpy(out + (i * tsz + j) * 64 + 32, ay.w, 32);
            }
        }
    }
    free(tj); free(zs); free(pre); free(alltj); free(live);
    return 0;
}

/* Multi-scalar multiplication (Straus shared-doubling over wNAF digits).
 * The first npre points use caller-precomputed Montgomery odd-multiple
 * tables (pretab, from g1_msm_precompute at window wpre); the remaining
 * n-npre points get {1,3,...}P tables built on the fly at window wvar
 * and batch-normalized to affine with one inversion.
 * points: (n, 64) canonical affine LE x||y bytes (all-zero = identity;
 * for i < npre only the identity flag is read — an all-zero pretab row 0
 * marks identity too); scalars: (n, 32) canonical LE bytes.
 * out: 64 bytes canonical affine.  Returns 1, 0 for identity result,
 * -1 on error. */
int g1_msm_pre(const uint8_t *points, const uint8_t *scalars, size_t n,
               size_t npre, const uint8_t *pretab, int wpre, int wvar,
               const uint64_t *p_words, const uint64_t *r2_words,
               uint64_t n0inv, uint8_t *out) {
    if (n > 8192 || npre > n || wpre < 2 || wpre > 8 || wvar < 2 || wvar > 8)
        return -1;
    const size_t tszp = (size_t)1 << (wpre - 2);
    const size_t tszv = (size_t)1 << (wvar - 2);
    fctx c;
    fctx_init(&c, p_words, r2_words, n0inv);
    memset(out, 0, 64);
    if (n == 0) return 0;
    size_t nvar = n - npre;
    uint8_t *live = (uint8_t *)malloc(n);
    int16_t *dig = (int16_t *)malloc(n * 260 * sizeof(int16_t));
    int *dlen = (int *)malloc(n * sizeof(int));
    /* tables: precomputed rows are memcpy'd (alignment safety), variable
     * rows are built in Jacobian then batch-normalized */
    u256 *tx = (u256 *)malloc(sizeof(u256) * (npre * tszp + nvar * tszv));
    u256 *ty = (u256 *)malloc(sizeof(u256) * (npre * tszp + nvar * tszv));
    pjac *tj = (pjac *)malloc(sizeof(pjac) * (nvar ? nvar * tszv : 1));
    u256 *zs = (u256 *)malloc(sizeof(u256) * (nvar ? nvar * tszv : 1));
    u256 *pre = (u256 *)malloc(sizeof(u256) * (nvar ? nvar * tszv : 1));
    if (!live || !dig || !dlen || !tx || !ty || !tj || !zs || !pre) {
        free(live); free(dig); free(dlen); free(tx); free(ty);
        free(tj); free(zs); free(pre);
        return -1;
    }
    int maxlen = 0;
    for (size_t i = 0; i < n; i++) {
        u256 x, y;
        memcpy(x.w, points + 64 * i, 32);
        memcpy(y.w, points + 64 * i + 32, 32);
        live[i] = !(fe_is_zero(&x) && fe_is_zero(&y));
        if (i < npre && live[i]) {
            /* identity may also be flagged by a zero table row */
            const uint8_t *row = pretab + i * tszp * 64;
            int all0 = 1;
            for (size_t b2 = 0; b2 < 64 && all0; b2++) all0 = row[b2] == 0;
            if (all0) live[i] = 0;
        }
        if (live[i]) {
            dlen[i] = wnaf_rec(scalars + 32 * i, dig + 260 * i,
                               i < npre ? wpre : wvar);
            if (dlen[i] == 0) live[i] = 0;
            if (dlen[i] > maxlen) maxlen = dlen[i];
        }
        if (live[i]) {
            if (i < npre) {
                for (size_t j = 0; j < tszp; j++) {
                    memcpy(tx[i * tszp + j].w, pretab + (i * tszp + j) * 64, 32);
                    memcpy(ty[i * tszp + j].w, pretab + (i * tszp + j) * 64 + 32, 32);
                }
            } else {
                /* stage Montgomery affine base into tj[...,0] below */
                size_t v = i - npre;
                fe_mul(&c, &x, &c.r2, &tj[v * tszv].x);
                fe_mul(&c, &y, &c.r2, &tj[v * tszv].y);
                tj[v * tszv].z = c.one; tj[v * tszv].inf = 0;
            }
        }
    }
    if (maxlen == 0) {
        free(live); free(dig); free(dlen); free(tx); free(ty);
        free(tj); free(zs); free(pre);
        return 0;
    }
    /* variable-point Jacobian odd multiples + batch normalize */
    size_t m = 0;
    for (size_t i = npre; i < n; i++) {
        if (!live[i]) continue;
        size_t v = i - npre;
        pjac p2 = tj[v * tszv];
        pj_double(&c, &p2);
        for (size_t j = 1; j < tszv; j++) {
            tj[v * tszv + j] = tj[v * tszv + j - 1];
            pj_add(&c, &tj[v * tszv + j], &p2);
        }
        for (size_t j = 0; j < tszv; j++) zs[m++] = tj[v * tszv + j].z;
    }
    if (m) {
        u256 acc_z = c.one, inv, zi, zi2;
        for (size_t t = 0; t < m; t++) {
            pre[t] = acc_z;
            fe_mul(&c, &acc_z, &zs[t], &acc_z);
        }
        fe_inv(&c, &acc_z, &inv);
        size_t t = m;
        for (size_t i2 = n; i2-- > npre;) {
            if (!live[i2]) continue;
            size_t v = i2 - npre;
            for (size_t j = tszv; j-- > 0;) {
                t--;
                fe_mul(&c, &inv, &pre[t], &zi);
                fe_mul(&c, &inv, &zs[t], &inv);
                fe_mul(&c, &zi, &zi, &zi2);
                fe_mul(&c, &tj[v * tszv + j].x, &zi2, &tx[npre * tszp + v * tszv + j]);
                fe_mul(&c, &tj[v * tszv + j].y, &zi2, &ty[npre * tszp + v * tszv + j]);
                fe_mul(&c, &ty[npre * tszp + v * tszv + j], &zi,
                       &ty[npre * tszp + v * tszv + j]);
            }
        }
    }
    pjac acc;
    acc.inf = 1;
    for (int j = maxlen - 1; j >= 0; j--) {
        pj_double(&c, &acc);
        for (size_t i = 0; i < n; i++) {
            if (!live[i] || j >= dlen[i]) continue;
            int d = dig[260 * i + j];
            if (d == 0) continue;
            size_t base = i < npre ? i * tszp : npre * tszp + (i - npre) * tszv;
            size_t idx = (size_t)((d > 0 ? d : -d) >> 1);
            if (d > 0) {
                pj_add_affine(&c, &acc, &tx[base + idx], &ty[base + idx]);
            } else {
                u256 ny, zero = {{0, 0, 0, 0}};
                fe_sub(&c, &zero, &ty[base + idx], &ny);
                pj_add_affine(&c, &acc, &tx[base + idx], &ny);
            }
        }
    }
    free(live); free(dig); free(dlen); free(tx); free(ty);
    free(tj); free(zs); free(pre);
    if (acc.inf) return 0;
    u256 zi, zi2, xa, ya, lit_one = {{1, 0, 0, 0}};
    fe_inv(&c, &acc.z, &zi);
    fe_mul(&c, &zi, &zi, &zi2);
    fe_mul(&c, &acc.x, &zi2, &xa);
    fe_mul(&c, &acc.y, &zi2, &ya);
    fe_mul(&c, &ya, &zi, &ya);
    fe_mul(&c, &xa, &lit_one, &xa);
    fe_mul(&c, &ya, &lit_one, &ya);
    memcpy(out, xa.w, 32);
    memcpy(out + 32, ya.w, 32);
    return 1;
}

/* Back-compat wrapper: the original w=4 shared-doubling MSM surface,
 * now at window 5 with no precomputed block. */
int g1_msm(const uint8_t *points, const uint8_t *scalars, size_t n,
           const uint64_t *p_words, const uint64_t *r2_words, uint64_t n0inv,
           uint8_t *out) {
    return g1_msm_pre(points, scalars, n, 0, NULL, 5, 5,
                      p_words, r2_words, n0inv, out);
}

/* Square root mod p for p = 3 (mod 4): y = a^((p+1)/4), verified by
 * squaring.  a: canonical 32-byte LE (< p); out: canonical 32-byte LE.
 * Returns 1 if a is a quadratic residue (root written), 0 if not,
 * -1 if p != 3 (mod 4).  Used by G1 point decompression (the verifier
 * reads ~30 compressed commitments per proof; a Python modexp per point
 * was the single largest verify cost). */
int fq_sqrt(const uint8_t *a_bytes, const uint64_t *p_words,
            const uint64_t *r2_words, uint64_t n0inv, uint8_t *out) {
    fctx c;
    fctx_init(&c, p_words, r2_words, n0inv);
    if ((c.p.w[0] & 3) != 3) return -1;
    u256 a, am, e, y, y2;
    memcpy(a.w, a_bytes, 32);
    if (fe_is_zero(&a)) { memset(out, 0, 32); return 1; }
    fe_mul(&c, &a, &c.r2, &am);
    /* e = (p + 1) / 4 = (p >> 2) + 1 */
    for (int i = 0; i < 4; i++)
        e.w[i] = (c.p.w[i] >> 2) | (i < 3 ? c.p.w[i + 1] << 62 : 0);
    u128 s = (u128)e.w[0] + 1;
    e.w[0] = (uint64_t)s;
    for (int i = 1; i < 4 && (s >> 64); i++) {
        s = (u128)e.w[i] + 1;
        e.w[i] = (uint64_t)s;
    }
    fe_pow(&c, &am, &e, &y);
    fe_mul(&c, &y, &y, &y2);
    if (memcmp(y2.w, am.w, 32) != 0) return 0;
    u256 lit_one = {{1, 0, 0, 0}};
    fe_mul(&c, &y, &lit_one, &y);    /* out of Montgomery form */
    memcpy(out, y.w, 32);
    return 1;
}

/* Batch G1 point decompression (halo2-style 32-byte encodings: x with
 * the y-parity in bit 255; all-zero = identity).  in: n * 32 bytes.
 * b_bytes: the curve constant b, canonical 32-byte LE.  out: n * 64
 * bytes canonical affine x||y.  flags[i]: 1 = point, 0 = identity,
 * 2 = invalid (non-canonical x or not on curve).  One fctx setup and
 * one shared exponent for the whole proof's ~30 commitments (the
 * per-point Python wrapper overhead was a measurable slice of verify).
 * Requires p = 3 (mod 4); returns -1 otherwise, else 0. */
int g1_decompress_batch(const uint8_t *in, size_t n, const uint8_t *b_bytes,
                        const uint64_t *p_words, const uint64_t *r2_words,
                        uint64_t n0inv, uint8_t *out, uint8_t *flags) {
    fctx c;
    fctx_init(&c, p_words, r2_words, n0inv);
    if ((c.p.w[0] & 3) != 3) return -1;
    u256 e, bm, lit_one = {{1, 0, 0, 0}};
    /* e = (p + 1) / 4 = (p >> 2) + 1 */
    for (int i = 0; i < 4; i++)
        e.w[i] = (c.p.w[i] >> 2) | (i < 3 ? c.p.w[i + 1] << 62 : 0);
    {
        u128 s = (u128)e.w[0] + 1;
        e.w[0] = (uint64_t)s;
        for (int i = 1; i < 4 && (s >> 64); i++) {
            s = (u128)e.w[i] + 1;
            e.w[i] = (uint64_t)s;
        }
    }
    u256 b;
    memcpy(b.w, b_bytes, 32);
    fe_mul(&c, &b, &c.r2, &bm);
    memset(out, 0, n * 64);
    for (size_t i = 0; i < n; i++) {
        u256 x;
        memcpy(x.w, in + 32 * i, 32);
        int ysign = (int)(x.w[3] >> 63);
        x.w[3] &= ~(1ULL << 63);
        if (fe_geq(&x, &c.p)) { flags[i] = 2; continue; }
        if (fe_is_zero(&x) && !ysign) { flags[i] = 0; continue; }  /* identity */
        /* x = 0 with the sign bit set falls through to the curve check,
         * matching g1_from_bytes (invalid iff b is a non-residue) */
        u256 xm, rhs, y, y2;
        fe_mul(&c, &x, &c.r2, &xm);
        fe_mul(&c, &xm, &xm, &rhs);
        fe_mul(&c, &rhs, &xm, &rhs);
        fe_add(&c, &rhs, &bm, &rhs);
        fe_pow(&c, &rhs, &e, &y);
        fe_mul(&c, &y, &y, &y2);
        if (memcmp(y2.w, rhs.w, 32) != 0) { flags[i] = 2; continue; }
        fe_mul(&c, &y, &lit_one, &y);   /* canonical */
        if ((int)(y.w[0] & 1) != ysign) {
            u256 yn = c.p;
            fe_sub_raw(&yn, &y);
            y = yn;
        }
        memcpy(out + 64 * i, x.w, 32);
        memcpy(out + 64 * i + 32, y.w, 32);
        flags[i] = 1;
    }
    return 0;
}

/* ------------------------------------------------------------------ */
/* Optimal-ate pairing check (verifier fast path)                      */
/*                                                                     */
/* Python (curves/pairing.py) prepares the P-independent line          */
/* coefficients per fixed G2 point (G2Prepared); this C path runs the  */
/* shared-squaring multi-Miller loop and the final exponentiation on   */
/* the Fq2/Fq6/Fq12 tower.  Frobenius coefficients and the BN u-bit    */
/* pattern arrive as data (computed once in Python), keeping this      */
/* file free of constant generation.  All field elements are in        */
/* Montgomery form.                                                    */

typedef struct { u256 c0, c1; } fq2;
typedef struct { fq2 c0, c1, c2; } fq6;
typedef struct { fq6 c0, c1; } fq12;

static void fq2_add(const fctx *c, const fq2 *a, const fq2 *b, fq2 *o) {
    fe_add(c, &a->c0, &b->c0, &o->c0);
    fe_add(c, &a->c1, &b->c1, &o->c1);
}
static void fq2_sub(const fctx *c, const fq2 *a, const fq2 *b, fq2 *o) {
    fe_sub(c, &a->c0, &b->c0, &o->c0);
    fe_sub(c, &a->c1, &b->c1, &o->c1);
}
static void fq2_neg(const fctx *c, const fq2 *a, fq2 *o) {
    u256 zero = {{0, 0, 0, 0}};
    fe_sub(c, &zero, &a->c0, &o->c0);
    fe_sub(c, &zero, &a->c1, &o->c1);
}
static void fq2_mul(const fctx *c, const fq2 *a, const fq2 *b, fq2 *o) {
    u256 t0, t1, s1, s2, m;
    fe_mul(c, &a->c0, &b->c0, &t0);
    fe_mul(c, &a->c1, &b->c1, &t1);
    fe_add(c, &a->c0, &a->c1, &s1);
    fe_add(c, &b->c0, &b->c1, &s2);
    fe_mul(c, &s1, &s2, &m);
    fe_sub(c, &t0, &t1, &o->c0);
    fe_sub(c, &m, &t0, &m);
    fe_sub(c, &m, &t1, &o->c1);
}
static void fq2_sq(const fctx *c, const fq2 *a, fq2 *o) {
    u256 s, d, m;
    fe_add(c, &a->c0, &a->c1, &s);
    fe_sub(c, &a->c0, &a->c1, &d);
    fe_mul(c, &a->c0, &a->c1, &m);
    fe_mul(c, &s, &d, &o->c0);
    fe_add(c, &m, &m, &o->c1);
}
/* * xi = 9 + u */
static void fq2_mul_xi(const fctx *c, const fq2 *a, fq2 *o) {
    u256 a0_9, a1_9, t;
    fe_add(c, &a->c0, &a->c0, &t); fe_add(c, &t, &t, &t);
    fe_add(c, &t, &t, &a0_9); fe_add(c, &a0_9, &a->c0, &a0_9); /* 9*a0 */
    fe_add(c, &a->c1, &a->c1, &t); fe_add(c, &t, &t, &t);
    fe_add(c, &t, &t, &a1_9); fe_add(c, &a1_9, &a->c1, &a1_9); /* 9*a1 */
    fq2 r;
    fe_sub(c, &a0_9, &a->c1, &r.c0);
    fe_add(c, &a1_9, &a->c0, &r.c1);
    *o = r;
}
static void fq2_conj(const fctx *c, const fq2 *a, fq2 *o) {
    u256 zero = {{0, 0, 0, 0}};
    o->c0 = a->c0;
    fe_sub(c, &zero, &a->c1, &o->c1);
}
static void fq2_inv(const fctx *c, const fq2 *a, fq2 *o) {
    u256 t0, t1, t;
    fe_mul(c, &a->c0, &a->c0, &t0);
    fe_mul(c, &a->c1, &a->c1, &t1);
    fe_add(c, &t0, &t1, &t);
    fe_inv(c, &t, &t);
    fe_mul(c, &a->c0, &t, &o->c0);
    u256 zero = {{0, 0, 0, 0}};
    u256 n1;
    fe_mul(c, &a->c1, &t, &n1);
    fe_sub(c, &zero, &n1, &o->c1);
}
static int fq2_is_zero(const fq2 *a) {
    return fe_is_zero(&a->c0) && fe_is_zero(&a->c1);
}

static void fq6_add(const fctx *c, const fq6 *a, const fq6 *b, fq6 *o) {
    fq2_add(c, &a->c0, &b->c0, &o->c0);
    fq2_add(c, &a->c1, &b->c1, &o->c1);
    fq2_add(c, &a->c2, &b->c2, &o->c2);
}
static void fq6_sub(const fctx *c, const fq6 *a, const fq6 *b, fq6 *o) {
    fq2_sub(c, &a->c0, &b->c0, &o->c0);
    fq2_sub(c, &a->c1, &b->c1, &o->c1);
    fq2_sub(c, &a->c2, &b->c2, &o->c2);
}
static void fq6_neg(const fctx *c, const fq6 *a, fq6 *o) {
    fq2_neg(c, &a->c0, &o->c0);
    fq2_neg(c, &a->c1, &o->c1);
    fq2_neg(c, &a->c2, &o->c2);
}
/* * v */
static void fq6_mul_v(const fctx *c, const fq6 *a, fq6 *o) {
    fq6 r;
    fq2_mul_xi(c, &a->c2, &r.c0);
    r.c1 = a->c0;
    r.c2 = a->c1;
    *o = r;
}
static void fq6_mul(const fctx *c, const fq6 *a, const fq6 *b, fq6 *o) {
    fq2 t0, t1, t2, s1, s2, m, r0, r1, r2;
    fq2_mul(c, &a->c0, &b->c0, &t0);
    fq2_mul(c, &a->c1, &b->c1, &t1);
    fq2_mul(c, &a->c2, &b->c2, &t2);
    /* c0 = ((a1+a2)(b1+b2) - t1 - t2)*xi + t0 */
    fq2_add(c, &a->c1, &a->c2, &s1);
    fq2_add(c, &b->c1, &b->c2, &s2);
    fq2_mul(c, &s1, &s2, &m);
    fq2_sub(c, &m, &t1, &m);
    fq2_sub(c, &m, &t2, &m);
    fq2_mul_xi(c, &m, &m);
    fq2_add(c, &m, &t0, &r0);
    /* c1 = (a0+a1)(b0+b1) - t0 - t1 + t2*xi */
    fq2_add(c, &a->c0, &a->c1, &s1);
    fq2_add(c, &b->c0, &b->c1, &s2);
    fq2_mul(c, &s1, &s2, &m);
    fq2_sub(c, &m, &t0, &m);
    fq2_sub(c, &m, &t1, &m);
    fq2 t2xi;
    fq2_mul_xi(c, &t2, &t2xi);
    fq2_add(c, &m, &t2xi, &r1);
    /* c2 = (a0+a2)(b0+b2) - t0 - t2 + t1 */
    fq2_add(c, &a->c0, &a->c2, &s1);
    fq2_add(c, &b->c0, &b->c2, &s2);
    fq2_mul(c, &s1, &s2, &m);
    fq2_sub(c, &m, &t0, &m);
    fq2_sub(c, &m, &t2, &m);
    fq2_add(c, &m, &t1, &r2);
    o->c0 = r0; o->c1 = r1; o->c2 = r2;
}
/* sparse: (b0 + b1 v) */
static void fq6_mul01(const fctx *c, const fq6 *a, const fq2 *b0, const fq2 *b1, fq6 *o) {
    fq2 aa, bb, t, s1, s2, r0, r1, r2;
    fq2_mul(c, &a->c0, b0, &aa);
    fq2_mul(c, &a->c1, b1, &bb);
    fq2_add(c, &a->c1, &a->c2, &s1);
    fq2_mul(c, &s1, b1, &t);
    fq2_sub(c, &t, &bb, &t);
    fq2_mul_xi(c, &t, &t);
    fq2_add(c, &t, &aa, &r0);
    fq2_add(c, b0, b1, &s1);
    fq2_add(c, &a->c0, &a->c1, &s2);
    fq2_mul(c, &s1, &s2, &t);
    fq2_sub(c, &t, &aa, &t);
    fq2_sub(c, &t, &bb, &r1);
    fq2_add(c, &a->c0, &a->c2, &s1);
    fq2_mul(c, &s1, b0, &t);
    fq2_sub(c, &t, &aa, &t);
    fq2_add(c, &t, &bb, &r2);
    o->c0 = r0; o->c1 = r1; o->c2 = r2;
}
static void fq6_inv(const fctx *c, const fq6 *a, fq6 *o) {
    fq2 t0, t1, t2, m, det, di;
    fq2_sq(c, &a->c0, &t0);
    fq2_mul(c, &a->c1, &a->c2, &m);
    fq2_mul_xi(c, &m, &m);
    fq2_sub(c, &t0, &m, &t0);
    fq2_sq(c, &a->c2, &t1);
    fq2_mul_xi(c, &t1, &t1);
    fq2_mul(c, &a->c0, &a->c1, &m);
    fq2_sub(c, &t1, &m, &t1);
    fq2_sq(c, &a->c1, &t2);
    fq2_mul(c, &a->c0, &a->c2, &m);
    fq2_sub(c, &t2, &m, &t2);
    fq2 d0, d1, d2;
    fq2_mul(c, &a->c0, &t0, &d0);
    fq2_mul(c, &a->c2, &t1, &d1);
    fq2_mul_xi(c, &d1, &d1);
    fq2_mul(c, &a->c1, &t2, &d2);
    fq2_mul_xi(c, &d2, &d2);
    fq2_add(c, &d0, &d1, &det);
    fq2_add(c, &det, &d2, &det);
    fq2_inv(c, &det, &di);
    fq2_mul(c, &t0, &di, &o->c0);
    fq2_mul(c, &t1, &di, &o->c1);
    fq2_mul(c, &t2, &di, &o->c2);
}

static void fq12_mul(const fctx *c, const fq12 *a, const fq12 *b, fq12 *o) {
    fq6 t0, t1, s1, s2, m;
    fq6_mul(c, &a->c0, &b->c0, &t0);
    fq6_mul(c, &a->c1, &b->c1, &t1);
    fq6_add(c, &a->c0, &a->c1, &s1);
    fq6_add(c, &b->c0, &b->c1, &s2);
    fq6_mul(c, &s1, &s2, &m);
    fq6 t1v;
    fq6_mul_v(c, &t1, &t1v);
    fq6_add(c, &t0, &t1v, &o->c0);
    fq6_sub(c, &m, &t0, &m);
    fq6_sub(c, &m, &t1, &o->c1);
}
static void fq12_sq(const fctx *c, const fq12 *a, fq12 *o) {
    fq6 t, s1, s2, m;
    fq6_mul(c, &a->c0, &a->c1, &t);
    fq6_add(c, &a->c0, &a->c1, &s1);
    fq6 a1v;
    fq6_mul_v(c, &a->c1, &a1v);
    fq6_add(c, &a->c0, &a1v, &s2);
    fq6_mul(c, &s1, &s2, &m);
    fq6 tv;
    fq6_mul_v(c, &t, &tv);
    fq6_sub(c, &m, &t, &m);
    fq6_sub(c, &m, &tv, &o->c0);
    fq6_add(c, &t, &t, &o->c1);
}
static void fq12_conj(const fctx *c, const fq12 *a, fq12 *o) {
    o->c0 = a->c0;
    fq6_neg(c, &a->c1, &o->c1);
}
static void fq12_inv(const fctx *c, const fq12 *a, fq12 *o) {
    fq6 t0, t1, t;
    fq6_mul(c, &a->c0, &a->c0, &t0);
    fq6_mul(c, &a->c1, &a->c1, &t1);
    fq6_mul_v(c, &t1, &t1);
    fq6_sub(c, &t0, &t1, &t);
    fq6_inv(c, &t, &t);
    fq6_mul(c, &a->c0, &t, &o->c0);
    fq6 m;
    fq6_mul(c, &a->c1, &t, &m);
    fq6_neg(c, &m, &o->c1);
}
/* sparse mul by c0 + (c3 + c4 v) w */
static void fq12_mul034(const fctx *c, fq12 *f, const fq2 *s0, const fq2 *s3, const fq2 *s4) {
    fq6 t0, t1, o6;
    t0.c0 = f->c0.c0; t0.c1 = f->c0.c1; t0.c2 = f->c0.c2;
    fq2_mul(c, &f->c0.c0, s0, &t0.c0);
    fq2_mul(c, &f->c0.c1, s0, &t0.c1);
    fq2_mul(c, &f->c0.c2, s0, &t0.c2);
    fq6_mul01(c, &f->c1, s3, s4, &t1);
    fq2 o;
    fq2_add(c, s0, s3, &o);
    fq6 sum;
    fq6_add(c, &f->c1, &f->c0, &sum);
    fq6_mul01(c, &sum, &o, s4, &o6);
    fq6_sub(c, &o6, &t0, &o6);
    fq6_sub(c, &o6, &t1, &f->c1);
    fq6 t1v;
    fq6_mul_v(c, &t1, &t1v);
    fq6_add(c, &t1v, &t0, &f->c0);
}

/* frobenius powers 1..3 using coefficient tables passed from Python:
 * frob6_c1[i], frob6_c2[i] (i=1..3), frob12_c1[i] (i=1..3), each an fq2 */
typedef struct {
    fq2 c1_6[4], c2_6[4], c1_12[4];
} frob_tabs;

static void fq6_frob(const fctx *c, const frob_tabs *ft, int power, const fq6 *a, fq6 *o) {
    fq6 r = *a;
    for (int i = 0; i < power; i++) {
        fq2_conj(c, &r.c0, &r.c0);
        fq2_conj(c, &r.c1, &r.c1);
        fq2_conj(c, &r.c2, &r.c2);
    }
    fq2_mul(c, &r.c1, &ft->c1_6[power], &r.c1);
    fq2_mul(c, &r.c2, &ft->c2_6[power], &r.c2);
    *o = r;
}
static void fq12_frob(const fctx *c, const frob_tabs *ft, int power, const fq12 *a, fq12 *o) {
    fq6 r0, r1;
    fq6_frob(c, ft, power, &a->c0, &r0);
    fq6_frob(c, ft, power, &a->c1, &r1);
    fq2_mul(c, &r1.c0, &ft->c1_12[power], &r1.c0);
    fq2_mul(c, &r1.c1, &ft->c1_12[power], &r1.c1);
    fq2_mul(c, &r1.c2, &ft->c1_12[power], &r1.c2);
    o->c0 = r0; o->c1 = r1;
}

/* Granger-Scott cyclotomic squaring (fields/bn254.py:cyclotomic_square) */
static void fp4_sq(const fctx *c, const fq2 *a, const fq2 *b, fq2 *o0, fq2 *o1) {
    fq2 t0, t1, s;
    fq2_sq(c, a, &t0);
    fq2_sq(c, b, &t1);
    fq2_mul_xi(c, &t1, o0);
    fq2_add(c, o0, &t0, o0);
    fq2_add(c, a, b, &s);
    fq2_sq(c, &s, &s);
    fq2_sub(c, &s, &t0, &s);
    fq2_sub(c, &s, &t1, o1);
}
static void fq12_cyc_sq(const fctx *c, const fq12 *a, fq12 *o) {
    fq2 z0 = a->c0.c0, z4 = a->c0.c1, z3 = a->c0.c2;
    fq2 z2 = a->c1.c0, z1 = a->c1.c1, z5 = a->c1.c2;
    fq2 t0, t1, t2, t3, tmp;
    fp4_sq(c, &z0, &z1, &t0, &t1);
    fq2_sub(c, &t0, &z0, &tmp); fq2_add(c, &tmp, &tmp, &tmp); fq2_add(c, &tmp, &t0, &z0);
    fq2_add(c, &t1, &z1, &tmp); fq2_add(c, &tmp, &tmp, &tmp); fq2_add(c, &tmp, &t1, &z1);
    fp4_sq(c, &z2, &z3, &t0, &t1);
    fp4_sq(c, &z4, &z5, &t2, &t3);
    fq2_sub(c, &t0, &z4, &tmp); fq2_add(c, &tmp, &tmp, &tmp); fq2_add(c, &tmp, &t0, &z4);
    fq2_add(c, &t1, &z5, &tmp); fq2_add(c, &tmp, &tmp, &tmp); fq2_add(c, &tmp, &t1, &z5);
    fq2_mul_xi(c, &t3, &t0);
    fq2_add(c, &t0, &z2, &tmp); fq2_add(c, &tmp, &tmp, &tmp); fq2_add(c, &tmp, &t0, &z2);
    fq2_sub(c, &t2, &z3, &tmp); fq2_add(c, &tmp, &tmp, &tmp); fq2_add(c, &tmp, &t2, &z3);
    o->c0.c0 = z0; o->c0.c1 = z4; o->c0.c2 = z3;
    o->c1.c0 = z2; o->c1.c1 = z1; o->c1.c2 = z5;
}

static void fq12_one(const fctx *c, fq12 *o) {
    memset(o, 0, sizeof(*o));
    o->c0.c0.c0 = c->one;
}
static int fq12_is_one(const fctx *c, const fq12 *a) {
    fq12 one;
    fq12_one(c, &one);
    return memcmp(a, &one, sizeof(one)) == 0;
}

/* f^u with cyclotomic squarings (u = BN_U bits passed MSB-first) */
static void fq12_cyc_pow(const fctx *c, const fq12 *a, const uint8_t *bits,
                         int nbits, fq12 *o) {
    fq12 r;
    int started = 0;
    for (int i = 0; i < nbits; i++) {
        if (started) fq12_cyc_sq(c, &r, &r);
        if (bits[i]) {
            if (!started) { r = *a; started = 1; }
            else fq12_mul(c, &r, a, &r);
        }
    }
    if (!started) fq12_one(c, &r);
    *o = r;
}

/* One Miller pass over prepared line coefficients for a block of pairs;
 * writes the block's Miller value to *f.  Extracted from
 * pairing_check_prepared so the MT variant can run disjoint pair blocks
 * on separate threads: the Miller product is multiplicative across
 * pairs, and each block pays its own squaring chain, which is exactly
 * what makes the blocks independent. */
static void miller_prepared_loop(const fctx *c, const u256 *xp,
                                 const u256 *yp, const int *live,
                                 size_t npairs, const uint8_t *coeffs,
                                 size_t nsteps, const uint8_t *ate_bits,
                                 size_t nate, fq12 *f) {
    /* coefficient stream: canonical -> Montgomery on the fly */
    #define LOAD_STEP(i, step, lam, c4v) do { \
        const uint8_t *q = coeffs + ((i) * nsteps + (step)) * 128; \
        memcpy((lam).c0.w, q, 32); memcpy((lam).c1.w, q + 32, 32); \
        memcpy((c4v).c0.w, q + 64, 32); memcpy((c4v).c1.w, q + 96, 32); \
        fe_mul(c, &(lam).c0, &c->r2, &(lam).c0); \
        fe_mul(c, &(lam).c1, &c->r2, &(lam).c1); \
        fe_mul(c, &(c4v).c0, &c->r2, &(c4v).c0); \
        fe_mul(c, &(c4v).c1, &c->r2, &(c4v).c1); \
    } while (0)
    #define MUL_LINE(i) do { \
        fq2 lam, c4v, s0, s3; \
        LOAD_STEP(i, idx, lam, c4v); \
        s0.c0 = yp[i]; s0.c1 = zero256; \
        fq2 lx; \
        fe_mul(c, &lam.c0, &xp[i], &lx.c0); \
        fe_mul(c, &lam.c1, &xp[i], &lx.c1); \
        fq2_neg(c, &lx, &s3); \
        fq12_mul034(c, f, &s0, &s3, &c4v); \
    } while (0)

    fq12_one(c, f);
    size_t idx = 0;
    u256 zero256; memset(&zero256, 0, sizeof(zero256));
    for (size_t b = 0; b < nate; b++) {
        fq12_sq(c, f, f);
        for (size_t i = 0; i < npairs; i++) {
            if (!live[i]) continue;
            MUL_LINE(i);
        }
        idx++;
        if (ate_bits[b]) {
            for (size_t i = 0; i < npairs; i++) {
                if (!live[i]) continue;
                MUL_LINE(i);
            }
            idx++;
        }
    }
    for (int extra = 0; extra < 2; extra++) {
        for (size_t i = 0; i < npairs; i++) {
            if (!live[i]) continue;
            MUL_LINE(i);
        }
        idx++;
    }
    (void)nsteps;
    #undef MUL_LINE
    #undef LOAD_STEP
}

/* load the G1 sides (canonical -> Montgomery) and the frobenius tables */
static void pairing_load(const fctx *c, const uint8_t *points, size_t npairs,
                         const uint8_t *frob, u256 *xp, u256 *yp, int *live,
                         frob_tabs *ft) {
    for (size_t i = 0; i < npairs; i++) {
        u256 x, y;
        memcpy(x.w, points + 64 * i, 32);
        memcpy(y.w, points + 64 * i + 32, 32);
        live[i] = !(fe_is_zero(&x) && fe_is_zero(&y));
        fe_mul(c, &x, &c->r2, &xp[i]);
        fe_mul(c, &y, &c->r2, &yp[i]);
    }
    memset(ft, 0, sizeof(*ft));
    const uint8_t *fp_ = frob;
    for (int grp = 0; grp < 3; grp++) {
        for (int pw = 1; pw <= 3; pw++) {
            fq2 v;
            memcpy(v.c0.w, fp_, 32);
            memcpy(v.c1.w, fp_ + 32, 32);
            fp_ += 64;
            fe_mul(c, &v.c0, &c->r2, &v.c0);
            fe_mul(c, &v.c1, &c->r2, &v.c1);
            if (grp == 0) ft->c1_6[pw] = v;
            else if (grp == 1) ft->c2_6[pw] = v;
            else ft->c1_12[pw] = v;
        }
    }
}

static int final_exp_is_one(const fctx *cx, const frob_tabs *ftp,
                            const uint8_t *u_bits, size_t nu, const fq12 *fin);

/* multi-Miller loop over prepared lines + final exponentiation.
 * pairs: np G1 affine points (canonical LE x||y, 64B each).
 * coeffs: np * nsteps fq2 PAIRS (lam, c4) canonical LE (128B per step).
 * ate_bits: the |6u+2| bit string MSB-first EXCLUDING the leading bit.
 * u_bits: BN u MSB-first.  frob: 12 fq2 canonical (c1_6[1..3], c2_6[1..3],
 * c1_12[1..3], padded with 3 unused).  Returns 1 iff the pairing product
 * is one. */
int pairing_check_prepared(const uint8_t *points, size_t npairs,
                           const uint8_t *coeffs, size_t nsteps,
                           const uint8_t *ate_bits, size_t nate,
                           const uint8_t *u_bits, size_t nu,
                           const uint8_t *frob,
                           const uint64_t *p_words, const uint64_t *r2_words,
                           uint64_t n0inv) {
    if (npairs > 16) return -1;
    fctx c;
    fctx_init(&c, p_words, r2_words, n0inv);
    u256 xp[16], yp[16];
    int live[16];
    frob_tabs ft;
    pairing_load(&c, points, npairs, frob, xp, yp, live, &ft);
    fq12 f;
    miller_prepared_loop(&c, xp, yp, live, npairs, coeffs, nsteps,
                         ate_bits, nate, &f);
    return final_exp_is_one(&c, &ft, u_bits, nu, &f);
}

static int final_exp_is_one(const fctx *cx, const frob_tabs *ftp,
                            const uint8_t *u_bits, size_t nu,
                            const fq12 *fin) {
    const fctx c = *cx;
    const frob_tabs ft = *ftp;
    fq12 f = *fin;
    /* final exponentiation: easy part */
    fq12 finv, r;
    fq12_inv(&c, &f, &finv);
    fq12_conj(&c, &f, &r);
    fq12_mul(&c, &r, &finv, &r);
    fq12 rf;
    fq12_frob(&c, &ft, 2, &r, &rf);
    fq12_mul(&c, &rf, &r, &r);
    /* hard part: Fuentes-Castaneda chain (curves/pairing.py) */
    #define EXP_NEG_U(in, out) do { \
        fq12 t_; fq12_cyc_pow(&c, &(in), u_bits, (int)nu, &t_); \
        fq12_conj(&c, &t_, &(out)); \
    } while (0)
    fq12 y0, y1, y2, y3, y4, y5, y6, y7, y8, y9, y10, y11, y12, y13, y14, y15;
    EXP_NEG_U(r, y0);
    fq12_cyc_sq(&c, &y0, &y1);
    fq12_cyc_sq(&c, &y1, &y2);
    fq12_mul(&c, &y2, &y1, &y3);
    EXP_NEG_U(y3, y4);
    fq12_cyc_sq(&c, &y4, &y5);
    EXP_NEG_U(y5, y6);
    fq12_conj(&c, &y3, &y3);
    fq12_conj(&c, &y6, &y6);
    fq12_mul(&c, &y6, &y4, &y7);
    fq12_mul(&c, &y7, &y3, &y8);
    fq12_mul(&c, &y8, &y1, &y9);
    fq12_mul(&c, &y8, &y4, &y10);
    fq12_mul(&c, &y10, &r, &y11);
    fq12_frob(&c, &ft, 1, &y9, &y12);
    fq12_mul(&c, &y12, &y11, &y13);
    fq12_frob(&c, &ft, 2, &y8, &y8);
    fq12_mul(&c, &y8, &y13, &y14);
    fq12_conj(&c, &r, &r);
    fq12_mul(&c, &r, &y9, &y15);
    fq12_frob(&c, &ft, 3, &y15, &y15);
    fq12_mul(&c, &y15, &y14, &y15);
    return fq12_is_one(&c, &y15);
}

/* ------------------------------------------------------------------ */
/* threaded verifier entry points.  One verify is latency-bound on two
 * native calls (multiopen MSM ~1.5 ms, pairing ~1.7 ms single-thread);
 * the work inside each is embarrassingly parallel across points/pairs,
 * and a verify runs alone on the host, so a handful of pthreads turns
 * the reference's verifying-time row from a loss into a win. */

typedef struct {
    const fctx *c;
    const u256 *xp, *yp;
    const int *live;
    size_t npairs;
    const uint8_t *coeffs;
    size_t nsteps;
    const uint8_t *ate_bits;
    size_t nate;
    fq12 f;
} miller_task;

static void *miller_worker(void *arg) {
    miller_task *t = (miller_task *)arg;
    miller_prepared_loop(t->c, t->xp, t->yp, t->live, t->npairs, t->coeffs,
                         t->nsteps, t->ate_bits, t->nate, &t->f);
    return NULL;
}

/* pairing_check_prepared with the pairs split into min(nthreads, npairs)
 * contiguous blocks, each running one multi-pair Miller loop on its own
 * thread (each block repeats the shared squaring chain, but the blocks
 * run in parallel — a net win for the 2-pair KZG check, and never more
 * than nthreads concurrent workers).  Identical result. */
int pairing_check_prepared_mt(const uint8_t *points, size_t npairs,
                              const uint8_t *coeffs, size_t nsteps,
                              const uint8_t *ate_bits, size_t nate,
                              const uint8_t *u_bits, size_t nu,
                              const uint8_t *frob,
                              const uint64_t *p_words,
                              const uint64_t *r2_words, uint64_t n0inv,
                              int nthreads) {
    if (npairs > 16) return -1;
    if (nthreads <= 1 || npairs < 2)
        return pairing_check_prepared(points, npairs, coeffs, nsteps,
                                      ate_bits, nate, u_bits, nu, frob,
                                      p_words, r2_words, n0inv);
    fctx c;
    fctx_init(&c, p_words, r2_words, n0inv);
    u256 xp[16], yp[16];
    int live[16];
    frob_tabs ft;
    pairing_load(&c, points, npairs, frob, xp, yp, live, &ft);

    size_t nlive = 0;
    for (size_t i = 0; i < npairs; i++)
        if (live[i]) nlive++;
    fq12 f;
    if (nlive == 0) {
        fq12_one(&c, &f);
        return final_exp_is_one(&c, &ft, u_bits, nu, &f);
    }
    /* contiguous index blocks; an all-dead block computes f=1 (the live
     * mask skips its line multiplies), so block boundaries need no
     * live-aware balancing for the small npairs this path sees */
    size_t nblocks = (size_t)nthreads < npairs ? (size_t)nthreads : npairs;
    miller_task tasks[16];
    pthread_t th[16];
    int spawned[16];
    for (size_t b = 0; b < nblocks; b++) {
        size_t i0 = b * npairs / nblocks, i1 = (b + 1) * npairs / nblocks;
        miller_task *t = &tasks[b];
        t->c = &c; t->xp = &xp[i0]; t->yp = &yp[i0]; t->live = &live[i0];
        t->npairs = i1 - i0;
        t->coeffs = coeffs + i0 * nsteps * 128;
        t->nsteps = nsteps; t->ate_bits = ate_bits; t->nate = nate;
    }
    /* last block runs on the calling thread */
    for (size_t k = 0; k + 1 < nblocks; k++) {
        spawned[k] = pthread_create(&th[k], NULL, miller_worker,
                                    &tasks[k]) == 0;
        if (!spawned[k]) miller_worker(&tasks[k]);
    }
    miller_worker(&tasks[nblocks - 1]);
    f = tasks[nblocks - 1].f;
    for (size_t k = 0; k + 1 < nblocks; k++) {
        if (spawned[k]) pthread_join(th[k], NULL);
        fq12_mul(&c, &f, &tasks[k].f, &f);
    }
    return final_exp_is_one(&c, &ft, u_bits, nu, &f);
}

typedef struct {
    const uint8_t *points, *scalars;
    size_t n, npre;
    const uint8_t *pretab;
    int wpre, wvar;
    const uint64_t *p_words, *r2_words;
    uint64_t n0inv;
    uint8_t out[64];
    int rc;
} msm_task;

static void *msm_worker(void *arg) {
    msm_task *t = (msm_task *)arg;
    t->rc = g1_msm_pre(t->points, t->scalars, t->n, t->npre, t->pretab,
                       t->wpre, t->wvar, t->p_words, t->r2_words, t->n0inv,
                       t->out);
    return NULL;
}

/* g1_msm_pre over point-range slices on nthreads threads.  Each slice
 * pays its own shared-doubling chain and batch inversion, so the split
 * only wins when the per-point add work dominates — true from a few
 * dozen points up (the verifier's multiopen MSM).  Identical result. */
int g1_msm_pre_mt(const uint8_t *points, const uint8_t *scalars, size_t n,
                  size_t npre, const uint8_t *pretab, int wpre, int wvar,
                  const uint64_t *p_words, const uint64_t *r2_words,
                  uint64_t n0inv, int nthreads, uint8_t *out) {
    if (nthreads > 8) nthreads = 8;
    if (nthreads <= 1 || n < 16)
        return g1_msm_pre(points, scalars, n, npre, pretab, wpre, wvar,
                          p_words, r2_words, n0inv, out);
    if (n > 8192 || npre > n || wpre < 2 || wpre > 8) return -1;
    /* weighted split: a precomputed-table point costs ~2 units (wNAF
     * adds only), a variable point ~3 (table build + normalize + adds) */
    size_t total = 2 * npre + 3 * (n - npre);
    size_t per = (total + (size_t)nthreads - 1) / (size_t)nthreads;
    msm_task tasks[8];
    pthread_t th[8];
    int spawned[8];
    int nt = 0;
    size_t lo = 0;
    const size_t tszp = (size_t)1 << (wpre - 2);
    while (lo < n && nt < nthreads) {
        size_t hi = lo, acc = 0;
        while (hi < n && (acc < per || hi == lo)) {
            acc += hi < npre ? 2 : 3;
            hi++;
        }
        if (nt == nthreads - 1) hi = n;
        msm_task *t = &tasks[nt];
        t->points = points + 64 * lo;
        t->scalars = scalars + 32 * lo;
        t->n = hi - lo;
        t->npre = lo < npre ? (npre < hi ? npre : hi) - lo : 0;
        t->pretab = lo < npre ? pretab + lo * tszp * 64 : pretab;
        t->wpre = wpre; t->wvar = wvar;
        t->p_words = p_words; t->r2_words = r2_words; t->n0inv = n0inv;
        t->rc = -2;
        nt++;
        lo = hi;
    }
    for (int k = 1; k < nt; k++) {
        spawned[k] = pthread_create(&th[k], NULL, msm_worker,
                                    &tasks[k]) == 0;
        if (!spawned[k]) msm_worker(&tasks[k]);
    }
    msm_worker(&tasks[0]);
    for (int k = 1; k < nt; k++)
        if (spawned[k]) pthread_join(th[k], NULL);
    fctx c;
    fctx_init(&c, p_words, r2_words, n0inv);
    pjac acc2;
    acc2.inf = 1;
    for (int k = 0; k < nt; k++) {
        if (tasks[k].rc < 0) return -1;
        if (tasks[k].rc == 0) continue;  /* identity partial */
        u256 x, y;
        memcpy(x.w, tasks[k].out, 32);
        memcpy(y.w, tasks[k].out + 32, 32);
        fe_mul(&c, &x, &c.r2, &x);
        fe_mul(&c, &y, &c.r2, &y);
        pj_add_affine(&c, &acc2, &x, &y);
    }
    memset(out, 0, 64);
    if (acc2.inf) return 0;
    u256 zi, zi2, xa, ya, lit_one = {{1, 0, 0, 0}};
    fe_inv(&c, &acc2.z, &zi);
    fe_mul(&c, &zi, &zi, &zi2);
    fe_mul(&c, &acc2.x, &zi2, &xa);
    fe_mul(&c, &acc2.y, &zi2, &ya);
    fe_mul(&c, &ya, &zi, &ya);
    fe_mul(&c, &xa, &lit_one, &xa);
    fe_mul(&c, &ya, &lit_one, &ya);
    memcpy(out, xa.w, 32);
    memcpy(out + 32, ya.w, 32);
    return 1;
}

typedef struct {
    const uint8_t *in;
    size_t n;
    const uint8_t *b_bytes;
    const uint64_t *p_words, *r2_words;
    uint64_t n0inv;
    uint8_t *out, *flags;
    int rc;
} dec_task;

static void *dec_worker(void *arg) {
    dec_task *t = (dec_task *)arg;
    t->rc = g1_decompress_batch(t->in, t->n, t->b_bytes, t->p_words,
                                t->r2_words, t->n0inv, t->out, t->flags);
    return NULL;
}

/* g1_decompress_batch sliced across threads (each point's sqrt is
 * independent; out/flags slices are disjoint).  Identical result. */
int g1_decompress_batch_mt(const uint8_t *in, size_t n,
                           const uint8_t *b_bytes, const uint64_t *p_words,
                           const uint64_t *r2_words, uint64_t n0inv,
                           uint8_t *out, uint8_t *flags, int nthreads) {
    if (nthreads > 8) nthreads = 8;
    if (nthreads <= 1 || n < 8)
        return g1_decompress_batch(in, n, b_bytes, p_words, r2_words,
                                   n0inv, out, flags);
    dec_task tasks[8];
    pthread_t th[8];
    int spawned[8];
    int nt = 0;
    size_t per = (n + (size_t)nthreads - 1) / (size_t)nthreads;
    size_t lo = 0;
    while (lo < n && nt < nthreads) {
        size_t hi = lo + per < n ? lo + per : n;
        if (nt == nthreads - 1) hi = n;
        dec_task *t = &tasks[nt];
        t->in = in + 32 * lo; t->n = hi - lo; t->b_bytes = b_bytes;
        t->p_words = p_words; t->r2_words = r2_words; t->n0inv = n0inv;
        t->out = out + 64 * lo; t->flags = flags + lo; t->rc = -2;
        nt++;
        lo = hi;
    }
    for (int k = 1; k < nt; k++) {
        spawned[k] = pthread_create(&th[k], NULL, dec_worker,
                                    &tasks[k]) == 0;
        if (!spawned[k]) dec_worker(&tasks[k]);
    }
    dec_worker(&tasks[0]);
    for (int k = 1; k < nt; k++)
        if (spawned[k]) pthread_join(th[k], NULL);
    for (int k = 0; k < nt; k++)
        if (tasks[k].rc < 0) return -1;
    return 0;
}

/* ------------------------------------------------------------------ */
/* bulk uniform-bytes -> Montgomery Fr (the prover's random polynomial
 * draws n=2^k wide-reduced scalars per proof; Python bigint reduction
 * is ~0.2 s at k=16, this is ~15 ms).
 * in: (n, 64) LE uniform bytes; out: (n, 4) u64 LE words, Montgomery, the
 * port's (n, 8) u32 words, written in place (the rows handed in).
 * v = lo + 2^256*hi mod p; out = v*R = mont(lo,R2) + mont(mont(hi,R2),R2). */
void fr_from_uniform_mont(const uint8_t *in, size_t n, const uint64_t *p_words,
                          const uint64_t *r2_words, uint64_t n0inv,
                          uint64_t *out) {
    fctx c;
    fctx_init(&c, p_words, r2_words, n0inv);
    for (size_t i = 0; i < n; i++) {
        u256 lo, hi, a, b;
        memcpy(lo.w, in + 64 * i, 32);
        memcpy(hi.w, in + 64 * i + 32, 32);
        fe_mul(&c, &lo, &c.r2, &a);        /* lo * R */
        fe_mul(&c, &hi, &c.r2, &b);        /* hi * R */
        fe_mul(&c, &b, &c.r2, &b);         /* hi * R^2 */
        fe_add(&c, &a, &b, &a);            /* (lo + 2^256 hi) * R mod p */
        memcpy(out + 4 * i, a.w, 32);
    }
}
