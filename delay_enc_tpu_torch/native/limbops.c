/* Native host-side limb conversion kernels.
 *
 * The TPU framework crosses the host<->device boundary with (n, 16) uint32
 * tensors of 16-bit limbs in Montgomery form (R = 2^256).  The pure-Python
 * conversions (Python bigints, ~µs/element) show up in every prover phase
 * that pulls evaluations or witness columns; these C kernels do the same
 * work with 64-bit-word CIOS Montgomery arithmetic (__uint128_t products),
 * ~100x faster.
 *
 * Compiled at import time by delay_enc_tpu/native/__init__.py (cc -O2
 * -shared); loaded via ctypes.  Field parameters (p, n', R^2) are passed in
 * per call, so the same binary serves Fr and Fq.
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

typedef unsigned __int128 u128;

/* 4x64-bit little-endian representation */
typedef struct { uint64_t w[4]; } u256;

static inline void load_from_u16limbs(const uint32_t *limbs, u256 *out) {
    for (int i = 0; i < 4; i++) {
        uint64_t v = 0;
        for (int j = 3; j >= 0; j--) {
            v = (v << 16) | (uint64_t)(limbs[i * 4 + j] & 0xFFFF);
        }
        out->w[i] = v;
    }
}

static inline void store_to_u16limbs(const u256 *in, uint32_t *limbs) {
    for (int i = 0; i < 4; i++) {
        uint64_t v = in->w[i];
        for (int j = 0; j < 4; j++) {
            limbs[i * 4 + j] = (uint32_t)(v & 0xFFFF);
            v >>= 16;
        }
    }
}

static inline int geq(const u256 *a, const u256 *b) {
    for (int i = 3; i >= 0; i--) {
        if (a->w[i] != b->w[i]) return a->w[i] > b->w[i];
    }
    return 1;
}

static inline void sub_inplace(u256 *a, const u256 *b) {
    u128 borrow = 0;
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)a->w[i] - b->w[i] - borrow;
        a->w[i] = (uint64_t)d;
        borrow = (d >> 64) & 1;
    }
}

/* Montgomery product: a * b * R^-1 mod p (CIOS, 4x64-bit words). */
static void mont_mul(const u256 *a, const u256 *b, const u256 *p,
                     uint64_t n0inv, u256 *out) {
    uint64_t t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; i++) {
        /* t += a[i] * b */
        u128 carry = 0;
        for (int j = 0; j < 4; j++) {
            u128 cur = (u128)t[j] + (u128)a->w[i] * b->w[j] + carry;
            t[j] = (uint64_t)cur;
            carry = cur >> 64;
        }
        u128 cur = (u128)t[4] + carry;
        t[4] = (uint64_t)cur;
        t[5] = (uint64_t)(cur >> 64);
        /* reduce one word */
        uint64_t m = t[0] * n0inv;
        carry = 0;
        for (int j = 0; j < 4; j++) {
            u128 c2 = (u128)t[j] + (u128)m * p->w[j] + carry;
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
    if (t[4] || geq(&r, p)) sub_inplace(&r, p);
    *out = r;
}

/* limbs (n,16) Montgomery -> canonical 32-byte LE values. */
void from_mont(const uint32_t *limbs, size_t n, const uint64_t *p_words,
               uint64_t n0inv, uint8_t *out) {
    u256 p, one = {{1, 0, 0, 0}};
    memcpy(p.w, p_words, 32);
    for (size_t k = 0; k < n; k++) {
        u256 v, r;
        load_from_u16limbs(limbs + 16 * k, &v);
        mont_mul(&v, &one, &p, n0inv, &r); /* v * 1 * R^-1 = canonical */
        memcpy(out + 32 * k, r.w, 32);
    }
}

/* canonical 32-byte LE values -> limbs (n,16) Montgomery. */
void to_mont(const uint8_t *in, size_t n, const uint64_t *p_words,
             const uint64_t *r2_words, uint64_t n0inv, uint32_t *out) {
    u256 p, r2;
    memcpy(p.w, p_words, 32);
    memcpy(r2.w, r2_words, 32);
    for (size_t k = 0; k < n; k++) {
        u256 v, r;
        memcpy(v.w, in + 32 * k, 32);
        mont_mul(&v, &r2, &p, n0inv, &r); /* v * R^2 * R^-1 = v * R */
        store_to_u16limbs(&r, out + 16 * k);
    }
}

/* Compressed lookup-table values, vectorized (plonk/prover.py lookup
 * phase): for each u32 key k (tag t = k>>16, value v = k&0xFFFF) compute
 *   f = (t + theta * t * v) mod p
 * directly in the device's u16-limb Montgomery layout.  Replaces the
 * per-proof Python path (bigint dict build + per-row dict lookups +
 * per-element to_bytes) with one C pass over the <= 2^16 table keys.
 * theta arrives canonical (32-byte LE). */
void lookup_fvals(const uint32_t *keys, size_t n, const uint8_t *theta_bytes,
                  const uint64_t *p_words, const uint64_t *r2_words,
                  uint64_t n0inv, uint32_t *out) {
    u256 p, r2, theta, theta_m;
    memcpy(p.w, p_words, 32);
    memcpy(r2.w, r2_words, 32);
    memcpy(theta.w, theta_bytes, 32);
    mont_mul(&theta, &r2, &p, n0inv, &theta_m); /* theta * R */
    for (size_t k = 0; k < n; k++) {
        uint64_t t = keys[k] >> 16, v = keys[k] & 0xFFFF;
        u256 tv = {{t * v, 0, 0, 0}};
        u256 prod; /* mont_mul(theta*R, tv) = theta * tv mod p, canonical */
        mont_mul(&theta_m, &tv, &p, n0inv, &prod);
        /* f = t + prod (t < 2^16, prod < p: one add, one cond-subtract) */
        u128 carry = t;
        for (int i = 0; i < 4; i++) {
            carry += prod.w[i];
            prod.w[i] = (uint64_t)carry;
            carry >>= 64;
        }
        if (carry || geq(&prod, &p)) sub_inplace(&prod, &p);
        u256 f_m;
        mont_mul(&prod, &r2, &p, n0inv, &f_m); /* -> Montgomery */
        store_to_u16limbs(&f_m, out + 16 * k);
    }
}
