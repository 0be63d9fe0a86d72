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
#include <stdlib.h>
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

/* (n, 4) 64-bit LE words, each value in [0, 2^256) -> its Montgomery form
 * mod p, in place: the port's (n, 8) 32-bit words.  No reduction first: for
 * v < 2^256 and R^2 mod p < p the CIOS result stays below 2p, and
 * mont_mul's conditional subtraction finishes it. */
void to_mont_words(uint64_t *words, size_t n, const uint64_t *p_words,
                   const uint64_t *r2_words, uint64_t n0inv) {
    u256 p, r2;
    memcpy(p.w, p_words, 32);
    memcpy(r2.w, r2_words, 32);
    for (size_t k = 0; k < n; k++) {
        u256 v, r;
        memcpy(v.w, words + 4 * k, 32);
        if ((v.w[0] | v.w[1] | v.w[2] | v.w[3]) == 0) continue; /* 0 * R = 0 */
        mont_mul(&v, &r2, &p, n0inv, &r); /* v * R^2 * R^-1 = v * R */
        memcpy(words + 4 * k, r.w, 32);
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

/* halo2's lookup permutation (plonk/prover.py _permuted_columns), by
 * counting over the table's keys instead of sorting the column.
 *
 * keys u32[rows]: the lookup's pair keys (tag << 16 | value, 0 untagged);
 * the rows from `rows` to `usable` are key 0.  table u32[usable]: the
 * padded table's keys, sorted; equal keys form a group, whose first row
 * stands for it.  fvals u32[usable][8]: each table row's compressed value
 * as Montgomery words.  Writes ap and sp, u32[usable][8] each:
 *   A' = each group's value repeated by the count of its key among the
 *        `usable` keys, in the table's order (the keys sorted);
 *   S' = a used group's value at the first row of its run in A', and the
 *        table's other rows, in order, at the other rows; every row takes
 *        the value of its key's group.
 * One pass counts the keys (a binary search over the groups, skipped while
 * a run of equal keys lasts), then each output row is written once.
 * Returns -1; or the smallest key not in the table, with nothing written;
 * or -2 when out of memory.  Needs rows <= usable.  Holds no Python
 * object: ctypes releases the GIL for the call. */
int64_t lookup_permute(const uint32_t *keys, size_t rows, size_t usable,
                       const uint32_t *table, const uint32_t *fvals,
                       uint32_t *ap, uint32_t *sp) {
    size_t *first = malloc((usable + 1) * sizeof(size_t)); /* group j's first row */
    size_t *count = calloc(usable + 1, sizeof(size_t));    /* group j's keys */
    uint32_t *gkey = malloc((usable + 1) * sizeof(uint32_t));
    if (!first || !count || !gkey) {
        free(first), free(count), free(gkey);
        return -2;
    }
    size_t m = 0;
    for (size_t i = 0; i < usable; i++)
        if (i == 0 || table[i] != table[i - 1]) {
            gkey[m] = table[i];
            first[m++] = i;
        }
    first[m] = usable;
    int64_t missing = -1;
    size_t last = 0; /* the group of the key before */
    for (size_t i = 0; i <= rows; i++) {
        uint32_t k = 0;
        size_t c = 1;
        if (i < rows)
            k = keys[i];
        else if (rows < usable)
            c = usable - rows; /* the rows past the circuit's: key 0 */
        else
            break;
        if (m == 0 || gkey[last] != k) {
            size_t lo = 0, hi = m; /* the first group whose key is >= k */
            while (lo < hi) {
                size_t mid = (lo + hi) / 2;
                if (gkey[mid] < k) lo = mid + 1;
                else hi = mid;
            }
            if (lo == m || gkey[lo] != k) {
                if (missing < 0 || k < (uint64_t)missing) missing = k;
                continue;
            }
            last = lo;
        }
        count[last] += c;
    }
    if (missing < 0) {
        size_t r = 0;
        for (size_t j = 0; j < m; j++)
            for (size_t c = 0; c < count[j]; c++, r++)
                memcpy(ap + 8 * r, fvals + 8 * first[j], 32);
        size_t li = 0, g = 0; /* the next table row to fill with, its group */
        r = 0;
        for (size_t j = 0; j < m; j++) {
            if (count[j] == 0) continue;
            memcpy(sp + 8 * r++, fvals + 8 * first[j], 32);
            for (size_t c = 1; c < count[j]; c++, li++) {
                for (;; li++) { /* skip the first rows of used groups */
                    while (first[g + 1] <= li) g++;
                    if (li != first[g] || count[g] == 0) break;
                }
                memcpy(sp + 8 * r++, fvals + 8 * first[g], 32);
            }
        }
    }
    free(first), free(count), free(gkey);
    return missing;
}
