/* Python ints read in one C pass.
 *
 * Two readers of a circuit's columns, which are lists of Python ints
 * (cs/builder.py), each one C pass over the list's items in place of a
 * Python step an element:
 *
 * - `ints_to_words`, for `FieldCtx.to_words_np` and `to_mont_np`
 *   (ops/limbs.py): the advice and instance columns, which the card then
 *   puts in Montgomery form, and a proof's pads and blinds, whose Montgomery
 *   product (`to_mont_words`, limbops.c) then runs over the words in place.
 * - `lookup_keys`, for `_permuted_columns` (plonk/prover.py): a lookup's tag
 *   column and advice wire, read together into the u32 pair keys
 *   tag << 16 | value; the permutation by counting (`lookup_permute`,
 *   limbops.c) then runs over the keys.
 *
 * Each reader takes the items it can and says which it could not; Python
 * reads those by its own rule, so every other object behaves as it would
 * without this file.  Compiled against the interpreter's headers and loaded
 * with ctypes.PyDLL, so the caller holds the GIL for the whole call: the
 * lists cannot change while they are read, and the borrowed items stay
 * alive.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>

/* For each item of the list or tuple `seq` (n items) that is an exact int
 * (not a bool, not a subclass) in [0, 2^256): its value as four 64-bit
 * little-endian words in out[4*i .. 4*i+3], taken[i] = 1.  Every other item
 * gets taken[i] = 0 and leaves its words unwritten.  Returns the count of
 * items not taken, or -1 with a Python error set when `seq` is neither a
 * list nor a tuple of n items. */
#if PY_VERSION_HEX >= 0x030C0000 && defined(_PyLong_NON_SIZE_BITS) && PyLong_SHIFT == 30
/* A non-negative int of at most 256 bits, read from its 30-bit digits
 * (cpython/longintrepr.h, the layout of 3.12: the digit count above
 * _PyLong_NON_SIZE_BITS of lv_tag, the sign in its low bits, 2 for a
 * negative int) into four 64-bit words; 0 for any other int, which the
 * caller then reads by the general rule.  A few nanoseconds where
 * _PyLong_AsByteArray, byte by byte, takes tens. */
static inline int digits_to_words(const PyLongObject *x, uint64_t *w) {
    const uintptr_t tag = x->long_value.lv_tag;
    if ((tag & _PyLong_SIGN_MASK) == 2) return 0;
    const Py_ssize_t nd = (Py_ssize_t)(tag >> _PyLong_NON_SIZE_BITS);
    const digit *d = x->long_value.ob_digit;
    /* 8 digits hold 240 bits: a ninth may add 16 more */
    if (nd > 9 || (nd == 9 && (d[8] >> 16) != 0)) return 0;
    w[0] = w[1] = w[2] = w[3] = 0;
    for (Py_ssize_t i = 0; i < nd; i++) {
        const unsigned bit = 30u * (unsigned)i, k = bit >> 6, s = bit & 63u;
        w[k] |= (uint64_t)d[i] << s;
        if (s > 34 && k < 3) w[k + 1] |= (uint64_t)d[i] >> (64 - s);
    }
    return 1;
}
#define HAVE_DIGITS_TO_WORDS 1
#endif

Py_ssize_t ints_to_words(PyObject *seq, Py_ssize_t n, uint64_t *out, uint8_t *taken) {
    if (!(PyList_CheckExact(seq) || PyTuple_CheckExact(seq)) || PySequence_Fast_GET_SIZE(seq) != n) {
        PyErr_SetString(PyExc_TypeError, "ints_to_words: expected a list or tuple of n items");
        return -1;
    }
    PyObject **items = PySequence_Fast_ITEMS(seq);
    Py_ssize_t missed = 0;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *x = items[i];
        uint64_t *w = out + 4 * i;
        int ok = PyLong_CheckExact(x);
#if PY_VERSION_HEX >= 0x030C0000
        /* most of a circuit's cells are small (zeros, bits, limbs): a
         * compact int holds its value in one machine word */
        if (ok && PyUnstable_Long_IsCompact((PyLongObject *)x)) {
            Py_ssize_t v = PyUnstable_Long_CompactValue((PyLongObject *)x);
            if (v >= 0) {
                w[0] = (uint64_t)v;
                w[1] = w[2] = w[3] = 0;
                taken[i] = 1;
                continue;
            }
        }
#endif
#ifdef HAVE_DIGITS_TO_WORDS
        if (ok && digits_to_words((PyLongObject *)x, w)) {
            taken[i] = 1;
            continue;
        }
#endif
        if (ok) {
            /* is_signed = 0: a negative int or one of 2^256 or more fails
             * and sets an error, which this pass clears */
#if PY_VERSION_HEX >= 0x030D0000
            ok = _PyLong_AsByteArray((PyLongObject *)x, (unsigned char *)w, 32, 1, 0, 1) == 0;
#else
            ok = _PyLong_AsByteArray((PyLongObject *)x, (unsigned char *)w, 32, 1, 0) == 0;
#endif
            if (!ok) PyErr_Clear();
        }
        taken[i] = (uint8_t)ok;
        missed += !ok;
    }
    return missed;
}

/* A small exact int: an int (not a bool, not a subclass) whose value fits
 * one machine word, stored in *v.  0 for every other object. */
static inline int small_int(PyObject *x, Py_ssize_t *v) {
    if (!PyLong_CheckExact(x)) return 0;
#if PY_VERSION_HEX >= 0x030C0000
    if (!PyUnstable_Long_IsCompact((PyLongObject *)x)) return 0;
    *v = PyUnstable_Long_CompactValue((PyLongObject *)x);
    return 1;
#else
    int overflow;
    long long r = PyLong_AsLongLongAndOverflow(x, &overflow);
    if (overflow || (r == -1 && PyErr_Occurred())) {
        PyErr_Clear();
        return 0;
    }
    *v = (Py_ssize_t)r;
    return 1;
#endif
}

/* The pair keys of a lookup's first `rows` rows: for row i, with the tag
 * t = tags[i] and the advice value v = wire[i], keys[i] = t << 16 | v where
 * t != 0, and 0 where t == 0 (v is then not read, whatever it is).  Stops
 * at the first row it cannot take and returns it (rows when it took them
 * all): a tag that is not a small exact int in [0, 2^16), a tagged row
 * whose value is not one, a row past the end of `wire`, or any row when
 * `tags` or `wire` is neither a list nor a tuple, or `tags` has fewer than
 * `rows` items.  The caller reads the rows from there on in Python. */
Py_ssize_t lookup_keys(PyObject *tags, PyObject *wire, Py_ssize_t rows, uint32_t *keys) {
    if (!(PyList_CheckExact(tags) || PyTuple_CheckExact(tags))
        || !(PyList_CheckExact(wire) || PyTuple_CheckExact(wire))
        || PySequence_Fast_GET_SIZE(tags) < rows)
        return 0;
    PyObject **ts = PySequence_Fast_ITEMS(tags);
    PyObject **ws = PySequence_Fast_ITEMS(wire);
    Py_ssize_t end = PySequence_Fast_GET_SIZE(wire) < rows ? PySequence_Fast_GET_SIZE(wire) : rows;
    for (Py_ssize_t i = 0; i < end; i++) {
        Py_ssize_t t, v;
        if (!small_int(ts[i], &t) || t < 0 || t >= (1 << 16)) return i;
        if (t == 0) {
            keys[i] = 0;
            continue;
        }
        if (!small_int(ws[i], &v) || v < 0 || v >= (1 << 16)) return i;
        keys[i] = ((uint32_t)t << 16) | (uint32_t)v;
    }
    return end;
}
