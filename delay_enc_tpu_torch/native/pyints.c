/* Python ints -> 256-bit little-endian words, read in one C pass.
 *
 * `FieldCtx.to_mont_np` (ops/limbs.py) converts lists of Python ints (the
 * advice columns, a proof's pads and blinds) to Montgomery words.  Turning
 * each int into bytes in Python costs several bytecode steps an element;
 * this pass reads the list's ints here instead, and the Montgomery product
 * (`to_mont_words`, limbops.c) then runs over the words in place.
 *
 * Compiled against the interpreter's headers and loaded with ctypes.PyDLL,
 * so the caller holds the GIL for the whole call: the list cannot change
 * while it is read, and the borrowed items stay alive.
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
