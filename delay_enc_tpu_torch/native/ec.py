"""Python wrappers for the native BN254 G1 kernels (ecops.c).

Callers (`ops/msm.py`, `curves/bn254.py`) use these when the C library is
available and fall back to their pure-Python paths otherwise.
"""

from __future__ import annotations

import os

import numpy as np

from ..fields.bn254 import FQ
from . import get_eclib

_P = FQ.p
_CONSTS = None


def _consts():
    global _CONSTS
    if _CONSTS is None:
        p_words = np.frombuffer(_P.to_bytes(32, "little"), dtype="<u8").copy()
        r2 = ((1 << 256) % _P) ** 2 % _P
        r2_words = np.frombuffer(r2.to_bytes(32, "little"), dtype="<u8").copy()
        n0inv = (-pow(_P, -1, 1 << 64)) % (1 << 64)
        _CONSTS = (p_words, r2_words, n0inv)
    return _CONSTS


def fold_planes_batch(planes: np.ndarray, base_bits: int):
    """planes: (B, np, 3, 16) uint32 u16-limb projective Montgomery plane
    sums (LSB-first).  Returns a list of B affine points [(x, y) | None],
    each = sum_p base^p planes[b, p].  None if the C library is missing."""
    lib = get_eclib()
    if lib is None:
        return None
    planes = np.ascontiguousarray(planes.astype(np.uint32, copy=False))
    b, n_planes = planes.shape[0], planes.shape[1]
    out = np.empty(b * 64, dtype=np.uint8)
    flags = np.empty(b, dtype=np.uint8)
    pw, r2w, n0 = _consts()
    lib.g1_fold_planes_batch(
        planes.ctypes.data, b, n_planes, base_bits,
        pw.ctypes.data, r2w.ctypes.data, n0, out.ctypes.data, flags.ctypes.data,
    )
    ob = out.tobytes()
    res = []
    for i in range(b):
        if not flags[i]:
            res.append(None)
        else:
            x = int.from_bytes(ob[64 * i : 64 * i + 32], "little")
            y = int.from_bytes(ob[64 * i + 32 : 64 * i + 64], "little")
            res.append((x, y))
    return res


PRE_WINDOW = 7   # wNAF window for precomputed (per-vk fixed) points
VAR_WINDOW = 5   # wNAF window for per-proof points


def verify_threads(threads: int | None = None) -> int:
    """Thread count for the host-verifier C kernels.  A single verify is
    latency-bound on the multiopen MSM and the pairing check, both
    embarrassingly parallel inside; `threads` is the caller's count, held
    to 1..8 (1 disables threading), by default min(4, cpu count).  The
    JAX package reads DELAY_ENC_VERIFY_THREADS here; the port reads no
    environment, and its callers pass the count down."""
    if threads is not None:
        return min(max(int(threads), 1), 8)
    return min(4, os.cpu_count() or 1)


def msm_precompute(points, w: int = PRE_WINDOW):
    """Montgomery-form odd-multiple tables {1,3,...,2^(w-1)-1}P for a
    FIXED point set (the verifier builds these once per verifying key).
    Returns opaque bytes for msm_host(pretab=...), or None when the C
    library is missing."""
    lib = get_eclib()
    if lib is None or len(points) > 8192:
        return None
    n = len(points)
    pts = bytearray(64 * n)
    for i, pt in enumerate(points):
        if pt is None:
            continue
        pts[64 * i : 64 * i + 32] = pt[0].to_bytes(32, "little")
        pts[64 * i + 32 : 64 * i + 64] = pt[1].to_bytes(32, "little")
    out = np.empty(n * (1 << (w - 2)) * 64, dtype=np.uint8)
    pw, r2w, n0 = _consts()
    rc = lib.g1_msm_precompute(
        bytes(pts), n, w, pw.ctypes.data, r2w.ctypes.data, n0, out.ctypes.data
    )
    if rc < 0:
        return None
    return out.tobytes()


def msm_host(scalars, points, order: int, pretab: bytes | None = None,
             npre: int = 0, wpre: int = PRE_WINDOW, threads: int | None = None):
    """sum_i scalars[i] * points[i] over host affine ints, on
    `verify_threads(threads)` threads.  The first
    `npre` points may come with precomputed tables (msm_precompute) —
    identical result, no per-call table build for them.  Returns the
    affine point, None for identity, or the string "unavailable" when the
    C library is missing (distinct from a legitimate None result)."""
    lib = get_eclib()
    if lib is None or len(points) > 8192:
        return "unavailable"
    n = len(points)
    pts = bytearray(64 * n)
    scs = bytearray(32 * n)
    for i, (s, pt) in enumerate(zip(scalars, points)):
        s = s % order
        if pt is None or s == 0:
            continue  # row stays zero = identity/skip
        pts[64 * i : 64 * i + 32] = pt[0].to_bytes(32, "little")
        pts[64 * i + 32 : 64 * i + 64] = pt[1].to_bytes(32, "little")
        scs[32 * i : 32 * i + 32] = s.to_bytes(32, "little")
    out = np.empty(64, dtype=np.uint8)
    pw, r2w, n0 = _consts()
    mt = getattr(lib, "g1_msm_pre_mt", None)
    if pretab is not None and npre:
        if mt is not None:
            rc = mt(
                bytes(pts), bytes(scs), n, npre, pretab, wpre, VAR_WINDOW,
                pw.ctypes.data, r2w.ctypes.data, n0, verify_threads(threads),
                out.ctypes.data,
            )
        else:
            rc = lib.g1_msm_pre(
                bytes(pts), bytes(scs), n, npre, pretab, wpre, VAR_WINDOW,
                pw.ctypes.data, r2w.ctypes.data, n0, out.ctypes.data,
            )
    elif mt is not None:
        rc = mt(
            bytes(pts), bytes(scs), n, 0, None, PRE_WINDOW, VAR_WINDOW,
            pw.ctypes.data, r2w.ctypes.data, n0, verify_threads(threads),
            out.ctypes.data,
        )
    else:
        rc = lib.g1_msm(
            bytes(pts), bytes(scs), n, pw.ctypes.data, r2w.ctypes.data, n0,
            out.ctypes.data,
        )
    if rc < 0:
        return "unavailable"
    if rc == 0:
        return None
    ob = out.tobytes()
    return (
        int.from_bytes(ob[:32], "little"),
        int.from_bytes(ob[32:], "little"),
    )


def g1_decompress_batch(blobs: bytes, n: int, b_curve: int, threads: int | None = None):
    """Decompress n 32-byte G1 encodings (concatenated) in one C call, on
    `verify_threads(threads)` threads.
    Returns a list of affine points/None, raises ValueError on any invalid
    encoding, or returns the string "unavailable" without the C library."""
    lib = get_eclib()
    if lib is None:
        return "unavailable"
    out = np.empty(n * 64, dtype=np.uint8)
    flags = np.empty(n, dtype=np.uint8)
    pw, r2w, n0 = _consts()
    mt = getattr(lib, "g1_decompress_batch_mt", None)
    nthreads = verify_threads(threads)
    if mt is not None and nthreads > 1 and n >= 8:
        rc = mt(
            blobs, n, b_curve.to_bytes(32, "little"),
            pw.ctypes.data, r2w.ctypes.data, n0,
            out.ctypes.data, flags.ctypes.data, nthreads,
        )
    else:
        rc = lib.g1_decompress_batch(
            blobs, n, b_curve.to_bytes(32, "little"),
            pw.ctypes.data, r2w.ctypes.data, n0, out.ctypes.data, flags.ctypes.data,
        )
    if rc < 0:
        return "unavailable"
    if (flags > 1).any():
        raise ValueError("invalid G1 encoding in proof")
    ob = out.tobytes()
    return [
        None if flags[i] == 0 else (
            int.from_bytes(ob[64 * i : 64 * i + 32], "little"),
            int.from_bytes(ob[64 * i + 32 : 64 * i + 64], "little"),
        )
        for i in range(n)
    ]


def fq_sqrt_host(a: int):
    """Square root of a mod the BN254 base field p (p = 3 mod 4) via the
    C kernel: one 254-bit modexp in C instead of Python's `pow`.  Returns
    the root (parity unspecified), None if a is a non-residue, or the
    string "unavailable" when the C library is missing."""
    lib = get_eclib()
    if lib is None:
        return "unavailable"
    out = np.empty(32, dtype=np.uint8)
    pw, r2w, n0 = _consts()
    rc = lib.fq_sqrt(
        (a % _P).to_bytes(32, "little"), pw.ctypes.data, r2w.ctypes.data, n0,
        out.ctypes.data,
    )
    if rc < 0:
        return "unavailable"
    if rc == 0:
        return None
    return int.from_bytes(out.tobytes(), "little")


# ---- native pairing check (prepared lines) -------------------------------

_PAIRING_CONSTS = None


def _pairing_consts():
    """(ate_bits, u_bits, frob_table_bytes) — computed once."""
    global _PAIRING_CONSTS
    if _PAIRING_CONSTS is None:
        from ..fields.bn254 import ATE_LOOP_COUNT, BN_U, _frob_coeffs
        from ..fields import bn254 as F

        ate = bytes(int(b) for b in bin(ATE_LOOP_COUNT)[2:][1:])
        u_bits = bytes(int(b) for b in bin(BN_U)[2:])
        _frob_coeffs()
        frob = b""
        for tab in (F._FROB_C1_6, F._FROB_C2_6, F._FROB_C1_12):
            for pw in (1, 2, 3):
                v = tab[pw]
                frob += v.c0.to_bytes(32, "little") + v.c1.to_bytes(32, "little")
        _PAIRING_CONSTS = (ate, u_bits, frob)
    return _PAIRING_CONSTS


def _pack_prepared(prep) -> bytes:
    """G2Prepared -> packed canonical coefficient bytes (cached on the
    object: prepared points are fixed per SRS)."""
    packed = getattr(prep, "_native_packed", None)
    if packed is None:
        out = bytearray()
        for lam, c4 in prep.coeffs:
            out += lam.c0.to_bytes(32, "little") + lam.c1.to_bytes(32, "little")
            out += c4.c0.to_bytes(32, "little") + c4.c1.to_bytes(32, "little")
        packed = bytes(out)
        prep._native_packed = packed
    return packed


def pairing_check_native(pairs, threads: int | None = None):
    """pairs: [(g1_affine | None, G2Prepared)], on `verify_threads(threads)`
    threads.  Returns True/False, or None when the C library is
    unavailable (caller falls back to Python)."""
    lib = get_eclib()
    if lib is None or not pairs or len(pairs) > 16:
        return None
    nsteps = len(pairs[0][1].coeffs)
    if any(len(q.coeffs) != nsteps for _, q in pairs):
        return None
    pts = bytearray(64 * len(pairs))
    coeffs = bytearray()
    for i, (pt, q) in enumerate(pairs):
        if pt is not None:
            pts[64 * i : 64 * i + 32] = pt[0].to_bytes(32, "little")
            pts[64 * i + 32 : 64 * i + 64] = pt[1].to_bytes(32, "little")
        coeffs += _pack_prepared(q)
    ate, u_bits, frob = _pairing_consts()
    pw, r2w, n0 = _consts()
    mt = getattr(lib, "pairing_check_prepared_mt", None)
    nthreads = verify_threads(threads)
    if mt is not None and nthreads > 1 and len(pairs) > 1:
        rc = mt(
            bytes(pts), len(pairs), bytes(coeffs), nsteps,
            ate, len(ate), u_bits, len(u_bits), frob,
            pw.ctypes.data, r2w.ctypes.data, n0, nthreads,
        )
    else:
        rc = lib.pairing_check_prepared(
            bytes(pts), len(pairs), bytes(coeffs), nsteps,
            ate, len(ate), u_bits, len(u_bits), frob,
            pw.ctypes.data, r2w.ctypes.data, n0,
        )
    if rc < 0:
        return None
    return bool(rc)


_FR_CONSTS = None


def _fr_consts():
    global _FR_CONSTS
    if _FR_CONSTS is None:
        from ..fields.bn254 import FR

        p = FR.p
        pw = np.frombuffer(p.to_bytes(32, "little"), dtype="<u8").copy()
        r2 = ((1 << 256) % p) ** 2 % p
        r2w = np.frombuffer(r2.to_bytes(32, "little"), dtype="<u8").copy()
        n0 = (-pow(p, -1, 1 << 64)) % (1 << 64)
        _FR_CONSTS = (pw, r2w, n0)
    return _FR_CONSTS


def uniform_to_fr_mont(raw: np.ndarray, out: np.ndarray | None = None):
    """(n, 64) LE uniform bytes -> (n, 8) uint32 Montgomery Fr words via
    the C wide reduction, written into `out` where given (C-contiguous
    uint32 (n, 8), which is returned), or None when the C library is
    missing."""
    from ..ops.limbs import rows_to_write

    lib = get_eclib()
    if lib is None:
        return None
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    n = raw.shape[0]
    out = np.empty((n, 8), dtype=np.uint32) if out is None else rows_to_write(out, n)
    pw, r2w, n0 = _fr_consts()
    lib.fr_from_uniform_mont(
        raw.ctypes.data, n, pw.ctypes.data, r2w.ctypes.data, n0, out.ctypes.data
    )
    return out
