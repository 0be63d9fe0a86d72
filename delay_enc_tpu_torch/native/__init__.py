"""Native (C) runtime components.

`limbops` — host-side Montgomery limb conversion and the lookup
permutation by counting; `ecops` — host-side BN254 G1 point kernels (MSM
plane folds for the prover, multi-scalar mul for the verifier); `pyints` —
reads lists of Python ints in C: into 256-bit words for
`FieldCtx.to_mont_np`, and a lookup's tag and wire columns into pair keys
for `_permuted_columns`.  Each is compiled on first use with the system C
compiler (cc -O3 -shared -fPIC) and loaded via ctypes.  `pyints` alone
includes `Python.h`, so it also needs the interpreter's headers
(`sysconfig.get_paths()["include"]`); it is its own shared object, loaded
with `ctypes.PyDLL` (the GIL held), so that a machine without those headers
still loads the other two.  Where a build fails, `get_lib`, `get_eclib` and
`get_pyints` return None and their callers take the pure-Python paths (the
Python API surfaces are unchanged either way); `status()` says which
library loaded and why one did not, and `require()` raises instead, for a
caller that must not run the host path in Python.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sysconfig

_HERE = os.path.dirname(__file__)
# the shared objects go to the package's build directory, not beside the
# sources
_BUILD = os.path.join(os.path.dirname(_HERE), "build")

_lib = None
_eclib = None
_ECLIB_TRIED = False
_pylib = None
_PYLIB_TRIED = False
_ERRORS: dict = {}  # library name -> why it did not load


def _build(src: str, so: str, cflags: tuple = ()) -> bool:
    # compile to a temp path, then atomically rename: overwriting the .so
    # in place would remap pages under any live process that has it
    # dlopen'd (SIGBUS hazard for a concurrently-running bench)
    # the temp name is per process: test workers may build concurrently
    tmp = f"{so}.{os.getpid()}.tmp"
    name = os.path.basename(src)[:-2]
    for flags in (["-O3", "-march=native", "-pthread"], ["-O3", "-pthread"]):
        try:
            subprocess.run(
                ["cc", *flags, *cflags, "-shared", "-fPIC", "-o", tmp, src],
                check=True,
                capture_output=True,
            )
            os.replace(tmp, so)
            return True
        except subprocess.CalledProcessError as e:
            _ERRORS[name] = f"cc {' '.join(flags)}: {e.stderr.decode(errors='replace')[-400:]}"
        except OSError as e:
            _ERRORS[name] = f"cc: {e}"
    return False


def _so(name: str) -> str:
    return os.path.join(_BUILD, f"_{name}.so")


def _load(name: str, cflags: tuple = (), dll=ctypes.CDLL):
    src = os.path.join(_HERE, f"{name}.c")
    so = _so(name)
    os.makedirs(_BUILD, exist_ok=True)
    if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
        if not _build(src, so, cflags):
            return None
    try:
        lib = dll(so)
    except OSError as e:
        _ERRORS[name] = f"dlopen: {e}"
        return None
    _ERRORS.pop(name, None)
    return lib


def get_lib():
    """ctypes handle to the limb-conversion library, or None."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _load("limbops")
    if lib is None:
        return None
    lib.from_mont.argtypes = [
        ctypes.c_void_p,
        ctypes.c_size_t,
        ctypes.c_void_p,
        ctypes.c_uint64,
        ctypes.c_void_p,
    ]
    lib.to_mont_words.argtypes = [
        ctypes.c_void_p,  # words u64[n][4], in place
        ctypes.c_size_t,
        ctypes.c_void_p,  # p words
        ctypes.c_void_p,  # r2 words
        ctypes.c_uint64,  # n0inv
    ]
    lib.to_mont_words.restype = None
    lib.lookup_permute.argtypes = [
        ctypes.c_void_p,  # keys u32[rows]
        ctypes.c_size_t,  # rows
        ctypes.c_size_t,  # usable
        ctypes.c_void_p,  # table u32[usable], sorted
        ctypes.c_void_p,  # fvals u32[usable][8]
        ctypes.c_void_p,  # out A' u32[usable][8]
        ctypes.c_void_p,  # out S' u32[usable][8]
    ]
    lib.lookup_permute.restype = ctypes.c_int64
    # lookup_fvals may be absent from a stale pre-round-5 .so: load
    # without it (prover falls back to the Python path)
    try:
        lib.lookup_fvals.argtypes = [
            ctypes.c_void_p,  # keys u32[n]
            ctypes.c_size_t,
            ctypes.c_void_p,  # theta canonical 32B LE
            ctypes.c_void_p,  # p words
            ctypes.c_void_p,  # r2 words
            ctypes.c_uint64,  # n0inv
            ctypes.c_void_p,  # out u32[n][16]
        ]
    except AttributeError:
        pass
    _lib = lib
    return _lib


def get_eclib():
    """ctypes handle to the G1 point-kernel library, or None."""
    global _eclib, _ECLIB_TRIED
    if _eclib is not None or _ECLIB_TRIED:
        return _eclib
    _ECLIB_TRIED = True
    lib = _load("ecops")
    if lib is None:
        return None
    lib.g1_fold_planes_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.g1_msm.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p,
    ]
    lib.g1_msm.restype = ctypes.c_int
    lib.g1_msm_pre.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p,
    ]
    lib.g1_msm_pre.restype = ctypes.c_int
    lib.g1_msm_precompute.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p,
    ]
    lib.g1_msm_precompute.restype = ctypes.c_int
    lib.pairing_check_prepared.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t,  # points, npairs
        ctypes.c_void_p, ctypes.c_size_t,  # coeffs, nsteps
        ctypes.c_void_p, ctypes.c_size_t,  # ate_bits, nate
        ctypes.c_void_p, ctypes.c_size_t,  # u_bits, nu
        ctypes.c_void_p,                   # frobenius coefficient table
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
    ]
    lib.pairing_check_prepared.restype = ctypes.c_int
    lib.g1_decompress_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.g1_decompress_batch.restype = ctypes.c_int
    lib.fq_sqrt.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
        ctypes.c_void_p,
    ]
    lib.fq_sqrt.restype = ctypes.c_int
    # threaded verifier entry points (identical results to the
    # single-thread forms; nthreads trails each original signature).  A
    # stale _ecops.so may predate these symbols — load without them (the
    # ec.py wrappers getattr-guard every MT call) rather than failing the
    # whole library.
    try:
        lib.g1_msm_pre_mt.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
            ctypes.c_int, ctypes.c_void_p,
        ]
        lib.g1_msm_pre_mt.restype = ctypes.c_int
        lib.pairing_check_prepared_mt.argtypes = [
            *lib.pairing_check_prepared.argtypes, ctypes.c_int,
        ]
        lib.pairing_check_prepared_mt.restype = ctypes.c_int
        lib.g1_decompress_batch_mt.argtypes = [
            *lib.g1_decompress_batch.argtypes, ctypes.c_int,
        ]
        lib.g1_decompress_batch_mt.restype = ctypes.c_int
    except AttributeError:
        pass
    lib.fr_from_uniform_mont.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p,
    ]
    _eclib = lib
    return _eclib


def get_pyints():
    """ctypes handle (PyDLL: the GIL held) to the Python-int reader, or
    None."""
    global _pylib, _PYLIB_TRIED
    if _pylib is not None or _PYLIB_TRIED:
        return _pylib
    _PYLIB_TRIED = True
    lib = _load("pyints", ("-I" + sysconfig.get_paths()["include"],), ctypes.PyDLL)
    if lib is None:
        return None
    lib.ints_to_words.argtypes = [
        ctypes.py_object,  # list or tuple
        ctypes.c_ssize_t,  # its length
        ctypes.c_void_p,   # out u64[n][4]
        ctypes.c_void_p,   # taken u8[n]
    ]
    lib.ints_to_words.restype = ctypes.c_ssize_t
    lib.lookup_keys.argtypes = [
        ctypes.py_object,  # tag column, list or tuple
        ctypes.py_object,  # advice wire, list or tuple
        ctypes.c_ssize_t,  # rows
        ctypes.c_void_p,   # out u32[rows]
    ]
    lib.lookup_keys.restype = ctypes.c_ssize_t
    _pylib = lib
    return _pylib


def status() -> dict:
    """{library: its shared object's path if it loaded, else None}, after
    trying to load all three."""
    loaded = {"limbops": get_lib(), "ecops": get_eclib(), "pyints": get_pyints()}
    return {name: _so(name) if lib is not None else None for name, lib in loaded.items()}


def require() -> dict:
    """Load the three C libraries or raise RuntimeError naming each that did not
    load and why; returns `status()`.  The libraries stay loaded, so every
    later caller takes the C path."""
    st = status()
    missing = [name for name, path in st.items() if path is None]
    if missing:
        raise RuntimeError("host C libraries not loaded: " + "; ".join(
            f"{name} ({_ERRORS.get(name, 'no reason recorded')})" for name in missing))
    return st
