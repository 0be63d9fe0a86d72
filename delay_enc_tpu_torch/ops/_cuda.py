"""Build, load and launch the hand-written CUDA kernels of `csrc/`.

Each `csrc/<name>.cu` becomes `build/lib<name>.so`, compiled by `nvcc` with
a plain C interface at first use (one `nvcc` per source, all started
together) and loaded with `ctypes`.  Every pointer and the stream go over
as `c_void_p`; each C entry point launches on the given stream and returns
`cudaGetLastError()`, which `Kernel.__call__` turns into an exception.

Each `Kernel` keeps a launch count, so a run can show which kernels its
main path went through (`reset_launches`, `launch_counts`).  The counts,
the build and the bindings are shared by every thread (the pipelined
prover launches from several) and kept under one lock; a launch goes to
the calling thread's current stream (`stream`).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
SOURCES = ("field", "ntt", "scan", "msm", "quotient", "fracs", "open", "shard")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_P = ctypes.c_void_p
_U = ctypes.c_uint
_I = ctypes.c_int
_Q = ctypes.c_ulonglong

# C signatures: library, symbol, argument types (all return int)
_SIGNATURES = {
    "field_binary": ("field", [_I, _I, _P, _P, _P, _U, _U, _U, _U, _U, _P]),
    "ntt_fused": ("ntt", [_P, _P, _P, _P, _P, _U, _U, _U, _U, _U, _U, _U, _U, _U, _P]),
    "field_scan": ("scan", [_I, _I, _P, _P, _P, _U, _U, _U, _P]),
    "field_scan_plan": ("scan", [_U, _U, _U, _P, _P]),
    "plane_sums": ("msm", [_P, _P, _P, _U, _U, _U, _U, _U, _I, _P]),
    "plane_sums16": ("msm", [_P, _P, _P, _U, _U, _U, _U, _U, _I, _P]),
    "pair_sel": ("msm", [_P, _P, _U, _U, _U, _P]),
    "g1_complete_add": ("msm", [_P, _P, _P, _U, _U, _P]),
    "g1_fixed_base_mul": ("msm", [_P, _P, _P, _U, _U, _P]),
    "quotient_h": ("quotient", [_P, _P, _P, _P, _P, _P, _Q, _Q, _Q, _Q, _U, _P]),
    "gp_fracs": ("fracs", [_P, _P, _P, _P, _P, _P, _P, _P, _Q, _Q, _U, _P]),
    "open_eval": ("open", [_P, _U, _P]),
    "open_combine": ("open", [_P, _U, _P]),
    "shard_butterfly": ("shard", [_P, _P, _P, _P, _U, _I, _I, _P]),
}

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _stale(name: str) -> bool:
    so = os.path.join(BUILD, f"lib{name}.so")
    if not os.path.exists(so):
        return True
    deps = [os.path.join(CSRC, f"{name}.cu")]
    deps += [os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh")]
    return os.path.getmtime(so) < max(os.path.getmtime(d) for d in deps)


def build(force: bool = False) -> float:
    """Compile every stale source, one `nvcc` each, all in parallel.
    Returns the seconds spent; the compiler's output (register and spill
    counts from `-Xptxas=-v`) is kept in `build/<name>.log`."""
    todo = [s for s in SOURCES if force or _stale(s)]
    if not todo:
        return 0.0
    os.makedirs(BUILD, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.time()
    procs = []
    for name in todo:
        so = os.path.join(BUILD, f"lib{name}.so")
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        log = open(os.path.join(BUILD, f"{name}.log"), "w")
        procs.append((name, so, tmp, log,
                      subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for name, so, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(name)
        else:
            os.replace(tmp, so)
    if failed:
        msgs = []
        for name in failed:
            with open(os.path.join(BUILD, f"{name}.log")) as f:
                msgs.append(f"--- {name}.cu ---\n{f.read()[-4000:]}")
        raise RuntimeError("nvcc failed:\n" + "\n".join(msgs))
    return time.time() - t0


def load_all() -> None:
    """Build what is stale and load every library, so that no later launch
    waits for nvcc (a server calls this before it takes requests)."""
    build()
    for name in SOURCES:
        _lib(name)


def _lib(name: str) -> ctypes.CDLL:
    with _lock:
        if name not in _libs:
            if _stale(name):
                build()
            _libs[name] = ctypes.CDLL(os.path.join(BUILD, f"lib{name}.so"))
        return _libs[name]


_fns: dict = {}


def _bind(symbol: str):
    fn = _fns.get(symbol)
    if fn is None:
        libname, argtypes = _SIGNATURES[symbol]
        lib = _lib(libname)
        with _lock:
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _fns[symbol] = fn
    return fn


def query(symbol: str, *args) -> None:
    """Call a C entry point that launches nothing (a kernel's plan for a
    shape); it counts as no launch."""
    rc = _bind(symbol)(*args)
    if rc != 0:
        raise RuntimeError(f"{symbol} failed: error {rc}")


class Kernel:
    """One CUDA entry point with its launch count."""

    def __init__(self, name: str, symbol: str, replaces: str, source: str):
        self.name = name
        self.symbol = symbol
        self.replaces = replaces
        self.source = source
        self.launches = 0

    def __call__(self, *args) -> None:
        rc = _bind(self.symbol)(*args)
        if rc != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: error {rc}")
        with _lock:
            self.launches += 1


KERNELS: dict[str, Kernel] = {}


def kernel(name: str, symbol: str, replaces: str, source: str) -> Kernel:
    k = Kernel(name, symbol, replaces, source)
    KERNELS[name] = k
    return k


def reset_launches() -> None:
    with _lock:
        for k in KERNELS.values():
            k.launches = 0


def launch_counts() -> dict:
    with _lock:
        return {name: k.launches for name, k in KERNELS.items()}


def require_cuda(*tensors) -> None:
    """Kernels take CUDA tensors only: a tensor elsewhere (other than the
    CPU, which the wrappers route to the plain versions) is refused."""
    for t in tensors:
        if t is not None and t.device.type != "cuda":
            raise ValueError(f"a CUDA kernel cannot take a tensor on {t.device}")


_raw_stream = None


def stream() -> int:
    """The current CUDA stream's handle, an integer that `c_void_p` in a
    kernel's `argtypes` takes as it is."""
    global _raw_stream
    if _raw_stream is None:
        import torch

        # the handle without a Stream object around it, where this PyTorch has it
        raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
        if raw is not None:
            _raw_stream = lambda: raw(torch.cuda.current_device())
        else:
            _raw_stream = lambda: torch.cuda.current_stream().cuda_stream
    return _raw_stream()


def ptr(t):
    """A tensor's address for a `c_void_p` argument; None stays a null pointer."""
    return None if t is None else t.data_ptr()
