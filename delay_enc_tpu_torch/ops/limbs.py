"""BN254 Fr / Fq arithmetic on word tensors: kernel K-a and its plain version.

Counterpart of `delay_enc_tpu/ops/limbs.py`.  A field element is a
`torch.int32` tensor of shape (…, 8): eight little-endian 32-bit words,
which the CUDA kernels read as uint32.  Values are in Montgomery form with
R = 2^256, exactly as in the JAX package, and every result is fully reduced
into [0, p), so each Montgomery value is the same 256-bit integer in both
packages.  The JAX package's (…, 16) uint32 limb array is this array's
bytes read as uint16 (`words_to_limbs_np`, `limbs_to_words_np`).

`mont_mul`, `add` and `sub` launch kernel K-a (`csrc/field.cu`) on CUDA
tensors and use their plain PyTorch versions (`*_plain`) on CPU tensors;
`mont_pow` and `inv` launch `field_pow` (the same source) once, or run
`mont_pow_plain`, a loop of `mont_mul_plain`.  `batch_inv` is
`ops/poly.py:batch_inv_log`.
The plain versions compute in 16-bit limbs held in int64, because this
PyTorch has no uint32 add, subtract, shift or compare; they run on any
device and are what the kernel is checked against.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..fields.bn254 import FQ, FR
from ..fields.prime import PrimeField
from ..utils.timers import GLOBAL_METRICS
from . import _cuda

NW = 8  # 32-bit words per element
NLIMB = 16  # 16-bit limbs per element (plain version, JAX boundary)
LIMB_BITS = 16
MASK = 0xFFFF

OP_MUL, OP_ADD, OP_SUB = 0, 1, 2
_REPLACES = "delay_enc_tpu/ops/limbs.py:"
K_MUL = _cuda.kernel("field_mont_mul", "field_binary",
                     _REPLACES + "496 mont_mul (ll_mont_mul :275)",
                     "delay_enc_tpu_torch/csrc/field.cu")
K_ADD = _cuda.kernel("field_add", "field_binary",
                     _REPLACES + "397 add (ll_add :250, _carry_and_mod :372)",
                     "delay_enc_tpu_torch/csrc/field.cu")
K_SUB = _cuda.kernel("field_sub", "field_binary",
                     _REPLACES + "401 sub (ll_sub :254, _sub_p_if_ge :346)",
                     "delay_enc_tpu_torch/csrc/field.cu")
_KERNEL = {OP_MUL: K_MUL, OP_ADD: K_ADD, OP_SUB: K_SUB}
K_POW = _cuda.kernel("field_pow", "field_pow",
                     _REPLACES + "539 mont_pow, :551 inv (K1 chains; a lax.scan in inv)",
                     "delay_enc_tpu_torch/csrc/field.cu")


# ------------------------------------------------------- numpy boundary

def words_to_limbs_np(w: np.ndarray) -> np.ndarray:
    """C-contiguous uint32 (…, 8) words -> the JAX package's (…, 16) limbs."""
    w = np.ascontiguousarray(w, dtype=np.uint32)
    return w.view(np.uint16).astype(np.uint32)


def limbs_to_words_np(limbs: np.ndarray) -> np.ndarray:
    """The JAX package's (…, 16) uint32 limbs -> uint32 (…, 8) words."""
    return np.ascontiguousarray(np.asarray(limbs).astype(np.uint16)).view(np.uint32)


def ints_to_words_np(xs) -> np.ndarray:
    """Sequence of ints (canonical, not Montgomery) -> (N, 8) uint32."""
    buf = b"".join(int(x).to_bytes(32, "little") for x in xs)
    return np.frombuffer(buf, dtype="<u4").reshape(len(xs), NW).copy()


def words_to_ints_np(w) -> list[int]:
    b = np.ascontiguousarray(np.asarray(w, dtype=np.uint32).reshape(-1, NW)).tobytes()
    return [int.from_bytes(b[32 * i : 32 * i + 32], "little") for i in range(len(b) // 32)]


def rows_to_write(out: np.ndarray, rows: int) -> np.ndarray:
    """`out`, checked to be C-contiguous uint32 (rows, 8) words that a
    writer can fill in place (the prover's staging rows)."""
    if out.shape != (rows, NW) or out.dtype != np.uint32 or not out.flags.c_contiguous:
        raise ValueError(f"rows to write: C-contiguous uint32 ({rows}, {NW}), got "
                         f"{out.dtype} {out.shape}")
    return out


def to_tensor(words: np.ndarray, device) -> torch.Tensor:
    """uint32 (…, 8) numpy words -> int32 tensor on `device`: a copy from
    pageable host memory, the span `htod`, its bytes counted (`htod bytes`).
    To a CUDA device the words are sent as they lie, with no host copy:
    the copy returns after it has read them, so the caller may rewrite
    them then (the prover's staging buffer, `plonk/prover.py`).  To any
    other device the tensor is a host copy, so that it never aliases
    `words`."""
    device = torch.device(device)
    with GLOBAL_METRICS.span("htod"):
        w = np.ascontiguousarray(words, dtype=np.uint32)
        GLOBAL_METRICS.count("htod bytes", w.nbytes)
        if device.type != "cuda" or not w.flags.writeable:
            w = w.copy()
        return torch.from_numpy(w.view(np.int32)).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 word tensor -> uint32 numpy words on the host: waits for the
    work queued on the stream, then copies (the span `device wait`; one
    more on the counter `device waits`)."""
    GLOBAL_METRICS.count("device waits")
    with GLOBAL_METRICS.span("device wait"):
        return t.detach().cpu().contiguous().numpy().view(np.uint32)


# ------------------------------------------------------------- contexts

class FieldCtx:
    """Per-field constants: host conversions through the copied C library,
    and small device tensors cached per device."""

    def __init__(self, field: PrimeField, fid: int):
        self.field = field
        self.fid = fid  # field id of the CUDA kernels: 0 = Fr, 1 = Fq
        p = field.p
        self.p = p
        self.n_prime = (-pow(p, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
        self.r_mod_p = (1 << 256) % p
        self.r2 = self.r_mod_p * self.r_mod_p % p
        self.p_limbs = tuple((p >> (16 * i)) & MASK for i in range(NLIMB))
        self._dev: dict = {}

    def _native_consts(self):
        if not hasattr(self, "_nc"):
            p = self.p
            p_words = np.frombuffer(p.to_bytes(32, "little"), dtype="<u8").copy()
            r2_words = np.frombuffer(self.r2.to_bytes(32, "little"), dtype="<u8").copy()
            n0inv = (-pow(p, -1, 1 << 64)) % (1 << 64)
            self._nc = (p_words, r2_words, n0inv)
        return self._nc

    def to_mont_np(self, xs, out: np.ndarray | None = None) -> np.ndarray:
        """ints -> (N, 8) uint32 Montgomery words (the span `to_mont`),
        written into `out` where given (C-contiguous uint32 (N, 8), which is
        returned): every step below then works in its rows, and no array of
        N elements is made.

        A list or tuple is read in C (`native/pyints.c`): each exact int in
        [0, 2^256) goes into the words as it is, with no Python step.  Every
        other element (a negative int, one of 2^256 or more, a bool, a numpy
        scalar), and every element of any other sequence, becomes
        int(x) % p in Python.  The C Montgomery product then runs over all
        the words in place.  The counters `to_mont native` and
        `to_mont python` count the elements that took each way."""
        from ..native import get_lib, get_pyints

        with GLOBAL_METRICS.span("to_mont"):
            lib = get_lib()
            p = self.p
            n = len(xs)
            out = np.empty((n, NW), dtype=np.uint32) if out is None else rows_to_write(out, n)
            if lib is None:
                GLOBAL_METRICS.count("to_mont python", n)
                out[...] = ints_to_words_np([(int(x) << 256) % p for x in xs])
                return out
            words = out.view(np.uint64)  # (n, 4)
            pyints = get_pyints() if isinstance(xs, (list, tuple)) else None
            if pyints is not None:
                taken = np.empty(n, dtype=np.uint8)
                missed = pyints.ints_to_words(xs, n, words.ctypes.data, taken.ctypes.data)
                rest = np.flatnonzero(taken == 0) if missed else ()
            else:
                rest = range(n)
            if len(rest):
                buf = b"".join((int(xs[i]) % p).to_bytes(32, "little") for i in rest)
                words[rest] = np.frombuffer(buf, dtype="<u8").reshape(-1, 4)
            GLOBAL_METRICS.count("to_mont native", n - len(rest))
            GLOBAL_METRICS.count("to_mont python", len(rest))
            pw, r2w, n0 = self._native_consts()
            lib.to_mont_words(words.ctypes.data, n, pw.ctypes.data, r2w.ctypes.data, n0)
            return out

    def from_mont_np(self, a) -> list[int]:
        """(…, 8) uint32 Montgomery words -> ints."""
        from ..native import get_lib

        lib = get_lib()
        w = np.ascontiguousarray(np.asarray(a, dtype=np.uint32).reshape(-1, NW))
        if lib is not None:
            limbs = np.ascontiguousarray(words_to_limbs_np(w))
            n = limbs.shape[0]
            out = np.empty(n * 32, dtype=np.uint8)
            pw, _, n0 = self._native_consts()
            lib.from_mont(limbs.ctypes.data, n, pw.ctypes.data, n0, out.ctypes.data)
            ob = out.tobytes()
            return [int.from_bytes(ob[32 * i : 32 * i + 32], "little") for i in range(n)]
        rinv = pow(self.r_mod_p, -1, self.p)
        return [(v * rinv) % self.p for v in words_to_ints_np(w)]

    def const(self, name: str, device) -> torch.Tensor:
        """(8,) int32 constant on `device`: "one" (Montgomery 1 = R mod p),
        "canon_one" (canonical 1), "r2" (R^2 mod p), "zero"."""
        device = torch.device(device)
        key = (name, str(device))
        if key not in self._dev:
            v = {"one": self.r_mod_p, "canon_one": 1, "r2": self.r2, "zero": 0}[name]
            self._dev[key] = to_tensor(ints_to_words_np([v])[0], device)
        return self._dev[key]

    def one_mont(self, device) -> torch.Tensor:
        return self.const("one", device)

    def limbs_p(self, device) -> torch.Tensor:
        key = ("p_limbs", str(device))
        if key not in self._dev:
            self._dev[key] = torch.tensor(self.p_limbs, dtype=torch.int64, device=device)
        return self._dev[key]


FR_CTX = FieldCtx(FR, 0)
FQ_CTX = FieldCtx(FQ, 1)


# ------------------------------------------------------- plain versions

def _limbs(x: torch.Tensor) -> torch.Tensor:
    """int32 (…, 8) words -> int64 (…, 16) 16-bit limbs."""
    w = x.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([w & MASK, w >> LIMB_BITS], dim=-1).flatten(-2)


def _words(limbs: torch.Tensor) -> torch.Tensor:
    """int64 (…, 16) limbs, each < 2^16 -> int32 (…, 8) words."""
    pairs = limbs.reshape(*limbs.shape[:-1], NW, 2)
    w = pairs[..., 0] | (pairs[..., 1] << LIMB_BITS)
    w = torch.where(w >= (1 << 31), w - (1 << 32), w)
    return w.to(torch.int32)


def _sub_p_if_ge(ctx: FieldCtx, r: torch.Tensor) -> torch.Tensor:
    """(…, 16) normalized limbs of a value < 2p -> the value mod p."""
    p = ctx.p_limbs
    diffs = []
    borrow = torch.zeros_like(r[..., 0])
    for i in range(NLIMB):
        d = r[..., i] - p[i] - borrow
        borrow = (d < 0).to(torch.int64)
        diffs.append(d & MASK)
    return torch.where((borrow == 0)[..., None], torch.stack(diffs, dim=-1), r)


def _carry_and_mod(ctx: FieldCtx, cols: torch.Tensor) -> torch.Tensor:
    """(…, 16) columns (non-negative, any size below 2^62) of a value < 2p
    -> normalized limbs of the value mod p."""
    limbs = []
    carry = torch.zeros_like(cols[..., 0])
    for i in range(NLIMB):
        v = cols[..., i] + carry
        limbs.append(v & MASK)
        carry = v >> LIMB_BITS
    return _sub_p_if_ge(ctx, torch.stack(limbs, dim=-1))


def mont_mul_plain(ctx: FieldCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * 2^-256 mod p: schoolbook product into 32 columns, then the
    16-step base-2^16 Montgomery reduction (as ll_mont_mul)."""
    x, y = torch.broadcast_tensors(_limbs(a), _limbs(b))
    cols = x.new_zeros(x.shape[:-1] + (2 * NLIMB,))
    for j in range(NLIMB):
        cols[..., j : j + NLIMB] += x * y[..., j : j + 1]  # each product < 2^32
    p = ctx.limbs_p(cols.device)
    for i in range(NLIMB):
        u = ((cols[..., i] & MASK) * ctx.n_prime) & MASK
        cols[..., i : i + NLIMB] += u[..., None] * p
        cols[..., i + 1] += cols[..., i] >> LIMB_BITS
    return _words(_carry_and_mod(ctx, cols[..., NLIMB:]))


def add_plain(ctx: FieldCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    x, y = torch.broadcast_tensors(_limbs(a), _limbs(b))
    return _words(_carry_and_mod(ctx, x + y))


def sub_plain(ctx: FieldCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + p) - b, normalized with a borrow chain, then reduced."""
    x, y = torch.broadcast_tensors(_limbs(a), _limbs(b))
    p = ctx.p_limbs
    outs = []
    borrow = torch.zeros_like(x[..., 0])
    carry = torch.zeros_like(x[..., 0])
    for i in range(NLIMB):
        v = x[..., i] + p[i] + carry
        carry = v >> LIMB_BITS
        d = (v & MASK) - y[..., i] - borrow
        borrow = (d < 0).to(torch.int64)
        outs.append(d & MASK)
    return _words(_sub_p_if_ge(ctx, torch.stack(outs, dim=-1)))


def mont_pow_plain(ctx: FieldCtx, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e elementwise, MSB first as the kernel: the top bit gives a, then a
    squaring for every lower bit and a product for every set one; e = 0
    gives 1 (R mod p), also for a = 0."""
    if e == 0:
        return ctx.one_mont(a.device).expand_as(a).clone()
    r = a.clone()
    for bit in bin(e)[3:]:
        r = mont_mul_plain(ctx, r, r)
        if bit == "1":
            r = mont_mul_plain(ctx, r, a)
    return r


_PLAIN = {OP_MUL: mont_mul_plain, OP_ADD: add_plain, OP_SUB: sub_plain}


# ------------------------------------------------------------ dispatch

@functools.lru_cache(maxsize=4096)
def _operand(ts: tuple, shape: tuple) -> tuple:
    """How the kernel reads an operand of shape `ts` broadcast to `shape`:
    (div, mod, expand) with element i of the output reading element
    (i // div) % mod of the contiguous operand.  A pattern that does not fit
    has expand set: the operand is materialised at `shape` first.  Fixed by
    the two shapes, so it is computed once for each pair."""
    nd = len(shape) - 1  # element dims (the word axis excluded)
    ts = (1,) * (len(shape) - len(ts)) + ts
    active = [i for i in range(nd) if shape[i] != 1]
    kept = [i for i in active if ts[i] != 1]
    if kept:
        pos = [active.index(i) for i in kept]
        if pos != list(range(pos[0], pos[0] + len(pos))):
            return 1, math.prod(shape[:-1]), True
    mod = 1
    for i in kept:
        mod *= shape[i]
    div = 1
    if kept:
        for i in active:
            if i > kept[-1]:
                div *= shape[i]
    return div, mod, False


@functools.lru_cache(maxsize=4096)
def _layout(sa: tuple, sb: tuple) -> tuple:
    """(output shape, elements, how a is read, how b is read) of a
    broadcasting binary operation on operands of shapes sa and sb."""
    shape = tuple(torch.broadcast_shapes(sa, sb))
    return shape, math.prod(shape[:-1]), _operand(sa, shape), _operand(sb, shape)


def _check(t: torch.Tensor) -> None:
    if t.dtype != torch.int32 or t.shape[-1] != NW:
        raise ValueError(f"field operand must be int32 (…, {NW}), got {t.dtype} {tuple(t.shape)}")


def _binary(op: int, ctx: FieldCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check(a)
    _check(b)
    if a.device != b.device:
        raise ValueError(f"operands on different devices: {a.device} and {b.device}")
    if a.device.type == "cpu":
        return _PLAIN[op](ctx, a, b)
    _cuda.require_cuda(a)
    sa, sb = a.shape, b.shape
    if sa == sb and a.is_contiguous() and b.is_contiguous():
        # the common case: nothing to broadcast, nothing to copy
        out = torch.empty_like(a)
        n = out.numel() // NW
        adiv = bdiv = 1
        amod = bmod = n
    else:
        shape, n, (adiv, amod, aexp), (bdiv, bmod, bexp) = _layout(tuple(sa), tuple(sb))
        out = torch.empty(shape, dtype=torch.int32, device=a.device)
        a = (a.expand(shape) if aexp else a).contiguous()
        b = (b.expand(shape) if bexp else b).contiguous()
    if n == 0:
        return out
    if n >= 1 << 32:
        raise ValueError("too many elements for one launch")
    pa, pb, po = a.data_ptr(), b.data_ptr(), out.data_ptr()
    if (pa | pb | po) % 16:
        raise ValueError("field operand is not 16-byte aligned")
    _KERNEL[op](op, ctx.fid, pa, pb, po, n, adiv, amod, bdiv, bmod, _cuda.stream())
    return out


def mont_mul(ctx: FieldCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a * b * R^-1 mod p, broadcasting."""
    return _binary(OP_MUL, ctx, a, b)


def add(ctx: FieldCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _binary(OP_ADD, ctx, a, b)


def sub(ctx: FieldCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _binary(OP_SUB, ctx, a, b)


def mont_sqr(ctx: FieldCtx, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(ctx, a, a)


def mont_pow(ctx: FieldCtx, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e elementwise for a host-known exponent 0 <= e < 2^256: one launch
    of `field_pow` on a card, whatever e."""
    _check(a)
    e = int(e)
    if not 0 <= e < 1 << 256:
        raise ValueError(f"exponent out of range [0, 2^256): {e}")
    if a.device.type == "cpu":
        return mont_pow_plain(ctx, a, e)
    _cuda.require_cuda(a)
    a = a.contiguous()
    out = torch.empty_like(a)
    n = out.numel() // NW
    if n == 0:
        return out
    if n >= 1 << 32:
        raise ValueError("too many elements for one launch")
    if (a.data_ptr() | out.data_ptr()) % 16:
        raise ValueError("field operand is not 16-byte aligned")
    words = (ctypes.c_uint * NW)(*((e >> (32 * j)) & 0xFFFFFFFF for j in range(NW)))
    K_POW(ctx.fid, a.data_ptr(), out.data_ptr(), n, ctypes.addressof(words), e.bit_length(),
          _cuda.stream())
    return out


def inv(ctx: FieldCtx, a: torch.Tensor) -> torch.Tensor:
    """Elementwise inverse by Fermat, a^(p-2); zero maps to zero."""
    return mont_pow(ctx, a, ctx.p - 2)


def batch_inv(ctx: FieldCtx, a: torch.Tensor) -> torch.Tensor:
    """Inverses along axis 0, zeros to zero: `ops/poly.py:batch_inv_log`
    (the answer is unique, so the JAX package's two forms are one here)."""
    from .poly import batch_inv_log

    return batch_inv_log(ctx, a)


def neg(ctx: FieldCtx, a: torch.Tensor) -> torch.Tensor:
    return sub(ctx, ctx.const("zero", a.device), a)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=-1)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Word-wise equality along the last axis (broadcast over the rest): the
    JAX package's `eq` of the (…, 16) limbs of the same bytes."""
    return (a == b).all(dim=-1)


def select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cond ? a : b, cond shaped like the batch (no word axis)."""
    return torch.where(cond[..., None], a, b)


def mont_to_canonical(ctx: FieldCtx, a: torch.Tensor) -> torch.Tensor:
    """Montgomery form -> canonical words (a * 1 * R^-1)."""
    return mont_mul(ctx, a, ctx.const("canon_one", a.device))


def canonical_to_mont(ctx: FieldCtx, a: torch.Tensor) -> torch.Tensor:
    """Canonical words -> Montgomery form (a * R^2 * R^-1)."""
    return mont_mul(ctx, a, ctx.const("r2", a.device))


def to_device_mont(ctx: FieldCtx, xs, device) -> torch.Tensor:
    return to_tensor(ctx.to_mont_np(xs), device)


def from_device_mont(ctx: FieldCtx, a: torch.Tensor) -> list[int]:
    return ctx.from_mont_np(to_numpy(a))
