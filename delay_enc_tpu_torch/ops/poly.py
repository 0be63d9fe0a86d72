"""Polynomial helpers for the prover: the scan kernel and its plain versions.

Counterpart of `delay_enc_tpu/ops/poly.py`.  Every scan runs along the row
axis (dim -2) of a (…, n, 8) tensor, so a stack of columns scans in one
call.  Each prefix is one reduced field element, so every way of scanning
gives the same words.

On CUDA tensors every scan, `powers_of` and `powers_rows` is one launch of
the kernel `field_scan` (`csrc/scan.cu`): inclusive or exclusive, forward
or reverse, with the Montgomery product or the modular sum as the operator,
and with a constant input, one element a row, for the powers of elements.  On CPU tensors the plain
versions run: "block" is the work-efficient two-level form (about 2n
operations), "hs" the Hillis-Steele ladder (n log n), with flips and shifts
around them for the reverse and the exclusive forms.  Each call names its
scan, and any other name raises, on either device.  `scan_tiles_plain`
follows the kernel's own steps (each thread's elements one after another,
the scan of the threads' totals, the tile's prefix from its predecessors,
then each thread's elements again) and is what the tests hold against the
others.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda
from . import limbs as L
from .limbs import FieldCtx

SCAN_BLOCK = 16  # rows per block of the "block" scan
SCANS = ("block", "hs")
EXCLUSIVE, REVERSE, CONSTANT = 1, 2, 4  # flag bits of the kernel
OPS = {"mul": 0, "add": 1}

_REPLACES = "delay_enc_tpu/ops/poly.py:"
K_SCAN = _cuda.kernel(
    "field_scan", "field_scan",
    _REPLACES + "49 prefix_product, :79 suffix_product, :146 suffix_sum, :100 powers_of",
    "delay_enc_tpu_torch/csrc/scan.cu")


def _check_impl(impl: str) -> None:
    if impl not in SCANS:
        raise ValueError(f"unknown scan {impl!r}; expected one of {SCANS}")


def _op_plain(ctx: FieldCtx, op: str):
    """The operator over the plain field functions, and its identity."""
    if op == "mul":
        return lambda x, y: L.mont_mul(ctx, x, y), "one"
    if op == "add":
        return lambda x, y: L.add(ctx, x, y), "zero"
    raise ValueError(f"unknown scan operator {op!r}; expected one of {tuple(OPS)}")


# ---------------------------------------------------------- plain versions

def _scan_hs(op, a: torch.Tensor, identity: torch.Tensor) -> torch.Tensor:
    n = a.shape[-2]
    s = 1
    while s < n:
        pad = identity.expand(*a.shape[:-2], s, L.NW)
        a = op(a, torch.cat([pad, a[..., : n - s, :]], dim=-2))
        s *= 2
    return a


def _scan_block(op, a: torch.Tensor, identity: torch.Tensor) -> torch.Tensor:
    """Inclusive scan: in-block prefixes over n/B rows at a time, a scan of
    the block totals, then one broadcast combine."""
    n = a.shape[-2]
    B = SCAN_BLOCK
    nb = -(-n // B)
    if nb * B != n:  # pad with the identity, which leaves every prefix as is
        pad = identity.expand(*a.shape[:-2], nb * B - n, L.NW)
        a = torch.cat([a, pad], dim=-2)
    blocks = a.reshape(*a.shape[:-2], nb, B, L.NW)
    cols = [blocks[..., 0, :]]
    for j in range(1, B):
        cols.append(op(cols[-1], blocks[..., j, :]))
    pref = torch.stack(cols, dim=-2)  # (…, nb, B, 8)
    if nb > 1:
        tot = _scan_block(op, cols[-1], identity)  # (…, nb, 8) inclusive
        first = identity.expand(*tot.shape[:-2], 1, L.NW)
        excl = torch.cat([first, tot[..., :-1, :]], dim=-2)
        pref = op(pref, excl[..., :, None, :])
    return pref.reshape(*a.shape[:-2], nb * B, L.NW)[..., :n, :]


def _shift(a: torch.Tensor, identity: torch.Tensor) -> torch.Tensor:
    """An inclusive scan made exclusive: the identity first, the last dropped."""
    first = identity.expand(*a.shape[:-2], 1, L.NW)
    return torch.cat([first, a[..., :-1, :]], dim=-2)


def scan_plain(ctx: FieldCtx, a: torch.Tensor, op: str, impl: str, *,
               exclusive: bool = False, reverse: bool = False) -> torch.Tensor:
    """The scan in plain PyTorch over the field functions of `ops.limbs`."""
    _check_impl(impl)
    fn, ident = _op_plain(ctx, op)
    identity = ctx.const(ident, a.device)
    if a.shape[-2] == 0:
        return a.clone()
    x = a.flip(-2) if reverse else a
    x = (_scan_block if impl == "block" else _scan_hs)(fn, x, identity)
    if exclusive:
        x = _shift(x, identity)
    return x.flip(-2) if reverse else x


def _power_plain(fn, identity: torch.Tensor, base: torch.Tensor, t: torch.Tensor):
    """base (…, 8) combined with itself t (…,) times, by squaring."""
    r = identity.expand_as(base)
    t = t.clone()
    while bool((t > 0).any()):
        r = torch.where((t & 1).bool()[..., None], fn(r, base), r)
        t >>= 1
        base = fn(base, base)
    return r


def scan_tiles_plain(ctx: FieldCtx, a: torch.Tensor, op: str, *, tile: tuple,
                     exclusive: bool = False, reverse: bool = False,
                     n: int | None = None) -> torch.Tensor:
    """The scan in the kernel's own steps, with tiles of `tile` = (threads,
    elements a thread); `kernel_plan` gives the kernel's.  Element j in
    scan order is index j, or n - 1 - j in reverse; elements from n on count
    as the identity.  Each thread combines its elements one after another;
    the threads' totals are scanned across the tile, which gives the tile's
    total; a tile's prefix is the combination of its predecessors' totals
    (the look-back), or, for a constant input (`a` one (8,) element standing
    for n of them), the full tile's total to the power of the tile's index;
    each thread then applies its prefix to its elements one after another."""
    fn, ident = _op_plain(ctx, op)
    identity = ctx.const(ident, a.device)
    constant = n is not None
    if constant:
        lead = ()
        if a.shape != (L.NW,):
            raise ValueError(f"a constant input is one (8,) element, got {tuple(a.shape)}")
    else:
        n, lead = a.shape[-2], a.shape[:-2]
    if n == 0:
        return a.new_empty(*lead, 0, L.NW)
    threads, items = tile
    size = threads * items
    nt = -(-n // size)
    j = torch.arange(n, device=a.device)
    place = (n - 1 - j) if reverse else j
    if constant:  # every slot holds the element, those past n too
        x = a.expand(nt * size, L.NW)
    else:
        x = a[..., place, :]
        if nt * size != n:
            x = torch.cat([x, identity.expand(*lead, nt * size - n, L.NW)], dim=-2)
    x = x.reshape(*lead, nt, threads, items, L.NW)
    total = x[..., 0, :]
    for i in range(1, items):
        total = fn(total, x[..., i, :])
    inc = _scan_hs(fn, total, identity)  # (…, nt, threads, 8) across the tile
    before = _shift(inc, identity)
    tile_total = inc[..., -1, :]  # (…, nt, 8)
    if constant:
        pre_tile = _power_plain(fn, identity, tile_total, torch.arange(nt, device=a.device))
    else:
        pre_tile = _shift(_scan_hs(fn, tile_total, identity), identity)
    acc = fn(pre_tile[..., None, :], before)
    outs = []
    for i in range(items):
        if exclusive:
            outs.append(acc)
            acc = fn(acc, x[..., i, :]) if i + 1 < items else acc
        else:
            acc = fn(acc, x[..., i, :])
            outs.append(acc)
    out = torch.stack(outs, dim=-2).reshape(*lead, nt * size, L.NW)[..., :n, :]
    res = torch.empty_like(out)
    res[..., place, :] = out
    return res


# ------------------------------------------------------------------ dispatch

def kernel_plan(rows: int, n: int, flags: int = 0) -> tuple:
    """The kernel's tile (threads, elements a thread) for `rows` rows of n
    elements, and the words of scratch its call needs (0: none), from the
    kernel's own build (csrc/scan_tile.cuh plan)."""
    tile = (ctypes.c_uint * 2)()
    words = ctypes.c_ulonglong()
    _cuda.query("field_scan_plan", rows, n, flags, ctypes.addressof(tile),
                ctypes.addressof(words))
    return (tile[0], tile[1]), words.value


def _launch(ctx: FieldCtx, src: torch.Tensor, shape, op: str, flags: int) -> torch.Tensor:
    """One call of the kernel: `src` is the (…, n, 8) input, or one element
    with the CONSTANT flag; `shape` is the output's."""
    _cuda.require_cuda(src)
    L._check(src)
    n = shape[-2]
    out = torch.empty(shape, dtype=torch.int32, device=src.device)
    rows = out.numel() // (n * L.NW) if n else 0
    if rows == 0:
        return out
    if n >= 1 << 31:
        raise ValueError("row too long for the scan kernel")
    src = src.contiguous()
    _, words = kernel_plan(rows, n, flags)
    scratch = torch.empty(words, dtype=torch.int32, device=src.device) if words else None
    K_SCAN(OPS[op], ctx.fid, src.data_ptr(), out.data_ptr(), _cuda.ptr(scratch), rows, n,
           flags, _cuda.stream())
    return out


def scan(ctx: FieldCtx, a: torch.Tensor, op: str, impl: str, *, exclusive: bool = False,
         reverse: bool = False) -> torch.Tensor:
    """Scan along the row axis of a (…, n, 8) with `op` ("mul" or "add").
    Exclusive: element i holds the combination of the elements before it
    (after it, in reverse), the identity where there is none."""
    _check_impl(impl)
    if op not in OPS:
        raise ValueError(f"unknown scan operator {op!r}; expected one of {tuple(OPS)}")
    if a.device.type == "cpu":
        return scan_plain(ctx, a, op, impl, exclusive=exclusive, reverse=reverse)
    flags = (EXCLUSIVE if exclusive else 0) | (REVERSE if reverse else 0)
    return _launch(ctx, a, a.shape, op, flags)


def prefix_product(ctx: FieldCtx, a: torch.Tensor, impl: str, *,
                   exclusive: bool = False) -> torch.Tensor:
    """Prefix products along the row axis: out[i] = a[0]*...*a[i], or
    a[0]*...*a[i-1] when exclusive."""
    return scan(ctx, a, "mul", impl, exclusive=exclusive)


def suffix_product(ctx: FieldCtx, a: torch.Tensor, impl: str, *,
                   exclusive: bool = False) -> torch.Tensor:
    return scan(ctx, a, "mul", impl, exclusive=exclusive, reverse=True)


def suffix_sum(ctx: FieldCtx, t: torch.Tensor, impl: str, *,
               exclusive: bool = False) -> torch.Tensor:
    """Suffix sums mod p along the row axis: suf[i] = sum_{j>=i} t[j], or
    over j > i when exclusive."""
    return scan(ctx, t, "add", impl, exclusive=exclusive, reverse=True)


def powers_of_plain(ctx: FieldCtx, x: torch.Tensor, n: int) -> torch.Tensor:
    """[1, x, ..., x^(n-1)] by log2(n) doubling steps."""
    p = torch.stack([ctx.one_mont(x.device), x])
    while p.shape[0] < n:
        x_m = L.mont_mul(ctx, p[-1:], x[None])  # x^m
        p = torch.cat([p, L.mont_mul(ctx, p, x_m)], dim=0)
    return p[:n]


def powers_of(ctx: FieldCtx, x: torch.Tensor, n: int) -> torch.Tensor:
    """[1, x, x^2, ..., x^(n-1)] from one (8,) Montgomery element: the
    exclusive product scan of the constant x."""
    if x.device.type == "cpu":
        return powers_of_plain(ctx, x, n)
    if x.shape != (L.NW,):
        raise ValueError(f"powers_of takes one (8,) element, got {tuple(x.shape)}")
    return _launch(ctx, x, (n, L.NW), "mul", EXCLUSIVE | CONSTANT)


def powers_rows(ctx: FieldCtx, xs: torch.Tensor, n: int) -> torch.Tensor:
    """(R, 8) Montgomery elements -> (R, n, 8), row r the powers
    [1, x_r, ..., x_r^(n-1)]: one launch for every row (the exclusive product
    scan of a constant input, one element a row)."""
    if xs.dim() != 2 or xs.shape[-1] != L.NW:
        raise ValueError(f"powers_rows takes (R, 8) elements, got {tuple(xs.shape)}")
    if xs.device.type == "cpu":
        return torch.stack([powers_of_plain(ctx, x, n) for x in xs]) if len(xs) \
            else xs.new_empty((0, n, L.NW))
    return _launch(ctx, xs, (xs.shape[0], n, L.NW), "mul", EXCLUSIVE | CONSTANT)


def divide_scaled(ctx: FieldCtx, t: torch.Tensor, zinv_powers: torch.Tensor) -> torch.Tensor:
    """(f(X) - f(z)) / (X - z) in coefficient form, from t_j = a_j z^j
    (delay_enc_tpu/ops/poly.py divide_by_linear, whose product by the powers
    of z is K7's): b_i = (sum of t_j over j > i) * z^-(i+1), the n-1
    coefficients padded with a zero to length n.  t (…, n, 8); zinv_powers
    (…, n + 1, 8), z^-i for each row of t."""
    n = t.shape[-2]
    above = suffix_sum(ctx, t, "block", exclusive=True)
    return L.mont_mul(ctx, above, zinv_powers[..., 1 : n + 1, :])
