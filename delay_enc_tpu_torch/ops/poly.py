"""Polynomial helpers for the prover: the scan kernel and its plain versions.

Counterpart of `delay_enc_tpu/ops/poly.py`.  Every scan runs along the row
axis (dim -2) of a (…, n, 8) tensor, so a stack of columns scans in one
call.  Each prefix is one reduced field element, so every way of scanning
gives the same words.

On CUDA tensors every scan, and `powers_of`, is one call of the kernel
`field_scan` (`csrc/scan.cu`): inclusive or exclusive, forward or reverse,
with the Montgomery product or the modular sum as the operator, and with a
constant input for the powers of one element.  On CPU tensors the plain
versions run: "block" is the work-efficient two-level form (about 2n
operations), "hs" the Hillis-Steele ladder (n log n), with flips and shifts
around them for the reverse and the exclusive forms.  Each call names its
scan, and any other name raises, on either device.  `scan_tiles_plain`
follows the kernel's own three steps (tile totals, their exclusive scan, the
tiles again) and is what the tests hold against the others.
"""

from __future__ import annotations

import torch

from . import _cuda
from . import limbs as L
from .limbs import FieldCtx

SCAN_BLOCK = 16  # rows per block of the "block" scan
SCANS = ("block", "hs")
TILE = 1024  # elements a block of the kernel scans: 256 threads x 4 (csrc/scan.cu)
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


def scan_tiles_plain(ctx: FieldCtx, a: torch.Tensor, op: str, *, tile: int = TILE,
                     exclusive: bool = False, reverse: bool = False) -> torch.Tensor:
    """The scan in the kernel's own steps: element j in scan order is index
    j, or n - 1 - j in reverse; each tile of `tile` elements leaves its
    total; the totals are scanned exclusively, `tile` at a time with a
    running carry; then each tile is scanned from its prefix.  Elements
    beyond n count as the identity."""
    fn, ident = _op_plain(ctx, op)
    identity = ctx.const(ident, a.device)
    n = a.shape[-2]
    lead = a.shape[:-2]
    if n == 0:
        return a.clone()
    j = torch.arange(n, device=a.device)
    place = (n - 1 - j) if reverse else j
    nt = -(-n // tile)
    x = a[..., place, :]
    if nt * tile != n:
        x = torch.cat([x, identity.expand(*lead, nt * tile - n, L.NW)], dim=-2)
    tiles = x.reshape(*lead, nt, tile, L.NW)
    local = _scan_hs(fn, tiles, identity)  # inclusive inside each tile
    totals = local[..., -1, :]  # (…, nt, 8)
    # the exclusive scan of the totals, a tile of them at a time
    prefixes, carry = [], identity.expand(*lead, L.NW)
    for lo in range(0, nt, tile):
        part = totals[..., lo : lo + tile, :]
        inc = fn(carry[..., None, :], _scan_hs(fn, part, identity))
        prefixes.append(torch.cat([carry[..., None, :], inc[..., :-1, :]], dim=-2))
        carry = inc[..., -1, :]
    start = torch.cat(prefixes, dim=-2)  # (…, nt, 8)
    out = fn(start[..., :, None, :], local)
    if exclusive:
        out = torch.cat([start[..., :, None, :], out[..., :-1, :]], dim=-2)
    out = out.reshape(*lead, nt * tile, L.NW)[..., :n, :]
    res = torch.empty_like(out)
    res[..., place, :] = out
    return res


# ------------------------------------------------------------------ dispatch

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
    tiles = -(-n // TILE)
    scratch = None
    if tiles > 1:
        scratch = torch.empty((rows, tiles, L.NW), dtype=torch.int32, device=src.device)
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


def divide_by_linear(ctx: FieldCtx, coeffs: torch.Tensor, z_powers: torch.Tensor,
                     zinv_powers: torch.Tensor) -> torch.Tensor:
    """(f(X) - f(z)) / (X - z) in coefficient form:
    b_i = (sum of a_j z^j over j > i) * z^-(i+1).  Returns the n-1
    coefficients padded with a zero to length n."""
    n = coeffs.shape[-2]
    t = L.mont_mul(ctx, coeffs, z_powers[:n])
    above = suffix_sum(ctx, t, "block", exclusive=True)
    return L.mont_mul(ctx, above, zinv_powers[1 : n + 1])
