"""Polynomial helpers for the prover, in plain PyTorch over kernel K-a.

Counterpart of `delay_enc_tpu/ops/poly.py`.  Every scan runs along the row
axis (dim -2) of a (…, n, 8) tensor, so a stack of columns scans in one
pass.  Each call names its scan: "block" is the work-efficient two-level
form (about 2n operations), "hs" the Hillis-Steele ladder (n log n); any
other name raises.  Both give the same values, since each prefix is a
unique field element.
"""

from __future__ import annotations

import torch

from . import limbs as L
from .limbs import FieldCtx

SCAN_BLOCK = 16  # rows per block of the "block" scan
SCANS = ("block", "hs")


def _check_impl(impl: str) -> None:
    if impl not in SCANS:
        raise ValueError(f"unknown scan {impl!r}; expected one of {SCANS}")


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


def _scan(op, a, identity, impl):
    _check_impl(impl)
    return (_scan_block if impl == "block" else _scan_hs)(op, a, identity)


def prefix_product(ctx: FieldCtx, a: torch.Tensor, impl: str) -> torch.Tensor:
    """Inclusive prefix products along the row axis: out[i] = a[0]*...*a[i]."""
    return _scan(lambda x, y: L.mont_mul(ctx, x, y), a, ctx.one_mont(a.device), impl)


def suffix_product(ctx: FieldCtx, a: torch.Tensor, impl: str) -> torch.Tensor:
    return prefix_product(ctx, a.flip(-2), impl).flip(-2)


def suffix_sum(ctx: FieldCtx, t: torch.Tensor, impl: str) -> torch.Tensor:
    """Inclusive suffix sums mod p along the row axis: suf[i] = sum_{j>=i} t[j]."""
    zero = ctx.const("zero", t.device)
    return _scan(lambda x, y: L.add(ctx, x, y), t.flip(-2), zero, impl).flip(-2)


def powers_of(ctx: FieldCtx, x: torch.Tensor, n: int) -> torch.Tensor:
    """[1, x, x^2, ..., x^(n-1)] from one (8,) Montgomery element, by
    log2(n) doubling steps."""
    p = torch.stack([ctx.one_mont(x.device), x])
    while p.shape[0] < n:
        x_m = L.mont_mul(ctx, p[-1:], x[None])  # x^m
        p = torch.cat([p, L.mont_mul(ctx, p, x_m)], dim=0)
    return p[:n]


def divide_by_linear(ctx: FieldCtx, coeffs: torch.Tensor, z_powers: torch.Tensor,
                     zinv_powers: torch.Tensor) -> torch.Tensor:
    """(f(X) - f(z)) / (X - z) in coefficient form:
    b_i = (suffix sum of a_j z^j at i+1) * z^-(i+1).  Returns the n-1
    coefficients padded with a zero to length n."""
    n = coeffs.shape[-2]
    t = L.mont_mul(ctx, coeffs, z_powers[:n])
    suf = suffix_sum(ctx, t, "block")
    suf_shift = torch.cat([suf[..., 1:, :], torch.zeros_like(suf[..., :1, :])], dim=-2)
    return L.mont_mul(ctx, suf_shift, zinv_powers[1 : n + 1])
