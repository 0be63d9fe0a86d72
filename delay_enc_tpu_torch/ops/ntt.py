"""Radix-2 NTT over Fr word tensors: kernel K-b and its plain version.

Counterpart of `delay_enc_tpu/ops/ntt.py`.  The transform is the same
Stockham autosort DIF (natural-order input and output): stage t, with
l = n / 2^(t+1) groups of m = 2^t columns, views x as (2l, m) and writes
    y[j, 0, k] = x[j, k] + x[j+l, k]
    y[j, 1, k] = w^(j*m) * (x[j, k] - x[j+l, k]).
Any correct NTT returns the same evaluations, so the results are
bit-identical to the JAX package's.

`stockham` launches kernel K-b (`csrc/ntt.cu`, one launch per stage) on
CUDA tensors and runs `stockham_plain` on CPU tensors.  Both transform
every row of a (…, n, 8) batch.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import _cuda
from . import limbs as L
from .limbs import FieldCtx

K_STAGE = _cuda.kernel("ntt_stage", "ntt_stage",
                       "delay_enc_tpu/ops/ntt.py:85 stockham",
                       "delay_enc_tpu_torch/csrc/ntt.cu")


@dataclass
class NTTPlan:
    ctx: FieldCtx
    k: int
    omega: int  # primitive 2^k-th root of unity (canonical int)
    tw: torch.Tensor  # (max(1, n/2), 8) Montgomery powers omega^0 .. omega^(n/2-1)
    tw_inv: torch.Tensor  # the same for omega^-1
    n_inv: torch.Tensor  # (1, 8) Montgomery 1/n

    @property
    def n(self) -> int:
        return 1 << self.k

    @staticmethod
    def make(ctx: FieldCtx, k: int, device, omega: int | None = None) -> "NTTPlan":
        f = ctx.field
        n = 1 << k
        if omega is None:
            omega = f.root_of_unity(k)
        omega_inv = f.inv(omega)

        def table(w):
            pows = [1] * max(1, n // 2)
            for i in range(1, len(pows)):
                pows[i] = pows[i - 1] * w % f.p
            return L.to_device_mont(ctx, pows, device)

        return NTTPlan(
            ctx=ctx, k=k, omega=omega, tw=table(omega), tw_inv=table(omega_inv),
            n_inv=L.to_device_mont(ctx, [f.inv(n)], device),
        )


def stockham_plain(ctx: FieldCtx, a: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """Natural-order radix-2 NTT of every row of a (…, n, 8), in plain
    PyTorch; tw holds the powers w^0 .. w^(n/2-1)."""
    n = a.shape[-2]
    lead = a.shape[:-2]
    k = n.bit_length() - 1
    a = a.reshape(-1, n, L.NW)
    l, m = n // 2, 1
    for _ in range(k):
        x = a.reshape(-1, 2 * l, m, L.NW)
        c0, c1 = x[:, :l], x[:, l:]
        s = L.add_plain(ctx, c0, c1)
        d = L.mont_mul_plain(ctx, tw[: l * m : m][:, None, :], L.sub_plain(ctx, c0, c1))
        a = torch.stack([s, d], dim=2).reshape(-1, n, L.NW)
        l //= 2
        m *= 2
    return a.reshape(*lead, n, L.NW)


def stockham(ctx: FieldCtx, a: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """Natural-order radix-2 NTT of every row of a (…, n, 8)."""
    if a.device.type == "cpu":
        return stockham_plain(ctx, a, tw)
    _cuda.require_cuda(a, tw)
    if ctx is not L.FR_CTX:
        raise ValueError("the NTT kernel is built for Fr")
    L._check(a)
    n = a.shape[-2]
    if n & (n - 1):
        raise ValueError(f"NTT length {n} is not a power of two")
    k = n.bit_length() - 1
    if tw.device != a.device or tw.dtype != torch.int32 or tw.shape[0] < n // 2:
        raise ValueError("twiddle table does not fit the transform")
    a = a.contiguous()
    tw = tw.contiguous()
    if k == 0:
        return a.clone()
    batch = a.numel() // (n * L.NW)
    out = torch.empty_like(a)
    scratch = torch.empty_like(a)
    src = a
    for t in range(k):
        # the last stage lands in `out`
        dst = out if (k - 1 - t) % 2 == 0 else scratch
        K_STAGE(_cuda.ptr(src), _cuda.ptr(dst), _cuda.ptr(tw), batch, n,
                n >> (t + 1), t, _cuda.stream())
        src = dst
    return out


def ntt(plan: NTTPlan, a: torch.Tensor) -> torch.Tensor:
    """Coefficients -> evaluations over the 2^k subgroup (A[j] = a(omega^j))."""
    return stockham(plan.ctx, a, plan.tw)


def intt(plan: NTTPlan, a: torch.Tensor) -> torch.Tensor:
    """Evaluations -> coefficients."""
    return L.mont_mul(plan.ctx, stockham(plan.ctx, a, plan.tw_inv), plan.n_inv)


def powers(ctx: FieldCtx, base: int, n: int, device) -> torch.Tensor:
    """(n, 8) Montgomery words of [1, base, base^2, ...] (host precompute)."""
    f = ctx.field
    vals, cur = [], 1
    for _ in range(n):
        vals.append(cur)
        cur = cur * base % f.p
    return L.to_device_mont(ctx, vals, device)


def coset_scale(ctx: FieldCtx, coeffs: torch.Tensor, zeta_powers: torch.Tensor) -> torch.Tensor:
    """coeff_i *= zeta^i: evaluate on the coset zeta*H by a plain NTT after."""
    return L.mont_mul(ctx, coeffs, zeta_powers)
