"""Radix-2 NTT over Fr word tensors: kernel K-b and its plain versions.

Counterpart of `delay_enc_tpu/ops/ntt.py`.  `stockham` returns the
natural-order evaluations A[j] = sum_i a[i] w^(i j) of every row of a
(…, n, 8) batch.  Any correct NTT returns the same reduced words, so the
results are bit-identical to the JAX package's whatever the decomposition.

On CUDA tensors `stockham` launches kernel K-b (`csrc/ntt.cu`) once for each
pass that `plan` lays out: a pass runs up to `MAX_STAGES` radix-2 stages on
tiles in shared memory, so a transform of length 2^16 or 2^19 is two
launches.  The rule is on k alone: k <= MAX_STAGES is one pass, otherwise
ceil(k / MAX_STAGES) passes of nearly equal depth; no size falls back to
anything else.  The first pass can read rows shorter than n as zero-padded
and multiply a per-index table in (`in_table`); the last can multiply by one
constant or by a per-index table as it stores (`out_scale`).

Two plain versions stand beside the kernel.  `stockham_plain` is the
one-stage-at-a-time Stockham autosort transform, which CPU tensors take
(`stockham_sides_plain` puts the two fused sides around it).
`stockham_passes_plain` follows the kernel's own passes with the kernel's
index arithmetic (tiles, twiddle exponents, the skipped padding, both fused
sides), so that arithmetic can be tested without a card.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import _cuda
from . import limbs as L
from .limbs import FieldCtx
from .poly import powers_of

K_FUSED = _cuda.kernel("ntt_fused", "ntt_fused",
                       "delay_enc_tpu/ops/ntt.py:85 stockham",
                       "delay_enc_tpu_torch/csrc/ntt.cu")

TILE_LOG = 10  # a tile holds at most 2^10 elements: 33 KB of shared memory
MAX_STAGES = 10  # stages a pass may run; a tile then has 2^(TILE_LOG - stages) columns
THREADS = 256  # threads a block, two butterflies each a stage on a full tile
SHARED_LIMIT = 227 * 1024  # bytes of shared memory a block may ask for
OUT_NONE, OUT_CONST, OUT_TABLE = 0, 1, 2


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
        """The plan of length 2^k on `device`; the twiddle tables are made
        there (`powers`)."""
        f = ctx.field
        n = 1 << k
        if omega is None:
            omega = f.root_of_unity(k)
        omega_inv = f.inv(omega)

        def table(w):
            return powers(ctx, w, max(1, n // 2), device)

        return NTTPlan(
            ctx=ctx, k=k, omega=omega, tw=table(omega), tw_inv=table(omega_inv),
            n_inv=L.to_device_mont(ctx, [f.inv(n)], device),
        )


# ------------------------------------------------------------ the pass plan

@dataclass(frozen=True)
class Pass:
    """One launch of K-b: the stages t0 .. t0 + s - 1 of a transform of
    length 2^k, on tiles of 2^s rows by 2^c_log columns (csrc/ntt_tile.cuh
    has the layout).  Source rows hold n_in elements; local rows from nz on
    are zero padding."""

    k: int
    t0: int
    s: int
    c_log: int
    n_in: int
    nz: int

    @property
    def first(self) -> bool:
        return self.t0 == 0

    @property
    def last(self) -> bool:
        return self.t0 + self.s == self.k

    @property
    def tile(self) -> int:
        return 1 << (self.s + self.c_log)

    @property
    def groups(self) -> int:
        """Tiles a row."""
        return 1 << (self.k - self.s - self.c_log)

    @property
    def threads(self) -> int:
        return max(32, min(THREADS, self.tile // 2))

    @property
    def shared_bytes(self) -> int:
        top = self.tile - 1
        return 8 * 4 * (top + (top >> 5) + (top >> 10) + 1)


def plan(k: int, n_in: int | None = None, *, tile_log: int | None = None,
         max_stages: int | None = None) -> tuple:
    """The passes of a transform of length 2^k whose rows hold n_in <= 2^k
    elements (the rest read as zero): ceil(k / max_stages) passes, the
    deeper ones first, each on the widest tile that fits.  `tile_log` and
    `max_stages` default to TILE_LOG and MAX_STAGES."""
    tile_log = TILE_LOG if tile_log is None else tile_log
    max_stages = MAX_STAGES if max_stages is None else max_stages
    n = 1 << k
    if n_in is None:
        n_in = n
    if k < 0 or not 1 <= n_in <= n:
        raise ValueError(f"no transform of length 2^{k} over rows of {n_in}")
    if not 1 <= max_stages <= tile_log:
        raise ValueError(f"{max_stages} stages do not fit a tile of 2^{tile_log}")
    count = max(1, -(-k // max_stages))
    base, extra = divmod(k, count)
    passes, t0 = [], 0
    for i in range(count):
        s = base + (1 if i < extra else 0)
        c_log = min(tile_log - s, k - s)
        rows_in, nz = n_in, 1 << s
        if t0 == 0:
            span = n >> s  # L: indices a local row covers
            nz = min(nz, -(-n_in // span))
        else:
            rows_in = n
        p = Pass(k, t0, s, c_log, rows_in, nz)
        if p.shared_bytes > SHARED_LIMIT:
            raise ValueError(f"a tile of 2^{tile_log} elements does not fit shared memory")
        passes.append(p)
        t0 += s
    return tuple(passes)


def _bitrev(x: torch.Tensor, bits: int) -> torch.Tensor:
    r = torch.zeros_like(x)
    for j in range(bits):
        r |= ((x >> j) & 1) << (bits - 1 - j)
    return r


def pass_indices(p: Pass) -> dict:
    """The index arithmetic of one pass for every tile of a row, as
    csrc/ntt_tile.cuh computes it: `load` (groups, T) source indices,
    `stages` a list of (pa, pb, ex, live, padded) with the butterflies'
    positions (T/2,), twiddle exponents (groups, T/2), the mask (T/2,) of
    butterflies that are not skipped and whether the stage's upper operands
    are all padding, `store_pos` (T,) positions and `store` (groups, T)
    destination indices."""
    T, c_log, s = p.tile, p.c_log, p.s
    cmask = (1 << c_log) - 1
    log_lm = p.k - s
    g0 = (torch.arange(p.groups) << c_log)[:, None]
    e = torch.arange(T)[None, :]
    load = ((e >> c_log) << log_lm) + g0 + (e & cmask)
    stages = []
    b = torch.arange(T // 2)[None, :]
    for u in range(s):
        half_log = s - 1 - u
        half = 1 << half_log
        cc, t = b & cmask, b >> c_log
        i, blk = t & (half - 1), t >> half_log
        pa = (((blk << (half_log + 1)) + i) << c_log) + cc
        pb = pa + (half << c_log)
        r = (g0 + cc) >> p.t0
        ex = ((i << (log_lm - p.t0)) + r) << (p.t0 + u)
        padded = half >= p.nz
        live = (i < p.nz) if padded else torch.ones_like(i, dtype=torch.bool)
        stages.append((pa[0], pb[0], ex, live[0], padded))
    ck_log = min(c_log, p.t0)
    kl, c, rl = e & ((1 << ck_log) - 1), (e >> ck_log) & ((1 << s) - 1), e >> (ck_log + s)
    cc = (rl << ck_log) + kl
    g = g0 + cc
    store = ((((g >> p.t0) << s) + c) << p.t0) + (g & ((1 << p.t0) - 1))
    store_pos = ((_bitrev(c, s) << c_log) + cc)[0]
    return {"load": load, "stages": stages, "store_pos": store_pos, "store": store}


# ---------------------------------------------------------- plain versions

def stockham_plain(ctx: FieldCtx, a: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """Natural-order radix-2 NTT of every row of a (…, n, 8), in plain
    PyTorch, a stage at a time: stage t views x as (2l, m) with
    l = n / 2^(t+1), m = 2^t and writes y[2j, k] = x[j, k] + x[j+l, k],
    y[2j+1, k] = w^(j m) (x[j, k] - x[j+l, k]).  tw holds w^0 .. w^(n/2-1)."""
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


def stockham_sides_plain(ctx, a, tw, n, in_table, out_scale):
    """The transform of length n with both fused sides, by the one-stage
    plain version: scale by the table, pad with zeros, transform, scale."""
    n_in = a.shape[-2]
    if in_table is not None:
        a = L.mont_mul_plain(ctx, a, in_table[:n_in])
    if n_in < n:
        a = torch.cat([a, a.new_zeros(*a.shape[:-2], n - n_in, L.NW)], dim=-2)
    out = stockham_plain(ctx, a, tw)
    return out if out_scale is None else L.mont_mul_plain(ctx, out, out_scale)


def stockham_passes_plain(ctx: FieldCtx, a: torch.Tensor, tw: torch.Tensor, *,
                          n: int | None = None, in_table: torch.Tensor | None = None,
                          out_scale: torch.Tensor | None = None,
                          passes: tuple | None = None) -> torch.Tensor:
    """`stockham` in plain PyTorch, pass by pass as K-b makes it: the same
    tiles, positions, twiddle exponents and skipped padding (`pass_indices`),
    the input table on the first load and the output scale on the last
    store."""
    n_in = a.shape[-2]
    n = n_in if n is None else n
    k = n.bit_length() - 1
    lead = a.shape[:-2]
    if passes is None:
        passes = plan(k, n_in)
    x = a.reshape(-1, n_in, L.NW)
    batch = x.shape[0]
    for p in passes:
        ix = pass_indices(p)
        load = ix["load"]
        inside = load < p.n_in
        src = load.clamp(max=p.n_in - 1)
        tile = x[:, src]  # (batch, groups, T, 8)
        if p.first and in_table is not None:
            tile = L.mont_mul_plain(ctx, tile, in_table[src])
        tile = torch.where(inside[None, :, :, None], tile, torch.zeros_like(tile))
        for pa, pb, ex, live, padded in ix["stages"]:
            xa, xb, w = tile[:, :, pa], tile[:, :, pb], tw[ex]
            if padded:
                new_a = xa
                new_b = L.mont_mul_plain(ctx, w, xa)
            else:
                new_a = L.add_plain(ctx, xa, xb)
                new_b = L.mont_mul_plain(ctx, w, L.sub_plain(ctx, xa, xb))
            keep = live[None, None, :, None]
            tile = tile.clone()
            tile[:, :, pa] = torch.where(keep, new_a, xa)
            tile[:, :, pb] = torch.where(keep, new_b, xb)
        vals = tile[:, :, ix["store_pos"]]
        store = ix["store"]
        if p.last and out_scale is not None:
            scale = out_scale.reshape(-1, L.NW)
            vals = L.mont_mul_plain(ctx, vals, scale if scale.shape[0] == 1 else scale[store])
        y = x.new_empty(batch, n, L.NW)
        y[:, store.reshape(-1)] = vals.reshape(batch, -1, L.NW)
        x = y
    return x.reshape(*lead, n, L.NW)


# ------------------------------------------------------------------ dispatch

def _check_sides(a, tw, n, in_table, out_scale):
    n_in = a.shape[-2]
    if n < 1 or n & (n - 1):
        raise ValueError(f"NTT length {n} is not a power of two")
    if not 1 <= n_in <= n:
        raise ValueError(f"rows of {n_in} elements do not fit a transform of length {n}")
    if tw.device != a.device or tw.dtype != torch.int32 or tw.shape[0] < n // 2:
        raise ValueError("twiddle table does not fit the transform")
    if in_table is not None:
        L._check(in_table)
        if in_table.device != a.device or in_table.dim() != 2 or in_table.shape[0] < n_in:
            raise ValueError("input table does not cover the rows")
    if out_scale is not None:
        L._check(out_scale)
        count = out_scale.numel() // L.NW
        if out_scale.device != a.device or count not in (1, n) or out_scale.dim() > 2:
            raise ValueError(f"output scale must be one element or a table of {n}")


def stockham(ctx: FieldCtx, a: torch.Tensor, tw: torch.Tensor, *, n: int | None = None,
             in_table: torch.Tensor | None = None,
             out_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Natural-order radix-2 NTT of length n of every row of a (…, n_in, 8).

    Rows shorter than n are read as zero-padded.  `in_table` (>= n_in, 8) is
    multiplied into the rows index by index before the transform;
    `out_scale`, one element or an (n, 8) table, into the result."""
    L._check(a)
    n = a.shape[-2] if n is None else n
    _check_sides(a, tw, n, in_table, out_scale)
    if a.device.type == "cpu":
        return stockham_sides_plain(ctx, a, tw, n, in_table, out_scale)
    _cuda.require_cuda(a, tw)
    if ctx is not L.FR_CTX:
        raise ValueError("the NTT kernel is built for Fr")
    n_in = a.shape[-2]
    k = n.bit_length() - 1
    a = a.contiguous()
    tw = tw.contiguous()
    lead = a.shape[:-2]
    batch = a.numel() // (n_in * L.NW)
    out = torch.empty((*lead, n, L.NW), dtype=torch.int32, device=a.device)
    if batch == 0:
        return out
    if in_table is not None:
        in_table = in_table.contiguous()
    out_mode = OUT_NONE
    if out_scale is not None:
        out_scale = out_scale.contiguous()
        out_mode = OUT_CONST if out_scale.numel() == L.NW else OUT_TABLE
    passes = plan(k, n_in)
    scratch = torch.empty_like(out) if len(passes) > 1 else None
    stream = _cuda.stream()
    src = a
    for i, p in enumerate(passes):
        # the last pass lands in `out`
        dst = out if (len(passes) - 1 - i) % 2 == 0 else scratch
        K_FUSED(src.data_ptr(), dst.data_ptr(), tw.data_ptr(),
                _cuda.ptr(in_table) if p.first else None,
                _cuda.ptr(out_scale) if p.last else None,
                batch, p.k, p.t0, p.s, p.c_log, p.n_in, p.nz,
                out_mode if p.last else OUT_NONE, p.threads, stream)
        src = dst
    return out


def ntt(plan: NTTPlan, a: torch.Tensor) -> torch.Tensor:
    """Coefficients -> evaluations over the 2^k subgroup (A[j] = a(omega^j))."""
    return stockham(plan.ctx, a, plan.tw)


def intt(plan: NTTPlan, a: torch.Tensor) -> torch.Tensor:
    """Evaluations -> coefficients: 1/n goes in as the last pass stores."""
    return stockham(plan.ctx, a, plan.tw_inv, out_scale=plan.n_inv)


def powers(ctx: FieldCtx, base: int, n: int, device, start: int = 1) -> torch.Tensor:
    """(n, 8) Montgomery words of [start, start*base, start*base^2, ...],
    made on `device`: `powers_of` (one `field_scan` launch on a card), then
    one product by `start` unless it is 1."""
    pw = powers_of(ctx, L.to_device_mont(ctx, [base], device)[0], n)
    if start % ctx.p == 1:
        return pw
    return L.mont_mul(ctx, pw, L.to_device_mont(ctx, [start], device))


def coset_scale(ctx: FieldCtx, coeffs: torch.Tensor, zeta_powers: torch.Tensor) -> torch.Tensor:
    """coeff_i * zeta^i, one K-a product: a plain NTT afterwards evaluates on
    the coset zeta H."""
    return L.mont_mul(ctx, coeffs, zeta_powers)
