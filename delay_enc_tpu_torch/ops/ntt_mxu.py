"""The matmul NTT over Fr word tensors: kernel K11 and its plain versions.

Counterpart of `delay_enc_tpu/ops/ntt_mxu.py`.  A transform of length
n = n1 * n2 (n1 = 2^(k // 2), both at most 1024) is the four-step DFT
    y[i1 + n1 i2] = sum_j2 W2[i2, j2] T[i1, j2] sum_j1 W1[i1, j1] A[j1, j2],
A = a as (n1, n2): two products of fixed matrices by the data and one
product by T, elementwise.  The plan's tables fold in the coset scale
(zeta^j, into W1's columns and T), the uniform factor (1/n, into W2) and the
per-output scale (zeta^-i, into T and W2's rows), so the prover's coset and
inverse transforms need no separate products.  Any correct NTT gives the
same reduced words, so the results equal `ops.ntt.stockham`'s.

On CUDA tensors `ntt_mxu_stack` launches kernel K11 (`csrc/ntt_mxu.cu`)
four times for a few polynomials at a time: for each step, `ntt_mxu_split`
cuts the data into 32 byte planes in the order the product's shared memory
holds them, and `ntt_mxu_product` brings the plan's fixed planes and those
data planes in by bulk copies, multiplies them with wgmma over u8 (one
fixed plane by a run of data planes at a time), carries each element's 63
byte columns, Montgomery-reduces them and, in the first step, multiplies
by T.  The plan's fixed planes are built on the device,
in the order the kernel's shared memory holds them (`frag_fixed`).

Two plain versions stand beside the kernel.  `ntt_mxu_plain` is the
four-step in field arithmetic (`ops.limbs` products and sums).
`ntt_mxu_cols_plain`, which CPU tensors take, follows the kernel: the same
layouts (`frag_fixed`, `split_plain`), the plane products summed into byte
columns (`columns_plain`, exact float64 matmuls) and the kernel's
reduction (`reduce_columns_plain`), so the kernel's layouts and exactness
can be tested without a card.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import _cuda
from . import limbs as L
from .limbs import FieldCtx
from .ntt import powers
from .poly import powers_rows

_REPLACES = "delay_enc_tpu/ops/ntt_mxu.py:307 ntt_mxu_raw"
_SOURCE = "delay_enc_tpu_torch/csrc/ntt_mxu.cu"
K_SPLIT = _cuda.kernel("ntt_mxu_split", "ntt_mxu_split",
                       _REPLACES + " (_to_nibbles :192, the transpose of step 3)", _SOURCE)
K_PRODUCT = _cuda.kernel("ntt_mxu_product", "ntt_mxu_product",
                         _REPLACES + " (_planes_dot :199, _redc_barrett :271, the product by T)",
                         _SOURCE)
K_REDUCE = _cuda.kernel("ntt_mxu_reduce", "ntt_mxu_reduce",
                        "delay_enc_tpu/ops/ntt_mxu.py:271 _redc_barrett", _SOURCE)

PLANES = 32  # byte planes of an element
COLS = 2 * PLANES - 1  # byte columns of a product of two elements
HALF_COLS, HALF_WORDS = 32, 9  # the product's low half of the columns; a carried half's words
TILE_M, TILE_N, TILE_K = 64, 8, 32  # an output tile, and a K tile (csrc/ntt_mxu_row.cuh)
MAX_SIDE = 1024  # n1 and n2; a column sums at most 32 * 1024 * 255^2 < 2^31
MU = (1 << 270) // L.FR_CTX.p  # the quotient estimate's constant (csrc: mxu::MU)
CHUNK_ELEMS = 1 << 21  # elements of the polynomials one launch set takes


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@dataclass
class MXUPlan:
    ctx: FieldCtx
    k: int
    n1: int
    n2: int
    w1_frag: torch.Tensor  # uint8 (n1/64, n1/32, 32, 2048): W1's planes (`frag_fixed`)
    w2_frag: torch.Tensor  # uint8 (n2/64, n2/32, 32, 2048): W2's
    t: torch.Tensor  # (n1, n2, 8) Montgomery words of T

    @property
    def n(self) -> int:
        return self.n1 * self.n2

    @property
    def device(self):
        return self.t.device

    @property
    def w1(self) -> torch.Tensor:
        """(n1, n1, 8) Montgomery words of W1."""
        return fixed_words(self.w1_frag, self.n1, self.n1)

    @property
    def w2(self) -> torch.Tensor:
        return fixed_words(self.w2_frag, self.n2, self.n2)


def make_plan(ctx: FieldCtx, k: int, omega: int, device, *, in_scale: int | None = None,
              out_mul: int | None = None, out_scale: int | None = None) -> MXUPlan:
    """Tables for y[i] = out_mul * out_scale^i * NTT_omega(in_scale^j * a_j)[i],
    made on `device` from ladders of powers (`powers`, `powers_rows`: one
    scan launch each on a card) and products (K-a):
        W1[i1, j1] = w1^(i1 j1) in_scale^(n2 j1),
        W2[i2, j2] = w2^(i2 j2) out_mul out_scale^(n1 i2),
        T[i1, j2] = omega^(i1 j2) in_scale^j2 out_scale^i1,
    with w1 = omega^n2 and w2 = omega^n1."""
    p = ctx.p
    n = 1 << k
    n1 = 1 << (k // 2)
    n2 = n // n1
    if max(n1, n2) > MAX_SIDE:
        raise ValueError(f"mxu ntt supports n <= 2^20 (n1,n2 <= 1024); got k={k}")
    s_in = 1 if in_scale is None else int(in_scale) % p
    m_out = 1 if out_mul is None else int(out_mul) % p
    s_out = 1 if out_scale is None else int(out_scale) % p

    def rows_of_powers(base: int, count: int, length: int, start: int = 1):
        """(count, length, 8): row r the powers of (start * base^r)."""
        return powers_rows(ctx, powers(ctx, base, count, device, start), length)

    w1 = rows_of_powers(pow(omega, n2, p), n1, n1)
    if s_in != 1:
        w1 = L.mont_mul(ctx, w1, powers(ctx, pow(s_in, n2, p), n1, device)[None])
    w2 = rows_of_powers(pow(omega, n1, p), n2, n2)
    if s_out != 1 or m_out != 1:
        w2 = L.mont_mul(ctx, w2, powers(ctx, pow(s_out, n1, p), n2, device, m_out)[:, None])
    t = rows_of_powers(omega, n1, n2, s_in)
    if s_out != 1:
        t = L.mont_mul(ctx, t, powers(ctx, s_out, n1, device)[:, None])
    return MXUPlan(ctx=ctx, k=k, n1=n1, n2=n2, w1_frag=frag_fixed(w1), w2_frag=frag_fixed(w2),
                   t=t.contiguous())


# ------------------------------------------------------------ layouts

def _planes(words: torch.Tensor) -> torch.Tensor:
    """(…, 8) int32 words -> (…, 32) uint8: byte b of the value is plane b."""
    return words.contiguous().view(torch.uint8)


def frag_fixed(words: torch.Tensor) -> torch.Tensor:
    """(m, K, 8) words of a fixed matrix -> its byte planes in the order the
    product's shared memory holds them, (m/64, K/32, 32 planes, 2048 bytes),
    rows and K padded with zeros: a plane's tile K-major in core matrices of
    8 rows x 16 bytes, byte 256 g + 128 h + 16 r + c holding row 64 I + 8 g
    + r, K 32 Kt + 16 h + c (csrc/ntt_mxu_row.cuh plane_pos)."""
    m, kk = words.shape[0], words.shape[1]
    it, kt = _ceil(m, TILE_M), _ceil(kk, TILE_K)
    b = _planes(words)
    if (it * TILE_M, kt * TILE_K) != (m, kk):
        b = torch.nn.functional.pad(b, (0, 0, 0, kt * TILE_K - kk, 0, it * TILE_M - m))
    b = b.reshape(it, 8, 8, kt, 2, 16, PLANES)  # I g r Kt h c a
    return b.permute(0, 3, 6, 1, 4, 2, 5).reshape(it, kt, PLANES, TILE_M * TILE_K).contiguous()


def _fixed_dims(frag: torch.Tensor) -> torch.Tensor:
    """A fixed operand as (I, Kt, a, g, h, r, c)."""
    return frag.reshape(frag.shape[0], frag.shape[1], PLANES, 8, 2, 8, 16)


def fixed_words(frag: torch.Tensor, m: int, kk: int) -> torch.Tensor:
    """The inverse of `frag_fixed`: (m, K, 8) words."""
    it, kt = frag.shape[0], frag.shape[1]
    b = _fixed_dims(frag).permute(0, 3, 5, 1, 4, 6, 2)
    b = b.reshape(it * TILE_M, kt * TILE_K, PLANES)[:m, :kk]
    return b.contiguous().view(torch.int32)


def fixed_planes(frag: torch.Tensor) -> torch.Tensor:
    """(32, rows, K) uint8 planes of a fixed operand in the product's order
    (padded)."""
    it, kt = frag.shape[0], frag.shape[1]
    b = _fixed_dims(frag).permute(2, 0, 3, 5, 1, 4, 6)
    return b.reshape(PLANES, it * TILE_M, kt * TILE_K)


def data_planes(frag: torch.Tensor) -> torch.Tensor:
    """(batch, col tiles, K tiles, 32, 256) data planes -> (batch, 32, cols,
    K) uint8 planes (padded): byte 128 h + 16 n + c of a plane holds column
    8 J + n, K 32 Kt + 16 h + c (plane_pos)."""
    batch, jt, kt = frag.shape[:3]
    b = frag.reshape(batch, jt, kt, PLANES, 2, 8, 16).permute(0, 3, 1, 5, 2, 4, 6)
    return b.reshape(batch, PLANES, jt * TILE_N, kt * TILE_K)


@dataclass(frozen=True)
class StepShape:
    """One matrix step: output (rows, cols) a polynomial; the data matrix
    (K, cols) read from source rows of n_in elements, element (k, col) at
    k * k_stride + col * c_stride, indices from n_in on read as zero; the
    K tiles that hold the first `kused` rows run, the rest are zero."""

    rows: int
    cols: int
    kdim: int
    n_in: int
    k_stride: int
    c_stride: int
    kused: int

    @property
    def ktiles(self) -> int:
        return _ceil(self.kused, TILE_K)

    @property
    def row_tiles(self) -> int:
        return _ceil(self.rows, TILE_M)

    @property
    def col_tiles(self) -> int:
        return _ceil(self.cols, TILE_N)


def steps(plan: MXUPlan, n_in: int) -> tuple:
    """The two steps of a transform whose rows hold n_in elements: the first
    reads A (j1 the K index, j2 the column), the second C = B (.) T
    transposed (j2 the K index, i1 the column)."""
    n1, n2 = plan.n1, plan.n2
    return (StepShape(n1, n2, n1, n_in, n2, 1, min(n1, _ceil(n_in, n2))),
            StepShape(n2, n1, n2, n1 * n2, 1, n2, n2))


# ---------------------------------------------------------- plain versions

def split_plain(x: torch.Tensor, s: StepShape) -> torch.Tensor:
    """`ntt_mxu_split` in plain PyTorch: (batch, n_in, 8) source rows -> the
    data planes in the product's order (batch, col tiles, K tiles, 32, 256):
    each plane's tile K-major, two halves of K of 8 columns x 16 bytes."""
    batch = x.shape[0]
    cols, kk = s.col_tiles * TILE_N, s.ktiles * TILE_K
    col = torch.arange(cols, device=x.device)[:, None]
    k = torch.arange(kk, device=x.device)[None, :]
    idx = k * s.k_stride + col * s.c_stride
    inside = (col < s.cols) & (k < s.kdim) & (idx < s.n_in)
    vals = x[:, idx.clamp(max=x.shape[1] - 1)]  # (batch, cols, K, 8)
    vals = torch.where(inside[None, :, :, None], vals, torch.zeros_like(vals))
    b = _planes(vals).reshape(batch, s.col_tiles, 8, s.ktiles, 2, 16, PLANES)  # J n Kt h c b
    return b.permute(0, 1, 3, 6, 4, 2, 5).reshape(
        batch, s.col_tiles, s.ktiles, PLANES, TILE_K * TILE_N).contiguous()


def columns_plain(w_frag: torch.Tensor, d_frag: torch.Tensor, s: StepShape) -> torch.Tensor:
    """The 63 byte columns of every output element, (batch, rows, cols, 63)
    int64: column c sums the plane products W_a . D_b over a + b = c.  The
    plane products are float matmuls, exact: every partial sum is an integer
    below K * 255^2, which float32 holds for K < 258 and float64 for any
    K <= 1024."""
    kk = s.ktiles * TILE_K
    exact = torch.float32 if kk * 255 ** 2 < 1 << 24 else torch.float64
    w = fixed_planes(w_frag)[:, : s.rows, :kk].to(exact)  # (32, m, K)
    d = data_planes(d_frag)[:, :, : s.cols].to(exact)  # (batch, 32, q, K)
    batch = d.shape[0]
    out = torch.zeros((batch, s.rows, s.cols, COLS), dtype=torch.int64, device=d.device)
    for z in range(batch):
        prod = torch.matmul(w.reshape(PLANES * s.rows, kk),
                            d[z].reshape(PLANES * s.cols, kk).T)
        prod = prod.reshape(PLANES, s.rows, PLANES, s.cols).to(torch.int64)
        for a in range(PLANES):
            out[z, :, :, a : a + PLANES] += prod[a].permute(0, 2, 1)
    return out


def reduce_columns_plain(cols: torch.Tensor) -> torch.Tensor:
    """(…, 63) byte columns (each below 2^31) of V < 2^518 -> (…, 8) words
    of V * 2^-256 mod p, the kernel's reduction (mxu::reduce_columns) in
    16-bit limbs held in int64: carry into 34 limbs, Montgomery-reduce the
    low 16, then q = floor(floor(X / 2^250) * MU / 2^20) and X - q p < 2p,
    reduced once."""
    ctx = L.FR_CTX
    cols = cols.to(torch.int64)
    limbs, carry = [], torch.zeros_like(cols[..., 0])
    for i in range(34):
        v = carry
        if 2 * i < COLS:
            v = v + cols[..., 2 * i]
        if 2 * i + 1 < COLS:
            v = v + (cols[..., 2 * i + 1] << 8)
        limbs.append(v & L.MASK)
        carry = v >> L.LIMB_BITS
    x = torch.stack(limbs, dim=-1)
    p = ctx.limbs_p(x.device)
    for i in range(L.NLIMB):
        u = ((x[..., i] & L.MASK) * ctx.n_prime) & L.MASK
        x[..., i : i + L.NLIMB] += u[..., None] * p
        x[..., i + 1] += x[..., i] >> L.LIMB_BITS
    top, carry = [], torch.zeros_like(x[..., 0])
    for i in range(L.NLIMB, 34):
        v = x[..., i] + carry
        top.append(v & L.MASK)
        carry = v >> L.LIMB_BITS
    t = (top[15] >> 10) | (top[16] << 6)  # X / 2^250 < 2^13
    q = (t * MU) >> 20
    out, borrow, qc = [], torch.zeros_like(q), torch.zeros_like(q)
    for i in range(L.NLIMB):
        qc = qc + q * ctx.p_limbs[i]
        d = top[i] - (qc & L.MASK) - borrow
        qc = qc >> L.LIMB_BITS
        borrow = (d < 0).to(torch.int64)
        out.append(d & L.MASK)
    return L._words(L._sub_p_if_ge(ctx, torch.stack(out, dim=-1)))


def product_plain(w_frag: torch.Tensor, d_frag: torch.Tensor, t: torch.Tensor | None,
                  s: StepShape) -> torch.Tensor:
    """`ntt_mxu_product` in plain PyTorch: (batch, rows * cols, 8) words."""
    out = reduce_columns_plain(columns_plain(w_frag, d_frag, s))
    if t is not None:
        out = L.mont_mul_plain(L.FR_CTX, out, t.reshape(1, s.rows, s.cols, L.NW))
    return out.reshape(out.shape[0], s.rows * s.cols, L.NW)


def ntt_mxu_cols_plain(plan: MXUPlan, stack: torch.Tensor) -> torch.Tensor:
    """`ntt_mxu_stack` step by step as the kernel makes it: (…, n_in, 8) ->
    (…, n, 8)."""
    lead, n_in = stack.shape[:-2], stack.shape[-2]
    x = stack.reshape(-1, n_in, L.NW)
    s1, s3 = steps(plan, n_in)
    c = product_plain(plan.w1_frag, split_plain(x, s1), plan.t, s1)
    y = product_plain(plan.w2_frag, split_plain(c, s3), None, s3)
    return y.reshape(*lead, plan.n, L.NW)


def _field_matmul_plain(ctx, w: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(m, K, 8) by (batch, K, q, 8) -> (batch, m, q, 8): Montgomery
    products, summed over K by a tree of additions."""
    prod = L.mont_mul_plain(ctx, w[None, :, :, None, :], d[:, None])  # (batch, m, K, q, 8)
    while prod.shape[2] > 1:
        if prod.shape[2] % 2:
            prod = torch.cat([prod, torch.zeros_like(prod[:, :, :1])], dim=2)
        prod = L.add_plain(ctx, prod[:, :, 0::2], prod[:, :, 1::2])
    return prod[:, :, 0]


def ntt_mxu_plain(plan: MXUPlan, stack: torch.Tensor) -> torch.Tensor:
    """The four-step in field arithmetic: B = W1 . A, C = B (.) T,
    Y = W2 . C^T, read in natural order.  (…, n_in, 8) -> (…, n, 8)."""
    ctx = plan.ctx
    lead, n_in = stack.shape[:-2], stack.shape[-2]
    x = stack.reshape(-1, n_in, L.NW)
    if n_in < plan.n:
        x = torch.cat([x, x.new_zeros(x.shape[0], plan.n - n_in, L.NW)], dim=1)
    a = x.reshape(-1, plan.n1, plan.n2, L.NW)
    c = L.mont_mul_plain(ctx, _field_matmul_plain(ctx, plan.w1, a), plan.t[None])
    y = _field_matmul_plain(ctx, plan.w2, c.transpose(1, 2))  # (batch, n2, n1, 8)
    return y.reshape(*lead, plan.n, L.NW)


# ------------------------------------------------------------------ dispatch

def split(x: torch.Tensor, s: StepShape) -> torch.Tensor:
    """One launch of `ntt_mxu_split` over (batch, rows, 8) source rows."""
    batch = x.shape[0]
    out = torch.empty((batch, s.col_tiles, s.ktiles, PLANES, TILE_K * TILE_N),
                      dtype=torch.uint8, device=x.device)
    K_SPLIT(x.data_ptr(), out.data_ptr(), batch, s.n_in, x.shape[1], s.k_stride, s.c_stride,
            s.cols, s.kdim, s.col_tiles, s.ktiles, _cuda.stream())
    return out


def product(w_frag: torch.Tensor, d_frag: torch.Tensor, t: torch.Tensor | None,
            s: StepShape, out: torch.Tensor) -> torch.Tensor:
    """One launch of `ntt_mxu_product` into out (batch, rows * cols, 8)."""
    batch = d_frag.shape[0]
    if w_frag.shape[1] < s.ktiles or d_frag.shape[2] != s.ktiles:
        raise ValueError("the planes do not cover the step's K tiles")
    K_PRODUCT(w_frag.data_ptr(), d_frag.data_ptr(), _cuda.ptr(t), out.data_ptr(), batch,
              s.rows, s.cols, s.row_tiles, s.col_tiles, w_frag.shape[1], s.ktiles,
              _cuda.stream())
    return out


def product_attrs() -> dict:
    """The product kernel's resources as the card's runtime reports them
    (no launch): registers and spilled bytes a thread, static and dynamic
    shared memory a block, blocks an SM, threads a block.  The registers are
    those of the launch; the consumer warpgroups raise theirs with
    setmaxnreg (csrc/ntt_mxu.cu CONSUMER_REGS)."""
    out = (ctypes.c_int * 6)()
    _cuda.query("ntt_mxu_product_attrs", ctypes.addressof(out))
    keys = ("registers", "local_bytes", "static_smem", "dynamic_smem", "blocks_per_sm",
            "threads")
    return dict(zip(keys, out))


def reduce_columns(cols: torch.Tensor) -> torch.Tensor:
    """(count, 63) int32 byte columns -> (count, 8) words of V * 2^-256 mod p:
    the product's reduction alone (`ntt_mxu_reduce`, no transform launches
    it), or its plain version on CPU tensors."""
    if cols.dim() != 2 or cols.shape[1] != COLS or cols.dtype != torch.int32:
        raise ValueError(f"columns must be int32 (count, {COLS}), got {cols.dtype} "
                         f"{tuple(cols.shape)}")
    if cols.device.type == "cpu":
        return reduce_columns_plain(cols.to(torch.int64) & 0xFFFFFFFF)
    _cuda.require_cuda(cols)
    cols = cols.contiguous()
    out = torch.empty((cols.shape[0], L.NW), dtype=torch.int32, device=cols.device)
    K_REDUCE(cols.data_ptr(), out.data_ptr(), cols.shape[0], _cuda.stream())
    return out


def ntt_mxu_stack(plan: MXUPlan, stack: torch.Tensor) -> torch.Tensor:
    """The plan's transform of every row of a (…, n_in, 8) stack, rows
    shorter than n read as zero-padded -> (…, n, 8).  On a card, K11 over
    a few polynomials at a time (CHUNK_ELEMS), four launches each."""
    L._check(stack)
    n_in, n = stack.shape[-2], plan.n
    if not 1 <= n_in <= n:
        raise ValueError(f"rows of {n_in} elements do not fit a transform of length {n}")
    if stack.device != plan.device:
        raise ValueError(f"stack on {stack.device}, plan on {plan.device}")
    if stack.device.type == "cpu":
        return ntt_mxu_cols_plain(plan, stack)
    _cuda.require_cuda(stack)
    if plan.ctx is not L.FR_CTX:
        raise ValueError("the matmul NTT kernel is built for Fr")
    lead = stack.shape[:-2]
    x = stack.reshape(-1, n_in, L.NW).contiguous()
    batch = x.shape[0]
    out = torch.empty((batch, n, L.NW), dtype=torch.int32, device=x.device)
    s1, s3 = steps(plan, n_in)
    chunk = max(1, CHUNK_ELEMS // n)
    for first in range(0, batch, chunk):
        part = x[first : first + chunk]
        c = product(plan.w1_frag, split(part, s1), plan.t, s1,
                    torch.empty((part.shape[0], n, L.NW), dtype=torch.int32, device=x.device))
        product(plan.w2_frag, split(c, s3), None, s3, out[first : first + chunk])
    return out.reshape(*lead, n, L.NW)


def ntt_mxu(plan: MXUPlan, a: torch.Tensor) -> torch.Tensor:
    """The plan's transform of one (n_in, 8) row -> (n, 8)."""
    return ntt_mxu_stack(plan, a[None])[0]


def launches(n: int, rows: int) -> int:
    """Launches of each K11 kernel in `ntt_mxu_stack` of `rows` polynomials
    of length n: two a chunk."""
    return 2 * _ceil(rows, max(1, CHUNK_ELEMS // n))
