"""Multi-scalar multiplication on BN254 G1 over Fq word tensors.

Counterpart of `delay_enc_tpu/ops/msm.py`, base-4 planes only:

 1. pair tables, built once per point set: for each adjacent pair
    (P_even, P_odd) the 16 options ce*P_even + co*P_odd, ce, co in 0..3,
    with kernel K-d (`complete_add`);
 2. per base-4 digit plane, each pair contributes the option its two
    digits select, and the row of W = n/2 selected points is summed with
    complete additions: kernel K-c (`msm_tree.tree_reduce`), which fuses
    the select into its load;
 3. the 127 plane sums come back to the host and the copied C fold
    combines them (sum_p 4^p S_p).

Points are (…, 3, 8) projective (X : Y : Z) in Montgomery form; the
identity is (0 : R mod q : 0).  `complete_add` launches kernel K-d
(`csrc/msm.cu`) on CUDA tensors and runs `complete_add_plain` on CPU ones.
`fixed_base_batch_mul` (the SRS powers) launches the fused fixed-base
kernel of `csrc/msm.cu` once on CUDA tensors and runs
`fixed_base_batch_mul_plain` on CPU ones.
"""

from __future__ import annotations

import numpy as np
import torch

from ..curves.bn254 import G1, _jac_add_affine, _jac_double, _jac_to_affine
from ..fields.bn254 import FQ
from ..utils.timers import GLOBAL_METRICS
from . import _cuda
from . import limbs as L
from . import msm_tree
from .limbs import FQ_CTX

SCALAR_BITS = 254
PLANES = 127  # base-4 digit planes of a 254-bit scalar
P = FQ.p

K_ADD = _cuda.kernel("g1_complete_add", "g1_complete_add",
                     "delay_enc_tpu/ops/msm.py:216 complete_add (_ll_complete_add :129)",
                     "delay_enc_tpu_torch/csrc/msm.cu")
K_SEL = _cuda.kernel("pair_sel", "pair_sel",
                     "delay_enc_tpu/ops/msm.py:393 _jit_pair_sel and ops/msm16.py:112 "
                     "_jit_pair_sel16",
                     "delay_enc_tpu_torch/csrc/msm.cu")
K_FIXED = _cuda.kernel("g1_fixed_base_mul", "g1_fixed_base_mul",
                       "delay_enc_tpu/ops/msm.py:508 fixed_base_batch_mul (lax.scan of "
                       "complete_add over 254 bit planes)",
                       "delay_enc_tpu_torch/csrc/msm.cu")


# ----------------------------------------------------------- point helpers

def identity_proj(device) -> torch.Tensor:
    """(3, 8) projective identity (0 : 1 : 0) in Montgomery form."""
    return torch.stack([FQ_CTX.const("zero", device), FQ_CTX.one_mont(device),
                        FQ_CTX.const("zero", device)])


def points_to_device(points, device) -> torch.Tensor:
    """Host affine points [(x, y) | None] -> (N, 3, 8) projective Montgomery."""
    xs, ys, zs = [], [], []
    for pt in points:
        if pt is None:
            xs.append(0), ys.append(1), zs.append(0)
        else:
            xs.append(pt[0]), ys.append(pt[1]), zs.append(1)
    arr = np.stack([FQ_CTX.to_mont_np(xs), FQ_CTX.to_mont_np(ys), FQ_CTX.to_mont_np(zs)],
                   axis=1)
    return L.to_tensor(arr, device)


def points_from_device(pts) -> list:
    """(…, 3, 8) projective Montgomery (tensor or numpy words) -> host affine
    [(x, y) | None], with one shared field inversion."""
    arr = L.to_numpy(pts) if isinstance(pts, torch.Tensor) else np.asarray(pts, np.uint32)
    arr = arr.reshape(-1, 3, L.NW)
    xs = FQ_CTX.from_mont_np(arr[:, 0])
    ys = FQ_CTX.from_mont_np(arr[:, 1])
    zs = FQ_CTX.from_mont_np(arr[:, 2])
    prefix = []
    acc = 1
    for z in zs:
        prefix.append(acc)
        if z:
            acc = acc * z % P
    inv = pow(acc, -1, P)
    out: list = [None] * len(zs)
    for i in range(len(zs) - 1, -1, -1):
        if zs[i]:
            zi = inv * prefix[i] % P
            inv = inv * zs[i] % P
            out[i] = (xs[i] * zi % P, ys[i] * zi % P)
    return out



def complete_add_plain(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Complete addition on y^2 = x^3 + 3 (b3 = 9), Renes-Costello-Batina
    2016 Algorithm 7, in plain PyTorch: the JAX package's array form
    (_complete_add_array), its 12 products in two 6-wide batches."""
    ctx = FQ_CTX
    p, q = torch.broadcast_tensors(p, q)
    X1, Y1, Z1 = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    X2, Y2, Z2 = q[..., 0, :], q[..., 1, :], q[..., 2, :]
    add = lambda a, b: L.add_plain(ctx, a, b)
    sub = lambda a, b: L.sub_plain(ctx, a, b)
    mul = lambda a, b: L.mont_mul_plain(ctx, a, b)
    st = torch.stack

    s = add(st([X1, Y1, X1, X2, Y2, X2]), st([Y1, Z1, Z1, Y2, Z2, Z2]))
    r1 = mul(st([X1, Y1, Z1, s[0], s[1], s[2]]), st([X2, Y2, Z2, s[3], s[4], s[5]]))
    t0, t1, t2, m3, m4, m5 = (r1[i] for i in range(6))
    d3 = sub(st([m3, m4, m5]), add(st([t0, t1, t0]), st([t1, t2, t2])))
    t3, t4, y3p = d3[0], d3[1], d3[2]
    tri_in = st([t2, y3p, t0])
    tri = add(add(tri_in, tri_in), tri_in)
    nine_in = tri[:2]
    nine = add(add(nine_in, nine_in), nine_in)
    t2_9, Y3 = nine[0], nine[1]
    t0 = tri[2]
    Z3 = add(t1, t2_9)
    t1 = sub(t1, t2_9)
    r2 = mul(st([t4, t3, Y3, t1, t0, Z3]), st([Y3, t1, t0, Z3, t3, t4]))
    X3 = sub(r2[1], r2[0])
    fin = add(st([r2[3], r2[5]]), st([r2[2], r2[4]]))
    return st([X3, fin[0], fin[1]], dim=-2)


def complete_add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """p + q for (…, 3, 8) point tensors; q may be one (3, 8) point."""
    if p.device.type == "cpu" and q.device.type == "cpu":
        return complete_add_plain(p, q)
    if p.device != q.device:
        raise ValueError(f"points on different devices: {p.device} and {q.device}")
    _cuda.require_cuda(p)
    for t in (p, q):
        if t.dtype != torch.int32 or t.shape[-2:] != (3, L.NW):
            raise ValueError(f"points must be int32 (…, 3, 8), got {t.dtype} {tuple(t.shape)}")
    if p.numel() < q.numel():
        p, q = q, p  # the sum is symmetric in its operands
    shape = p.shape
    a = p.contiguous().reshape(-1, 3, L.NW)
    b = q.contiguous().reshape(-1, 3, L.NW)
    n = a.shape[0]
    if b.shape[0] not in (1, n) or torch.broadcast_shapes(p.shape, q.shape) != shape:
        raise ValueError(f"cannot add points of shapes {tuple(p.shape)} and {tuple(q.shape)}")
    out = torch.empty_like(a)
    if n:
        K_ADD(_cuda.ptr(a), _cuda.ptr(b), _cuda.ptr(out), n, b.shape[0], _cuda.stream())
    return out.reshape(shape)


def point_double(p: torch.Tensor) -> torch.Tensor:
    return complete_add(p, p)


def point_neg(p: torch.Tensor) -> torch.Tensor:
    """(X : -Y : Z), -Y by one K-a subtraction over Fq."""
    return torch.stack([p[..., 0, :], L.neg(FQ_CTX, p[..., 1, :]), p[..., 2, :]], dim=-2)


def point_select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cond ? a : b, cond shaped like the batch (no point or word axis)."""
    return torch.where(cond[..., None, None], a, b)


# ------------------------------------------------------------ scalar planes

def scalars_to_words(scalars, device) -> torch.Tensor:
    """Host ints -> (N, 8) canonical words."""
    return L.to_tensor(L.ints_to_words_np([int(s) for s in scalars]), device)


def sel_planes(digit_bits: int) -> int:
    """Digit planes of a 254-bit scalar in digits of `digit_bits` bits."""
    if digit_bits not in (2, 4):
        raise ValueError(f"digits of 2 or 4 bits, not {digit_bits}")
    return -(-SCALAR_BITS // digit_bits)


def pair_sel_plain(scalar_words: torch.Tensor, digit_bits: int = 2) -> torch.Tensor:
    """(…, n, 8) canonical words -> (…, planes, n/2) uint8 pair selectors,
    digit_even + 2^digit_bits * digit_odd per plane, in plain PyTorch.  Bits
    past 253 are dropped, as the JAX package's zero padding drops them."""
    planes = sel_planes(digit_bits)
    *lead, n, _ = scalar_words.shape
    shifts = torch.arange(0, 32, digit_bits, dtype=torch.int32, device=scalar_words.device)
    # digit j of each word; the arithmetic shift's sign copies land above the
    # digit and are masked off
    d = ((scalar_words[..., None] >> shifts) & ((1 << digit_bits) - 1)).to(torch.uint8)
    d = d.reshape(*lead, n, 8 * len(shifts))[..., :planes].transpose(-1, -2)  # (…, planes, n)
    d[..., -1, :] &= (1 << (SCALAR_BITS - (planes - 1) * digit_bits)) - 1
    pairs = d.reshape(*lead, planes, n // 2, 2)
    return pairs[..., 0] + (1 << digit_bits) * pairs[..., 1]


def pair_sel(scalar_words: torch.Tensor, digit_bits: int = 2) -> torch.Tensor:
    """(…, n, 8) canonical words -> (…, planes, n/2) uint8 pair selectors of
    `pair_sel_plain`: 127 base-4 planes for digit_bits 2, 64 base-16 planes
    for 4.  One launch of the selector kernel on CUDA tensors."""
    if scalar_words.device.type == "cpu":
        return pair_sel_plain(scalar_words, digit_bits)
    _cuda.require_cuda(scalar_words)
    planes = sel_planes(digit_bits)
    if scalar_words.dtype != torch.int32 or scalar_words.dim() < 2 \
            or scalar_words.shape[-1] != L.NW or scalar_words.shape[-2] % 2:
        raise ValueError(f"scalars must be int32 (…, n, 8) with n even, got "
                         f"{scalar_words.dtype} {tuple(scalar_words.shape)}")
    *lead, n, _ = scalar_words.shape
    words = scalar_words.contiguous()
    batch = words.numel() // (n * L.NW) if n else 0
    out = torch.empty((*lead, planes, n // 2), dtype=torch.uint8, device=words.device)
    if batch and n:
        K_SEL(_cuda.ptr(words), _cuda.ptr(out), batch, n // 2, digit_bits, _cuda.stream())
    return out


# ------------------------------------------------------------------- MSM

def _pad_pow2(points: torch.Tensor, scalar_words: torch.Tensor):
    n = points.shape[0]
    n_pad = max(2, 1 << (n - 1).bit_length())
    if n_pad != n:
        pad_pts = identity_proj(points.device).expand(n_pad - n, 3, L.NW)
        points = torch.cat([points, pad_pts], dim=0)
        pad_axes = scalar_words.shape[:-2]
        scalar_words = torch.cat(
            [scalar_words, scalar_words.new_zeros((*pad_axes, n_pad - n, L.NW))], dim=-2)
    return points, scalar_words


def pair_tables(points: torch.Tensor) -> torch.Tensor:
    """(n, 3, 8) projective Montgomery -> (16, n/2, 3, 8) base-4 pair
    tables: option[ce + 4*co] = ce*P_even + co*P_odd for ce, co in 0..3.
    Depends only on the points: built once per SRS."""
    pe, po = points[0::2], points[1::2]
    m = pe.shape[0]
    both = torch.cat([pe, po])
    dbl = complete_add(both, both)
    tpl = complete_add(dbl, both)
    inf = identity_proj(points.device).expand(m, 3, L.NW)
    e_opts = [inf, pe, dbl[:m], tpl[:m]]
    o_opts = [inf, po, dbl[m:], tpl[m:]]
    cross = complete_add(
        torch.cat([e_opts[ce] for ce in (1, 2, 3) for _ in (1, 2, 3)]),
        torch.cat([o_opts[co] for _ in (1, 2, 3) for co in (1, 2, 3)]),
    )
    opts = [None] * 16
    for ce in range(4):
        opts[ce] = e_opts[ce]
    for co in range(1, 4):
        opts[4 * co] = o_opts[co]
    idx = 0
    for ce in (1, 2, 3):
        for co in (1, 2, 3):
            opts[ce + 4 * co] = cross[idx * m : (idx + 1) * m]
            idx += 1
    return torch.stack(opts)


def plane_sums_batch(tables: torch.Tensor, scalar_words: torch.Tensor) -> torch.Tensor:
    """tables from `pair_tables`; scalar_words (B, n, 8) canonical.
    Returns (B, 127, 3, 8) base-4 plane sums."""
    sel = pair_sel(scalar_words)  # (B, 127, n/2)
    b = sel.shape[0]
    sums = msm_tree.tree_reduce(tables, sel.reshape(b * PLANES, -1))
    return sums.reshape(b, PLANES, 3, L.NW)


def horner_host(plane_pts_affine, base_bits: int = 2) -> "tuple | None":
    """LSB-first list of plane sums (affine or None) -> the affine MSM result
    sum_p 2^(base_bits p) S_p."""
    acc = None
    for pt in reversed(plane_pts_affine):
        for _ in range(base_bits):
            acc = _jac_double(acc)
        acc = _jac_add_affine(acc, pt)
    return _jac_to_affine(acc)


def fold_planes_host(sums: torch.Tensor, base_bits: int = 2) -> list:
    """(B, P, 3, 8) plane sums of base 2^base_bits -> B affine MSM results,
    by the copied C fold (`native/ec.py:fold_planes_batch`, which reads
    16-bit limbs), or by `horner_host` where the C library is missing.  The
    span `fold`; its read of the sums is its child `device wait`."""
    from ..native.ec import fold_planes_batch

    with GLOBAL_METRICS.span("fold"):
        words = L.to_numpy(sums)
        b, n_planes = words.shape[0], words.shape[1]
        res = fold_planes_batch(L.words_to_limbs_np(words), base_bits)
        if res is not None:
            return res
        affine = points_from_device(words)
        return [horner_host(affine[i * n_planes : (i + 1) * n_planes], base_bits)
                for i in range(b)]


def msm_with_tables(tables: torch.Tensor, scalar_words: torch.Tensor) -> list:
    """tables from `pair_tables` (padded power-of-two point count);
    scalar_words (B, n, 8) canonical.  Returns B host affine points."""
    return fold_planes_host(plane_sums_batch(tables, scalar_words), base_bits=2)


def msm(points: torch.Tensor, scalar_words: torch.Tensor) -> torch.Tensor:
    """points (N, 3, 8) projective Montgomery, scalar_words (N, 8)
    canonical.  Returns the (3, 8) projective Montgomery result."""
    points, scalar_words = _pad_pow2(points, scalar_words)
    (res,) = msm_with_tables(pair_tables(points), scalar_words[None])
    return points_to_device([res], points.device)[0]


# --------------------------------------------- fixed-base batch scalar mul

def base_table(point, device) -> torch.Tensor:
    """(254, 3, 8) table of 2^b * P (host doubling chain)."""
    pts = []
    cur = point
    for _ in range(SCALAR_BITS):
        pts.append(cur)
        cur = G1.double(cur)
    return points_to_device(pts, device)


def fixed_base_batch_mul_plain(table: torch.Tensor, scalar_words: torch.Tensor) -> torch.Tensor:
    """[s_i * P] in plain PyTorch: a pass over the bit planes of the shared
    base table, each a batched complete addition of the table's entry or,
    where the bit is zero, of the identity."""
    n = scalar_words.shape[0]
    ident = identity_proj(scalar_words.device)
    acc = ident.expand(n, 3, L.NW).contiguous()
    for b in range(SCALAR_BITS):
        bit = ((scalar_words[:, b // 32] >> (b % 32)) & 1).bool()
        acc = complete_add_plain(acc, torch.where(bit[:, None, None], table[b], ident))
    return acc


def fixed_base_split(n: int) -> int:
    """Threads that share one scalar in the fixed-base kernel: the power of
    two up to 32 for which n scalars take the fewest additions in sequence,
    counted as waves of the card's resident threads times the additions a
    thread makes (its share of the 254 bits, then the fold)."""
    def cost(split: int) -> int:
        waves = -(-n * split // (msm_tree.SMS * msm_tree.SM_THREADS))
        return waves * (-(-SCALAR_BITS // split) + split.bit_length() - 1)

    return min((1, 2, 4, 8, 16, 32), key=cost)


def fixed_base_batch_mul(table: torch.Tensor, scalar_words: torch.Tensor) -> torch.Tensor:
    """[s_i * P] for (n, 8) canonical scalar words and the (254, 3, 8) table
    of `base_table`: one launch of the fused fixed-base kernel on CUDA
    tensors, `fixed_base_batch_mul_plain` on CPU ones."""
    if table.device.type == "cpu" and scalar_words.device.type == "cpu":
        return fixed_base_batch_mul_plain(table, scalar_words)
    if table.device != scalar_words.device:
        raise ValueError(f"table on {table.device}, scalars on {scalar_words.device}")
    _cuda.require_cuda(table)
    if table.dtype != torch.int32 or table.shape != (SCALAR_BITS, 3, L.NW):
        raise ValueError(f"the table must be int32 (254, 3, 8), got {table.dtype} "
                         f"{tuple(table.shape)}")
    if scalar_words.dtype != torch.int32 or scalar_words.dim() != 2 \
            or scalar_words.shape[1] != L.NW:
        raise ValueError(f"scalars must be int32 (n, 8), got {scalar_words.dtype} "
                         f"{tuple(scalar_words.shape)}")
    table, scalar_words = table.contiguous(), scalar_words.contiguous()
    n = scalar_words.shape[0]
    out = torch.empty((n, 3, L.NW), dtype=torch.int32, device=table.device)
    if n:
        K_FIXED(_cuda.ptr(table), _cuda.ptr(scalar_words), _cuda.ptr(out), n,
                fixed_base_split(n), _cuda.stream())
    return out
