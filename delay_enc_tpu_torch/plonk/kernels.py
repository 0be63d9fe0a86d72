"""Prover building blocks: the fused kernels and plain PyTorch over the others.

Counterpart of `delay_enc_tpu/plonk/kernels.py`, the fused 8n quotient and
the split one (`split_quotient`, from k = 18 on).  Each function keeps its
JAX name; the JAX `vmap`s are a leading batch axis here.  Two blocks are
one kernel each on a card: `gp_fracs` (K5, `csrc/fracs.cu`), the
numerators and denominators of the five grand products, and `quotient_h`
(K6, `csrc/quotient.cu`), the y-folded quotient expression times 1/Z_H, on
the fused 8n coset or, in its coset form, on one size-n coset of the split
quotient (K9).  The openings' contractions of coefficient rows with
the powers of a point are K7 (`open_stack`, `csrc/open.cu`): one launch
evaluates every opened row at its point, one forms every point's v-weighted
sum times z^i, so `_eval_stack` and `_gwc_witness` take the stacks of all
the points at once, where the JAX package calls them a point at a time.
On CPU tensors they run their plain versions, which are the
functions below them.  The batched prover (`plonk/batch_prover.py`)
gives K5, K6 and K7 a leading instance axis: one launch serves every
instance of the batch (up to `MAX_INSTANCES`), each with its own witness
rows and challenges over the key's shared rows, as the JAX package's vmaps
do; their plain versions loop the single-instance ones over the instances.
Field arithmetic goes through `ops.limbs`
(kernel K-a on a card), transforms through `ops.ntt.stockham` (kernel K-b,
with the coset scaling, the zero padding, 1/n or zeta^-i / n_ext fused into
its first and last pass), scans and powers through `ops.poly` (kernel
`field_scan`), commitments through `ops.msm` (kernels `pair_sel`, K-c and
K-d) or `ops.msm16` (`pair_sel`, `plane_sums16` and K-d).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..fields.bn254 import FR
from ..ops import _cuda
from ..ops import limbs as L
from ..ops import msm as M
from ..ops import msm16 as M16
from ..ops import poly as P
from ..ops.ntt import NTTPlan, stockham
from .domain import MAX_DEGREE
from .keygen import ALL_FIXED, KEY_ROWS, NUM_PERM_COLS

WIRE_COL = {"a": 0, "b": 1, "c": 2, "d": 3}
LOOKUPS = ("a", "b", "c", "d")
CTX = L.FR_CTX
N_EXPRS = 4 + 5 * len(LOOKUPS)  # gate, 3 permutation terms, 5 terms a lookup

# rows of the prover's (19, n_ext, 8) witness stack: advice a..e, instance,
# z_perm, z_l, A'_l, S'_l for the lookups a..d (csrc/quotient_row.cuh)
W_INSTANCE, W_Z_PERM, W_Z_L, W_AP, W_SP, WIT_ROWS = 5, 6, 7, 11, 15, 19

# rows of `challenge_words` (csrc/fracs_row.cuh Consts)
C_THETA, C_BETA, C_GAMMA, C_Y, C_DELTA, C_BETA_DELTA, N_CONSTS = 0, 1, 2, 3, 4, 10, 16
# instances one launch of K5, K6 or K7 takes (csrc/fracs_row.cuh
# MAX_INSTANCES, csrc/open_row.cuh MAX_TABLES): the wrappers split a batch
MAX_INSTANCES = 16

_REPLACES = "delay_enc_tpu/plonk/kernels.py:"
K_FRACS = _cuda.kernel(
    "gp_fracs", "gp_fracs",
    _REPLACES + "102 _jit_compress, :109 _jit_perm_fracs, :125 _jit_lookup_fracs (K5)",
    "delay_enc_tpu_torch/csrc/fracs.cu")
K_QUOTIENT = _cuda.kernel(
    "quotient_h", "quotient_h",
    _REPLACES + "192 _quotient_expr and the * zh_inv_ext of :294 _jit_quotient (K6)",
    "delay_enc_tpu_torch/csrc/quotient.cu")
K_QUOTIENT_COSET = _cuda.kernel(
    "quotient_h_coset", "quotient_h",
    _REPLACES + "337 _jit_quotient_coset and the swapaxes of :361 _jit_interleave_intt (K9)",
    "delay_enc_tpu_torch/csrc/quotient.cu")
K_OPEN_EVAL = _cuda.kernel(
    "open_eval", "open_eval", _REPLACES + "396 _jit_eval_stack (K7)",
    "delay_enc_tpu_torch/csrc/open.cu")
K_OPEN_COMBINE = _cuda.kernel(
    "open_combine", "open_combine",
    _REPLACES + "411 _jit_gwc_witness, its v-weighted sum and the * z^i of "
    "delay_enc_tpu/ops/poly.py:137 divide_by_linear (K7)",
    "delay_enc_tpu_torch/csrc/open.cu")


def _mul(a, b):
    return L.mont_mul(CTX, a, b)


def _add(a, b):
    return L.add(CTX, a, b)


def _sub(a, b):
    return L.sub(CTX, a, b)


# ---------------------------------------------------------------- transforms

def _coeff(stack: torch.Tensor, plan: NTTPlan) -> torch.Tensor:
    """(…, n, 8) evaluations -> coefficients (iNTT with 1/n in its last pass)."""
    return stockham(CTX, stack, plan.tw_inv, out_scale=plan.n_inv)


def _ext(coeff: torch.Tensor, zeta_powers: torch.Tensor, plan_ext: NTTPlan) -> torch.Tensor:
    """(…, n, 8) coefficients -> evaluations on the extended coset
    zeta*H_ext (…, n_ext, 8): coeff_i * zeta^i goes in as the first pass
    loads, and the rows are read as zero-padded to n_ext.  No sacrificial
    lane: the JAX package's ext_batch_padded works around an XLA:TPU fault
    this path does not have."""
    return stockham(CTX, coeff, plan_ext.tw, n=plan_ext.n, in_table=zeta_powers)


def _evals_batch(coeff: torch.Tensor, plan: NTTPlan) -> torch.Tensor:
    return stockham(CTX, coeff, plan.tw)


def _canon_batch(a: torch.Tensor) -> torch.Tensor:
    return L.mont_to_canonical(CTX, a)


def msm_plane_sums(tables, canon_stack: torch.Tensor) -> tuple:
    """The device part of `msm_commit_batch`: ((B, planes, 3, 8) plane
    sums, bits a digit), for the host fold (`ops/msm.py:fold_planes_host`)."""
    kind = "b4"
    if isinstance(tables, tuple):
        kind, tables = tables
    if kind == "b16":
        return M16.plane_sums_batch16(tables, canon_stack), M16.DIGIT_BITS
    if kind != "b4":
        raise ValueError(f"unknown MSM {kind!r}: 'b4' or 'b16'")
    return M.plane_sums_batch(tables, canon_stack), 2


def msm_commit_batch(tables, canon_stack: torch.Tensor) -> list:
    """(B, n, 8) canonical coefficient stack -> B host affine commitments,
    through the shared per-SRS tables: a bare base-4 pair table, or a
    ("b4" | "b16", table) pair from `SRS.msm_tables`."""
    sums, base_bits = msm_plane_sums(tables, canon_stack)
    return M.fold_planes_host(sums, base_bits=base_bits)


# ----------------------------------------------------------- grand products

def _compress(tag_raw, adv_raw, theta_m):
    return _add(tag_raw, _mul(theta_m, _mul(tag_raw, adv_raw)))


def _perm_fracs(perm_cols, sigmas, omega_dev, beta_m, gamma_m, delta_ms):
    """perm_cols: the 5 advice columns + the instance column (row evals)."""
    num = CTX.one_mont(omega_dev.device).expand_as(perm_cols[0])
    den = num
    for c in range(len(perm_cols)):
        idterm = _mul(_mul(beta_m, delta_ms[c]), omega_dev)
        num = _mul(num, _add(_add(perm_cols[c], idterm), gamma_m))
        den = _mul(den, _add(_add(perm_cols[c], _mul(beta_m, sigmas[c])), gamma_m))
    return num, den


def _lookup_fracs(a, s, ap, sp, beta_m, gamma_m):
    num = _mul(_add(a, beta_m), _add(s, gamma_m))
    den = _mul(_add(ap, beta_m), _add(sp, gamma_m))
    return num, den


# The grand product needs one field inversion (of the total denominator
# product): the totals come back to the host (32 bytes each), are inverted
# there, and `_gp_finish` completes.  Blinding rows are overwritten with
# caller-supplied randomness.

def _gp_partials(num, den, active_mask, impl: str):
    """num, den (G, n, 8) for G grand products; active_mask (n,) bool.
    Returns the masked num, the exclusive prefix and suffix products of the
    masked den (row i: the product of the rows before it, and after it), and
    the (G, 8) totals."""
    one = CTX.one_mont(num.device)
    num = torch.where(active_mask[:, None], num, one)
    den = torch.where(active_mask[:, None], den, one)
    pre = P.prefix_product(CTX, den, impl, exclusive=True)
    suf = P.suffix_product(CTX, den, impl, exclusive=True)
    return num, pre, suf, _mul(pre[:, -1], den[:, -1])


def _gp_finish(num, pre, suf, total_inv_m, blind_rows, impl: str):
    """pre, suf as `_gp_partials` returns them; total_inv_m (G, 8);
    blind_rows (G, b, 8) -> z (G, n, 8)."""
    den_inv = _mul(_mul(pre, suf), total_inv_m[:, None, :])
    z = P.prefix_product(CTX, _mul(num, den_inv), impl, exclusive=True)
    z[:, z.shape[1] - blind_rows.shape[1]:] = blind_rows
    return z


# ------------------------------------------------------------------ quotient

def _tree_mul(x):
    """Modular product along axis 0 via a pairwise tree."""
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        s = _mul(x[:half], x[half : 2 * half])
        if x.shape[0] % 2:
            s = torch.cat([s, x[-1:]], dim=0)
        x = s
    return x[0]


def _tree_sum(x):
    """Modular sum along axis 0 via a pairwise tree."""
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        s = _add(x[:half], x[half : 2 * half])
        if x.shape[0] % 2:
            s = torch.cat([s, x[-1:]], dim=0)
        x = s
    return x[0]


def _quotient_expr(advice_ext, instance_ext, z_perm_ext, z_l_ext, ap_ext, sp_ext,
                   fe, sigma_ext, masks, chals, delta_ms, y_pows_rev, rot_step=MAX_DEGREE):
    """The y-folded constraint expression evaluated pointwise on a domain.

    rot_step is the index distance of "the next row" there: MAX_DEGREE on
    the fused 8n extended coset, which interleaves the row domain MAX_DEGREE
    times, 1 on one size-n coset of the split quotient.
    masks = (l0, l_last, l_blind, x) evals on the domain;
    chals = (theta_m, beta_m, gamma_m); y_pows_rev[i] = y^(n_exprs-1-i)."""
    rot = rot_step
    l0_ext, l_last_ext, l_blind_ext, x_ext = masks
    theta_m, beta_m, gamma_m = chals
    one = CTX.one_mont(advice_ext[0].device)
    mask = _sub(one, _add(l_last_ext, l_blind_ext))
    st = torch.stack

    a_e, b_e, c_e, d_e, e_e = advice_ext

    # gate: products [a*b, c*d], then the 8 selector products in one batch
    prods = _mul(st([a_e, c_e]), st([b_e, d_e]))
    gate_terms = _mul(
        st([fe["q_a"], fe["q_b"], fe["q_c"], fe["q_d"], fe["q_e"],
            fe["q_mul_ab"], fe["q_mul_cd"], fe["q_e_next"]]),
        st([a_e, b_e, c_e, d_e, e_e, prods[0], prods[1], torch.roll(e_e, -rot, 0)]),
    )
    gate = _add(_tree_sum(gate_terms), fe["q_constant"])

    # permutation
    perm_cols = st(list(advice_ext) + [instance_ext])  # (6, n_ext, 8)
    sig_st = st(list(sigma_ext))
    delta_st = st([d[0] for d in delta_ms])[:, None, :]  # (6, 1, 8)
    bsig = _mul(beta_m, sig_st)
    bdx = _mul(_mul(beta_m, delta_st), x_ext)
    left_f = _add(_add(perm_cols, bsig), gamma_m)
    right_f = _add(_add(perm_cols, bdx), gamma_m)
    lprod = _tree_mul(left_f)
    rprod = _tree_mul(right_f)
    lr = _mul(st([torch.roll(z_perm_ext, -rot, 0), z_perm_ext]), st([lprod, rprod]))
    e_perm_a = _mul(l0_ext, _sub(one, z_perm_ext))
    e_perm_b = _mul(l_last_ext, _sub(_mul(z_perm_ext, z_perm_ext), z_perm_ext))
    e_perm_c = _mul(mask, _sub(lr[0], lr[1]))
    del perm_cols, sig_st, bsig, bdx, left_f, right_f, lprod, rprod, lr

    # lookups: all four arguments batched on a leading axis
    s_ext = _add(fe["table_tag"], _mul(theta_m, _mul(fe["table_tag"], fe["table_value"])))
    tag_st = st([fe[f"tag_{l}"] for l in LOOKUPS])  # (4, n_ext, 8)
    adv_st = st([advice_ext[WIRE_COL[l]] for l in LOOKUPS])
    zl_st = st([z_l_ext[l] for l in LOOKUPS])
    ap_st = st([ap_ext[l] for l in LOOKUPS])
    sp_st = st([sp_ext[l] for l in LOOKUPS])
    a_exp = _add(tag_st, _mul(theta_m, _mul(tag_st, adv_st)))
    lhs = _mul(torch.roll(zl_st, -rot, 1), _mul(_add(ap_st, beta_m), _add(sp_st, gamma_m)))
    rhs = _mul(zl_st, _mul(_add(a_exp, beta_m), _add(s_ext, gamma_m)))
    ap_m_sp = _sub(ap_st, sp_st)
    lk_a = _mul(l0_ext, _sub(one, zl_st))
    lk_b = _mul(l_last_ext, _sub(_mul(zl_st, zl_st), zl_st))
    lk_c = _mul(mask, _sub(lhs, rhs))
    lk_d = _mul(l0_ext, ap_m_sp)
    lk_e = _mul(mask, _mul(ap_m_sp, _sub(ap_st, torch.roll(ap_st, rot, 1))))
    del tag_st, adv_st, zl_st, ap_st, sp_st, a_exp, lhs, rhs, ap_m_sp

    # y-fold in the verifier's expression order: gate, 3 perm terms, then
    # per lookup [l0(1-z), l_last(z^2-z), mask(lhs-rhs), l0(ap-sp),
    # mask(ap-sp)(ap-ap_prev)]; chunks of 8 bound the live stack
    exprs = [gate, e_perm_a, e_perm_b, e_perm_c]
    for i in range(len(LOOKUPS)):
        exprs.extend([lk_a[i], lk_b[i], lk_c[i], lk_d[i], lk_e[i]])
    total = None
    CH = 8
    for off in range(0, len(exprs), CH):
        w = _mul(y_pows_rev[off : off + CH, None, :], st(exprs[off : off + CH]))
        part = _tree_sum(w)
        total = part if total is None else _add(total, part)
    return total


# ------------------------------------------------------ the fused kernels

def challenge_words(theta: int, beta: int, gamma: int, y: int, deltas) -> np.ndarray:
    """(16, 8) uint32 Montgomery words that both fused kernels take: theta,
    beta, gamma, y, the six delta^c and the six beta delta^c."""
    deltas = list(deltas)
    if len(deltas) != NUM_PERM_COLS:
        raise ValueError(f"{NUM_PERM_COLS} powers of delta, got {len(deltas)}")
    return CTX.to_mont_np([theta, beta, gamma, y, *deltas, *(beta * d % FR.p for d in deltas)])


def _check_shapes(shapes: dict):
    """Check each named tensor against its (…, 8) shape: int32, one device."""
    device = None
    for name, (t, shape) in shapes.items():
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be int32 {shape}, got {t.dtype} {tuple(t.shape)}")
        if device is not None and t.device != device:
            raise ValueError(f"operands on different devices: {device} and {t.device}")
        device = t.device


def _check_operands(shapes: dict, consts, lead: tuple = ()) -> np.ndarray:
    """Check each named tensor against its (…, 8) shape: int32, one device;
    return the challenge words, checked, as a contiguous array: (16, 8), or
    (B, 16, 8) for a batch, lead = (B,)."""
    _check_shapes(shapes)
    want = (*lead, N_CONSTS, L.NW)
    if not isinstance(consts, np.ndarray) or consts.dtype != np.uint32 or consts.shape != want:
        raise ValueError(f"challenge words must be a {want} uint32 array")
    return np.ascontiguousarray(consts)


def _batch_of(t: torch.Tensor, dims: int) -> tuple:
    """(B,) where t carries a leading instance axis over `dims` dimensions,
    else ()."""
    return tuple(t.shape[:1]) if t.dim() == dims + 1 else ()


def _groups(count: int):
    """(first, count) of each launch over `count` instances."""
    for first in range(0, count, MAX_INSTANCES):
        yield first, min(MAX_INSTANCES, count - first)


def _pointers(tensors: list) -> list:
    """The addresses of contiguous tensors, each 16-byte aligned for the
    kernels' vector loads."""
    ptrs = [t.data_ptr() for t in tensors]
    if any(p % 16 for p in ptrs):
        raise ValueError("a kernel operand is not 16-byte aligned")
    return ptrs


def _plain_consts(consts: np.ndarray, device) -> torch.Tensor:
    """(16, 1, 8): row r is a (1, 8) operand of the plain functions."""
    return L.to_tensor(consts, device)[:, None, :]


def gp_fracs_plain(raw6, sigma_raw, omega_dev, raw_stack, lk_raw, consts, usable: int):
    """`gp_fracs` over the plain functions `_compress`, `_perm_fracs` and
    `_lookup_fracs`, stacked, with the rows from `usable` on set to one; for
    a batch, one instance after another."""
    if raw6.dim() == 4:
        outs = [gp_fracs_plain(r, sigma_raw, omega_dev, raw_stack, lk, c, usable)
                for r, lk, c in zip(raw6, lk_raw, consts)]
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])
    c = _plain_consts(consts, raw6.device)
    theta_m, beta_m, gamma_m = c[C_THETA], c[C_BETA], c[C_GAMMA]
    key = dict(zip(ALL_FIXED, raw_stack))
    s_raw = _compress(key["table_tag"], key["table_value"], theta_m)
    num_p, den_p = _perm_fracs(list(raw6), list(sigma_raw), omega_dev, beta_m, gamma_m,
                               list(c[C_DELTA : C_DELTA + NUM_PERM_COLS]))
    nums, dens = [num_p], [den_p]
    for i, l in enumerate(LOOKUPS):
        a_raw = _compress(key[f"tag_{l}"], raw6[WIRE_COL[l]], theta_m)
        num, den = _lookup_fracs(a_raw, s_raw, lk_raw[i], lk_raw[len(LOOKUPS) + i],
                                 beta_m, gamma_m)
        nums.append(num)
        dens.append(den)
    num, den = torch.stack(nums), torch.stack(dens)
    one = CTX.one_mont(num.device)
    num[:, usable:] = one
    den[:, usable:] = one
    return num, den


def gp_fracs(raw6, sigma_raw, omega_dev, raw_stack, lk_raw, consts, usable: int):
    """Numerators and denominators of the five grand products (the
    permutation, then the lookups a..d), each (5, n, 8), one from row
    `usable` on.  raw6 (6, n, 8): the advice columns and the instance column;
    sigma_raw (6, n, 8); omega_dev (n, 8): omega^i; raw_stack: the key's
    fixed columns (ALL_FIXED order); lk_raw (8, n, 8): A'_a..d then S'_a..d;
    consts: `challenge_words`.  For a batch of B instances of one circuit,
    raw6 (B, 6, n, 8), lk_raw (B, 8, n, 8) and consts (B, 16, 8), and num
    and den (B*5, n, 8), instance after instance (the rows `_gp_partials`
    takes).  One launch of K5 on CUDA tensors, for every instance."""
    lead = _batch_of(raw6, 3)
    n = raw6.shape[-2]
    consts = _check_operands({
        "raw6": (raw6, (*lead, NUM_PERM_COLS, n, L.NW)),
        "sigma_raw": (sigma_raw, (NUM_PERM_COLS, n, L.NW)),
        "omega_dev": (omega_dev, (n, L.NW)),
        "raw_stack": (raw_stack, (len(ALL_FIXED), n, L.NW)),
        "lk_raw": (lk_raw, (*lead, 2 * len(LOOKUPS), n, L.NW)),
    }, consts, lead)
    if not 0 <= usable <= n:
        raise ValueError(f"usable rows {usable} outside 0..{n}")
    if raw6.device.type == "cpu":
        return gp_fracs_plain(raw6, sigma_raw, omega_dev, raw_stack, lk_raw, consts, usable)
    _cuda.require_cuda(raw6)
    count = lead[0] if lead else 1
    ins = [t.contiguous() for t in (raw6, sigma_raw, omega_dev, raw_stack, lk_raw)]
    num = torch.empty((count * (1 + len(LOOKUPS)), n, L.NW), dtype=torch.int32,
                      device=raw6.device)
    den = torch.empty_like(num)
    raw_p, sig_p, om_p, key_p, lk_p = _pointers(ins)
    col = n * L.NW * 4  # bytes of a column
    words = consts.reshape(count, N_CONSTS, L.NW)
    for first, k in _groups(count):
        out = first * (1 + len(LOOKUPS)) * col
        K_FRACS(raw_p + first * NUM_PERM_COLS * col, sig_p, om_p, key_p,
                lk_p + first * 2 * len(LOOKUPS) * col, words[first:].ctypes.data,
                num.data_ptr() + out, den.data_ptr() + out, n, usable, k, _cuda.stream())
    return num, den


def _quotient_args(wit_ext, key_ext, x_ext, consts):
    """The stacks and challenge words as the arguments of `_quotient_expr`."""
    c = _plain_consts(consts, wit_ext.device)
    y = CTX.from_mont_np(consts[C_Y])[0]
    y_pows_rev = L.to_device_mont(CTX, [pow(y, N_EXPRS - 1 - i, FR.p) for i in range(N_EXPRS)],
                                  wit_ext.device)
    key = dict(zip(KEY_ROWS, key_ext))
    nf = len(ALL_FIXED)
    lookup = lambda row: {l: wit_ext[row + i] for i, l in enumerate(LOOKUPS)}
    return (list(wit_ext[:W_INSTANCE]), wit_ext[W_INSTANCE], wit_ext[W_Z_PERM],
            lookup(W_Z_L), lookup(W_AP), lookup(W_SP),
            {name: key[name] for name in ALL_FIXED}, list(key_ext[nf : nf + NUM_PERM_COLS]),
            (key["l0"], key["l_last"], key["l_blind"], x_ext),
            (c[C_THETA], c[C_BETA], c[C_GAMMA]), list(c[C_DELTA : C_DELTA + NUM_PERM_COLS]),
            y_pows_rev)


QUOTIENT_ROTS = (MAX_DEGREE, 1)  # "the next row": the fused coset, a split coset


def quotient_h_plain(wit_ext, key_ext, x_ext, zh_inv, consts, *, rot=MAX_DEGREE, out=None,
                     out_stride=1, out_offset=0):
    """`quotient_h` as `_quotient_expr` times 1/Z_H (period `rot`), stored
    at out[i * out_stride + out_offset]; for a batch, one instance after
    another."""
    if wit_ext.dim() == 4:
        return torch.stack([quotient_h_plain(w, key_ext, x_ext, zh_inv, c)
                            for w, c in zip(wit_ext, consts)])
    total = _quotient_expr(*_quotient_args(wit_ext, key_ext, x_ext, consts), rot_step=rot)
    h = _mul(total.reshape(-1, rot, L.NW), zh_inv).reshape(-1, L.NW)
    if out is None:
        return h
    out[out_offset : out_offset + (h.shape[0] - 1) * out_stride + 1 : out_stride] = h
    return out


def quotient_h(wit_ext, key_ext, x_ext, zh_inv, consts, *, rot=MAX_DEGREE, out=None,
               out_stride=1, out_offset=0):
    """The y-folded constraint expression on a domain of n rows, divided by
    Z_H.  wit_ext (19, n, 8): the prover's witness stack (W_* rows);
    key_ext (24, n, 8): the key's rows (KEY_ROWS); x_ext (n, 8): X there;
    zh_inv (rot, 8): 1/Z_H, which has period `rot`; consts:
    `challenge_words`.  `rot` is the distance of "the next row": MAX_DEGREE
    on the fused 8n coset, 1 on one coset of the split quotient, where Z_H
    is one constant.  Row i goes to out[i * out_stride + out_offset] of an
    (m, 8) `out`, or of a new (n, 8) tensor, which is returned.  For a batch
    of B instances of one circuit on the fused coset, wit_ext (B, 19, n, 8)
    and consts (B, 16, 8) give a new (B, n, 8); the coset form takes one
    instance.  One launch of K6 on CUDA tensors, for every instance (counted
    as `quotient_h_coset` where rot is 1)."""
    lead = _batch_of(wit_ext, 3)
    n = wit_ext.shape[-2]
    if rot not in QUOTIENT_ROTS:
        raise ValueError(f"the next row is {QUOTIENT_ROTS} rows on, not {rot}")
    if lead and (rot != MAX_DEGREE or out is not None):
        raise ValueError("a batch takes the fused form only: rot 8 and a new output")
    consts = _check_operands({
        "wit_ext": (wit_ext, (*lead, WIT_ROWS, n, L.NW)),
        "key_ext": (key_ext, (len(KEY_ROWS), n, L.NW)),
        "x_ext": (x_ext, (n, L.NW)),
        "zh_inv": (zh_inv, (rot, L.NW)),
    }, consts, lead)
    if n % rot or n == 0:
        raise ValueError(f"{n} rows are no multiple of {rot}")
    if out is None:
        if (out_stride, out_offset) != (1, 0):
            raise ValueError("a strided store needs its `out`")
    else:
        _check_shapes({"x_ext": (x_ext, (n, L.NW)), "out": (out, (len(out), L.NW))})
        if out_stride < 1 or out_offset < 0 or (n - 1) * out_stride + out_offset >= out.shape[0] \
                or not out.is_contiguous():
            raise ValueError(f"a contiguous out of {out.shape[0]} rows does not take {n} rows "
                             f"at stride {out_stride} from {out_offset}")
    if wit_ext.device.type == "cpu":
        return quotient_h_plain(wit_ext, key_ext, x_ext, zh_inv, consts, rot=rot, out=out,
                                out_stride=out_stride, out_offset=out_offset)
    _cuda.require_cuda(wit_ext)
    count = lead[0] if lead else 1
    ins = [t.contiguous() for t in (wit_ext, key_ext, x_ext, zh_inv)]
    if out is None:
        out = torch.empty((*lead, n, L.NW), dtype=torch.int32, device=wit_ext.device)
    kernel = K_QUOTIENT if rot == MAX_DEGREE else K_QUOTIENT_COSET
    wit_p, key_p, x_p, zh_p = _pointers(ins)
    out_p = _pointers([out])[0]
    col = n * L.NW * 4  # bytes of a column
    words = consts.reshape(count, N_CONSTS, L.NW)
    for first, k in _groups(count):
        kernel(wit_p + first * WIT_ROWS * col, key_p, x_p, zh_p, words[first:].ctypes.data,
               out_p + first * col, n, rot, out_stride, out_offset, k, _cuda.stream())
    return out


def quotient_stacked(wit_ext, key_ext, x_ext, zh_inv8, consts, unscale,
                     plan_ext: NTTPlan) -> torch.Tensor:
    """Fused extended-domain quotient: `quotient_h`, transformed back, for
    one instance or a batch (a leading instance axis on wit_ext and consts).
    `unscale` (n_ext, 8) holds zeta^-i / n_ext, which the transform's last
    pass multiplies in."""
    h_ext = quotient_h(wit_ext, key_ext, x_ext, zh_inv8, consts)
    return stockham(CTX, h_ext, plan_ext.tw_inv, out_scale=unscale)


def split_quotient(witness_coeffs, pk, consts, plan: NTTPlan, plan_ext: NTTPlan) -> torch.Tensor:
    """The quotient's coefficients through MAX_DEGREE separate size-n
    cosets zeta*g^j*H (JAX `plonk/prover.py:224 _split_quotient`): only one
    coset's evaluations are live at a time.  witness_coeffs: the 19 (n, 8)
    witness rows (W_* order); pk: a split-mode key's `coeff_stack` (KEY_ROWS
    order), `coset_powers` (8, n, 8) shift_j^i, `coset_x` (8, n, 8) X on each
    coset, `coset_zh_inv` (8, 8) 1/(shift_j^n - 1) and `quotient_unscale`.
    For each coset, one K-b launch set over the 43 stacked rows with shift_j^i
    in its first load (`_jit_coset_evals`), then K6 with rot 1 stores its
    rows at 8i + j of the extended coset (`_jit_quotient_coset`); one inverse
    of length 8n with zeta^-i / n_ext in its last store ends it
    (`_jit_interleave_intt`)."""
    coeffs = torch.stack(list(witness_coeffs) + list(pk.coeff_stack))
    n = coeffs.shape[1]
    h_ext = torch.empty((MAX_DEGREE * n, L.NW), dtype=torch.int32, device=coeffs.device)
    for j in range(MAX_DEGREE):
        evals = stockham(CTX, coeffs, plan.tw, in_table=pk.coset_powers[j])
        quotient_h(evals[:WIT_ROWS], evals[WIT_ROWS:], pk.coset_x[j], pk.coset_zh_inv[j : j + 1],
                   consts, rot=1, out=h_ext, out_stride=MAX_DEGREE, out_offset=j)
        del evals
    del coeffs
    return stockham(CTX, h_ext, plan_ext.tw_inv, out_scale=pk.quotient_unscale)


# ------------------------------------------------------ evaluations and GWC

# csrc/open_row.cuh: rows and points a table holds, elements an eval block sums
OPEN_MAX_ROWS, OPEN_MAX_POINTS, OPEN_EVAL_CHUNK = 64, 4, 4096
OPEN_KINDS = ("eval", "combine")


class _OpenTable(ctypes.Structure):
    """csrc/open_row.cuh opening::Table, field for field."""
    _fields_ = [
        ("row", ctypes.c_uint64 * OPEN_MAX_ROWS),
        ("pows", ctypes.c_uint64 * OPEN_MAX_POINTS),
        ("vpows", ctypes.c_uint64),
        ("out", ctypes.c_uint64),
        ("scratch", ctypes.c_uint64),
        ("first", ctypes.c_uint32 * (OPEN_MAX_POINTS + 1)),
        ("points", ctypes.c_uint32),
        ("n", ctypes.c_uint32),
    ]


def open_stack_plain(kind: str, stacks, pows, v_pows=None) -> torch.Tensor:
    """`open_stack` as products against the powers and pairwise add trees."""
    outs = []
    for rows, p in zip(stacks, pows):
        st = torch.stack(list(rows))
        m, n = st.shape[0], st.shape[1]
        if kind == "eval":
            outs.append(_tree_sum(_mul(st, p[:n]).transpose(0, 1).contiguous()))
        else:
            outs.append(_mul(_tree_sum(_mul(st, v_pows[:m, None, :])), p[:n]))
    return torch.cat(outs) if kind == "eval" else torch.stack(outs)


def open_stacks_plain(kind: str, stacks_b, pows_b, v_pows_b=None) -> torch.Tensor:
    """`open_stacks` as `open_stack_plain`, one instance after another."""
    v_pows_b = v_pows_b if v_pows_b is not None else [None] * len(stacks_b)
    return torch.cat([open_stack_plain(kind, st, p, v)
                      for st, p, v in zip(stacks_b, pows_b, v_pows_b)])


def _open_shapes(kind: str, b: int, stacks, pows, v_pows, n: int) -> dict:
    """The shapes of one instance's operands, checked against its table's
    limits."""
    if not 0 < len(stacks) <= OPEN_MAX_POINTS or len(pows) != len(stacks):
        raise ValueError(f"1 to {OPEN_MAX_POINTS} points, each with its powers")
    if not all(stacks) or sum(len(r) for r in stacks) > OPEN_MAX_ROWS:
        raise ValueError(f"1 to {OPEN_MAX_ROWS} rows in all, at least one a point")
    shapes = {}
    for s, (rows, p) in enumerate(zip(stacks, pows)):
        for j, row in enumerate(rows):
            shapes[f"stacks[{b}][{s}][{j}]"] = (row, (n, L.NW))
        shapes[f"pows[{b}][{s}]"] = (p[:n], (n, L.NW))
    if kind == "combine":
        if v_pows is None:
            raise ValueError("combine takes the powers of v")
        m_max = max(len(r) for r in stacks)
        shapes[f"v_pows[{b}]"] = (v_pows[:m_max], (m_max, L.NW))
    return shapes


def open_stack(kind: str, stacks, pows, v_pows=None) -> torch.Tensor:
    """The openings' contractions, for up to 4 points at once.  stacks[s]:
    the (n, 8) coefficient rows opened at point s; pows[s]: its powers
    x_s^0 .. x_s^(n-1) (or more).
    "eval": (rows, 8), row j's sum_i c_j[i] x_s^i, the rows of every point in
    order; "combine": (points, n, 8), x_s^i sum_j v^j c_{s,j}[i], with
    v_pows = v^0 .. v^(m-1) for the largest stack.  One launch of K7 on CUDA
    tensors, which takes the rows where they lie."""
    return open_stacks(kind, [stacks], [pows], None if v_pows is None else [v_pows])


def open_stacks(kind: str, stacks_b, pows_b, v_pows_b=None) -> torch.Tensor:
    """`open_stack` for a batch of instances, each with its own stacks,
    points and powers of v, all rows of one length n: the outputs of every
    instance in order, (rows of all, 8) for "eval" and (points of all, n, 8)
    for "combine".  One launch of K7 on CUDA tensors for up to
    `MAX_INSTANCES` instances, one table each."""
    if kind not in OPEN_KINDS:
        raise ValueError(f"unknown contraction {kind!r}; expected one of {OPEN_KINDS}")
    if not stacks_b or len(pows_b) != len(stacks_b) \
            or (v_pows_b is not None and len(v_pows_b) != len(stacks_b)):
        raise ValueError("one or more instances, each with its stacks and powers")
    stacks_b = [[list(rows) for rows in stacks] for stacks in stacks_b]
    v_pows_b = v_pows_b if v_pows_b is not None else [None] * len(stacks_b)
    n = stacks_b[0][0][0].shape[0] if stacks_b[0] and stacks_b[0][0] else 0
    if n >= 1 << 31:
        raise ValueError("rows too long for the K7 kernels")
    shapes = {}
    for b, (stacks, pows, v_pows) in enumerate(zip(stacks_b, pows_b, v_pows_b)):
        shapes.update(_open_shapes(kind, b, stacks, pows, v_pows, n))
    device = stacks_b[0][0][0].device
    _check_shapes(shapes)
    if device.type == "cpu":
        return open_stacks_plain(kind, stacks_b, pows_b, v_pows_b)
    _cuda.require_cuda(stacks_b[0][0][0])
    rows_b = [sum(len(rs) for rs in stacks) for stacks in stacks_b]
    points_b = [len(stacks) for stacks in stacks_b]
    chunks = -(-n // OPEN_EVAL_CHUNK)
    # each table's eval scratch: its partial sums and a ticket a row, padded
    # to 16 bytes for the partials' vector stores
    scratch_words = [-(-r * (chunks * L.NW + 1) // 4) * 4 for r in rows_b]
    if kind == "eval":
        out = torch.empty((sum(rows_b), L.NW), dtype=torch.int32, device=device)
        scratch = torch.empty(sum(scratch_words), dtype=torch.int32, device=device)
    else:
        out = torch.empty((sum(points_b), n, L.NW), dtype=torch.int32, device=device)
    keep = []  # the contiguous operands, alive until the launch is queued
    tables = (_OpenTable * len(stacks_b))()
    row_at = point_at = word_at = 0
    for t, stacks, pows, v_pows, rows, points, words in zip(
            tables, stacks_b, pows_b, v_pows_b, rows_b, points_b, scratch_words):
        flat = [r.contiguous() for rs in stacks for r in rs]
        pw = [p.contiguous() for p in pows]
        keep += flat + pw
        t.row[:rows] = _pointers(flat)
        t.pows[:points] = _pointers(pw)
        first = np.cumsum([0] + [len(rs) for rs in stacks])
        t.first[: len(first)] = [int(v) for v in first]
        t.points, t.n = points, n
        if kind == "eval":
            t.out = out[row_at].data_ptr()
            t.scratch = scratch[word_at:].data_ptr()
        else:
            v_pows = v_pows.contiguous()
            keep.append(v_pows)
            t.vpows = _pointers([v_pows])[0]
            t.out = out[point_at].data_ptr()
        row_at, point_at, word_at = row_at + rows, point_at + points, word_at + words
    kernel = K_OPEN_EVAL if kind == "eval" else K_OPEN_COMBINE
    size = ctypes.sizeof(_OpenTable)
    for first, k in _groups(len(stacks_b)):
        kernel(ctypes.addressof(tables) + first * size, k, _cuda.stream())
    return out


def _eval_stack(stacks, pows) -> torch.Tensor:
    """Evaluate every poly of every stack at its point -> (rows, 8), the rows
    of every point in order.  stacks[s]: the (n, 8) polys opened at point
    x_s (an (m, n, 8) tensor or a list of rows); pows[s]: x_s^0 .. x_s^(n-1)
    or more.  One launch of K7 for all the points."""
    return open_stack("eval", stacks, pows)


def _eval_stack_batch(stacks_b, pows_b) -> torch.Tensor:
    """`_eval_stack` for every instance of a batch (the JAX package's
    _jit_eval_stack_batch, a point at a time there) -> (rows of all, 8),
    instance after instance.  One launch of K7 for every instance."""
    return open_stacks("eval", stacks_b, pows_b)


def _gwc_witness(stacks, pows, v_m: torch.Tensor, zinv_ms) -> list:
    """W_s = (Q_s - Q_s(z_s)) / (X - z_s) with Q_s = sum_j v^j p_{s,j} over
    stack s, for every point z_s at once -> one (n, 8) a point.  pows[s]:
    z_s^0 .. z_s^(n-1) or more; v_m and zinv_ms[s] = 1/z_s: (8,) Montgomery
    elements.  One launch of K7 for all the points, then for each point the
    exclusive suffix sums times z_s^-(i+1)."""
    n = stacks[0][0].shape[0]
    v_pows = P.powers_of(CTX, v_m, max(len(rows) for rows in stacks))
    scaled = open_stack("combine", stacks, pows, v_pows)
    return [P.divide_scaled(CTX, t, P.powers_of(CTX, zinv_m, n + 1))
            for t, zinv_m in zip(scaled, zinv_ms)]


def _gwc_witness_batch(stacks_b, pows_b, v_ms: torch.Tensor, zinv_ms: torch.Tensor):
    """`_gwc_witness` for every instance of a batch (the JAX package's
    _jit_gwc_witness_batch, a point at a time there): v_ms (B, 8), instance
    b's v; zinv_ms (points of all, 8), 1/z_s of every point of every
    instance in order -> (points of all, n, 8).  One launch each of K7 and
    of the scans for every instance: the powers of the v's, of the 1/z_s,
    and the suffix sums."""
    n = stacks_b[0][0][0].shape[0]
    m_max = max(len(rows) for stacks in stacks_b for rows in stacks)
    v_pows = P.powers_rows(CTX, v_ms, m_max)
    scaled = open_stacks("combine", stacks_b, pows_b, list(v_pows))
    return P.divide_scaled(CTX, scaled, P.powers_rows(CTX, zinv_ms, n + 1))
