"""Prover building blocks: the fused kernels and plain PyTorch over the others.

Counterpart of `delay_enc_tpu/plonk/kernels.py`, fused 8n quotient only.
Each function keeps its JAX name; the JAX `vmap`s are a leading batch axis
here.  Two blocks are one kernel each on a card: `gp_fracs` (K5,
`csrc/fracs.cu`), the numerators and denominators of the five grand
products, and `quotient_h` (K6, `csrc/quotient.cu`), the y-folded quotient
expression times 1/Z_H; on CPU tensors they run their plain versions, which
are the functions below them.  Field arithmetic goes through `ops.limbs`
(kernel K-a on a card), transforms through `ops.ntt.stockham` (kernel K-b,
with the coset scaling, the zero padding, 1/n or zeta^-i / n_ext fused into
its first and last pass), scans and powers through `ops.poly` (kernel
`field_scan`), commitments through `ops.msm` (kernels `pair_sel`, K-c and
K-d) or `ops.msm16` (`pair_sel`, `plane_sums16` and K-d).
"""

from __future__ import annotations

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

_REPLACES = "delay_enc_tpu/plonk/kernels.py:"
K_FRACS = _cuda.kernel(
    "gp_fracs", "gp_fracs",
    _REPLACES + "102 _jit_compress, :109 _jit_perm_fracs, :125 _jit_lookup_fracs (K5)",
    "delay_enc_tpu_torch/csrc/fracs.cu")
K_QUOTIENT = _cuda.kernel(
    "quotient_h", "quotient_h",
    _REPLACES + "192 _quotient_expr and the * zh_inv_ext of :294 _jit_quotient (K6)",
    "delay_enc_tpu_torch/csrc/quotient.cu")


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


def msm_commit_batch(tables, canon_stack: torch.Tensor) -> list:
    """(B, n, 8) canonical coefficient stack -> B host affine commitments,
    through the shared per-SRS tables: a bare base-4 pair table, or a
    ("b4" | "b16", table) pair from `SRS.msm_tables`."""
    kind = "b4"
    if isinstance(tables, tuple):
        kind, tables = tables
    if kind == "b16":
        return M16.msm16_with_tables(tables, canon_stack)
    if kind != "b4":
        raise ValueError(f"unknown MSM {kind!r}: 'b4' or 'b16'")
    return M.msm_with_tables(tables, canon_stack)


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
                   fe, sigma_ext, masks, chals, delta_ms, y_pows_rev):
    """The y-folded constraint expression evaluated pointwise on the fused
    8n extended coset, where "the next row" is MAX_DEGREE indices on.

    masks = (l0, l_last, l_blind, x) evals on the domain;
    chals = (theta_m, beta_m, gamma_m); y_pows_rev[i] = y^(n_exprs-1-i)."""
    rot = MAX_DEGREE
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


def _check_operands(shapes: dict, consts) -> np.ndarray:
    """Check each named tensor against its (…, 8) shape: int32, one device;
    return the challenge words, checked, as a contiguous array."""
    device = None
    for name, (t, shape) in shapes.items():
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be int32 {shape}, got {t.dtype} {tuple(t.shape)}")
        if device is not None and t.device != device:
            raise ValueError(f"operands on different devices: {device} and {t.device}")
        device = t.device
    if not isinstance(consts, np.ndarray) or consts.dtype != np.uint32 \
            or consts.shape != (N_CONSTS, L.NW):
        raise ValueError(f"challenge words must be a ({N_CONSTS}, {L.NW}) uint32 array")
    return np.ascontiguousarray(consts)


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
    `_lookup_fracs`, stacked, with the rows from `usable` on set to one."""
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
    consts: `challenge_words`.  One launch of K5 on CUDA tensors."""
    n = raw6.shape[1]
    consts = _check_operands({
        "raw6": (raw6, (NUM_PERM_COLS, n, L.NW)),
        "sigma_raw": (sigma_raw, (NUM_PERM_COLS, n, L.NW)),
        "omega_dev": (omega_dev, (n, L.NW)),
        "raw_stack": (raw_stack, (len(ALL_FIXED), n, L.NW)),
        "lk_raw": (lk_raw, (2 * len(LOOKUPS), n, L.NW)),
    }, consts)
    if not 0 <= usable <= n:
        raise ValueError(f"usable rows {usable} outside 0..{n}")
    if raw6.device.type == "cpu":
        return gp_fracs_plain(raw6, sigma_raw, omega_dev, raw_stack, lk_raw, consts, usable)
    _cuda.require_cuda(raw6)
    ins = [t.contiguous() for t in (raw6, sigma_raw, omega_dev, raw_stack, lk_raw)]
    num = torch.empty((1 + len(LOOKUPS), n, L.NW), dtype=torch.int32, device=raw6.device)
    den = torch.empty_like(num)
    K_FRACS(*_pointers(ins), consts.ctypes.data, num.data_ptr(), den.data_ptr(), n, usable,
            _cuda.stream())
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


def quotient_h_plain(wit_ext, key_ext, x_ext, zh_inv8, consts):
    """`quotient_h` as `_quotient_expr` times 1/Z_H (period MAX_DEGREE)."""
    total = _quotient_expr(*_quotient_args(wit_ext, key_ext, x_ext, consts))
    return _mul(total.reshape(-1, MAX_DEGREE, L.NW), zh_inv8).reshape(-1, L.NW)


def quotient_h(wit_ext, key_ext, x_ext, zh_inv8, consts):
    """The y-folded constraint expression on the fused 8n coset, divided by
    Z_H: (n_ext, 8).  wit_ext (19, n_ext, 8): the prover's witness stack
    (W_* rows); key_ext (24, n_ext, 8): `ProvingKey.ext_stack`; x_ext
    (n_ext, 8): X there; zh_inv8 (8, 8): 1/Z_H, which has period
    MAX_DEGREE; consts: `challenge_words`.  One launch of K6 on CUDA
    tensors."""
    n_ext = wit_ext.shape[1]
    consts = _check_operands({
        "wit_ext": (wit_ext, (WIT_ROWS, n_ext, L.NW)),
        "key_ext": (key_ext, (len(KEY_ROWS), n_ext, L.NW)),
        "x_ext": (x_ext, (n_ext, L.NW)),
        "zh_inv8": (zh_inv8, (MAX_DEGREE, L.NW)),
    }, consts)
    if n_ext % MAX_DEGREE:
        raise ValueError(f"{n_ext} rows are no multiple of {MAX_DEGREE}")
    if wit_ext.device.type == "cpu":
        return quotient_h_plain(wit_ext, key_ext, x_ext, zh_inv8, consts)
    _cuda.require_cuda(wit_ext)
    ins = [t.contiguous() for t in (wit_ext, key_ext, x_ext, zh_inv8)]
    h = torch.empty((n_ext, L.NW), dtype=torch.int32, device=wit_ext.device)
    K_QUOTIENT(*_pointers(ins), consts.ctypes.data, h.data_ptr(), n_ext, _cuda.stream())
    return h


def quotient_stacked(wit_ext, key_ext, x_ext, zh_inv8, consts, unscale,
                     plan_ext: NTTPlan) -> torch.Tensor:
    """Fused extended-domain quotient: `quotient_h`, transformed back.
    `unscale` (n_ext, 8) holds zeta^-i / n_ext, which the transform's last
    pass multiplies in."""
    h_ext = quotient_h(wit_ext, key_ext, x_ext, zh_inv8, consts)
    return stockham(CTX, h_ext, plan_ext.tw_inv, out_scale=unscale)


# ------------------------------------------------------ evaluations and GWC

def _eval_stack(stacked: torch.Tensor, x_m: torch.Tensor,
                pows: torch.Tensor | None = None) -> torch.Tensor:
    """Evaluate every poly of (m, n, 8) at the point x -> (m, 8).  `pows`,
    where the caller has them, are the powers x^0 .. x^(n-1) or more."""
    n = stacked.shape[1]
    pows = P.powers_of(CTX, x_m, n) if pows is None else pows[:n]
    prods = _mul(stacked, pows).transpose(0, 1).contiguous()  # (n, m, 8)
    return _tree_sum(prods)


def _gwc_witness(stacked: torch.Tensor, v_m, z_m, zinv_m,
                 z_pows: torch.Tensor | None = None) -> torch.Tensor:
    """W = (Q - Q(z)) / (X - z) with Q = sum_i v^i p_i over the stack.
    `z_pows`, where the caller has them, are the powers z^0 .. z^(n-1)."""
    m, n, _ = stacked.shape
    v_pows = P.powers_of(CTX, v_m, m)
    q = _tree_sum(_mul(stacked, v_pows[:, None, :]))
    zp = P.powers_of(CTX, z_m, n) if z_pows is None else z_pows
    zinv_p = P.powers_of(CTX, zinv_m, n + 1)
    return P.divide_by_linear(CTX, q, zp, zinv_p)
