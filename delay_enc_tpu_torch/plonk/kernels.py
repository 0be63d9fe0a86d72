"""Prover building blocks, in plain PyTorch over kernels K-a and K-b.

Counterpart of `delay_enc_tpu/plonk/kernels.py`, fused 8n quotient only.
Each function keeps its JAX name; the JAX `vmap`s are a leading batch axis
here.  Field arithmetic goes through `ops.limbs` (kernel K-a on a card),
transforms through `ops.ntt.stockham` (kernel K-b), commitments through
`ops.msm` (kernels K-c and K-d).
"""

from __future__ import annotations

import torch

from ..ops import limbs as L
from ..ops import msm as M
from ..ops import poly as P
from ..ops.ntt import NTTPlan, coset_scale, stockham
from .domain import MAX_DEGREE

WIRE_COL = {"a": 0, "b": 1, "c": 2, "d": 3}
LOOKUPS = ("a", "b", "c", "d")
CTX = L.FR_CTX


def _mul(a, b):
    return L.mont_mul(CTX, a, b)


def _add(a, b):
    return L.add(CTX, a, b)


def _sub(a, b):
    return L.sub(CTX, a, b)


# ---------------------------------------------------------------- transforms

def _coeff(stack: torch.Tensor, plan: NTTPlan) -> torch.Tensor:
    """(…, n, 8) evaluations -> coefficients (iNTT, then 1/n)."""
    return _mul(stockham(CTX, stack, plan.tw_inv), plan.n_inv)


def _ext(coeff: torch.Tensor, zeta_powers: torch.Tensor, plan_ext: NTTPlan) -> torch.Tensor:
    """(…, n, 8) coefficients -> evaluations on the extended coset
    zeta*H_ext (…, n_ext, 8).  No sacrificial lane: the JAX package's
    ext_batch_padded works around an XLA:TPU fault this path does not have."""
    n, n_ext = coeff.shape[-2], zeta_powers.shape[0]
    padded = coeff.new_zeros(*coeff.shape[:-2], n_ext, L.NW)
    padded[..., :n, :] = coeff
    return stockham(CTX, coset_scale(CTX, padded, zeta_powers), plan_ext.tw)


def _evals_batch(coeff: torch.Tensor, plan: NTTPlan) -> torch.Tensor:
    return stockham(CTX, coeff, plan.tw)


def _canon_batch(a: torch.Tensor) -> torch.Tensor:
    return L.mont_to_canonical(CTX, a)


def msm_commit_batch(tables: torch.Tensor, canon_stack: torch.Tensor) -> list:
    """(B, n, 8) canonical coefficient stack -> B host affine commitments,
    through the shared per-SRS base-4 pair tables."""
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
    """num, den (G, n, 8) for G grand products; active_mask (n,) bool."""
    one = CTX.one_mont(num.device)
    num = torch.where(active_mask[:, None], num, one)
    den = torch.where(active_mask[:, None], den, one)
    pre = P.prefix_product(CTX, den, impl)
    suf = P.suffix_product(CTX, den, impl)
    return num, pre, suf, pre[:, -1]


def _gp_finish(num, pre, suf, total_inv_m, blind_rows, impl: str):
    """total_inv_m (G, 8); blind_rows (G, b, 8) -> z (G, n, 8)."""
    g = num.shape[0]
    one = CTX.one_mont(num.device).expand(g, 1, L.NW)
    pre_excl = torch.cat([one, pre[:, :-1]], dim=1)
    suf_excl = torch.cat([suf[:, 1:], one], dim=1)
    den_inv = _mul(_mul(pre_excl, suf_excl), total_inv_m[:, None, :])
    pref = P.prefix_product(CTX, _mul(num, den_inv), impl)
    z = torch.cat([one, pref[:, :-1]], dim=1)
    keep = z.shape[1] - blind_rows.shape[1]
    return torch.cat([z[:, :keep], blind_rows], dim=1)


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


def _quotient(advice_ext, instance_ext, z_perm_ext, z_l_ext, ap_ext, sp_ext,
              fe, sigma_ext, masks, chals, delta_ms, zh_inv_ext,
              zeta_inv_powers, y_pows_rev, plan_ext: NTTPlan):
    """Fused extended-domain quotient: the folded expression on the 8n
    coset, divided by Z_H, transformed back and unscaled by zeta^-i."""
    total = _quotient_expr(advice_ext, instance_ext, z_perm_ext, z_l_ext,
                           ap_ext, sp_ext, fe, sigma_ext, masks, chals,
                           delta_ms, y_pows_rev)
    h_ext = _mul(total, zh_inv_ext)
    del total
    h_coeff = _mul(stockham(CTX, h_ext, plan_ext.tw_inv), plan_ext.n_inv)
    return _mul(h_coeff, zeta_inv_powers)


# ------------------------------------------------------ evaluations and GWC

def _eval_stack(stacked: torch.Tensor, x_m: torch.Tensor) -> torch.Tensor:
    """Evaluate every poly of (m, n, 8) at the point x -> (m, 8)."""
    n = stacked.shape[1]
    pows = P.powers_of(CTX, x_m, n)
    prods = _mul(stacked, pows).transpose(0, 1).contiguous()  # (n, m, 8)
    return _tree_sum(prods)


def _gwc_witness(stacked: torch.Tensor, v_m, z_m, zinv_m) -> torch.Tensor:
    """W = (Q - Q(z)) / (X - z) with Q = sum_i v^i p_i over the stack."""
    m, n, _ = stacked.shape
    v_pows = P.powers_of(CTX, v_m, m)
    q = _tree_sum(_mul(stacked, v_pows[:, None, :]))
    zp = P.powers_of(CTX, z_m, n)
    zinv_p = P.powers_of(CTX, zinv_m, n + 1)
    return P.divide_by_linear(CTX, q, zp, zinv_p)
