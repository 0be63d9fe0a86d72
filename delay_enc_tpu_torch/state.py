"""State carried across from the JAX package.

The JAX package stores a field element as a (…, 16) uint32 array of 16-bit
limbs; the port as a (…, 8) int32 tensor of 32-bit words.  Both hold the
same 256-bit Montgomery integer, so the conversion is a free reinterpret
of the bytes in numpy.  These functions take numpy arrays (never JAX
arrays) and return tensors on `device`.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import limbs as L
from .utils.device import resolve


def from_jax_limbs(limbs: np.ndarray, device="cuda") -> torch.Tensor:
    """(…, 16) uint32 limbs of the JAX package -> (…, 8) int32 words."""
    return L.to_tensor(L.limbs_to_words_np(np.asarray(limbs)), resolve(device))


def to_jax_limbs(words: torch.Tensor) -> np.ndarray:
    """(…, 8) int32 words -> the JAX package's (…, 16) uint32 limbs."""
    return L.words_to_limbs_np(L.to_numpy(words))


def srs_from_jax(g1_np: np.ndarray, tau_g2, device="cuda"):
    """An SRS from the JAX package's G1 powers ((n, 3, 16) uint32
    projective Montgomery) and its host [tau] G2 point."""
    from .curves.bn254 import G2_GEN
    from .plonk.kzg import SRS

    g1 = from_jax_limbs(g1_np, device)
    return SRS(int(g1.shape[0]).bit_length() - 1, g1, tau_g2, G2_GEN)


def proving_key_from_jax(pk_fields: dict, device="cuda"):
    """A ProvingKey from the fields of a JAX ProvingKey given as numpy arrays
    and ints: `k`, `fixed_commitments`, `sigma_commitments`,
    `transcript_repr`, `delta_powers`, `zeta_inv_powers`, the dicts
    `fixed_raw`, `fixed_coeff` (name -> (…, 16) limbs) and the list
    `sigma_coeff`; for a fused-path key the dict `fixed_ext`, the list
    `sigma_ext` and the arrays `l0_ext`, `l_last_ext`, `l_blind_ext`,
    `x_ext`, `zeta_powers`, `zh_inv_ext`; for a split-mode key `split`
    true, the arrays `l0_coeff`, `l_last_coeff`, `l_blind_coeff`, and None
    (or nothing) for every extended-coset field.  A split key's coset
    tables are made on `device` (`keygen.coset_tables`).  `shape`, where
    given, is the keyed circuit's `keygen.circuit_shape`."""
    from .fields.bn254 import FR
    from .plonk.domain import Domain
    from .plonk.keygen import ALL_FIXED, ProvingKey, VerifyingKey, _row, coset_tables

    device = resolve(device)
    t = lambda a: from_jax_limbs(a, device)
    f = pk_fields
    split = bool(f.get("split", False))
    domain = Domain(int(f["k"]))
    # the key's stacks in KEY_ROWS order (of the fixed columns, those given),
    # and the named columns as their rows
    names = [n for n in ALL_FIXED if n in f["fixed_coeff"]]
    raw_stack = t(np.stack([f["fixed_raw"][n] for n in names]))
    nf, nm = len(names), len(names) + len(f["sigma_coeff"])
    if split:
        coeff_stack = t(np.stack([f["fixed_coeff"][n] for n in names] + list(f["sigma_coeff"])
                                 + [f["l0_coeff"], f["l_last_coeff"], f["l_blind_coeff"]]))
        fixed_coeff = {n: coeff_stack[i] for i, n in enumerate(names)}
        sigma_coeff = [coeff_stack[c] for c in range(nf, nm)]
        ext_stack = None
        coset = coset_tables(domain, device)
    else:
        coeff_stack = None
        fixed_coeff = {n: t(a) for n, a in f["fixed_coeff"].items()}
        sigma_coeff = [t(a) for a in f["sigma_coeff"]]
        ext_stack = t(np.stack([f["fixed_ext"][n] for n in names] + list(f["sigma_ext"])
                               + [f["l0_ext"], f["l_last_ext"], f["l_blind_ext"]]))
        coset = (None, None, None)
    # the port keeps zeta^-i / n_ext in one table (plonk/kernels.py quotient_stacked)
    n_ext_inv = L.to_device_mont(L.FR_CTX, [FR.inv(domain.n_ext)], device)
    opt = lambda name: None if f.get(name) is None else t(f[name])
    vk = VerifyingKey(domain, dict(f["fixed_commitments"]),
                      list(f["sigma_commitments"]), int(f["transcript_repr"]))
    return ProvingKey(
        vk=vk,
        fixed_raw={n: raw_stack[i] for i, n in enumerate(names)},
        fixed_coeff=fixed_coeff,
        fixed_ext=None if split else {n: ext_stack[i] for i, n in enumerate(names)},
        sigma_coeff=sigma_coeff,
        sigma_ext=None if split else [ext_stack[c] for c in range(nf, nm)],
        l0_ext=_row(ext_stack, nm),
        l_last_ext=_row(ext_stack, nm + 1),
        l_blind_ext=_row(ext_stack, nm + 2),
        x_ext=opt("x_ext"),
        zeta_powers=opt("zeta_powers"),
        quotient_unscale=L.mont_mul(L.FR_CTX, t(f["zeta_inv_powers"]), n_ext_inv),
        zh_inv_ext=opt("zh_inv_ext"),
        delta_powers=[int(d) for d in f["delta_powers"]],
        raw_stack=raw_stack,
        ext_stack=ext_stack,
        split=split,
        coeff_stack=coeff_stack,
        l0_coeff=_row(coeff_stack, nm),
        l_last_coeff=_row(coeff_stack, nm + 1),
        l_blind_coeff=_row(coeff_stack, nm + 2),
        coset_powers=coset[0],
        coset_x=coset[1],
        coset_zh_inv=coset[2],
        shape=f.get("shape"),
    )
