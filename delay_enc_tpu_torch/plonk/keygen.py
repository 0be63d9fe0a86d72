"""Keygen: compile a built circuit (cs.Builder) into proving/verifying keys.

Counterpart of `delay_enc_tpu/plonk/keygen.py`.  The vk holds KZG
commitments to every fixed polynomial (selectors, lookup tags, table
columns) and the permutation sigma polynomials; the pk additionally holds
device-resident coefficient forms and what the quotient construction
needs: on the fused path (k < 18) the extended-coset evaluations of every
key column, in split-quotient mode (k >= 18) the tables of the 8 size-n
cosets, whose evaluations the prover makes a coset at a time.

Permutation sigma encoding (halo2-style): cell (col c, row r) is labelled
delta^c * omega^r with delta a non-root-of-unity (generator^(2^s)); copy
cycles rotate the labels.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..cs.builder import Builder, FIXED_NAMES, NUM_ADVICE
from ..cs.range import build_table
from ..fields.bn254 import FR
from ..ops import limbs as L
from ..ops.ntt import powers
from ..utils.device import resolve
from ..utils.timers import GLOBAL_METRICS
from .domain import BLINDING_ROWS, MAX_DEGREE, SPLIT_QUOTIENT_K, Domain

# the permutation argument covers the 5 advice columns plus the instance
# column (public inputs are bound to witness cells through it)
NUM_PERM_COLS = NUM_ADVICE + 1

# fixed poly order (shared prover/verifier): builder fixed + table columns
TABLE_NAMES = ("table_tag", "table_value")
ALL_FIXED = tuple(FIXED_NAMES) + TABLE_NAMES
LOOKUPS = ("a", "b", "c", "d")  # one lookup argument per tagged wire column
# rows of the key's device stacks (`ProvingKey.raw_stack`, `.ext_stack`),
# which csrc/fracs_row.cuh and csrc/quotient_row.cuh index by number
LAGRANGE_NAMES = ("l0", "l_last", "l_blind")
KEY_ROWS = ALL_FIXED + tuple(f"sigma_{c}" for c in range(NUM_PERM_COLS)) + LAGRANGE_NAMES

DELTA = pow(FR.generator, 1 << FR.s, FR.p)


@dataclass
class VerifyingKey:
    domain: Domain
    fixed_commitments: dict  # name -> affine G1 point
    sigma_commitments: list  # NUM_PERM_COLS affine G1 points
    # Fr scalar absorbed as the transcript's first message (halo2's
    # `VerifyingKey::transcript_repr`); see transcript_repr() below
    transcript_repr: int = 0


@dataclass
class ProvingKey:
    vk: VerifyingKey
    # device tensors, all (n, 8) Montgomery unless noted; the extended-coset
    # ones (n_ext, 8) are None in split-quotient mode
    fixed_raw: dict
    fixed_coeff: dict
    fixed_ext: dict | None
    sigma_coeff: list
    sigma_ext: list | None
    l0_ext: torch.Tensor | None
    l_last_ext: torch.Tensor | None
    l_blind_ext: torch.Tensor | None
    x_ext: torch.Tensor | None  # identity poly X on the extended coset
    zeta_powers: torch.Tensor | None  # (n_ext, 8) coset scale
    quotient_unscale: torch.Tensor  # (n_ext, 8) zeta^-i / n_ext: undoes scale and transform
    zh_inv_ext: torch.Tensor | None  # (n_ext, 8) 1/(X^n - 1) on the extended coset
    delta_powers: list  # host ints delta^0 .. delta^5
    # the stacks the fused kernels read, rows in KEY_ROWS order: the fixed
    # columns' row evaluations (len(ALL_FIXED), n, 8), and every column's
    # extended-coset evaluations (len(KEY_ROWS), n_ext, 8).  fixed_raw,
    # fixed_ext, sigma_ext and the l*_ext are views of their rows.
    raw_stack: torch.Tensor
    ext_stack: torch.Tensor | None
    # split-quotient mode (k >= SPLIT_QUOTIENT_K): the coefficient forms of
    # every KEY_ROWS column (len(KEY_ROWS), n, 8), of which fixed_coeff,
    # sigma_coeff and the l*_coeff are views, and the cosets' tables
    # (`coset_tables`)
    split: bool = False
    coeff_stack: torch.Tensor | None = None
    l0_coeff: torch.Tensor | None = None
    l_last_coeff: torch.Tensor | None = None
    l_blind_coeff: torch.Tensor | None = None
    coset_powers: torch.Tensor | None = None  # (8, n, 8) shift_j^i
    coset_x: torch.Tensor | None = None  # (8, n, 8) X on coset j: shift_j omega^i
    coset_zh_inv: torch.Tensor | None = None  # (8, 8) 1/(shift_j^n - 1)
    # the keyed circuit's `circuit_shape`, which the batched prover checks
    # every builder against (None: not recorded)
    shape: tuple | None = None

    @property
    def device(self) -> torch.device:
        return self.raw_stack.device


def _host_powers(base: int, count: int, start: int) -> list:
    """[start, start*base, start*base^2, ...] as host ints."""
    vals, cur = [], start
    for _ in range(count):
        vals.append(cur)
        cur = cur * base % FR.p
    return vals


def _pinned_vk_string(domain, fixed_comms: dict, sigma_comms: list) -> str:
    """The pinned verification-key description hashed into the transcript,
    byte for byte the JAX package's (its docstring gives the field order
    and content, after halo2's `PinnedVerificationKey`)."""
    from ..fields.bn254 import FQ

    def fe(v: int) -> str:
        return f"0x{v:064x}"

    def pt(p) -> str:
        if p is None:
            return "(0x0, 0x0)"
        return f"({fe(p[0])}, {fe(p[1])})"

    parts = [
        "PinnedVerificationKey { base_modulus: \"", fe(FQ.p),
        "\", scalar_modulus: \"", fe(FR.p),
        "\", domain: PinnedEvaluationDomain { k: ", str(domain.k),
        ", extended_k: ", str(domain.k_ext),
        ", omega: ", fe(domain.omega),
        " }, cs: PinnedConstraintSystem { num_fixed_columns: ",
        str(len(ALL_FIXED)),
        ", num_advice_columns: ", str(NUM_ADVICE),
        ", num_instance_columns: 1, num_selectors: 0",
        ", gate: maingate5(q_a*a + q_b*b + q_c*c + q_d*d + q_e*e",
        " + q_mul_ab*a*b + q_mul_cd*c*d + q_e_next*e_next + q_constant)",
        ", lookups: [a, b, c, d] in (table_tag, table_value)",
        ", permutation: Argument { columns: [a, b, c, d, e, instance] } }",
        ", fixed_commitments: [",
        ", ".join(pt(fixed_comms[name]) for name in ALL_FIXED),
        "], permutation: VerifyingKey { commitments: [",
        ", ".join(pt(p) for p in sigma_comms),
        "] }",
        " }",
    ]
    return "".join(parts)


def transcript_repr(domain, fixed_comms: dict, sigma_comms: list) -> int:
    """The vk's transcript representative: blake2b-512 with
    personalization ``Halo2-Verify-Key`` over ``len(s) as u64 LE || s``,
    s the pinned verification-key string, reduced into Fr."""
    import hashlib

    s = _pinned_vk_string(domain, fixed_comms, sigma_comms).encode()
    h = hashlib.blake2b(digest_size=64, person=b"Halo2-Verify-Key")
    h.update(len(s).to_bytes(8, "little"))
    h.update(s)
    return FR.from_uniform_bytes(h.digest())


def load_vk(path: str) -> VerifyingKey:
    """Read a vk file of the JAX package (npz: k, fixed (15, 32) uint8,
    sigma (6, 32) uint8 compressed points).  transcript_repr is recomputed,
    never read."""
    from ..curves.bn254 import g1_from_bytes

    z = np.load(path)
    k = int(z["k"])
    fixed = {name: g1_from_bytes(z["fixed"][i].tobytes()) for i, name in enumerate(ALL_FIXED)}
    sigma = [g1_from_bytes(row.tobytes()) for row in z["sigma"]]
    domain = Domain(k)
    return VerifyingKey(domain, fixed, sigma, transcript_repr(domain, fixed, sigma))


def min_k(builder: Builder) -> int:
    tags, _ = build_table(builder.lookup_widths)
    rows_needed = max(builder.rows, len(tags))
    k = 3
    while (1 << k) - BLINDING_ROWS - 1 < rows_needed:
        k += 1
    return k


def circuit_shape(builder: Builder) -> tuple:
    """What every witness of one circuit shares, cheap to compare: rows,
    lookup widths, public inputs and copy constraints counted.  The fixed
    columns' values are not compared (the JAX package trusts them too)."""
    return (builder.rows, tuple(sorted(builder.lookup_widths)), len(builder.instance),
            len(builder.copies))


def _row(stack, i: int):
    """Row i of a key stack, or None for a stack the key's mode lacks."""
    return None if stack is None else stack[i]


def use_split(k: int, split: bool | None = None) -> bool:
    """Whether keygen at k builds a split-quotient key: as asked, else from
    SPLIT_QUOTIENT_K on."""
    return k >= SPLIT_QUOTIENT_K if split is None else bool(split)


def ext_tables(domain: Domain, device):
    """The fused quotient's tables on the extended coset zeta*H_ext, each
    (n_ext, 8): zeta^i, X there (zeta omega_ext^i), and 1/(X^n - 1), a
    sequence of period MAX_DEGREE."""
    zeta_powers = powers(L.FR_CTX, domain.zeta, domain.n_ext, device)
    x_ext = powers(L.FR_CTX, domain.omega_ext, domain.n_ext, device, start=domain.zeta)
    w_n = pow(domain.omega_ext, domain.n, FR.p)  # order MAX_DEGREE
    zh = [FR.inv((c - 1) % FR.p)
          for c in _host_powers(w_n, MAX_DEGREE, start=pow(domain.zeta, domain.n, FR.p))]
    zh_inv_ext = L.to_device_mont(L.FR_CTX, zh, device).repeat(domain.n_ext // MAX_DEGREE, 1)
    return zeta_powers, x_ext, zh_inv_ext


def coset_tables(domain: Domain, device):
    """The split quotient's tables: (MAX_DEGREE, n, 8) shift_j^i, (MAX_DEGREE,
    n, 8) X on coset j (shift_j omega^i) and (MAX_DEGREE, 8) 1/(shift_j^n - 1),
    the constant 1/Z_H there, for shift_j = `domain.coset_shift(j)`."""
    ctx, n = L.FR_CTX, domain.n
    shifts = [domain.coset_shift(j) for j in range(MAX_DEGREE)]
    pows = torch.stack([powers(ctx, sh, n, device) for sh in shifts])
    xs = L.mont_mul(ctx, powers(ctx, domain.omega, n, device)[None],
                    L.to_device_mont(ctx, shifts, device)[:, None])
    zh = L.to_device_mont(ctx, [FR.inv((pow(sh, n, FR.p) - 1) % FR.p) for sh in shifts], device)
    return pows, xs, zh


def keygen(builder: Builder, srs, k: int | None = None, split: bool | None = None,
           device="cuda", msm: str = "b4"):
    """Compile the circuit structure; returns (pk, vk).

    Only the builder's structure is used (fixed columns, copies, lookup
    widths), never its witness.  `split` picks the split-quotient key
    (per-coset evaluation in the prover, no extended-coset tables); None
    means from k = SPLIT_QUOTIENT_K on.  Both modes give the same vk and the
    same proof bytes.  `msm` picks the commitments' pair tables, "b4" or
    "b16" (`SRS.msm_tables`); both give the same vk."""
    from .kernels import _canon_batch, _coeff, _ext, msm_commit_batch

    device = resolve(device)
    if builder.field.p != FR.p:
        raise ValueError("proving backend is BN254-Fr only")
    if k is None:
        k = min_k(builder)
    split = use_split(k, split)
    if srs.device != device:
        raise ValueError(f"SRS is on {srs.device}, keygen asked for {device}")
    ctx = L.FR_CTX
    domain = Domain(k)
    n = domain.n
    if builder.rows > domain.usable_rows:
        raise ValueError(f"circuit rows {builder.rows} exceed usable {domain.usable_rows} at k={k}")
    if srs.n < n:
        raise ValueError(f"SRS too small: {srs.n} < {n}")
    srs = srs.truncated(k)
    # both plans in both modes: the split prover's inverse runs at n_ext too
    plan, plan_ext = domain.plan(device), domain.plan_ext(device)

    # ---- fixed columns (padded to n) + table columns ------------------
    with GLOBAL_METRICS.span("keygen/host columns"):
        tags_col, values_col = build_table(builder.lookup_widths)
        if len(tags_col) > domain.usable_rows:
            raise ValueError("lookup table exceeds usable rows")
        fixed_host: dict[str, list[int]] = {}
        for name in FIXED_NAMES:
            col = builder.fixed[name]
            fixed_host[name] = col + [0] * (n - len(col))
        fixed_host["table_tag"] = tags_col + [0] * (n - len(tags_col))
        fixed_host["table_value"] = values_col + [0] * (n - len(values_col))

    # ---- permutation sigmas -------------------------------------------
    with GLOBAL_METRICS.span("keygen/sigma labels"):
        omega_pows = _host_powers(domain.omega, n, 1)
        delta_powers = [pow(DELTA, c, FR.p) for c in range(NUM_PERM_COLS)]
        # sigma starts as the identity labelling (5 advice + instance column)
        sigma_cols = [[delta_powers[c] * omega_pows[r] % FR.p for r in range(n)]
                      for c in range(NUM_PERM_COLS)]
        for cycle in builder.permutation_cycles():
            # rotate: sigma[cell_i] <- label(cell_{i+1})
            labels = [delta_powers[c] * omega_pows[r] % FR.p for (c, r) in cycle]
            for i, (c, r) in enumerate(cycle):
                sigma_cols[c][r] = labels[(i + 1) % len(cycle)]

    def lag_host(rows):
        col = [0] * n
        for r in rows:
            col[r] = 1
        return col

    host_cols = (
        [fixed_host[name] for name in ALL_FIXED]
        + sigma_cols
        + [lag_host([0]), lag_host([domain.usable_rows]),
           lag_host(range(domain.usable_rows + 1, n))]
    )
    with GLOBAL_METRICS.span("keygen/to_mont"):
        dev_stack = L.to_tensor(np.stack([ctx.to_mont_np(col) for col in host_cols]), device)

    # ---- device tables and transforms: one stacked launch for all 24 columns
    nf = len(ALL_FIXED)
    nm = nf + NUM_PERM_COLS
    with GLOBAL_METRICS.span("keygen/transforms", device):
        quotient_unscale = powers(ctx, FR.inv(domain.zeta), domain.n_ext, device,
                                   start=FR.inv(domain.n_ext))
        coeff_stack = _coeff(dev_stack, plan)
        if split:
            coset = coset_tables(domain, device)
            ext_stack = zeta_powers = x_ext = zh_inv_ext = None
        else:
            coset = (None, None, None)
            zeta_powers, x_ext, zh_inv_ext = ext_tables(domain, device)
            ext_stack = _ext(coeff_stack, zeta_powers, plan_ext)

    # ---- commitments (one batched MSM over the shared pair tables) ----
    with GLOBAL_METRICS.span("keygen/commit", device):
        all_comms = msm_commit_batch(srs.msm_tables(msm), _canon_batch(coeff_stack[:nm]))
    fixed_comms = dict(zip(ALL_FIXED, all_comms[:nf]))
    sigma_comms = list(all_comms[nf:])

    vk = VerifyingKey(domain, fixed_comms, sigma_comms,
                      transcript_repr(domain, fixed_comms, sigma_comms))
    kept = coeff_stack if split else None
    pk = ProvingKey(
        vk=vk,
        fixed_raw={name: dev_stack[i] for i, name in enumerate(ALL_FIXED)},
        fixed_coeff={name: coeff_stack[i] for i, name in enumerate(ALL_FIXED)},
        fixed_ext=None if split else {name: ext_stack[i] for i, name in enumerate(ALL_FIXED)},
        sigma_coeff=[coeff_stack[nf + c] for c in range(NUM_PERM_COLS)],
        sigma_ext=None if split else [ext_stack[nf + c] for c in range(NUM_PERM_COLS)],
        l0_ext=_row(ext_stack, nm),
        l_last_ext=_row(ext_stack, nm + 1),
        l_blind_ext=_row(ext_stack, nm + 2),
        x_ext=x_ext,
        zeta_powers=zeta_powers,
        quotient_unscale=quotient_unscale,
        zh_inv_ext=zh_inv_ext,
        delta_powers=delta_powers,
        raw_stack=dev_stack[:nf],
        ext_stack=ext_stack,
        split=split,
        coeff_stack=kept,
        l0_coeff=_row(kept, nm),
        l_last_coeff=_row(kept, nm + 1),
        l_blind_coeff=_row(kept, nm + 2),
        coset_powers=coset[0],
        coset_x=coset[1],
        coset_zh_inv=coset[2],
        shape=circuit_shape(builder),
    )
    return pk, vk
