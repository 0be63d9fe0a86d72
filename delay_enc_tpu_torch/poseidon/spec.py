"""Poseidon Spec: optimized round constants and sparse MDS factorization.

Bit-exact reimplementation of reference/src/poseidon/spec.rs:306-398
(which follows eprint 2019/458 supplementary material section B):

 - unoptimized constants + Cauchy MDS come from the Grain LFSR,
 - the partial-round constants are folded backwards through M^-1 so each
   partial round adds a single constant,
 - the MDS is factorised into r_p sparse matrices plus one transition
   ("pre-sparse") matrix applied at the end of the first half of full rounds.

Specs are cached per (field, T, r_f, r_p); generation is host-side, one-time.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

from ..fields.prime import PrimeField
from . import matrix as mat
from .grain import grain_generate


@dataclass
class SparseMDS:
    """row (length T) and col_hat (length RATE = T-1); apply semantics as in
    spec.rs:263-279."""

    row: list[int]
    col_hat: list[int]


@dataclass
class Spec:
    field: PrimeField
    t: int
    r_f: int
    r_p: int
    mds: list[list[int]]
    pre_sparse_mds: list[list[int]]
    sparse_matrices: list[SparseMDS]
    constants_start: list[list[int]]  # r_f/2 + 1 rows of T
    constants_partial: list[int]  # r_p single constants
    constants_end: list[list[int]]  # r_f/2 - 1 rows of T
    # unoptimized parameters kept for the SpecRef cross-test
    unoptimized_constants: list[list[int]]

    @property
    def rate(self) -> int:
        return self.t - 1


def _factorise(field: PrimeField, m):
    """spec.rs:206-235: factor M = M' * M'' with M'' sparse; returns
    (m_prime, SparseMDS built from transposed m_prime_prime)."""
    t = len(m)
    w = [m[i][0] for i in range(1, t)]
    m_hat = [row[1:] for row in m[1:]]
    m_hat_inv = mat.invert(field, m_hat)
    w_hat = mat.mul_vector(field, m_hat_inv, w)

    m_prime = mat.identity(field, t)
    for i in range(1, t):
        for j in range(1, t):
            m_prime[i][j] = m_hat[i - 1][j - 1]

    m_pp = mat.identity(field, t)
    m_pp[0] = list(m[0])
    for i in range(1, t):
        m_pp[i][0] = w_hat[i - 1]
    m_pp_t = mat.transpose(m_pp)
    # assert sparse form (spec.rs:288-292)
    for i in range(1, t):
        for j in range(1, t):
            assert m_pp_t[i][j] == (1 if i == j else 0)
    sparse = SparseMDS(row=list(m_pp_t[0]), col_hat=[m_pp_t[i][0] for i in range(1, t)])
    return m_prime, sparse


def _calculate_optimized_constants(field, r_f, r_p, constants, mds):
    p = field.p
    inv_mds = mat.invert(field, mds)
    r_f_half = r_f // 2
    assert len(constants) == r_f + r_p

    constants_start = [list(constants[0])]
    for i in range(1, r_f_half):
        constants_start.append(mat.mul_vector(field, inv_mds, constants[i]))

    acc = list(constants[r_f_half + r_p])
    constants_partial = [0] * r_p
    # optimized[j] pairs with constants row (r_f_half + j), j = r_p-1 .. 0
    for j in range(r_p - 1, -1, -1):
        tmp = mat.mul_vector(field, inv_mds, acc)
        constants_partial[j] = tmp[0]
        tmp[0] = 0
        acc = [(t_i + c_i) % p for t_i, c_i in zip(tmp, constants[r_f_half + j])]
    constants_start.append(mat.mul_vector(field, inv_mds, acc))

    constants_end = [
        mat.mul_vector(field, inv_mds, constants[r_f_half + r_p + 1 + i])
        for i in range(r_f_half - 1)
    ]
    return constants_start, constants_partial, constants_end


def _calculate_sparse_matrices(field, r_p, mds):
    mds_t = mat.transpose(mds)
    acc = [list(r) for r in mds_t]
    sparse_matrices = []
    for _ in range(r_p):
        m_prime, sparse = _factorise(field, acc)
        sparse_matrices.append(sparse)
        acc = mat.matmul(field, mds_t, m_prime)
    sparse_matrices.reverse()
    pre_sparse_mds = mat.transpose(acc)
    return sparse_matrices, pre_sparse_mds


_CACHE: dict = {}


def spec(field: PrimeField, t: int, rate: int, r_f: int, r_p: int) -> Spec:
    assert rate + 1 == t
    key = (field.name, t, r_f, r_p)
    if key in _CACHE:
        return _CACHE[key]
    constants, mds = grain_generate(field, t, r_f, r_p)
    cs, cp, ce = _calculate_optimized_constants(field, r_f, r_p, constants, mds)
    sparse, pre_sparse = _calculate_sparse_matrices(field, r_p, mds)
    s = Spec(
        field=field,
        t=t,
        r_f=r_f,
        r_p=r_p,
        mds=mds,
        pre_sparse_mds=pre_sparse,
        sparse_matrices=sparse,
        constants_start=cs,
        constants_partial=cp,
        constants_end=ce,
        unoptimized_constants=constants,
    )
    _CACHE[key] = s
    return s
