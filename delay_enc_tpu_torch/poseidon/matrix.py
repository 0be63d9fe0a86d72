"""Square-matrix helpers over a prime field (parameter construction only).

Mirrors the semantics of reference/src/poseidon/matrix.rs (transpose,
matmul, matrix-vector product, Gaussian inversion) with rows/cols as lists of
Python ints mod p.
"""

from __future__ import annotations

from ..fields.prime import PrimeField


def identity(field: PrimeField, t: int):
    return [[1 if i == j else 0 for j in range(t)] for i in range(t)]


def transpose(m):
    t = len(m)
    return [[m[i][j] for i in range(t)] for j in range(t)]


def matmul(field: PrimeField, a, b):
    p = field.p
    t = len(a)
    return [
        [sum(a[i][k] * b[k][j] for k in range(t)) % p for j in range(t)]
        for i in range(t)
    ]


def mul_vector(field: PrimeField, m, v):
    p = field.p
    return [sum(a_i * v_i for a_i, v_i in zip(row, v)) % p for row in m]


def invert(field: PrimeField, m):
    p = field.p
    t = len(m)
    aug = [list(row) + [1 if i == j else 0 for j in range(t)] for i, row in enumerate(m)]
    for i in range(t):
        inv_piv = pow(aug[i][i], -1, p)
        for j in range(t):
            if i != j:
                r = aug[j][i] * inv_piv % p
                for k in range(2 * t):
                    aug[j][k] = (aug[j][k] - r * aug[i][k]) % p
    for i in range(t):
        inv_piv = pow(aug[i][i], -1, p)
        for j in range(t, 2 * t):
            aug[i][j] = aug[i][j] * inv_piv % p
    return [row[t:] for row in aug]
