"""BN254 in plain Python integers: the fields, G1, and halo2's encodings.

The curve is y^2 = x^3 + 3 over Fq, G1 has prime order r (the scalar field
Fr) and cofactor 1, the generator is (1, 2).  Fr's multiplicative generator
is 7 and its 2-adicity 28, as in halo2curves' bn256.  A point is an affine
pair (x, y) of ints, or None for the point at infinity; arithmetic runs in
Jacobian coordinates (X, Y, Z).  Nothing here imports the program under
test.
"""

from __future__ import annotations

Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
B = 3
GEN = (1, 2)
FR_GENERATOR = 7
FR_TWO_ADICITY = 28


def root_of_unity(k: int) -> int:
    """A primitive 2^k-th root of unity of Fr: 7^((r - 1) / 2^k)."""
    if not 0 <= k <= FR_TWO_ADICITY:
        raise ValueError(f"Fr has no 2^{k}-th root of unity")
    return pow(FR_GENERATOR, (R - 1) >> k, R)


def fr_from_uniform(b: bytes) -> int:
    """A 64-byte little-endian integer reduced mod r."""
    if len(b) != 64:
        raise ValueError("64 bytes expected")
    return int.from_bytes(b, "little") % R


def batch_inverse(values: list, modulus: int) -> list:
    """Inverses of non-zero values with one modular inversion."""
    prefix, acc = [], 1
    for v in values:
        prefix.append(acc)
        acc = acc * v % modulus
    inv = pow(acc, -1, modulus)
    out = [0] * len(values)
    for i in range(len(values) - 1, -1, -1):
        out[i] = inv * prefix[i] % modulus
        inv = inv * values[i] % modulus
    return out


# ---- G1 ---------------------------------------------------------------

def on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return 0 <= x < Q and 0 <= y < Q and (y * y - x * x * x - B) % Q == 0


def _double(p):
    if p is None:
        return None
    x, y, z = p
    if y == 0:
        return None
    a = x * x % Q
    b = y * y % Q
    c = b * b % Q
    d = 2 * ((x + b) * (x + b) - a - c) % Q
    e = 3 * a % Q
    x3 = (e * e - 2 * d) % Q
    y3 = (e * (d - x3) - 8 * c) % Q
    z3 = 2 * y * z % Q
    return (x3, y3, z3)


def _add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1 = z1 * z1 % Q
    z2z2 = z2 * z2 % Q
    u1 = x1 * z2z2 % Q
    u2 = x2 * z1z1 % Q
    s1 = y1 * z2 * z2z2 % Q
    s2 = y2 * z1 * z1z1 % Q
    if u1 == u2:
        return _double(p) if s1 == s2 else None
    h = (u2 - u1) % Q
    i = 4 * h * h % Q
    j = h * i % Q
    rr = 2 * (s2 - s1) % Q
    v = u1 * i % Q
    x3 = (rr * rr - j - 2 * v) % Q
    y3 = (rr * (v - x3) - 2 * s1 * j) % Q
    z3 = ((z1 + z2) * (z1 + z2) - z1z1 - z2z2) * h % Q
    return (x3, y3, z3)


def _jac(pt):
    return None if pt is None else (pt[0], pt[1], 1)


def _affine(p):
    if p is None:
        return None
    x, y, z = p
    if z % Q == 0:
        return None
    zi = pow(z, -1, Q)
    zi2 = zi * zi % Q
    return (x * zi2 % Q, y * zi2 * zi % Q)


def add(a, b):
    """The sum of two affine points."""
    return _affine(_add(_jac(a), _jac(b)))


def neg(a):
    return None if a is None else (a[0], (-a[1]) % Q)


def msm(scalars: list, points: list):
    """sum_i scalars[i] * points[i] as an affine point: 4-bit windows over
    shared doublings (Straus)."""
    terms = [(s % R, _jac(p)) for s, p in zip(scalars, points, strict=True)
             if s % R and p is not None]
    if not terms:
        return None
    tables = []
    for _, p in terms:
        row = [None, p]
        for _ in range(14):
            row.append(_add(row[-1], p))
        tables.append(row)
    acc = None
    for shift in range(252, -1, -4):
        for _ in range(4):
            acc = _double(acc)
        for (s, _), row in zip(terms, tables):
            digit = (s >> shift) & 15
            if digit:
                acc = _add(acc, row[digit])
    return _affine(acc)


def mul(scalar: int, pt):
    return msm([scalar], [pt])


def to_bytes(pt) -> bytes:
    """halo2curves' compressed G1 encoding: x little-endian, the parity of y
    in the top bit; the point at infinity as 32 zero bytes."""
    if pt is None:
        return b"\x00" * 32
    x, y = pt
    return (x | ((y & 1) << 255)).to_bytes(32, "little")


def from_bytes(b: bytes):
    """The point of a compressed encoding; ValueError for one that names no
    point of the curve or is not canonical."""
    if len(b) != 32:
        raise ValueError("a G1 encoding is 32 bytes")
    v = int.from_bytes(b, "little")
    sign, x = v >> 255, v & ((1 << 255) - 1)
    if x >= Q:
        raise ValueError("non-canonical x coordinate")
    if x == 0 and not sign:
        return None
    rhs = (x * x * x + B) % Q
    y = pow(rhs, (Q + 1) // 4, Q)  # Q = 3 mod 4
    if y * y % Q != rhs:
        raise ValueError("x names no point of the curve")
    if (y & 1) != sign:
        y = Q - y
    return (x, y)
