"""Host-side BN254 G1/G2 group arithmetic.

Used for SRS bookkeeping, the verifier, and as the ground-truth oracle for
the device MSM kernels (delay_enc_tpu_torch.ops.msm).  G1 points are (x, y) ints,
G2 points are (x, y) Fq2; None encodes the identity.

Curve: y^2 = x^3 + 3 over Fq; twist (D-type): y^2 = x^3 + 3/(9+u) over Fq2.
Matches `halo2curves::bn256` parameters (reference Cargo.toml:14-17).
"""

from __future__ import annotations

from ..fields.bn254 import FQ, FR, Fq2

P = FQ.p

B1 = 3
# b2 = 3 / (9 + u)
B2 = Fq2(3, 0) * Fq2(9, 1).inv()

G1_GEN = (1, 2)
G2_GEN = (
    Fq2(
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    Fq2(
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
)


class _Group:
    """Shared affine short-Weierstrass arithmetic over a generic field."""

    def __init__(self, name, b, gen, is_fq2: bool):
        self.name = name
        self.b = b
        self.gen = gen
        self.is_fq2 = is_fq2

    # field helpers dispatch on coordinate type
    def _inv(self, x):
        return x.inv() if self.is_fq2 else pow(x, -1, P)

    def is_on_curve(self, pt) -> bool:
        if pt is None:
            return True
        x, y = pt
        if self.is_fq2:
            return y.square() == x.square() * x + self.b
        return (y * y - x * x * x - self.b) % P == 0

    def add(self, a, b):
        if a is None:
            return b
        if b is None:
            return a
        x1, y1 = a
        x2, y2 = b
        if x1 == x2:
            if self.is_fq2:
                if (y1 + y2).is_zero():
                    return None
            elif (y1 + y2) % P == 0:
                return None
            return self.double(a)
        lam = (y2 - y1) * self._inv(x2 - x1)
        x3 = lam * lam - x1 - x2
        y3 = lam * (x1 - x3) - y1
        if not self.is_fq2:
            x3 %= P
            y3 %= P
        return (x3, y3)

    def double(self, a):
        if a is None:
            return None
        x, y = a
        if self.is_fq2:
            if y.is_zero():
                return None
            lam = (3 * x.square()) * self._inv(2 * y)
        else:
            if y % P == 0:
                return None
            lam = (3 * x * x) * self._inv(2 * y)
        x3 = lam * lam - 2 * x
        y3 = lam * (x - x3) - y
        if not self.is_fq2:
            x3 %= P
            y3 %= P
        return (x3, y3)

    def neg(self, a):
        if a is None:
            return None
        x, y = a
        return (x, (-y) % P if not self.is_fq2 else -y)

    def mul(self, a, k: int):
        k %= FR.p
        if not self.is_fq2:
            return _g1_mul_jacobian(a, k)
        r, base = None, a
        while k:
            if k & 1:
                r = self.add(r, base)
            base = self.double(base)
            k >>= 1
        return r

    def msm(self, scalars, points):
        """Naive host MSM (test oracle only)."""
        acc = None
        for s, pt in zip(scalars, points):
            acc = self.add(acc, self.mul(pt, s))
        return acc

    def multi_scalar_mul(self, scalars, points, threads: int | None = None):
        """Fast host MSM for the verifier (G1 only): native C Straus
        shared-doubling on `native.ec.verify_threads(threads)` threads when
        the C library is available, else the same algorithm in Python
        Jacobian coordinates."""
        assert not self.is_fq2, "fast path is G1-only"
        from ..native.ec import msm_host

        res = msm_host(scalars, points, FR.p, threads=threads)
        if res != "unavailable":
            return res
        pairs = [(s % FR.p, pt) for s, pt in zip(scalars, points)
                 if pt is not None and s % FR.p]
        if not pairs:
            return None
        top = max(s.bit_length() for s, _ in pairs)
        acc = None
        for bit in range(top - 1, -1, -1):
            acc = _jac_double(acc)
            for s, pt in pairs:
                if (s >> bit) & 1:
                    acc = _jac_add_affine(acc, pt)
        return _jac_to_affine(acc)


# ---- host Jacobian helpers (shared with ops/msm.py's Horner fold) ----

def _jac_double(pt):
    """dbl-2009-l; pt = (X, Y, Z) Jacobian or None."""
    if pt is None:
        return None
    X, Y, Z = pt
    A = X * X % P
    B = Y * Y % P
    C = B * B % P
    D = 2 * ((X + B) * (X + B) - A - C) % P
    E = 3 * A % P
    F = E * E % P
    X3 = (F - 2 * D) % P
    Y3 = (E * (D - X3) - 8 * C) % P
    Z3 = 2 * Y * Z % P
    return (X3, Y3, Z3) if Z3 else None


def _jac_add_affine(pt, q):
    """madd-2007-bl: Jacobian + affine (x, y); q None = identity."""
    if q is None:
        return pt
    x2, y2 = q
    if pt is None:
        return (x2, y2, 1)
    X1, Y1, Z1 = pt
    Z1Z1 = Z1 * Z1 % P
    U2 = x2 * Z1Z1 % P
    S2 = y2 * Z1Z1 * Z1 % P
    if U2 == X1 and S2 == Y1:
        return _jac_double(pt)
    H = (U2 - X1) % P
    if H == 0:  # U2 == X1, S2 == -Y1
        return None
    HH = H * H % P
    I = 4 * HH % P
    J = H * I % P
    R_ = 2 * (S2 - Y1) % P
    V = X1 * I % P
    X3 = (R_ * R_ - J - 2 * V) % P
    Y3 = (R_ * (V - X3) - 2 * Y1 * J) % P
    Z3 = ((Z1 + H) * (Z1 + H) - Z1Z1 - HH) % P
    return (X3, Y3, Z3) if Z3 else None


def _jac_to_affine(pt):
    if pt is None:
        return None
    X, Y, Z = pt
    if Z % P == 0:
        return None
    zi = pow(Z, -1, P)
    zi2 = zi * zi % P
    return (X * zi2 % P, Y * zi2 % P * zi % P)


def _g1_mul_jacobian(a, k: int):
    """Scalar mul in Jacobian coordinates: one inversion total instead of
    one per double/add (the verifier multiplies ~40 commitments per proof;
    affine host muls were its dominant cost)."""
    if a is None or k == 0:
        return None
    acc = None
    for bit in bin(k)[2:]:
        acc = _jac_double(acc)
        if bit == "1":
            acc = _jac_add_affine(acc, a)
    return _jac_to_affine(acc)


G1 = _Group("G1", B1, G1_GEN, is_fq2=False)
G2 = _Group("G2", B2, G2_GEN, is_fq2=True)


# ---- serialization: halo2curves-compatible compressed encodings ----
#
# Matches `halo2curves::bn256::G1Affine::{to_bytes,from_bytes}` (the point
# format the reference's proofs/transcripts use, benches/delay_enc.rs:19-22):
# 32-byte little-endian x with the parity of y (y odd) stored in the top bit
# of the last byte; the identity encodes as all zeros.  Decoding rejects
# non-canonical x (x >= p) and off-curve x, so every point has exactly one
# valid encoding (no proof malleability through alternate encodings).

def g1_to_bytes(pt) -> bytes:
    if pt is None:
        return b"\x00" * 32
    x, y = pt
    return (x | ((y & 1) << 255)).to_bytes(32, "little")


def g1_from_bytes(b: bytes):
    if len(b) != 32:
        raise ValueError("G1 encoding must be 32 bytes")
    v = int.from_bytes(b, "little")
    ysign = v >> 255
    x = v & ((1 << 255) - 1)
    if x >= P:
        raise ValueError("non-canonical x coordinate")
    if x == 0 and not ysign:
        return None
    from ..native.ec import fq_sqrt_host

    y = fq_sqrt_host((x * x * x + B1) % P)
    if y == "unavailable":
        y = FQ.sqrt((x * x * x + B1) % P)
    if y is None:
        raise ValueError("not on curve")
    if (y & 1) != ysign:
        y = P - y
    return (x, y)


def g2_to_bytes(pt) -> bytes:
    """halo2curves bn256 G2Affine::to_bytes: 64-byte LE (x.c0 || x.c1) with
    the parity of y (lsb of y.c0) in the top bit of the last byte; identity
    encodes as all zeros."""
    if pt is None:
        return b"\x00" * 64
    x, y = pt
    hi = x.c1 | ((y.c0 & 1) << 255)
    return x.c0.to_bytes(32, "little") + hi.to_bytes(32, "little")
