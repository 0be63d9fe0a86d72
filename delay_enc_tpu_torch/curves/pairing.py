"""Optimal-ate pairing on BN254 (host-side; verifier only).

The reference delegates pairings to `halo2curves` inside
`halo2_proofs::verify_proof` (benches/delay_enc.rs:147-165).  The verifier is
ms-scale and host-side in this framework, so the pairing is implemented over
Python ints / the Fq tower — no device involvement.

Construction notes (standard BN optimal ate):
  - Miller loop over |6u+2| (u = BN_U), plain binary double-and-add.
  - D-type twist: untwist (x,y) -> (x*w^2, y*w^3), w^2 = v, v^3 = xi = 9+u.
    A line through T evaluated at P=(xp,yp) is the sparse Fq12 element
    yp + (-lambda*xp)*w + (lambda*x_T - y_T)*v*w   (mul_by_034 shape).
  - After the loop, two extra additions with the Frobenius images
    Q1 = pi(Q) and Q2 = -pi^2(Q).
  - Final exponentiation: easy part via conjugation/Frobenius, hard part by
    direct exponentiation with (p^4 - p^2 + 1)/r (host-side simplicity; this
    runs a handful of times per verification).
"""

from __future__ import annotations

from ..fields.bn254 import ATE_LOOP_COUNT, BN_U, FQ, FR, Fq2, Fq6, Fq12
from .bn254 import G1 as G1_GROUP, G2 as G2_GROUP

P = FQ.p
R = FR.p

_XI = Fq2(9, 1)
# Frobenius twist coefficients for G2 points
_TWIST_X = _XI.pow((P - 1) // 3)  # xi^((p-1)/3)
_TWIST_Y = _XI.pow((P - 1) // 2)  # xi^((p-1)/2)

_HARD_EXP = (P**4 - P**2 + 1) // R


def _line_double(t, pt_g1):
    """Tangent line at twisted T, evaluated at P; returns (line, 2T)."""
    x, y = t
    xp, yp = pt_g1
    lam = (3 * x.square()) * (2 * y).inv()
    x3 = lam.square() - 2 * x
    y3 = lam * (x - x3) - y
    c0 = Fq2(yp, 0)
    c3 = -(lam * xp)
    c4 = lam * x - y
    return (c0, c3, c4), (x3, y3)


def _line_add(t, q, pt_g1):
    """Chord line through twisted T and Q, evaluated at P; returns (line, T+Q)."""
    x1, y1 = t
    x2, y2 = q
    xp, yp = pt_g1
    lam = (y2 - y1) * (x2 - x1).inv()
    x3 = lam.square() - x1 - x2
    y3 = lam * (x1 - x3) - y1
    c0 = Fq2(yp, 0)
    c3 = -(lam * xp)
    c4 = lam * x1 - y1
    return (c0, c3, c4), (x3, y3)


def _frobenius_g2(q):
    x, y = q
    return (x.conjugate() * _TWIST_X, y.conjugate() * _TWIST_Y)


def miller_loop(pt_g1, pt_g2) -> Fq12:
    """f_{6u+2,Q}(P) with the two Frobenius correction lines."""
    if pt_g1 is None or pt_g2 is None:
        return Fq12.one()
    f = Fq12.one()
    t = pt_g2
    bits = bin(ATE_LOOP_COUNT)[2:]
    for bit in bits[1:]:
        line, t = _line_double(t, pt_g1)
        f = f.square().mul_by_034(*line)
        if bit == "1":
            line, t = _line_add(t, pt_g2, pt_g1)
            f = f.mul_by_034(*line)
    q1 = _frobenius_g2(pt_g2)
    q2 = _frobenius_g2(q1)
    q2 = (q2[0], -q2[1])
    line, t = _line_add(t, q1, pt_g1)
    f = f.mul_by_034(*line)
    line, t = _line_add(t, q2, pt_g1)
    f = f.mul_by_034(*line)
    return f


# ---- prepared pairings (fixed G2): precomputed line coefficients --------
#
# The verifier's two G2 points ([tau]2 and the generator) are fixed per
# SRS, so every step's (lambda, lambda*x_T - y_T) pair — the P-independent
# part of the line — is precomputed once.  Evaluation at P then costs two
# Fq2-by-scalar scalings per line instead of G2 point arithmetic with an
# Fq2 inversion per step (halo2curves G2Prepared equivalent).

class G2Prepared:
    __slots__ = ("coeffs", "_native_packed")  # packed bytes cached by native.ec

    def __init__(self, pt_g2):
        self.coeffs = []
        t = pt_g2
        bits = bin(ATE_LOOP_COUNT)[2:]
        for bit in bits[1:]:
            t = self._dbl(t)
            if bit == "1":
                t = self._add(t, pt_g2)
        q1 = _frobenius_g2(pt_g2)
        q2 = _frobenius_g2(q1)
        q2 = (q2[0], -q2[1])
        t = self._add(t, q1)
        self._add(t, q2)

    def _dbl(self, t):
        x, y = t
        lam = (3 * x.square()) * (2 * y).inv()
        x3 = lam.square() - 2 * x
        y3 = lam * (x - x3) - y
        self.coeffs.append((lam, lam * x - y))
        return (x3, y3)

    def _add(self, t, q):
        x1, y1 = t
        x2, y2 = q
        lam = (y2 - y1) * (x2 - x1).inv()
        x3 = lam.square() - x1 - x2
        y3 = lam * (x1 - x3) - y1
        self.coeffs.append((lam, lam * x1 - y1))
        return (x3, y3)


def multi_miller_loop_prepared(pairs) -> Fq12:
    """prod_i f_{6u+2,Q_i}(P_i) for [(P_i affine G1, G2Prepared)] — one
    shared squaring chain, precomputed lines."""
    pairs = [(p, q) for p, q in pairs if p is not None]
    if not pairs:
        return Fq12.one()
    evals = []
    for p, q in pairs:
        xp, yp = p
        c0 = Fq2(yp, 0)
        evals.append((xp, c0, q.coeffs))
    f = Fq12.one()
    idx = 0
    bits = bin(ATE_LOOP_COUNT)[2:]
    for bit in bits[1:]:
        f = f.square()
        for xp, c0, coeffs in evals:
            lam, c4 = coeffs[idx]
            f = f.mul_by_034(c0, -(lam * xp), c4)
        idx += 1
        if bit == "1":
            for xp, c0, coeffs in evals:
                lam, c4 = coeffs[idx]
                f = f.mul_by_034(c0, -(lam * xp), c4)
            idx += 1
    for _ in range(2):
        for xp, c0, coeffs in evals:
            lam, c4 = coeffs[idx]
            f = f.mul_by_034(c0, -(lam * xp), c4)
        idx += 1
    return f


def _exp_by_neg_u(f: Fq12) -> Fq12:
    """f^(-u) for elements of the cyclotomic subgroup (where inverse =
    conjugate).  u is positive for BN254, so exponentiate (with cyclotomic
    squarings) then conjugate."""
    return f.cyclotomic_pow(BN_U).conjugate()


def final_exponentiation(f: Fq12) -> Fq12:
    # easy part: f^((p^6-1)(p^2+1))
    f = f.conjugate() * f.inv()
    f = f.frobenius(2) * f
    # hard part via the Fuentes-Castaneda et al. u-addition chain (the
    # standard BN sequence shipped by arkworks/halo2curves) — 3
    # u-exponentiations (~63 squarings each) + ~13 multiplications instead
    # of a direct 3046-bit exponentiation.  NOTE: like those libraries,
    # this computes f^(c*lambda) with the fixed multiple
    # c = 2u(6u^2+3u+1), lambda = (p^4-p^2+1)/r; since gcd(c, r) = 1 this
    # changes no pairing product/equality check (tests/test_pairing.py
    # validates the exponent symbolically and the checks behaviorally).
    r = f
    y0 = _exp_by_neg_u(r)
    y1 = y0.square()
    y2 = y1.square()
    y3 = y2 * y1
    y4 = _exp_by_neg_u(y3)
    y5 = y4.square()
    y6 = _exp_by_neg_u(y5)
    y3 = y3.conjugate()
    y6 = y6.conjugate()
    y7 = y6 * y4
    y8 = y7 * y3
    y9 = y8 * y1
    y10 = y8 * y4
    y11 = y10 * r
    y12 = y9.frobenius(1)
    y13 = y12 * y11
    y8 = y8.frobenius(2)
    y14 = y8 * y13
    r = r.conjugate()
    y15 = (r * y9).frobenius(3)
    return y15 * y14


def final_exponentiation_direct(f: Fq12) -> Fq12:
    """Reference form (used by tests to validate the addition chain)."""
    f = f.conjugate() * f.inv()
    f = f.frobenius(2) * f
    return f.pow(_HARD_EXP)


def pairing(pt_g1, pt_g2) -> Fq12:
    assert G1_GROUP.is_on_curve(pt_g1), "P not on G1"
    assert G2_GROUP.is_on_curve(pt_g2), "Q not on G2"
    return final_exponentiation(miller_loop(pt_g1, pt_g2))


def multi_pairing(pairs) -> Fq12:
    """prod_i e(P_i, Q_i) with a single shared final exponentiation."""
    f = Fq12.one()
    for pt_g1, pt_g2 in pairs:
        f = f * miller_loop(pt_g1, pt_g2)
    return final_exponentiation(f)


def pairing_check(pairs, threads: int | None = None) -> bool:
    """Returns True iff prod_i e(P_i, Q_i) == 1 (the KZG verification shape).
    Each Q_i may be a raw G2 point or a G2Prepared (fixed-point fast path).
    When every Q is prepared and the native C library is available, the
    whole check (multi-Miller + final exponentiation) runs in C, on
    `native.ec.verify_threads(threads)` threads."""
    pairs = list(pairs)
    if pairs and all(isinstance(q, G2Prepared) for _, q in pairs):
        from ..native.ec import pairing_check_native

        res = pairing_check_native(pairs, threads)
        if res is not None:
            return res
    f = Fq12.one()
    raw = []
    for pt_g1, q in pairs:
        if isinstance(q, G2Prepared):
            raw.append((pt_g1, q))
        else:
            f = f * miller_loop(pt_g1, q)
    if raw:
        f = f * multi_miller_loop_prepared(raw)
    return final_exponentiation(f).is_one()
