"""BN254 (alt_bn128 / bn256) base and scalar fields + the Fq2/Fq6/Fq12 tower.

Parameters match `halo2curves::bn256` (the reference's curve backend,
reference/Cargo.toml:14-17): curve y^2 = x^3 + 3 over Fq, scalar field
Fr with 2-adicity 28 and multiplicative generator 7.

Tower (standard BN254 construction, used by the pairing verifier):
    Fq2  = Fq[u]  / (u^2 + 1)
    Fq6  = Fq2[v] / (v^3 - xi),  xi = 9 + u
    Fq12 = Fq6[w] / (w^2 - v)
"""

from __future__ import annotations

from .prime import PrimeField

# BN254 curve parameter (u in the BN family construction)
BN_U = 4965661367192848881
# |6u+2|, the optimal-ate Miller loop length
ATE_LOOP_COUNT = 6 * BN_U + 2  # = 29793968203157093288

FQ_MOD = 21888242871839275222246405745257275088696311157297823662689037894645226208583
FR_MOD = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# halo2curves bn256::Fq GENERATOR = 3, bn256::Fr GENERATOR = 7
FQ = PrimeField("bn254::Fq", FQ_MOD, generator=3)
FR = PrimeField("bn254::Fr", FR_MOD, generator=7)

# Back-compat aliases
Fp = FQ
Fr = FR

p = FQ_MOD


class Fq2:
    """Fq[u]/(u^2+1); element = c0 + c1*u with c0,c1 Python ints."""

    __slots__ = ("c0", "c1")
    NON_RESIDUE = (9, 1)  # xi = 9 + u

    def __init__(self, c0: int, c1: int = 0):
        self.c0 = c0 % p
        self.c1 = c1 % p

    @staticmethod
    def zero() -> "Fq2":
        return Fq2(0, 0)

    @staticmethod
    def one() -> "Fq2":
        return Fq2(1, 0)

    def is_zero(self) -> bool:
        return self.c0 == 0 and self.c1 == 0

    def __eq__(self, o) -> bool:
        return isinstance(o, Fq2) and self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash((self.c0, self.c1))

    def __add__(self, o: "Fq2") -> "Fq2":
        return Fq2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "Fq2") -> "Fq2":
        return Fq2(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self) -> "Fq2":
        return Fq2(-self.c0, -self.c1)

    def __mul__(self, o) -> "Fq2":
        if isinstance(o, int):
            return Fq2(self.c0 * o, self.c1 * o)
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        t0 = a0 * b0
        t1 = a1 * b1
        # (a0+a1)(b0+b1) - t0 - t1
        return Fq2(t0 - t1, (a0 + a1) * (b0 + b1) - t0 - t1)

    __rmul__ = __mul__

    def square(self) -> "Fq2":
        a0, a1 = self.c0, self.c1
        # (a0+a1)(a0-a1), 2*a0*a1
        return Fq2((a0 + a1) * (a0 - a1), 2 * a0 * a1)

    def mul_by_nonresidue(self) -> "Fq2":
        """Multiply by xi = 9 + u."""
        a0, a1 = self.c0, self.c1
        return Fq2(9 * a0 - a1, 9 * a1 + a0)

    def conjugate(self) -> "Fq2":
        return Fq2(self.c0, -self.c1)

    def inv(self) -> "Fq2":
        # 1/(c0 + c1 u) = (c0 - c1 u)/(c0^2 + c1^2)
        t = pow(self.c0 * self.c0 + self.c1 * self.c1, -1, p)
        return Fq2(self.c0 * t, -self.c1 * t)

    def pow(self, e: int) -> "Fq2":
        r, b = Fq2.one(), self
        while e:
            if e & 1:
                r = r * b
            b = b.square()
            e >>= 1
        return r

    def frobenius(self) -> "Fq2":
        """x -> x^p, i.e. conjugation."""
        return self.conjugate()

    def __repr__(self):
        return f"Fq2({self.c0}, {self.c1})"


class Fq6:
    """Fq2[v]/(v^3 - xi)."""

    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fq2, c1: Fq2, c2: Fq2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    @staticmethod
    def zero() -> "Fq6":
        return Fq6(Fq2.zero(), Fq2.zero(), Fq2.zero())

    @staticmethod
    def one() -> "Fq6":
        return Fq6(Fq2.one(), Fq2.zero(), Fq2.zero())

    def is_zero(self) -> bool:
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()

    def __eq__(self, o) -> bool:
        return (
            isinstance(o, Fq6) and self.c0 == o.c0 and self.c1 == o.c1 and self.c2 == o.c2
        )

    def __add__(self, o: "Fq6") -> "Fq6":
        return Fq6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o: "Fq6") -> "Fq6":
        return Fq6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self) -> "Fq6":
        return Fq6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o: "Fq6") -> "Fq6":
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0, t1, t2 = a0 * b0, a1 * b1, a2 * b2
        c0 = ((a1 + a2) * (b1 + b2) - t1 - t2).mul_by_nonresidue() + t0
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2.mul_by_nonresidue()
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fq6(c0, c1, c2)

    def square(self) -> "Fq6":
        return self * self

    def mul_by_fq2(self, x: Fq2) -> "Fq6":
        return Fq6(self.c0 * x, self.c1 * x, self.c2 * x)

    def mul_by_01(self, b0: Fq2, b1: Fq2) -> "Fq6":
        """Multiply by the sparse element b0 + b1 v (5 Fq2 muls)."""
        a_a = self.c0 * b0
        b_b = self.c1 * b1
        t1 = ((self.c1 + self.c2) * b1 - b_b).mul_by_nonresidue() + a_a
        t2 = (b0 + b1) * (self.c0 + self.c1) - a_a - b_b
        t3 = (self.c0 + self.c2) * b0 - a_a + b_b
        return Fq6(t1, t2, t3)

    def mul_by_nonresidue(self) -> "Fq6":
        """Multiply by v: (c0 + c1 v + c2 v^2) * v = c2*xi + c0 v + c1 v^2."""
        return Fq6(self.c2.mul_by_nonresidue(), self.c0, self.c1)

    def inv(self) -> "Fq6":
        a0, a1, a2 = self.c0, self.c1, self.c2
        t0 = a0.square() - (a1 * a2).mul_by_nonresidue()
        t1 = a2.square().mul_by_nonresidue() - a0 * a1
        t2 = a1.square() - a0 * a2
        det = a0 * t0 + (a2 * t1).mul_by_nonresidue() + (a1 * t2).mul_by_nonresidue()
        det_inv = det.inv()
        return Fq6(t0 * det_inv, t1 * det_inv, t2 * det_inv)


# Frobenius coefficients (computed lazily once, cached at module level)
_FROB_C1_6: list[Fq2] | None = None  # xi^((p^i - 1)/3)
_FROB_C2_6: list[Fq2] | None = None  # xi^((2p^i - 2)/3)
_FROB_C1_12: list[Fq2] | None = None  # xi^((p^i - 1)/6)


def _frob_coeffs():
    global _FROB_C1_6, _FROB_C2_6, _FROB_C1_12
    if _FROB_C1_6 is not None:
        return
    xi = Fq2(*Fq2.NON_RESIDUE)
    _FROB_C1_6 = [xi.pow((pow(p, i) - 1) // 3) for i in range(6)]
    _FROB_C2_6 = [xi.pow((2 * pow(p, i) - 2) // 3) for i in range(6)]
    _FROB_C1_12 = [xi.pow((pow(p, i) - 1) // 6) for i in range(12)]


def fq6_frobenius(a: Fq6, power: int = 1) -> Fq6:
    _frob_coeffs()
    r0, r1, r2 = a.c0, a.c1, a.c2
    for _ in range(power):
        r0, r1, r2 = r0.frobenius(), r1.frobenius(), r2.frobenius()
    r1 = r1 * _FROB_C1_6[power % 6]
    r2 = r2 * _FROB_C2_6[power % 6]
    return Fq6(r0, r1, r2)


class Fq12:
    """Fq6[w]/(w^2 - v)."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fq6, c1: Fq6):
        self.c0, self.c1 = c0, c1

    @staticmethod
    def one() -> "Fq12":
        return Fq12(Fq6.one(), Fq6.zero())

    def is_one(self) -> bool:
        return self == Fq12.one()

    def __eq__(self, o) -> bool:
        return isinstance(o, Fq12) and self.c0 == o.c0 and self.c1 == o.c1

    def __mul__(self, o: "Fq12") -> "Fq12":
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        t0 = a0 * b0
        t1 = a1 * b1
        return Fq12(t0 + t1.mul_by_nonresidue(), (a0 + a1) * (b0 + b1) - t0 - t1)

    def square(self) -> "Fq12":
        a0, a1 = self.c0, self.c1
        t = a0 * a1
        c0 = (a0 + a1) * (a0 + a1.mul_by_nonresidue()) - t - t.mul_by_nonresidue()
        return Fq12(c0, t + t)

    def conjugate(self) -> "Fq12":
        """x -> x^(p^6): negate the w-part (unitary inverse for GT elements)."""
        return Fq12(self.c0, -self.c1)

    def inv(self) -> "Fq12":
        t = (self.c0.square() - self.c1.square().mul_by_nonresidue()).inv()
        return Fq12(self.c0 * t, -(self.c1 * t))

    def frobenius(self, power: int = 1) -> "Fq12":
        _frob_coeffs()
        r0 = fq6_frobenius(self.c0, power)
        r1 = fq6_frobenius(self.c1, power)
        coeff = _FROB_C1_12[power % 12]
        r1 = Fq6(r1.c0 * coeff, r1.c1 * coeff, r1.c2 * coeff)
        return Fq12(r0, r1)

    def pow(self, e: int) -> "Fq12":
        r, b = Fq12.one(), self
        while e:
            if e & 1:
                r = r * b
            b = b.square()
            e >>= 1
        return r

    def mul_by_034(self, c0: Fq2, c3: Fq2, c4: Fq2) -> "Fq12":
        """Multiplication by a sparse element c0 + (c3 + c4 v) w
        (the shape of pairing line evaluations on the D-twist).  Dedicated
        sparse schedule (~13 Fq2 muls vs 18 for a full Fq12 multiply)."""
        a = self.c0
        t0 = Fq6(a.c0 * c0, a.c1 * c0, a.c2 * c0)
        t1 = self.c1.mul_by_01(c3, c4)
        o = c0 + c3
        c1_out = (self.c1 + self.c0).mul_by_01(o, c4) - t0 - t1
        c0_out = t1.mul_by_nonresidue() + t0
        return Fq12(c0_out, c1_out)

    def cyclotomic_square(self) -> "Fq12":
        """Granger-Scott squaring for elements of the cyclotomic subgroup
        (valid after the easy part of the final exponentiation) — ~9 Fq2
        squares vs 18 Fq2 muls for a generic square."""
        z0, z4, z3 = self.c0.c0, self.c0.c1, self.c0.c2
        z2, z1, z5 = self.c1.c0, self.c1.c1, self.c1.c2

        def fp4_sq(a: Fq2, b: Fq2):
            t0 = a.square()
            t1 = b.square()
            return t1.mul_by_nonresidue() + t0, (a + b).square() - t0 - t1

        t0, t1 = fp4_sq(z0, z1)
        z0 = (t0 - z0) + (t0 - z0) + t0
        z1 = (t1 + z1) + (t1 + z1) + t1
        t0, t1 = fp4_sq(z2, z3)
        t2, t3 = fp4_sq(z4, z5)
        z4 = (t0 - z4) + (t0 - z4) + t0
        z5 = (t1 + z5) + (t1 + z5) + t1
        t0 = t3.mul_by_nonresidue()
        z2 = (t0 + z2) + (t0 + z2) + t0
        z3 = (t2 - z3) + (t2 - z3) + t2
        return Fq12(Fq6(z0, z4, z3), Fq6(z2, z1, z5))

    def cyclotomic_pow(self, e: int) -> "Fq12":
        """self^e using cyclotomic squarings (self must be in the
        cyclotomic subgroup)."""
        r = Fq12.one()
        started = False
        for bit in bin(e)[2:]:
            if started:
                r = r.cyclotomic_square()
            if bit == "1":
                r = self if not started else r * self
                started = True
        return r if started else Fq12.one()
