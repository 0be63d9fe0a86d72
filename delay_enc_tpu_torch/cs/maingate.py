"""MainGate: the 5-wire PLONK instruction set over the columnar Builder.

Re-implements the capability surface of `maingate::MainGate` that the
reference's chips consume (usage inventory: src/poseidon/chip.rs,
src/big_integer/chip.rs, src/rsa/chip.rs, src/lib.rs): assign_constant,
assign_value, assign_bit, add, sub, mul, mul_add, mul_add_constant,
add_constant, add_with_constant, neg?, and, or, not, select, is_zero,
is_equal, compose, to_bits, assert_equal, assert_zero, assert_one.

Linear combinations (`compose`) chain through the `e` wire with the
`q_e_next` rotation selector: first/middle rows carry 4 terms each, the
final row carries up to 3 terms plus the result — matching halo2wrong's
row economics so circuit sizes stay comparable to the reference benches.
"""

from __future__ import annotations

from dataclasses import dataclass

from .builder import Builder, Cell


@dataclass(frozen=True)
class Term:
    """coeff * cell (maingate::Term::Assigned analog)."""

    cell: Cell
    coeff: int


class MainGate:
    def __init__(self, builder: Builder):
        self.b = builder
        self.f = builder.field

    # --- assignment ---------------------------------------------------
    def assign_constant(self, v: int) -> Cell:
        v = v % self.f.p
        return self.b.row({"a": v}, {"q_a": 1, "q_constant": -v})["a"]

    def assign_value(self, v: int) -> Cell:
        return self.b.row({"a": v % self.f.p})["a"]

    def assign_bit(self, v: int) -> Cell:
        assert v in (0, 1)
        out = self.b.row({"a": v, "b": v, "c": v}, {"q_mul_ab": 1, "q_c": -1})
        self.b.constrain_equal(out["a"], out["b"])
        self.b.constrain_equal(out["b"], out["c"])
        return out["a"]

    # --- arithmetic ---------------------------------------------------
    def add(self, x: Cell, y: Cell) -> Cell:
        v = (x.value + y.value) % self.f.p
        return self.b.row({"a": x, "b": y, "c": v}, {"q_a": 1, "q_b": 1, "q_c": -1})["c"]

    def sub(self, x: Cell, y: Cell) -> Cell:
        v = (x.value - y.value) % self.f.p
        return self.b.row({"a": x, "b": y, "c": v}, {"q_a": 1, "q_b": -1, "q_c": -1})["c"]

    def mul(self, x: Cell, y: Cell) -> Cell:
        v = x.value * y.value % self.f.p
        return self.b.row({"a": x, "b": y, "c": v}, {"q_mul_ab": 1, "q_c": -1})["c"]

    def mul_add(self, x: Cell, y: Cell, z: Cell) -> Cell:
        """x*y + z"""
        v = (x.value * y.value + z.value) % self.f.p
        return self.b.row(
            {"a": x, "b": y, "c": z, "d": v}, {"q_mul_ab": 1, "q_c": 1, "q_d": -1}
        )["d"]

    def mul_add_constant(self, x: Cell, y: Cell, k: int) -> Cell:
        """x*y + k"""
        v = (x.value * y.value + k) % self.f.p
        return self.b.row(
            {"a": x, "b": y, "c": v}, {"q_mul_ab": 1, "q_constant": k, "q_c": -1}
        )["c"]

    def add_constant(self, x: Cell, k: int) -> Cell:
        v = (x.value + k) % self.f.p
        return self.b.row({"a": x, "b": v}, {"q_a": 1, "q_constant": k, "q_b": -1})["b"]

    def add_with_constant(self, x: Cell, y: Cell, k: int) -> Cell:
        v = (x.value + y.value + k) % self.f.p
        return self.b.row(
            {"a": x, "b": y, "c": v}, {"q_a": 1, "q_b": 1, "q_constant": k, "q_c": -1}
        )["c"]

    def neg(self, x: Cell) -> Cell:
        v = (-x.value) % self.f.p
        return self.b.row({"a": x, "b": v}, {"q_a": 1, "q_b": 1})["b"]

    # --- boolean ------------------------------------------------------
    def and_(self, x: Cell, y: Cell) -> Cell:
        return self.mul(x, y)

    def or_(self, x: Cell, y: Cell) -> Cell:
        v = (x.value + y.value - x.value * y.value) % self.f.p
        return self.b.row(
            {"a": x, "b": y, "c": v}, {"q_a": 1, "q_b": 1, "q_mul_ab": -1, "q_c": -1}
        )["c"]

    def not_(self, x: Cell) -> Cell:
        v = (1 - x.value) % self.f.p
        return self.b.row({"a": x, "b": v}, {"q_a": -1, "q_b": -1, "q_constant": 1})["b"]

    def select(self, x: Cell, y: Cell, cond: Cell) -> Cell:
        """cond ? x : y (maingate select(ctx, a, b, cond) semantics)."""
        v = x.value if cond.value else y.value
        out = self.b.row(
            {"a": cond, "b": x, "c": cond, "d": y, "e": v},
            {"q_mul_ab": 1, "q_mul_cd": -1, "q_d": 1, "q_e": -1},
        )
        return out["e"]

    # --- predicates ---------------------------------------------------
    def is_zero(self, x: Cell) -> Cell:
        p = self.f.p
        inv0 = pow(x.value, -1, p) if x.value else 0
        r = (1 - x.value * inv0) % p
        row1 = self.b.row(
            {"a": x, "b": inv0, "c": r}, {"q_mul_ab": 1, "q_c": 1, "q_constant": -1}
        )
        self.b.row({"a": x, "b": row1["c"]}, {"q_mul_ab": 1})
        return row1["c"]

    def is_equal(self, x: Cell, y: Cell) -> Cell:
        return self.is_zero(self.sub(x, y))

    # --- assertions ---------------------------------------------------
    def assert_equal(self, x: Cell, y: Cell) -> None:
        """Copy-constraint equality: zero rows (halo2 constrain_equal).
        A witness mismatch is NOT raised here — it surfaces as a copy
        failure in the mock prover / an invalid permutation argument in a
        real proof, mirroring halo2 semantics (negative tests rely on it)."""
        self.b.constrain_equal(x, y)

    def assert_zero(self, x: Cell) -> None:
        self.b.row({"a": x}, {"q_a": 1})

    def assert_one(self, x: Cell) -> None:
        self.b.row({"a": x}, {"q_a": 1, "q_constant": -1})

    def assert_bit(self, x: Cell) -> None:
        out = self.b.row({"a": x, "b": x, "c": x}, {"q_mul_ab": 1, "q_c": -1})

    # --- linear combination -------------------------------------------
    def compose(self, terms: list[Term], constant: int = 0) -> Cell:
        """result = sum(coeff_i * cell_i) + constant.

        <=3 terms: one row (terms in a..c, result in d).
        Otherwise rows of 4 terms chained through e/q_e_next, with a final
        row of <=3 terms + accumulator + result."""
        p = self.f.p
        constant = constant % p
        total = (sum(t.coeff * t.cell.value for t in terms) + constant) % p
        n = len(terms)
        if n <= 3:
            wires = {}
            sel = {"q_d": -1, "q_constant": constant}
            for w, t in zip(("a", "b", "c"), terms):
                wires[w] = t.cell
                sel[f"q_{w}"] = t.coeff
            wires["d"] = total
            return self.b.row(wires, sel)["d"]

        # chunking: first row 4 terms, middle rows 4 terms, final row <=3
        rest = terms[4:]
        k = len(rest) % 4
        if k == 0:
            final_chunk, middle = [], rest
        else:
            final_chunk, middle = rest[-k:], rest[:-k]

        acc = constant
        first = terms[:4]
        acc = (acc + sum(t.coeff * t.cell.value for t in first)) % p
        self.b.row(
            {w: t.cell for w, t in zip(("a", "b", "c", "d"), first)},
            {
                **{f"q_{w}": t.coeff for w, t in zip(("a", "b", "c", "d"), first)},
                "q_constant": constant,
                "q_e_next": -1,
            },
        )
        for off in range(0, len(middle), 4):
            chunk = middle[off : off + 4]
            wires = {w: t.cell for w, t in zip(("a", "b", "c", "d"), chunk)}
            wires["e"] = acc
            acc = (acc + sum(t.coeff * t.cell.value for t in chunk)) % p
            self.b.row(
                wires,
                {
                    **{f"q_{w}": t.coeff for w, t in zip(("a", "b", "c", "d"), chunk)},
                    "q_e": 1,
                    "q_e_next": -1,
                },
            )
        # final row: remaining terms + accumulator + result
        wires = {w: t.cell for w, t in zip(("a", "b", "c"), final_chunk)}
        wires["e"] = acc
        wires["d"] = total
        sel = {f"q_{w}": t.coeff for w, t in zip(("a", "b", "c"), final_chunk)}
        sel.update({"q_e": 1, "q_d": -1})
        return self.b.row(wires, sel)["d"]

    # --- bit decomposition --------------------------------------------
    def to_bits(self, x: Cell, nbits: int) -> list[Cell]:
        """LSB-first bit decomposition with per-bit booleanity and a
        recomposition equality (maingate to_bits semantics)."""
        v = x.value
        bits = [self.assign_bit((v >> i) & 1) for i in range(nbits)]
        composed = self.compose([Term(b, 1 << i) for i, b in enumerate(bits)])
        self.assert_equal(composed, x)
        return bits
