"""Columnar constraint-system builder (the TPU-first halo2 replacement).

Rather than halo2's cell-by-cell `Layouter` interpreter, circuits append
*rows* to columnar tables; the proving pipeline consumes whole columns as
device limb tensors.  One fixed gate family covers every circuit in the
framework (the reference likewise routes everything through
`maingate::MainGate` + `RangeChip`, src/lib.rs:138-152):

    q_a*a + q_b*b + q_c*c + q_d*d + q_e*e
      + q_mul_ab*a*b + q_mul_cd*c*d + q_e_next*e(w*X) + q_constant = 0

plus four tagged range lookups, one per wire column a..d:

    (tag_a(X), a(X) * u_a(X))  ⊆  (table_tag(X), table_value(X))

where `tag_*`/`u_*` are fixed columns (tag = bit-width, u = 0/1 activity).

Copy constraints are recorded as cell pairs and folded into permutation
cycles at keygen.  Witness values are Python ints (host bignum) and are
converted to device limb tensors once, at proving time.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields.prime import PrimeField

NUM_ADVICE = 5
# column index used for the public-input (instance) column in copy
# constraints and the permutation argument
INSTANCE_COL = NUM_ADVICE
ADVICE_NAMES = ("a", "b", "c", "d", "e")
SELECTOR_NAMES = (
    "q_a",
    "q_b",
    "q_c",
    "q_d",
    "q_e",
    "q_mul_ab",
    "q_mul_cd",
    "q_e_next",
    "q_constant",
)
TAG_NAMES = ("tag_a", "tag_b", "tag_c", "tag_d")
FIXED_NAMES = SELECTOR_NAMES + TAG_NAMES


@dataclass(frozen=True)
class Cell:
    """A witness cell: (advice column, row) plus its assigned value."""

    col: int
    row: int
    value: int


class Builder:
    def __init__(self, field: PrimeField):
        self.field = field
        self.advice: list[list[int]] = [[] for _ in range(NUM_ADVICE)]
        self.fixed: dict[str, list[int]] = {name: [] for name in FIXED_NAMES}
        self.copies: list[tuple[tuple[int, int], tuple[int, int]]] = []
        self.lookup_widths: set[int] = set()
        self.instance: list[int] = []  # public inputs (instance column values)
        self.rows = 0

    # ------------------------------------------------------------------
    def row(
        self,
        wires: dict | None = None,
        sel: dict | None = None,
        tags: dict | None = None,
    ) -> dict[str, Cell]:
        """Append one gate row.

        wires: maps 'a'..'e' to either an int (fresh witness value) or an
               existing Cell (value is copied in and a copy constraint is
               recorded).  Unlisted wires default to 0 (unconstrained).
        sel:   selector name -> coefficient (int, reduced mod p).
        tags:  'a'..'d' -> bit width for a range lookup on that wire.
        """
        p = self.field.p
        r = self.rows
        self.rows += 1
        out: dict[str, Cell] = {}
        wires = wires or {}
        for i, name in enumerate(ADVICE_NAMES):
            v = wires.get(name, 0)
            if isinstance(v, Cell):
                self.copies.append(((v.col, v.row), (i, r)))
                val = v.value
            else:
                val = v % p
            self.advice[i].append(val)
            out[name] = Cell(i, r, val)
        sel = sel or {}
        for name in SELECTOR_NAMES:
            self.fixed[name].append(sel.get(name, 0) % p)
        tags = tags or {}
        for i, name in enumerate(("a", "b", "c", "d")):
            w = tags.get(name, 0)
            if w:
                self.lookup_widths.add(w)
                assert 0 <= out[name].value < (1 << w), (
                    f"range violation: wire {name} row {r} value {out[name].value} "
                    f"not in [0, 2^{w})"
                )
            self.fixed[TAG_NAMES[i]].append(w)
        return out

    def expose_public(self, cell: Cell) -> int:
        """Bind a witness cell to the next public-input slot (halo2 instance
        column semantics: equality through the permutation argument).
        Returns the instance row index."""
        idx = len(self.instance)
        self.instance.append(cell.value)
        self.copies.append(((cell.col, cell.row), (INSTANCE_COL, idx)))
        return idx

    def constrain_equal(self, x: Cell, y: Cell) -> None:
        """Copy-constrain two cells (halo2 `constrain_equal`): forces their
        witness values equal through the permutation argument — zero rows."""
        self.copies.append(((x.col, x.row), (y.col, y.row)))

    # ------------------------------------------------------------------
    def permutation_cycles(self) -> list[list[tuple[int, int]]]:
        """Union-find over copy pairs -> list of cycles of (col, row)."""
        parent: dict[tuple[int, int], tuple[int, int]] = {}

        def find(x):
            root = x
            while parent.get(root, root) != root:
                root = parent[root]
            while parent.get(x, x) != x:
                parent[x], x = root, parent[x]
            return root

        for u, v in self.copies:
            ru, rv = find(u), find(v)
            if ru != rv:
                parent[ru] = rv
        groups: dict[tuple[int, int], list[tuple[int, int]]] = {}
        for cell in set(parent) | {v for pair in self.copies for v in pair}:
            groups.setdefault(find(cell), []).append(cell)
        return [sorted(g) for g in groups.values() if len(g) > 1]
