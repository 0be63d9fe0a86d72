"""RangeChip: lookup-based range checks over the columnar builder.

Re-implements the capability of `maingate::RangeChip` as used by the
reference (range assign with composition/overflow sublimbs,
big_integer/chip.rs:65-85, 1224-1253; load_table src/lib.rs:207-208):

 * `assign(value, sublimb_bits, bit_len)` decomposes the value LSB-first
   into `bit_len // sublimb_bits` sublimbs plus an optional overflow sublimb
   of `bit_len % sublimb_bits` bits.  Sublimbs are laid out 4-per-row on the
   a..d wires with their bit-width written into the fixed tag columns (each
   tagged wire is range-looked-up against the shared (tag, value) table),
   and simultaneously composed into the returned value cell through the
   e/q_e_next chain — the same rows do double duty, so row costs match the
   reference's dense layout.
 * The lookup table itself is materialized at keygen from the set of tag
   widths the circuit used (Builder.lookup_widths).
"""

from __future__ import annotations

from .builder import Builder, Cell


class RangeChip:
    def __init__(self, builder: Builder):
        self.b = builder
        self.f = builder.field

    def decompose(self, value: int, sublimb_bits: int, bit_len: int):
        """LSB-first (width, sublimb_value) pairs."""
        num_full = bit_len // sublimb_bits
        overflow = bit_len % sublimb_bits
        out = []
        v = value
        for _ in range(num_full):
            out.append((sublimb_bits, v & ((1 << sublimb_bits) - 1)))
            v >>= sublimb_bits
        if overflow:
            out.append((overflow, v & ((1 << overflow) - 1)))
            v >>= overflow
        assert v == 0, f"value {value} does not fit in {bit_len} bits"
        return out

    def assign(self, value: int, sublimb_bits: int, bit_len: int) -> Cell:
        """Range-checked assignment; returns the composed value cell."""
        assert 0 <= value < (1 << bit_len), f"{value} out of range 2^{bit_len}"
        sub = self.decompose(value, sublimb_bits, bit_len)
        coeffs = []
        off = 0
        for w, _ in sub:
            coeffs.append(1 << off)
            off += w
        p = self.f.p
        n = len(sub)
        total = value % p

        if n <= 3:
            wires = {}
            sel = {"q_d": -1}
            tags = {}
            for wire, (w, sv), c in zip(("a", "b", "c"), sub, coeffs):
                wires[wire] = sv
                sel[f"q_{wire}"] = c
                tags[wire] = w
            wires["d"] = total
            return self.b.row(wires, sel, tags)["d"]

        rest = sub[4:]
        rest_coeffs = coeffs[4:]
        k = len(rest) % 4
        if k == 0:
            final, middle = [], list(zip(rest, rest_coeffs))
        else:
            pairs = list(zip(rest, rest_coeffs))
            final, middle = pairs[-k:], pairs[:-k]

        first = list(zip(sub[:4], coeffs[:4]))
        acc = sum(c * sv for (w, sv), c in first) % p
        self.b.row(
            {wire: sv for wire, ((w, sv), c) in zip(("a", "b", "c", "d"), first)},
            {
                **{f"q_{wire}": c for wire, ((w, sv), c) in zip(("a", "b", "c", "d"), first)},
                "q_e_next": -1,
            },
            {wire: w for wire, ((w, sv), c) in zip(("a", "b", "c", "d"), first)},
        )
        for off_i in range(0, len(middle), 4):
            chunk = middle[off_i : off_i + 4]
            wires = {wire: sv for wire, ((w, sv), c) in zip(("a", "b", "c", "d"), chunk)}
            wires["e"] = acc
            acc = (acc + sum(c * sv for (w, sv), c in chunk)) % p
            self.b.row(
                wires,
                {
                    **{f"q_{wire}": c for wire, ((w, sv), c) in zip(("a", "b", "c", "d"), chunk)},
                    "q_e": 1,
                    "q_e_next": -1,
                },
                {wire: w for wire, ((w, sv), c) in zip(("a", "b", "c", "d"), chunk)},
            )
        wires = {wire: sv for wire, ((w, sv), c) in zip(("a", "b", "c"), final)}
        wires["e"] = acc
        wires["d"] = total
        sel = {f"q_{wire}": c for wire, ((w, sv), c) in zip(("a", "b", "c"), final)}
        sel.update({"q_e": 1, "q_d": -1})
        tags = {wire: w for wire, ((w, sv), c) in zip(("a", "b", "c"), final)}
        return self.b.row(wires, sel, tags)["d"]

    def load_table(self) -> None:
        """API-parity no-op: the (tag, value) table is derived at keygen from
        Builder.lookup_widths (reference loads it during synthesize,
        src/lib.rs:207-208)."""


def build_table(lookup_widths) -> tuple[list[int], list[int]]:
    """(table_tag, table_value) columns: the (0,0) inactive row plus each
    width's full range."""
    tags, values = [0], [0]
    for w in sorted(lookup_widths):
        tags.extend([w] * (1 << w))
        values.extend(range(1 << w))
    return tags, values
