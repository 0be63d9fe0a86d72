"""Mock prover: a fast constraint-satisfaction checker over the witness
table (the `MockProver` / `mock_prover_verify` analog, reference
src/lib.rs:353, maingate::mock_prover_verify).

Checks, without any commitment machinery:
  1. the main-gate identity on every row (with the e(wX) rotation),
  2. copy-constraint cycles have equal witness values,
  3. every tagged wire's (tag, value) pair is in the range table.

Returns a list of failures (empty = satisfied); `mock_prove` raises on
failure for assert-style tests.
"""

from __future__ import annotations

from dataclasses import dataclass

from .builder import Builder, INSTANCE_COL
from .range import build_table


@dataclass
class MockFailure:
    kind: str  # "gate" | "copy" | "lookup"
    row: int
    detail: str


def mock_failures(b: Builder) -> list[MockFailure]:
    p = b.field.p
    n = b.rows
    adv = b.advice
    fx = b.fixed
    failures: list[MockFailure] = []

    for r in range(n):
        a, bb, c, d, e = (adv[i][r] for i in range(5))
        e_next = adv[4][r + 1] if r + 1 < n else 0
        v = (
            fx["q_a"][r] * a
            + fx["q_b"][r] * bb
            + fx["q_c"][r] * c
            + fx["q_d"][r] * d
            + fx["q_e"][r] * e
            + fx["q_mul_ab"][r] * a * bb
            + fx["q_mul_cd"][r] * c * d
            + fx["q_e_next"][r] * e_next
            + fx["q_constant"][r]
        ) % p
        if v != 0:
            failures.append(MockFailure("gate", r, f"gate identity = {v}"))

    def _cell_val(col, row):
        if col == INSTANCE_COL:
            return b.instance[row]
        return adv[col][row]

    for cycle in b.permutation_cycles():
        vals = {_cell_val(col, row) for col, row in cycle}
        if len(vals) > 1:
            failures.append(
                MockFailure("copy", cycle[0][1], f"cycle {cycle} has values {vals}")
            )

    if b.lookup_widths:
        tags, values = build_table(b.lookup_widths)
        table = set(zip(tags, values))
        for i, tag_name in enumerate(("tag_a", "tag_b", "tag_c", "tag_d")):
            col = b.fixed[tag_name]
            for r in range(n):
                t = col[r]
                if t and (t, adv[i][r]) not in table:
                    failures.append(
                        MockFailure(
                            "lookup", r, f"({t}, {adv[i][r]}) not in range table (wire {i})"
                        )
                    )
    return failures


def mock_prove(b: Builder, expect_error: bool = False) -> list[MockFailure]:
    failures = mock_failures(b)
    if expect_error:
        assert failures, "expected constraint failures but circuit is satisfied"
    else:
        assert not failures, f"constraint failures: {failures[:5]}"
    return failures
