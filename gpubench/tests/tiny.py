"""A tiny cell for the CPU tests: the k=7 test circuit of the program's own
tests (14 rows, one lookup width), proved at k=5 on the plain path."""

from __future__ import annotations

CELL = {"name": "tiny.serial", "config": "tiny", "traffic": "serial", "chips": 1}
CONFIG = {"name": "tiny", "workload": "tiny", "k": 5, "circuit_seed": 0, "rows": 14,
          "statement_blake2b": "7066a42716aa62ecf5088056817f285a"}


def build(config=None):
    from delay_enc_tpu_torch import cs
    from delay_enc_tpu_torch.fields import FR

    b = cs.Builder(FR)
    mg, rc = cs.MainGate(b), cs.RangeChip(b)
    x, y = mg.assign_value(7), mg.assign_value(11)
    s, m = mg.add(x, y), mg.mul(x, y)
    acc = mg.compose([cs.Term(x, 2), cs.Term(y, 3), cs.Term(s, 1), cs.Term(m, 5)], constant=9)
    sel = mg.select(s, m, mg.assign_bit(1))
    mg.assert_equal(sel, s)
    rc.assign(45, 2, 6)
    mg.assert_one(mg.is_equal(acc, mg.assign_value(acc.value)))
    return b
