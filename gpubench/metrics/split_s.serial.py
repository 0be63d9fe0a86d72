"""split_s.serial: seconds a proof in the `split` span inside `prove` (a
split-mode key's quotient: its eight cosets and the inverse, enqueued),
over the window."""

from gpubench import program_spans

ROOT = "prove"


def read(run):
    return program_spans.per_proof(run, program_spans.leaf_total(run, ROOT, "split"))
