"""permute_s.serial: seconds a proof in every `permute` span inside `prove` (the
lookup permutation), over the window."""

from gpubench import program_spans

ROOT = "prove"


def read(run):
    return program_spans.per_proof(run, program_spans.leaf_total(run, ROOT, "permute"))
