"""to_mont_s.batch: seconds a proof in every `to_mont` span inside `prove_batch`
(the int-to-Montgomery conversions), over the window."""

from gpubench import program_spans

ROOT = "prove_batch"


def read(run):
    return program_spans.per_proof(run, program_spans.leaf_total(run, ROOT, "to_mont"))
