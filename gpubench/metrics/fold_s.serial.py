"""fold_s.serial: seconds a proof in the `fold` spans inside `prove` less their
`device wait` children: the host's fold of the plane sums into commitments,
over the window."""

from gpubench import program_spans

ROOT = "prove"


def read(run):
    return program_spans.per_proof(run, program_spans.self_total(run, ROOT, "fold", "device wait"))
