"""launches.serial: hand-kernel launches a proof (the program's
`launches/<kernel>` counters), over a window in which `prove` ran."""

from gpubench import program_spans

ROOT = "prove"


def read(run):
    return program_spans.per_proof(run, program_spans.counter(run, ROOT, "launches/"))
