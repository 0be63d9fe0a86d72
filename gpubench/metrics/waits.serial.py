"""waits.serial: the proving thread's blocking reads of a result back to the
host a proof (the program's `device waits` counter, one a read), over a
window in which `prove` ran."""

from gpubench import program_spans

ROOT = "prove"


def read(run):
    return program_spans.per_proof(run, program_spans.counter(run, ROOT, "device waits"))
