"""htod_mb.batch: megabytes (1e6 B) a proof of the program's `htod bytes` counter
(host-to-device copies), over a window in which `prove_batch` ran."""

from gpubench import program_spans

ROOT = "prove_batch"


def read(run):
    return program_spans.per_proof(run, program_spans.counter(run, ROOT, "htod bytes"), 1e-6)
