"""device_wait_s.serial: seconds a proof the proving thread blocked in a `device
wait` span inside `prove` (a read of a result back to the host, behind the
stream's queued work), over the window."""

from gpubench import program_spans

ROOT = "prove"


def read(run):
    return program_spans.per_proof(run, program_spans.leaf_total(run, ROOT, "device wait"))
