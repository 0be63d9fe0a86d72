"""lookup_s.serial: seconds a proof in the program's span `prove/lookup permuted`, over the
window (the span closes on a stream synchronize)."""

SPAN = "prove/lookup permuted"


def read(run):
    if SPAN not in run.spans or not run.proofs:
        return None
    return run.spans[SPAN] / run.proofs
