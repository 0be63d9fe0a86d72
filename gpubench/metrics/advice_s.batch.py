"""advice_s.batch: seconds a proof in the program's span `prove_batch/advice commit`, over the
window (the span closes on a stream synchronize)."""

SPAN = "prove_batch/advice commit"


def read(run):
    if SPAN not in run.spans or not run.proofs:
        return None
    return run.spans[SPAN] / run.proofs
