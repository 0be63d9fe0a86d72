"""quotient_ms.serial: device milliseconds a proof of K6 (`quotient_kernel`:
one launch on the fused extended coset, eight on a split key's cosets) over
the traced requests, the union of its intervals in the profiler's trace."""

from gpubench import devtrace


def read(run):
    t = run.trace
    if t is None or not t.proofs:
        return None
    busy = t.busy_s(lambda name: devtrace.kernel_function(name) == "quotient_kernel")
    return busy * 1e3 / t.proofs if busy > 0 else None
