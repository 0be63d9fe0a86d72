"""ntt_ms.serial: device milliseconds a proof of K-b (`ntt_fused_kernel`:
every transform, a split key's coset transforms and 2^21 inverse among
them) over the traced requests, the union of its intervals in the
profiler's trace."""

from gpubench import devtrace


def read(run):
    t = run.trace
    if t is None or not t.proofs:
        return None
    busy = t.busy_s(lambda name: devtrace.kernel_function(name) == "ntt_fused_kernel")
    return busy * 1e3 / t.proofs if busy > 0 else None
