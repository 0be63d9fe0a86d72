"""msm_ms.batch: device milliseconds a proof of the commitments' kernels (the
selector, both plane sums, the point additions) over the traced requests:
the union of their intervals in the profiler's trace."""

from gpubench import devtrace


def read(run):
    t = run.trace
    if t is None or not t.proofs:
        return None
    busy = t.busy_s(lambda name: devtrace.kernel_function(name) in devtrace.MSM_FUNCTIONS)
    return busy * 1e3 / t.proofs if busy > 0 else None
