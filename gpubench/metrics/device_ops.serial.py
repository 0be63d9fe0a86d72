"""device_ops.serial: device operations a proof over the traced requests:
every record of the profiler's trace on the card (each kernel, the
program's and torch's own, and each memcpy and memset) over the proofs."""


def read(run):
    t = run.trace
    if t is None or not t.proofs or not t.ops:
        return None
    return len(t.ops) / t.proofs
