"""idle_share.batch: 1 - (the union of the device's busy intervals) / (the traced
requests' wall time), from the profiler's trace."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    busy = t.busy_s()
    return 1.0 - busy / t.window_s if busy > 0 else None
