"""proofs_per_s: the proofs the window completed over its seconds (host
clock)."""

from gpubench import stats


def read(run):
    return stats.rate_over_window(run.window_s, run.proofs)
