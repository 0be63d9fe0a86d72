"""proof_p90_s: the 90th percentile, by nearest rank, of the latencies of
the window's requests of one proof each, call to synchronize; nothing where
fewer than five lie beyond it (the 50 s window has held 109-162 proofs,
11-16 beyond)."""

from gpubench import stats


def read(run):
    if run.batch != 1:
        return None
    return stats.tail(run.latencies, 0.9, min_beyond=5)
