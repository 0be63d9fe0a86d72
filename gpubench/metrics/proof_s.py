"""proof_s: the window's seconds over the proofs it completed (host clock;
each request ends with torch.cuda.synchronize)."""

from gpubench import stats


def read(run):
    return stats.mean_over_window(run.window_s, run.proofs)
