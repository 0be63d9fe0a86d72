"""Latency statistics of a window."""

from __future__ import annotations

import math


def mean_over_window(window_s: float, completed: int):
    """The window's seconds over the work it completed (a mean latency for
    one client in a closed loop; a stall anywhere in the window counts)."""
    return window_s / completed if completed else None


def rate_over_window(window_s: float, completed: int):
    return completed / window_s if completed and window_s > 0 else None


def tail(values: list, q: float, min_beyond: int = 10):
    """The q-quantile by nearest rank, or None where fewer than min_beyond
    samples lie beyond it."""
    n = len(values)
    if not n:
        return None
    rank = max(1, math.ceil(q * n))
    if n - rank < min_beyond:
        return None
    return sorted(values)[rank - 1]

