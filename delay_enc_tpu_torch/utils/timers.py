"""Tracing / metrics utilities.

Phase timing as in the JAX package: `Metrics.span` accumulates wall-clock
seconds per name.  Work queued on a card is fenced by synchronising the
calling thread's current stream when the span is given the device it ran
on, so a span measures its device work and not only its enqueue, and does
not wait for other threads' streams.

Spans are shared by every thread and added under a lock (`add`).  Where
proofs run concurrently (`plonk/pipeline.py`), a name's seconds are the sum
over the threads that ran it: they can exceed the wall time that passed.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class Metrics:
    spans: dict = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False, compare=False)

    def add(self, name: str, seconds: float) -> None:
        """Add seconds to a span; safe from any thread."""
        with self._lock:
            self.spans[name] = self.spans.get(name, 0.0) + seconds

    def clear(self) -> None:
        with self._lock:
            self.spans.clear()

    def snapshot(self) -> dict:
        """A copy of the spans, consistent under concurrent `add`s."""
        with self._lock:
            return dict(self.spans)

    @contextmanager
    def span(self, name: str, device=None):
        t0 = time.time()
        try:
            yield
        finally:
            if device is not None:
                from .device import sync_stream

                sync_stream(device)
            self.add(name, time.time() - t0)


GLOBAL_METRICS = Metrics()
