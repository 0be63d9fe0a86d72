"""Tracing / metrics utilities.

Phase timing as in the JAX package: `Metrics.span` accumulates wall-clock
seconds per name.  Work queued on a card is fenced by synchronising the
calling thread's current stream when the span is given the device it ran
on, so a span measures its device work and not only its enqueue, and does
not wait for other threads' streams.

Spans and counters (`count`) are shared by every thread and added under a
lock (`add`); `dump` gives both as JSON in the JAX package's shape.  Where
proofs run concurrently (`plonk/pipeline.py`), a name's seconds are the sum
over the threads that ran it: they can exceed the wall time that passed.
`collect` keeps one thread's spans apart as well (the daemon's jobs and
its warmups, `runtime/daemon.py`).
"""

from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class Metrics:
    spans: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False, compare=False)
    _local: threading.local = field(default_factory=threading.local, repr=False, compare=False)

    def add(self, name: str, seconds: float) -> None:
        """Add seconds to a span; safe from any thread."""
        with self._lock:
            self.spans[name] = self.spans.get(name, 0.0) + seconds
        sink = getattr(self._local, "sink", None)
        if sink is not None:
            sink[name] = sink.get(name, 0.0) + seconds

    @contextmanager
    def collect(self):
        """Yield a dict that receives the spans the calling thread adds
        inside the block (they go to `spans` as well); other threads' spans
        stay out of it."""
        outer = getattr(self._local, "sink", None)
        self._local.sink = mine = {}
        try:
            yield mine
        finally:
            self._local.sink = outer

    def count(self, name: str, delta: int = 1) -> None:
        """Add delta to a counter; safe from any thread."""
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + delta

    def dump(self) -> str:
        """Spans and counters as JSON, {"spans_s": …, "counters": …}."""
        with self._lock:
            return json.dumps({"spans_s": dict(self.spans), "counters": dict(self.counters)},
                              indent=2)

    def clear(self) -> None:
        with self._lock:
            self.spans.clear()
            self.counters.clear()

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
