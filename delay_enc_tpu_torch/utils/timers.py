"""Tracing / metrics utilities.

Phase timing as in the JAX package: `Metrics.span` accumulates wall-clock
seconds per name.  Work queued on a card is fenced with
`torch.cuda.synchronize` when the span is given the device it ran on, so
a span measures the device work and not only its enqueue.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class Metrics:
    spans: dict = field(default_factory=dict)

    @contextmanager
    def span(self, name: str, device=None):
        t0 = time.time()
        try:
            yield
        finally:
            if device is not None:
                from .device import synchronize

                synchronize(device)
            self.spans[name] = self.spans.get(name, 0.0) + (time.time() - t0)


GLOBAL_METRICS = Metrics()
