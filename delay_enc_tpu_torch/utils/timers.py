"""Tracing / metrics utilities: the port's one registry of spans and counters.

Spans (`Metrics.span`) nest: a span opened while another is open in the
same thread is named `<parent's name>/<name>`.  A span opened with none
open is a root and takes a fresh request id, which its descendants carry
(`create_proof` opens the root `prove`, `create_proofs_batched` the root
`prove_batch`; each thread of the pipelined prover its own `prove`).  A
span's duration comes from `time.perf_counter_ns`, and each span closes by
calling `add(name, seconds)`, which adds its seconds to a per-name total:
a caller that wraps `add` sees every span as it closes.  Given the device
it ran on, a span first waits for the calling thread's current stream, so
it measures its device work and not only its enqueue.

Inside a `record()` block every closed span is also kept as a `Span`
(request id, name, parent's name, start and end in nanoseconds); while a
torch profiler is active each span is also a `record_function` range named
`<name> (request <id>)`, so an exported trace shows the program's spans
over the kernels on the profiler's clock.  Without either, a span costs a
clock read on each side and an `add`.

Counters (`count`) sit beside the spans: the bytes copied from the host to
the device and the blocking reads of a result back to the host (`device
waits`, one a `to_numpy` call, through which every such read of a proof
goes; `ops/limbs.py`), the kernels' launches under
`launches/<kernel>` (`ops/_cuda.py`) and the split quotient's cosets
(`split cosets`, `plonk/kernels.py`).  `snapshot` gives the span totals and
the counters, each counter under `#<name>`, so that a before/after
difference of two snapshots covers both; `clear` drops both, as the JAX
package's does.

Totals are shared by every thread and added under a lock.  Where proofs
run concurrently (`plonk/pipeline.py`), a name's seconds are the sum over
the threads that ran it: they can exceed the wall time that passed.
`collect` keeps one thread's span totals apart as well (the daemon's jobs
and its warmups, `runtime/daemon.py`); `dump` gives spans and counters as
JSON in the JAX package's shape.
"""

from __future__ import annotations

import itertools
import json
import math
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import NamedTuple

from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function

COUNTER = "#"  # prefix of a counter in `snapshot`
# the spacing of time.time()'s floats (2^-22 s until 2038): a span's
# seconds are a whole number of it, so a reader that places a span on that
# clock, end minus seconds (`gpubench/devtrace.py:SpanRecorder`), gets its
# seconds back exactly, as it did from the time.time() differences before
TICK = math.ulp(time.time())


class Span(NamedTuple):
    """One closed span, as `record` keeps it."""
    request: int
    name: str
    parent: str | None
    start_ns: int
    end_ns: int


@dataclass
class Metrics:
    spans: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False, compare=False)
    _local: threading.local = field(default_factory=threading.local, repr=False, compare=False)
    _requests: itertools.count = field(default_factory=lambda: itertools.count(1), repr=False,
                                       compare=False)
    _records: tuple = field(default=(), repr=False, compare=False)

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

    @contextmanager
    def record(self):
        """Yield a list that receives a `Span` for every span that closes,
        in any thread, inside the block."""
        mine: list = []
        with self._lock:
            self._records = self._records + (mine,)
        try:
            yield mine
        finally:
            with self._lock:
                self._records = tuple(r for r in self._records if r is not mine)

    def count(self, name: str, delta: int = 1) -> None:
        """Add delta to a counter; safe from any thread."""
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + delta

    def reset(self, prefix: str) -> None:
        """Drop the counters whose names start with prefix."""
        with self._lock:
            for name in [n for n in self.counters if n.startswith(prefix)]:
                del self.counters[name]

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
        """A copy of the span totals and of the counters (`#<name>`),
        consistent under concurrent `add`s and `count`s."""
        with self._lock:
            return {**self.spans, **{COUNTER + n: v for n, v in self.counters.items()}}

    @contextmanager
    def span(self, name: str, device=None):
        """Time the block as `name` inside the calling thread's open span,
        or as a root with a fresh request id; with `device`, wait for the
        thread's current stream on it before the block's end is read."""
        local = self._local
        parent = getattr(local, "path", None)
        request = local.request if parent is not None else next(self._requests)
        full = name if parent is None else f"{parent}/{name}"
        local.path, local.request = full, request
        ranged = None
        if _profiler_enabled():
            ranged = record_function(f"{full} (request {request})")
            ranged.__enter__()
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            if device is not None:
                from .device import sync_stream

                sync_stream(device)
            t1 = time.perf_counter_ns()
            if ranged is not None:
                ranged.__exit__(None, None, None)
            local.path = parent
            self.add(full, round((t1 - t0) * 1e-9 / TICK) * TICK)
            for kept in self._records:
                kept.append(Span(request, full, parent, t0, t1))


GLOBAL_METRICS = Metrics()
