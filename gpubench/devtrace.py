"""What the device did in a traced stretch of requests, from torch.profiler.

Busy time is the union of the intervals of every device operation (kernels,
copies, sets), so operations that overlap on several streams count once.
A kernel is named by its CUDA function through `KERNEL_SYMBOLS`; one that
the map does not know still counts as busy time, under its own name.  Idle
gaps are put under the program's span (`GLOBAL_METRICS`) in which they
fell.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

# CUDA function of the program's kernels -> the name the breakdown gives it
KERNEL_SYMBOLS = {
    "field_binary_kernel": "field (K-a)", "field_pow_kernel": "field_pow",
    "ntt_fused_kernel": "ntt_fused (K-b)", "scan_kernel": "field_scan",
    "quotient_kernel": "quotient_h (K6)", "fracs_kernel": "gp_fracs (K5)",
    "open_eval_kernel": "open_eval (K7)", "open_combine_kernel": "open_combine (K7)",
    "plane_sums_kernel": "plane_sums (K-c)", "plane_sums16_kernel": "plane_sums16",
    "pair_sel_kernel": "pair_sel", "g1_add_kernel": "g1_complete_add (K-d)",
    "fixed_base_kernel": "g1_fixed_base_mul", "shard_stages_kernel": "shard_stages (K12)",
    "shard_reshuffle_kernel": "shard_reshuffle (K12)",
    "mxu_split_kernel": "ntt_mxu_split (K11)", "mxu_product_kernel": "ntt_mxu_product (K11)",
    "mxu_reduce_kernel": "ntt_mxu_reduce (K11)",
}
# the commitments' kernels: the MSM's selector, plane sums and additions
MSM_FUNCTIONS = ("plane_sums_kernel", "plane_sums16_kernel", "pair_sel_kernel",
                 "g1_add_kernel")
REQUEST_MARK = "gpubench.request"


def kernel_function(event_name: str) -> str:
    """A device event's CUDA function as its bare name: without return
    type, namespaces, template arguments and parameters."""
    name = event_name.replace("(anonymous namespace)::", "")
    name = name.split("(")[0].split("<")[0].strip()
    return name.split(" ")[-1].split("::")[-1]


def op_name(event_name: str) -> str:
    """The breakdown's name of a device operation."""
    fn = kernel_function(event_name)
    if fn in KERNEL_SYMBOLS:
        return KERNEL_SYMBOLS[fn]
    if event_name.startswith(("Memcpy", "Memset")):
        return event_name
    return "other: " + event_name[:80]


def union(intervals) -> list:
    """Sorted, disjoint [start, end] covering the given intervals."""
    out = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def covered(intervals) -> float:
    return sum(e - s for s, e in union(intervals))


def clip(intervals, lo: float, hi: float) -> list:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


@dataclass
class Trace:
    """A traced stretch: device operations (name, start, end) and host spans
    (name, start, end) in seconds on one clock, the stretch's bounds, and
    the proofs it completed."""
    ops: list
    spans: list
    start: float
    end: float
    proofs: int

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_s(self, keep=None) -> float:
        """Seconds in which some device operation ran (only those whose
        event name `keep` accepts, where given)."""
        return covered(clip([(s, e) for n, s, e in self.ops if keep is None or keep(n)],
                            self.start, self.end))

    def device_ops(self, top: int = 10) -> list:
        """[[name, seconds]] of the operations that took most device time."""
        total: dict = {}
        for n, s, e in self.ops:
            total[op_name(n)] = total.get(op_name(n), 0.0) + (e - s)
        return [[n, t] for n, t in sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """[[span, seconds]]: the device's idle time in the stretch, each
        stretch of a gap put under the innermost host span open then."""
        busy = union(clip([(s, e) for _, s, e in self.ops], self.start, self.end))
        gaps, t = [], self.start
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < self.end:
            gaps.append((t, self.end))
        total: dict = {}
        for s, e in gaps:
            cuts = sorted({s, e, *(b for _, ss, se in self.spans for b in (ss, se) if s < b < e)})
            for a, b in zip(cuts, cuts[1:]):
                mid = (a + b) / 2
                inside = [(se - ss, n) for n, ss, se in self.spans if ss <= mid <= se]
                label = min(inside)[1] if inside else "outside the program's spans"
                total[label] = total.get(label, 0.0) + (b - a)
        return [[n, t] for n, t in sorted(total.items(), key=lambda kv: -kv[1])[:top]]


class SpanRecorder:
    """Records the program's spans with their times while installed: wraps
    `metrics.add(name, seconds)`, which the program calls as a span closes."""

    def __init__(self, metrics):
        self.metrics = metrics
        self.spans: list = []

    def __enter__(self):
        inner = self.metrics.add

        def add(name, seconds):
            now = time.time()
            self.spans.append((name, now - seconds, now))
            return inner(name, seconds)

        self.metrics.add = add
        return self

    def __exit__(self, *exc):
        del self.metrics.add  # the class's method again
        return False


def traced(run_request, requests: int, metrics, sync) -> Trace:
    """Run `requests` requests under torch.profiler; run_request(i) returns
    the proofs it made."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    proofs, host_marks = [], []
    sync()
    recorder = SpanRecorder(metrics) if metrics is not None else contextlib.nullcontext()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, recorder:
        for i in range(requests):
            t0 = time.time()
            with record_function(REQUEST_MARK):
                proofs.append(run_request(i))
                sync()
            host_marks.append((t0, time.time()))
    ops, marks = [], []
    for e in prof.events():
        start, end = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type == DeviceType.CUDA:
            # a host range shown on the device's timeline is no device work
            if not getattr(e, "is_user_annotation", False) and e.name != REQUEST_MARK:
                ops.append((e.name, start, end))
        elif e.name == REQUEST_MARK:
            marks.append((start, end))
    marks.sort()
    if not marks:
        raise RuntimeError("the profiler recorded no request marks")
    # the host clock's spans onto the profiler's clock, by the first mark
    offset = marks[0][0] - host_marks[0][0]
    spans = [(n, s + offset, e + offset) for n, s, e in getattr(recorder, "spans", [])]
    return Trace(ops=ops, spans=spans, start=marks[0][0], end=marks[-1][1],
                 proofs=sum(len(p) for p in proofs))
