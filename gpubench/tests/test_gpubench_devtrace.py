"""Busy time as the union of device intervals, the kernels' names, the idle
gaps by span."""

import time

import pytest

from gpubench import devtrace, registry
from gpubench.harness import Run


def test_union_counts_overlap_once():
    assert devtrace.union([(0, 2), (1, 3), (5, 6), (6, 7), (8, 8)]) == [[0, 3], [5, 7]]
    assert devtrace.covered([(0, 2), (1, 3), (0.5, 1.5)]) == 3


def trace(ops, spans=(), start=0.0, end=10.0, proofs=2):
    return devtrace.Trace(ops=list(ops), spans=list(spans), start=start, end=end, proofs=proofs)


def test_overlapping_streams_never_read_above_the_window():
    ops = [("plane_sums_kernel(int)", 0.0, 6.0), ("void ntt_fused_kernel<4>(x)", 2.0, 8.0),
           ("Memcpy HtoD (Pageable -> Device)", 1.0, 3.0)]
    t = trace(ops)
    assert t.busy_s() == 8.0
    assert t.busy_s() <= t.window_s
    idle = registry.load_metric("idle_share.serial").read(Run(setup_s=0, trace=t))
    assert idle == pytest.approx(0.2)


def test_busy_clipped_to_the_stretch():
    t = trace([("a", -5.0, 1.0), ("b", 9.0, 20.0)])
    assert t.busy_s() == 2.0


def test_msm_reads_only_the_commitments_kernels():
    ops = [("plane_sums_kernel(unsigned int const*)", 0.0, 0.004),
           ("pair_sel_kernel(x)", 0.004, 0.005), ("g1_add_kernel", 0.0045, 0.006),
           ("ntt_fused_kernel(x)", 0.006, 0.009), ("plane_sums16_kernel<1>(y)", 0.01, 0.012)]
    run = Run(setup_s=0, trace=trace(ops, end=0.02, proofs=2))
    for name in ("msm_ms.serial", "msm_ms.batch"):
        assert registry.load_metric(name).read(run) == pytest.approx(4.0)
    run = Run(setup_s=0, trace=trace([("ntt_fused_kernel", 0.0, 1.0)], proofs=1))
    assert registry.load_metric("msm_ms.serial").read(run) is None
    assert registry.load_metric("idle_share.batch").read(Run(setup_s=0, trace=None)) is None


def test_kernel_names():
    assert devtrace.kernel_function("void (anonymous namespace)::plane_sums_kernel<4u>(P)") \
        == "plane_sums_kernel"
    assert devtrace.op_name("quotient_kernel(int)") == "quotient_h (K6)"
    assert devtrace.op_name("Memcpy HtoD (Pageable -> Device)").startswith("Memcpy HtoD")
    assert devtrace.op_name("void at::native::vectorized_elementwise_kernel<4>(x)").startswith(
        "other: ")


def test_breakdown_and_gaps_by_span():
    ops = [("plane_sums_kernel", 1.0, 2.0), ("plane_sums_kernel", 2.5, 3.0),
           ("Memcpy HtoD (Pageable -> Device)", 6.0, 7.0)]
    spans = [("prove/advice commit", 0.0, 4.0), ("prove/lookup permuted", 4.0, 9.0),
             ("prove/fine/x", 4.5, 5.5)]
    t = trace(ops, spans)
    assert t.device_ops()[0] == ["plane_sums (K-c)", 1.5]
    gaps = dict(t.idle_gaps())
    assert gaps["prove/advice commit"] == pytest.approx(1.0 + 0.5 + 1.0)
    assert gaps["prove/lookup permuted"] == pytest.approx(0.5 + 0.5 + 2.0)
    assert gaps["prove/fine/x"] == pytest.approx(1.0)
    assert gaps["outside the program's spans"] == pytest.approx(1.0)
    assert len(t.device_ops(top=1)) == 1


def test_span_recorder_times_each_close():
    from delay_enc_tpu_torch.utils.timers import Metrics

    m = Metrics()
    with devtrace.SpanRecorder(m) as rec:
        with m.span("outer"):
            time.sleep(0.01)
    m.add("after", 1.0)
    assert [n for n, _, _ in rec.spans] == ["outer"]
    name, s, e = rec.spans[0]
    assert e - s == pytest.approx(m.spans["outer"])
    assert m.spans["after"] == 1.0
