"""The latency statistics: the tail's sample count, a stall in the window,
the spread."""

import pytest

from gpubench import registry, stats
from gpubench.harness import Run


def test_tail_needs_ten_beyond():
    assert stats.tail(list(range(99)), 0.9) is None
    values = list(range(100, 0, -1))
    assert stats.tail(values, 0.9) == 90  # nearest rank 90: ten values beyond
    assert sum(v > 90 for v in values) == 10
    assert stats.tail([5.0] * 100, 0.9) == 5.0


def test_a_stall_moves_the_mean_and_the_tail():
    read = registry.load_metric("proof_s").read
    p90 = registry.load_metric("proof_p90_s").read
    steady = Run(setup_s=1.0, window_s=100 * 0.3, latencies=[0.3] * 100, proofs=100)
    stalled = Run(setup_s=1.0, window_s=99 * 0.3 + 5.0, latencies=[0.3] * 99 + [5.0],
                  proofs=100)
    assert read(steady) == pytest.approx(0.3)
    assert read(stalled) == pytest.approx(0.347)
    assert p90(steady) == p90(stalled) == 0.3  # one stall lies beyond the p90
    many = Run(setup_s=1.0, window_s=88 * 0.3 + 12 * 5.0, latencies=[0.3] * 88 + [5.0] * 12,
               proofs=100)
    assert p90(many) == 5.0
    slow = Run(setup_s=1.0, window_s=50.0, latencies=[0.5 + i / 1000 for i in range(50)],
               proofs=50)
    assert p90(slow) == 0.544  # rank 45 of 50, five beyond
    assert p90(Run(setup_s=1.0, window_s=49.0, latencies=[1.0] * 49, proofs=49)) is None


def test_rate_and_batch():
    rate = registry.load_metric("proofs_per_s").read
    p90 = registry.load_metric("proof_p90_s").read
    run = Run(setup_s=1.0, window_s=10.0, latencies=[1.0] * 100, proofs=40, batch=4)
    assert rate(run) == 4.0
    assert p90(run) is None  # a request of a batch is not one proof's latency
    assert rate(Run(setup_s=1.0)) is None


def test_span_readers_per_proof():
    advice = registry.load_metric("advice_s.serial").read
    batch = registry.load_metric("advice_s.batch").read
    run = Run(setup_s=1.0, proofs=8, spans={"prove/advice commit": 0.4,
                                            "prove_batch/advice commit": 0.8})
    assert advice(run) == pytest.approx(0.05)
    assert batch(run) == pytest.approx(0.1)
    assert advice(Run(setup_s=1.0, proofs=8)) is None
