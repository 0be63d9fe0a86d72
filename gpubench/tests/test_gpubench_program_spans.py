"""The readers of the program's spans and counters inside the prover's
phases: each gives its window total over the proofs from a hand-made run,
and nothing where its names are absent, as in a program without them."""

import pytest

from gpubench import registry
from gpubench.harness import Run

SERIAL = {
    "prove": 1.0,
    "prove/advice commit": 0.5,
    "prove/advice commit/columns": 0.06,
    "prove/advice commit/to_mont": 0.04,
    "prove/advice commit/fold": 0.3,
    "prove/advice commit/fold/device wait": 0.1,
    "prove/lookup permuted/columns/to_mont": 0.01,
    "prove/lookup permuted/permute": 0.2,
    "prove/lookup permuted/to_mont": 0.03,
    "prove/quotient/fold": 0.2,
    "prove/quotient/fold/device wait": 0.05,
    "prove/evals/device wait": 0.02,
    # none of these is read
    "prove/fine/advice to_mont": 5.0,
    "keys/keygen/to_mont": 9.0,
    "warm/proof/prove/advice commit/to_mont": 7.0,
}
COUNTERS = {"#htod bytes": 63_000_000, "#htod copies": 30, "#dtoh bytes": 123,
            "#launches/plane_sums": 22, "#launches/ntt_fused": 24}
# seconds in the serial spans above, then the counters, over the window
WANT = {"to_mont_s": 0.08, "permute_s": 0.2, "fold_s": 0.5 - 0.15, "device_wait_s": 0.17,
        "htod_mb": 63.0, "launches": 46}
NAMES = [f"{base}.{kind}" for base in WANT for kind in ("serial", "batch")]


def run_with(spans, proofs=2):
    return Run(setup_s=1.0, window_s=10.0, proofs=proofs, spans=dict(spans))


def both_roots():
    """The serial spans, and the batch's under `prove_batch` at twice the
    seconds."""
    spans = dict(SERIAL)
    spans.update({"prove_batch" + n[len("prove"):]: 2 * v for n, v in SERIAL.items()
                  if n == "prove" or n.startswith("prove/")})
    return {**spans, **COUNTERS}


@pytest.mark.parametrize("name", NAMES)
def test_reader_reads_its_window_total_over_the_proofs(name):
    base, kind = name.split(".")
    seconds = base.endswith("_s")
    want = WANT[base] * (2 if kind == "batch" and seconds else 1) / 2
    assert registry.load_metric(name).read(run_with(both_roots())) == pytest.approx(want)


@pytest.mark.parametrize("name", NAMES)
def test_reader_reads_nothing_without_its_names(name):
    """The parent's names only (phase spans, no children, no counters),
    another root's, or no proofs: None."""
    reader = registry.load_metric(name)
    parent = {"prove/advice commit": 0.5, "prove/lookup permuted": 0.4,
              "prove_batch/advice commit": 1.0, "prove_batch/lookup permuted": 0.8}
    assert reader.read(run_with(parent)) is None
    other = "prove_batch" if name.endswith(".serial") else "prove"
    alone = {n.replace("prove", other, 1): v for n, v in SERIAL.items()
             if n == "prove" or n.startswith("prove/")}
    counted = {**alone, **COUNTERS}
    if name.startswith(("htod_mb", "launches")):
        assert reader.read(run_with(COUNTERS)) is None
    assert reader.read(run_with(counted)) is None
    assert reader.read(run_with(both_roots(), proofs=0)) is None
