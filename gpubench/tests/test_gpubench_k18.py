"""The cell delay_enc_k18.serial on the CPU: its configuration's statement
against its pin, the plain reference's key of it against the JAX package's
golden (committed by the program's tests), and the readers of the split
quotient's span and of K6's and K-b's device time, on hand-made runs."""

import os

import numpy as np
import pytest

from gpubench import check, devtrace, harness, registry
from gpubench.harness import Run
from gpubench.reference import plonk as ref

BENCH = registry.load_benchmark()
CONFIG = registry.load_config(BENCH, "delay_enc_k18")
GOLDEN = os.path.join(registry.ROOT, "tests", "data", "torch_port_vk_delay_enc_k18.npz")
K6 = "void (anonymous namespace)::quotient_kernel(prow::QuotientIn, prow::Batch)"
KB = "void (anonymous namespace)::ntt_fused_kernel(unsigned int const*, unsigned int*)"
MSM = "void (anonymous namespace)::plane_sums_kernel(msm::Planes)"


@pytest.fixture(scope="module")
def statement():
    """The configuration's statement as the harness builds it (about 8 s)."""
    b = harness.default_build(CONFIG)
    return harness.statement_of(b, CONFIG["k"])


def test_the_cell_runs_the_configuration():
    cell = registry.find_cell(BENCH, "delay_enc_k18.serial")
    assert cell["config"] == "delay_enc_k18" and cell["traffic"] == "serial"
    assert (CONFIG["workload"], CONFIG["k"], CONFIG["t_bits"]) == ("delay_enc", 18, 31)
    assert CONFIG["quotient"] == "split"
    names = [m["name"] for m in registry.cell_metrics(BENCH, cell["name"], True)]
    assert {"split_s.serial", "quotient_ms.serial", "ntt_ms.serial", "idle_share.serial",
            "permute_s.serial"} <= set(names)
    assert [m["name"] for m in registry.cell_metrics(BENCH, cell["name"], False)] == \
        ["proof_s", "setup_s"]


def test_statement_matches_its_pin(statement):
    assert statement["rows"] == CONFIG["rows"] == 241348
    assert check.digest(statement) == CONFIG["statement_blake2b"]


def test_reference_vk_equals_the_jax_package(statement):
    """The reference's key of the statement at the golden's tau (about
    12 s) is the JAX package's keygen of bench.py's circuit."""
    if not os.path.exists(GOLDEN):
        pytest.skip(f"{GOLDEN} is not in this checkout")
    z = np.load(GOLDEN)
    assert (int(z["seed"]), int(z["t_bits"]), int(z["rows"])) == \
        (CONFIG["circuit_seed"], CONFIG["t_bits"], CONFIG["rows"])
    vk = ref.verifying_key(statement, int(str(z["tau"]), 16))

    def points(arr):
        return [None if not row.any() else
                tuple(int.from_bytes(row[j].tobytes(), "little") for j in range(2))
                for row in arr]

    assert list(z["fixed_names"]) == list(ref.ALL_FIXED)
    assert [vk.fixed_points[n] for n in ref.ALL_FIXED] == points(z["fixed"])
    assert vk.sigma_points == points(z["sigma"])
    assert vk.transcript_repr == int(str(z["transcript_repr"]))


def reader(name):
    return registry.load_metric(name).read


def test_split_reader():
    read = reader("split_s.serial")
    spans = {"prove": 3.0, "prove/quotient": 1.0, "prove/quotient/split": 0.012,
             "prove/quotient/columns": 0.2, "warm/proof/prove/quotient/split": 5.0,
             "prove_batch/quotient/split": 7.0}
    assert read(Run(setup_s=1.0, window_s=50.0, proofs=4, spans=spans)) == \
        pytest.approx(0.003)
    fused = {n: v for n, v in spans.items() if n != "prove/quotient/split"}
    assert read(Run(setup_s=1.0, window_s=50.0, proofs=4, spans=fused)) is None
    assert read(Run(setup_s=1.0, window_s=50.0, proofs=0, spans=spans)) is None
    assert read(Run(setup_s=1.0)) is None


def trace(ops, proofs=2):
    return devtrace.Trace(ops=ops, spans=[], start=0.0, end=1.0, proofs=proofs)


@pytest.mark.parametrize("name,kernel,other", [("quotient_ms.serial", K6, KB),
                                               ("ntt_ms.serial", KB, K6)])
def test_kernel_readers(name, kernel, other):
    """The union of the kernel's intervals, two overlapping, over the
    proofs; another kernel's time is left out."""
    read = reader(name)
    ops = [(kernel, 0.10, 0.11), (kernel, 0.105, 0.12), (kernel, 0.50, 0.504),
           (other, 0.2, 0.3), (MSM, 0.11, 0.4), ("Memcpy HtoD (Pageable -> Device)", 0.0, 0.1)]
    assert read(Run(setup_s=1.0, proofs=9, trace=trace(ops))) == pytest.approx(12.0)
    assert read(Run(setup_s=1.0, proofs=9, trace=trace([o for o in ops if o[0] != kernel]))) \
        is None
    assert read(Run(setup_s=1.0, proofs=9, trace=trace(ops, proofs=0))) is None
    assert read(Run(setup_s=1.0, proofs=9)) is None
