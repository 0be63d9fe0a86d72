"""The cell pose_enc_k11.serial on the CPU: its configuration and metrics,
its statement against its pin, a statement with no range table run end to
end at a tiny size (the lookup table the inactive row alone), and the
readers of the blocking reads and of the device's operations, on hand-made
runs."""

import time

import pytest
import torch

from gpubench import check, devtrace, harness, registry
from gpubench.harness import Run
from gpubench.reference import plonk as ref

from . import tiny

BENCH = registry.load_benchmark()
CELL = "pose_enc_k11.serial"
CONFIG = registry.load_config(BENCH, "pose_enc_k11")
SEED = 2**33 + 5
# the k=7 test circuit of tiny.py without its RangeChip: 13 rows, every
# lookup row untagged
NO_RANGE = {"name": "tiny_no_range", "workload": "tiny_no_range", "k": 5, "circuit_seed": 0,
            "rows": 13, "statement_blake2b": "16d0dd94c6d3ab66323a3ccdf9ac77ab"}
KC = "void (anonymous namespace)::plane_sums_kernel(msm::Planes)"
TORCH_OP = "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<int>>"


def build_no_range(config=None):
    from delay_enc_tpu_torch import cs
    from delay_enc_tpu_torch.fields import FR

    b = cs.Builder(FR)
    mg = cs.MainGate(b)
    x, y = mg.assign_value(7), mg.assign_value(11)
    s, m = mg.add(x, y), mg.mul(x, y)
    acc = mg.compose([cs.Term(x, 2), cs.Term(y, 3), cs.Term(s, 1), cs.Term(m, 5)], constant=9)
    sel = mg.select(s, m, mg.assign_bit(1))
    mg.assert_equal(sel, s)
    mg.assert_one(mg.is_equal(acc, mg.assign_value(acc.value)))
    return b


def test_the_cell_runs_the_configuration():
    cell = registry.find_cell(BENCH, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("pose_enc_k11", "serial", 1)
    assert (CONFIG["workload"], CONFIG["k"], CONFIG["circuit_seed"]) == ("pose_enc", 11, 42)
    assert (CONFIG["message_elements"], CONFIG["lookup_widths"]) == (2, [])
    assert CONFIG["quotient"] == "fused" and CONFIG["reduced"] == []
    names = [m["name"] for m in registry.cell_metrics(BENCH, CELL, True)]
    assert names == ["advice_s.serial", "lookup_s.serial", "msm_ms.serial", "idle_share.serial",
                     "to_mont_s.serial", "permute_s.serial", "fold_s.serial",
                     "device_wait_s.serial", "htod_mb.serial", "launches.serial",
                     "waits.serial", "device_ops.serial"]
    assert [m["name"] for m in registry.cell_metrics(BENCH, CELL, False)] == \
        ["proof_s", "proof_p90_s", "setup_s"]


@pytest.mark.parametrize("cell", ["delay_enc_k16.serial", "mod_pow_k17.serial",
                                  "delay_enc_k18.serial", CELL])
def test_every_serial_cell_reads_the_new_metrics(cell):
    names = {m["name"] for m in registry.cell_metrics(BENCH, cell, True)}
    assert {"waits.serial", "device_ops.serial"} <= names


def test_statement_matches_its_pin():
    """The statement harness.default_build makes (about 4 s): 1,448 rows,
    no lookup width, no public input, and the pinned hash."""
    statement = harness.statement_of(harness.default_build(CONFIG), CONFIG["k"])
    assert statement["rows"] == CONFIG["rows"] == 1448
    assert statement["lookup_widths"] == CONFIG["lookup_widths"] == []
    assert statement["instance"] == []
    assert check.digest(statement) == CONFIG["statement_blake2b"]


def test_a_statement_with_no_range_table_end_to_end():
    """The program's lookup path and the reference's one-row table held to
    each other: a run of the tiny circuit without its range chip passes
    every check."""
    b = build_no_range()
    assert not b.lookup_widths
    assert ref.lookup_table(b.lookup_widths) == ([0], [0])
    assert not any(v for name, col in b.fixed.items() if name.startswith("tag_") for v in col)
    es = registry.cell_metrics(BENCH, CELL, False)
    readers = {m["name"]: registry.load_metric(m["name"]) for m in es}
    mix = dict(registry.load_traffic("serial"), check_sample=3)
    res = harness.run_cell(dict(tiny.CELL, name="tiny_no_range.serial", config="tiny_no_range"),
                           NO_RANGE, mix, SEED, 0.01, False, es, readers, torch.device("cpu"),
                           time.time(), build=build_no_range)
    assert res["correct"] is True and res["failed"] == 0
    assert {n: c["value"] for n, c in res["checks"].items()} == {
        "statement": 0, "vk_diff": 0, "rejected": 0, "missing": 0, "repeated": 0}


def reader(name):
    return registry.load_metric(name).read


def test_waits_reader():
    read = reader("waits.serial")
    spans = {"prove": 3.0, "prove/gwc": 1.0, "#device waits": 32, "#htod bytes": 7}
    assert read(Run(setup_s=1.0, window_s=50.0, proofs=4, spans=spans)) == 8
    assert read(Run(setup_s=1.0, window_s=50.0, proofs=0, spans=spans)) is None
    # a program without the counter, or a window in which no proof ran
    assert read(Run(setup_s=1.0, window_s=50.0, proofs=4,
                    spans={n: v for n, v in spans.items() if n != "#device waits"})) is None
    assert read(Run(setup_s=1.0, window_s=50.0, proofs=4,
                    spans={"prove_batch/gwc": 1.0, "#device waits": 32})) is None
    assert read(Run(setup_s=1.0)) is None


def trace(ops, proofs=2):
    return devtrace.Trace(ops=ops, spans=[], start=0.0, end=1.0, proofs=proofs)


def test_device_ops_reader():
    """Every operation on the card counts, the program's kernels, torch's
    own, copies and sets, overlapping or not, over the proofs."""
    read = reader("device_ops.serial")
    ops = [(KC, 0.10, 0.11), (KC, 0.105, 0.12), (TORCH_OP, 0.2, 0.21),
           ("Memcpy HtoD (Pageable -> Device)", 0.0, 0.1), ("Memset (Device)", 0.3, 0.31)]
    assert read(Run(setup_s=1.0, proofs=9, trace=trace(ops))) == pytest.approx(2.5)
    assert read(Run(setup_s=1.0, proofs=9, trace=trace(ops, proofs=4))) == pytest.approx(1.25)
    assert read(Run(setup_s=1.0, proofs=9, trace=trace([]))) is None
    assert read(Run(setup_s=1.0, proofs=9, trace=trace(ops, proofs=0))) is None
    assert read(Run(setup_s=1.0, proofs=9)) is None
