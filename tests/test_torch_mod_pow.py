"""mod_pow at k=17 as chip_smoke.py phase 5 builds it: the port's RSACircuit
from its own copy of bench.py's draw (`runtime/workloads.py`: seed 42,
T_BITS[("mod_pow", 17)] = 8)
against the JAX package's circuit from bench.py build_circuit itself:
the same rows, advice, fixed and instance columns, permutation cycles and
lookup widths."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)  # bench.py lives there

import bench  # noqa: E402
from delay_enc_tpu.utils.config import Config  # noqa: E402
from delay_enc_tpu_torch.plonk.keygen import min_k  # noqa: E402
from delay_enc_tpu_torch.runtime import workloads  # noqa: E402

K = 17


@pytest.fixture(scope="module")
def circuits():
    jax_side = bench.build_circuit("mod_pow", Config(), seed=42, k=K)
    port = workloads.build_circuit("mod_pow", K)
    return jax_side, port


def test_draw_is_bench_row(circuits):
    assert bench.T_BITS[("mod_pow", K)] == workloads.T_BITS[("mod_pow", K)] == 8
    jax_side, port = circuits
    assert jax_side.rows == port.rows == 62798
    # bench.py's k is an explicit choice: the circuit fits at k=16
    assert min_k(port) == 16


@pytest.mark.parametrize("part", ["advice", "fixed", "instance"])
def test_columns_identical(circuits, part):
    jax_side, port = circuits
    want, got = getattr(jax_side, part), getattr(port, part)
    if part == "fixed":
        assert list(got) == list(want)  # the same names in the same order
        want, got = list(want.values()), list(got.values())
    elif part == "instance":
        want, got = [want], [got]
    assert [[int(v) for v in c] for c in got] == [[int(v) for v in c] for c in want]


def test_permutation_and_lookups_identical(circuits):
    jax_side, port = circuits
    assert port.permutation_cycles() == jax_side.permutation_cycles()
    assert port.lookup_widths == jax_side.lookup_widths
