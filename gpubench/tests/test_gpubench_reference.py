"""The plain reference against two witnesses: the JAX package's verifying
keys of the benchmark's statements (committed by the program's tests), and
the program's keys and proofs at a tiny size on the CPU."""

import os

import numpy as np
import pytest

from gpubench.reference import bn254, plonk as ref

from . import tiny

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_vk_{}_k{}.npz")


def statement(builder, k):
    from gpubench.harness import statement_of

    return statement_of(builder, k)


def points(arr):
    return [None if not row.any() else
            tuple(int.from_bytes(row[j].tobytes(), "little") for j in range(2)) for row in arr]


@pytest.mark.parametrize("workload,k", [("delay_enc", 16), ("mod_pow", 17)])
def test_vk_equals_the_jax_package_at_the_benchmarks_sizes(workload, k):
    path = GOLDEN.format(workload, k)
    if not os.path.exists(path):
        pytest.skip(f"{path} is not in this checkout")
    from delay_enc_tpu_torch.runtime.workloads import build_circuit

    z = np.load(path)
    b = build_circuit(workload, k, seed=int(z["seed"]), t_bits=int(z["t_bits"]))
    assert b.rows == int(z["rows"])
    vk = ref.verifying_key(statement(b, k), int(str(z["tau"]), 16))
    assert list(z["fixed_names"]) == list(ref.ALL_FIXED)
    assert [vk.fixed_points[n] for n in ref.ALL_FIXED] == points(z["fixed"])
    assert vk.sigma_points == points(z["sigma"])
    assert vk.transcript_repr == int(str(z["transcript_repr"]))


@pytest.fixture(scope="module")
def tiny_run():
    from delay_enc_tpu_torch.plonk import SRS, create_proof, create_proofs_batched, keygen

    tau = 0x1234_5678_9ABC_DEF0_1122
    b = tiny.build()
    srs = SRS.setup(tiny.CONFIG["k"], tau=tau, device="cpu")
    pk, vk = keygen(b, srs, k=tiny.CONFIG["k"], device="cpu")
    proof = create_proof(srs, pk, b, np.random.default_rng(5), device="cpu")
    batch = create_proofs_batched(srs, pk, [b, b], np.random.default_rng(6), device="cpu")
    return tau, b, vk, proof, batch


def test_vk_and_proofs_of_the_program(tiny_run):
    tau, b, vk, proof, batch = tiny_run
    from gpubench.harness import vk_entries

    rvk = ref.verifying_key(statement(b, tiny.CONFIG["k"]), tau)
    assert dict(rvk.entries()) == dict(vk_entries(vk))
    for p in [proof] + batch:
        assert ref.verify(rvk, tau, p, b.instance) == (True, "")


@pytest.mark.parametrize("where", ["point", "evaluation", "opening", "tail"])
def test_an_altered_proof_is_rejected(tiny_run, where):
    tau, b, vk, proof, _ = tiny_run
    rvk = ref.verifying_key(statement(b, tiny.CONFIG["k"]), tau)
    bad = bytearray(proof)
    at = {"point": 32 * 2 + 5, "evaluation": 32 * 30 + 3, "opening": len(proof) - 40,
          "tail": None}[where]
    if at is None:
        bad += b"\x00" * 32
    else:
        bad[at] ^= 4
    ok, why = ref.verify(rvk, tau, bytes(bad), b.instance)
    assert not ok and why


def test_another_secret_rejects(tiny_run):
    tau, b, _, proof, _ = tiny_run
    other = ref.verifying_key(statement(b, tiny.CONFIG["k"]), tau + 1)
    assert not ref.verify(other, tau + 1, proof, b.instance)[0]


def test_curve_arithmetic():
    g = bn254.GEN
    assert bn254.on_curve(g) and bn254.mul(bn254.R, g) is None
    assert bn254.add(g, g) == bn254.mul(2, g)
    assert bn254.msm([3, 5], [g, bn254.mul(2, g)]) == bn254.mul(13, g)
    p = bn254.mul(123456789, g)
    assert bn254.from_bytes(bn254.to_bytes(p)) == p
    assert bn254.from_bytes(bn254.to_bytes(bn254.neg(p))) == bn254.neg(p)
    assert bn254.add(p, bn254.neg(p)) is None
    assert bn254.from_bytes(b"\x00" * 32) is None
    with pytest.raises(ValueError):
        bn254.from_bytes((bn254.Q).to_bytes(32, "little"))
