"""Port parity for the slice as a whole: SRS setup, keygen, create_proof and
verify of delay_enc_tpu_torch on the CPU against the JAX package, on the
circuit of tests/test_plonk_e2e.py at k=7 with tau=123456789 and
rng=default_rng(42).

The JAX package's side is a committed golden, tests/data/torch_port_k7.npz,
because its create_proof takes minutes of XLA:CPU compile;
test_golden_matches_jax (marked slow) regenerates it with the JAX package
and asserts it is unchanged.  Regenerate the file with
    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_prover.py
"""

import os

import numpy as np
import pytest

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "torch_port_k7.npz")
K = 7
TAU = 123456789
SEED = 42


def _build_circuit(cs, FR, x0=7, y0=11):
    """tests/test_plonk_e2e.py _build_circuit, over either package's cs."""
    b = cs.Builder(FR)
    mg = cs.MainGate(b)
    rc = cs.RangeChip(b)
    x = mg.assign_value(x0)
    y = mg.assign_value(y0)
    s = mg.add(x, y)
    m = mg.mul(x, y)
    acc = mg.compose([cs.Term(x, 2), cs.Term(y, 3), cs.Term(s, 1), cs.Term(m, 5)], constant=9)
    bit = mg.assign_bit(1)
    sel = mg.select(s, m, bit)
    mg.assert_equal(sel, s)
    rc.assign(45, 2, 6)  # range lookup path (table width 2)
    mg.assert_one(mg.is_equal(acc, mg.assign_value(acc.value)))
    return b


def _record(g1_to_bytes, srs_affine, vk, proof: bytes) -> dict:
    from delay_enc_tpu_torch.plonk.keygen import ALL_FIXED

    def pts(ps):
        return np.stack([np.frombuffer(g1_to_bytes(p), np.uint8) for p in ps]) if ps \
            else np.zeros((0, 32), np.uint8)

    return {
        "srs": pts(srs_affine),
        "fixed": pts([vk.fixed_commitments[n] for n in ALL_FIXED]),
        "sigma": pts(vk.sigma_commitments),
        "transcript_repr": np.array(str(vk.transcript_repr)),
        "proof": np.frombuffer(proof, np.uint8),
    }


def jax_golden() -> dict:
    """The JAX package's SRS, vk and proof for the test circuit."""
    from delay_enc_tpu import cs
    from delay_enc_tpu.curves.bn254 import g1_to_bytes
    from delay_enc_tpu.fields import FR
    from delay_enc_tpu.ops import msm as JM
    from delay_enc_tpu.plonk import SRS, create_proof, keygen

    srs = SRS.setup(K, tau=TAU)
    b = _build_circuit(cs, FR)
    pk, vk = keygen(b, srs)
    proof = create_proof(srs, pk, b, np.random.default_rng(SEED))
    return _record(g1_to_bytes, JM.points_from_device(srs.g1_powers), vk, proof)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The CPU keygen and proofs are many small torch operations: under the
    suite's parallel workers, torch's intra-op threads only contend (on
    eight cores under six workers, a k=7 fixture takes minutes with them
    and seconds with one).  Imported by the other files that prove on the
    CPU."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def port():
    """The port's SRS, keys, circuit and proof on the CPU."""
    from delay_enc_tpu_torch import cs
    from delay_enc_tpu_torch.fields import FR
    from delay_enc_tpu_torch.plonk import SRS, create_proof, keygen

    srs = SRS.setup(K, tau=TAU, device="cpu")
    b = _build_circuit(cs, FR)
    pk, vk = keygen(b, srs, device="cpu")
    proof = create_proof(srs, pk, b, np.random.default_rng(SEED), device="cpu")
    return srs, pk, vk, b, proof


@pytest.fixture(scope="module")
def port_b16(port):
    """keygen and create_proof on the same SRS and circuit through the
    base-16 MSM."""
    from delay_enc_tpu_torch.plonk import create_proof, keygen

    srs, _, _, b, _ = port
    pk, vk = keygen(b, srs, device="cpu", msm="b16")
    proof = create_proof(srs, pk, b, np.random.default_rng(SEED), device="cpu", msm="b16")
    return vk, proof


def test_srs_points_match_golden(port, golden):
    from delay_enc_tpu_torch.curves.bn254 import g1_to_bytes
    from delay_enc_tpu_torch.ops import msm as TM

    srs = port[0]
    rec = _record(g1_to_bytes, TM.points_from_device(srs.g1_powers), port[2], port[4])
    assert np.array_equal(rec["srs"], golden["srs"])


def test_vk_matches_golden(port, golden):
    from delay_enc_tpu_torch.curves.bn254 import g1_to_bytes

    vk = port[2]
    rec = _record(g1_to_bytes, [], vk, port[4])
    assert np.array_equal(rec["fixed"], golden["fixed"])
    assert np.array_equal(rec["sigma"], golden["sigma"])
    assert str(vk.transcript_repr) == str(golden["transcript_repr"])


def test_proof_bytes_match_golden(port, golden):
    assert np.array_equal(np.frombuffer(port[4], np.uint8), golden["proof"])


def test_b16_vk_and_proof_bytes_match_golden(port_b16, golden):
    """An MSM has one answer: the base-16 commitments give the same vk and,
    through the transcript, the same proof bytes as the JAX package's."""
    from delay_enc_tpu_torch.curves.bn254 import g1_to_bytes

    vk, proof = port_b16
    rec = _record(g1_to_bytes, [], vk, proof)
    for key in ("fixed", "sigma", "proof"):
        assert np.array_equal(rec[key], golden[key]), key
    assert str(vk.transcript_repr) == str(golden["transcript_repr"])


def test_unknown_msm_raises(port):
    from delay_enc_tpu_torch.plonk import create_proof, keygen

    srs, pk, _, b, _ = port
    with pytest.raises(ValueError, match="unknown MSM"):
        keygen(b, srs, device="cpu", msm="b5")
    with pytest.raises(ValueError, match="unknown MSM"):
        create_proof(srs, pk, b, np.random.default_rng(SEED), device="cpu", msm="b5")


def test_both_verifiers_accept_port_proof(port):
    from delay_enc_tpu.curves.bn254 import G2_GEN as J_G2_GEN
    from delay_enc_tpu.fields.bn254 import Fq2 as JFq2
    from delay_enc_tpu.plonk.domain import Domain as JDomain
    from delay_enc_tpu.plonk.keygen import VerifyingKey as JVerifyingKey
    from delay_enc_tpu.plonk.kzg import SRS as JSRS
    from delay_enc_tpu.plonk.verifier import verify_proof as jax_verify
    from delay_enc_tpu_torch.plonk import verify_proof

    srs, _, vk, _, proof = port
    jvk = JVerifyingKey(JDomain(vk.domain.k), dict(vk.fixed_commitments),
                        list(vk.sigma_commitments), vk.transcript_repr)
    jsrs = JSRS(srs.k, None, tuple(JFq2(c.c0, c.c1) for c in srs.tau_g2), J_G2_GEN)
    assert jax_verify(jsrs, jvk, proof)
    assert verify_proof(srs, vk, proof)
    bad = bytearray(proof)
    bad[-40] ^= 1
    assert not jax_verify(jsrs, jvk, bytes(bad))
    assert not verify_proof(srs, vk, bytes(bad))


def test_proof_is_deterministic_per_rng(port):
    from delay_enc_tpu_torch.plonk import create_proof

    srs, pk, _, b, proof = port
    assert create_proof(srs, pk, b, np.random.default_rng(SEED), device="cpu") == proof


def test_proof_converts_every_int_in_c(port, golden):
    """Every list a proof converts to Montgomery words holds exact ints
    below 2^256 (the advice columns, the pads, the blinds, the inverses):
    the C reader takes them all, and the bytes stay the golden's."""
    from delay_enc_tpu_torch.plonk import create_proof
    from delay_enc_tpu_torch.utils.timers import GLOBAL_METRICS

    srs, pk, _, b, _ = port

    def counts():
        c = GLOBAL_METRICS.counters
        return c.get("to_mont native", 0), c.get("to_mont python", 0)

    before = counts()
    proof = create_proof(srs, pk, b, np.random.default_rng(SEED), device="cpu")
    after = counts()
    assert np.array_equal(np.frombuffer(proof, np.uint8), golden["proof"])
    assert after[1] - before[1] == 0
    assert after[0] - before[0] >= 6 * pk.vk.domain.n  # the advice and instance columns


def test_proof_reads_every_lookup_key_in_c(port, golden):
    """The four lookups' tag and wire columns hold small exact ints wherever
    a tag is set: the C reader takes every row of each, and the bytes stay
    the golden's."""
    from delay_enc_tpu_torch.plonk import create_proof
    from delay_enc_tpu_torch.utils.timers import GLOBAL_METRICS

    srs, pk, _, b, _ = port

    def counts():
        c = GLOBAL_METRICS.counters
        return c.get("permute native", 0), c.get("permute python", 0)

    before = counts()
    proof = create_proof(srs, pk, b, np.random.default_rng(SEED), device="cpu")
    after = counts()
    assert np.array_equal(np.frombuffer(proof, np.uint8), golden["proof"])
    assert (after[0] - before[0], after[1] - before[1]) == (4 * b.rows, 0)


def test_port_verifies_committed_jax_proof():
    """The committed pose_enc k=11 proof, with its committed vk and SRS, as
    bench.py's verify workload reads them."""
    from delay_enc_tpu_torch.plonk import SRS, verify_proof
    from delay_enc_tpu_torch.plonk.keygen import load_vk

    root = os.path.join(os.path.dirname(os.path.dirname(__file__)), "bench_data_cpu")
    vk = load_vk(os.path.join(root, "keys_pose_enc_03b0f1e6255bb975e1394ff696635139.vk.npz"))
    srs = SRS.load_host_meta(os.path.join(root, "srs_bn254_k11.npz"))
    with open(os.path.join(root, "proof_pose_enc_k11.bin"), "rb") as f:
        proof = f.read()
    assert verify_proof(srs, vk, proof)
    assert not verify_proof(srs, vk, proof[:-1] + bytes([proof[-1] ^ 1]))


@pytest.mark.slow
def test_golden_matches_jax(golden):
    want = jax_golden()
    assert set(want) == set(golden)
    for key in want:
        assert np.array_equal(want[key], golden[key]), key


if __name__ == "__main__":
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(GOLDEN, **jax_golden())
    print("wrote", GOLDEN)
