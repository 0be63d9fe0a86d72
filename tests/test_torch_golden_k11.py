"""A JAX-made pose_enc k=11 proof, so that the port's multi-tile scans on the
card are held to the JAX package's bytes (chip_smoke.py phase 3 compares its
k=11 proofs, in both MSM bases, with tests/data/torch_port_k11.npz).

The proof is the JAX package's create_proof of bench.py's pose_enc circuit
(seed 42, the utils/config.py defaults) on the committed
bench_data_cpu/srs_bn254_k11.npz, with rng=default_rng(0).  Making it takes
minutes on a CPU, so it is committed; test_golden_k11_matches_jax (marked
slow) makes it again and asserts it is unchanged.  Regenerate the file with
    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_golden_k11.py
"""

import importlib
import os

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_k11.npz")
SRS_FILE = os.path.join(ROOT, "bench_data_cpu", "srs_bn254_k11.npz")
VK_FILE = os.path.join(ROOT, "bench_data_cpu",
                       "keys_pose_enc_03b0f1e6255bb975e1394ff696635139.vk.npz")
SEED = 0


def pose_enc_circuit(pkg: str, seed: int = 42):
    """bench.py build_circuit("pose_enc") over either package."""
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")
    FR = mod("fields").FR
    cc = mod("utils.config").CircuitConfig()
    rng = np.random.default_rng(seed)
    spec = mod("poseidon").get_spec(FR, cc.t, cc.rate, cc.r_f, cc.r_p)
    msg = cc.message_capacity
    key = (FR.random(rng), FR.random(rng))
    message = [0] * msg
    expected = mod("encryption").PoseidonCipher(spec, key, capacity=msg).encrypt(message, 1)
    return mod("models").PoseidonEncCircuit(spec=spec, num_input=msg, message=message, key=key,
                                            expected=expected, capacity=msg).build()


def jax_golden() -> dict:
    """The JAX package's keygen and proof on the committed SRS."""
    from delay_enc_tpu.plonk import SRS, create_proof, keygen
    from delay_enc_tpu.plonk.keygen import min_k

    b = pose_enc_circuit("delay_enc_tpu")
    srs = SRS.load(SRS_FILE)
    pk, _ = keygen(b, srs, k=max(min_k(b), 11))
    proof = create_proof(srs, pk, b, np.random.default_rng(SEED))
    return {"proof": np.frombuffer(proof, np.uint8), "seed": np.array(SEED)}


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


def test_golden_k11_verifies(golden):
    """The committed proof against the committed vk, through the port's
    verifier; a flipped byte is refused."""
    from delay_enc_tpu_torch.plonk import SRS, verify_proof
    from delay_enc_tpu_torch.plonk.keygen import load_vk

    vk = load_vk(VK_FILE)
    srs = SRS.load_host_meta(SRS_FILE)
    proof = golden["proof"].tobytes()
    assert int(golden["seed"]) == SEED
    assert verify_proof(srs, vk, proof)
    bad = bytearray(proof)
    bad[100] ^= 1
    assert not verify_proof(srs, vk, bytes(bad))


def test_port_circuit_is_the_jax_circuit():
    """The port's copy of the circuit builds the same rows and columns as
    the JAX package's, so the card proves the golden's statement."""
    want = pose_enc_circuit("delay_enc_tpu")
    got = pose_enc_circuit("delay_enc_tpu_torch")
    assert got.rows == want.rows
    assert got.advice == want.advice
    assert got.fixed == want.fixed


@pytest.mark.slow
def test_golden_k11_matches_jax(golden):
    want = jax_golden()
    assert set(want) == set(golden)
    for key in want:
        assert np.array_equal(want[key], golden[key]), key


if __name__ == "__main__":
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(GOLDEN, **jax_golden())
    print("wrote", GOLDEN)
