"""Port parity for the prover's arguments that stand for the JAX package's
environment variables, on the CPU: keygen(pinned_vk=) and
transcript_repr(pinned=) for DELAY_ENC_VK_PINNED_FILE (the golden of
tests/test_transcript.py); Metrics.count and dump from two threads in the
JAX package's shape; and runtime/workloads.py's T_BITS row by row against
bench.py's (no circuit is built)."""

import json
import threading

import numpy as np
import pytest

import bench
from delay_enc_tpu.plonk.keygen import transcript_repr as jax_transcript_repr
from delay_enc_tpu.utils.timers import Metrics as JaxMetrics
from delay_enc_tpu_torch.runtime import workloads as W
from delay_enc_tpu_torch.utils.timers import Metrics
from test_torch_prover import GOLDEN, K, SEED, TAU, _build_circuit, one_thread  # noqa: F401

PINNED = b"PinnedVerificationKey { parity-surface-fixture }"
PINNED_GOLDEN = 0x25CCA57BC81D1175DBEC0799E3AB649166B6CBC14C583FAB9DDA92DC83065FCC


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def k7():
    from delay_enc_tpu_torch import cs
    from delay_enc_tpu_torch.fields import FR
    from delay_enc_tpu_torch.plonk import SRS

    return SRS.setup(K, tau=TAU, device="cpu"), _build_circuit(cs, FR)


def test_transcript_repr_pinned_matches_golden():
    from delay_enc_tpu_torch.plonk.keygen import transcript_repr

    assert transcript_repr(None, {}, [], pinned=PINNED) == PINNED_GOLDEN


def test_keygen_pinned_vk_matches_jax_override(k7, golden, tmp_path, monkeypatch):
    """keygen(pinned_vk=) gives the JAX transcript_repr under the variable;
    without it the vk is the golden's; a proof under the pinned key
    verifies under its vk."""
    from delay_enc_tpu_torch.plonk import create_proof, keygen, verify_proof

    srs, b = k7
    pk, vk = keygen(b, srs, device="cpu", pinned_vk=PINNED)
    fx = tmp_path / "pinned.txt"
    fx.write_bytes(PINNED)
    monkeypatch.setenv("DELAY_ENC_VK_PINNED_FILE", str(fx))
    want = jax_transcript_repr(vk.domain, vk.fixed_commitments, vk.sigma_commitments)
    monkeypatch.delenv("DELAY_ENC_VK_PINNED_FILE")
    assert vk.transcript_repr == want == PINNED_GOLDEN
    _, plain = keygen(b, srs, device="cpu")
    assert str(plain.transcript_repr) == str(golden["transcript_repr"])
    assert plain.fixed_commitments == vk.fixed_commitments
    assert plain.sigma_commitments == vk.sigma_commitments
    proof = create_proof(srs, pk, b, np.random.default_rng(SEED), device="cpu")
    assert verify_proof(srs, vk, proof)
    assert not verify_proof(srs, plain, proof)


def test_metrics_count_and_dump_from_two_threads():
    m = Metrics()
    rounds = 2000

    def work(tag):
        for _ in range(rounds):
            m.count("shared")
            m.count(f"own/{tag}", 2)
            m.add("span", 0.001)

    threads = [threading.Thread(target=work, args=(t,)) for t in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    out = json.loads(m.dump())
    assert m.counters == {"shared": 2 * rounds, "own/a": 2 * rounds, "own/b": 2 * rounds}
    assert out["counters"] == m.counters
    assert out["spans_s"]["span"] == pytest.approx(2 * rounds * 0.001)
    jm = JaxMetrics()
    jm.count("shared")
    assert set(json.loads(jm.dump())) == set(out)
    m.clear()
    assert json.loads(m.dump()) == {"spans_s": {}, "counters": {}}


@pytest.mark.parametrize("row", sorted(bench.T_BITS), ids=lambda r: f"{r[0]}-{r[1]}")
def test_t_bits_row_matches_bench(row):
    assert W.T_BITS[row] == bench.T_BITS[row]
