"""The host-oracle selfcheck of create_proof (plonk/selfcheck.py), at k=7 on
the CPU: every commitment against the C MSM, each GWC witness against its
identity.  The checks leave the proof's bytes alone, and a commitment made
wrong on purpose is reported."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_prover import GOLDEN, K, SEED, TAU, _build_circuit, one_thread  # noqa: E402,F401

# commitments a proof makes, by batch: advice, lookup, gp, random, quotient, gwc
COMMITS = {"advice": 5, "lookup": 8, "gp": 5, "random": 1, "quotient": 7, "gwc": 3}


@pytest.fixture(scope="module")
def port():
    from delay_enc_tpu_torch import cs
    from delay_enc_tpu_torch.fields import FR
    from delay_enc_tpu_torch.plonk import SRS, keygen

    srs = SRS.setup(K, tau=TAU, device="cpu")
    b = _build_circuit(cs, FR)
    pk, vk = keygen(b, srs, device="cpu")
    with np.load(GOLDEN) as z:
        golden = z["proof"].tobytes()
    return srs, pk, vk, b, golden


def _expected_labels(level: int) -> list:
    labels = [f"{tag}[{j}]" for tag, m in COMMITS.items() for j in range(m)]
    if level >= 2:
        gwc = [f"gwc {key}[0]" for key in ("x", "wx", "winvx")]
        labels = labels[: -COMMITS["gwc"]] + gwc + labels[-COMMITS["gwc"]:]
    return labels


@pytest.mark.parametrize("level", [1, 2])
def test_selfcheck_passes_and_keeps_bytes(port, level, capfd):
    from delay_enc_tpu_torch.plonk import create_proof

    srs, pk, _, b, golden = port
    checks = []
    proof = create_proof(srs, pk, b, np.random.default_rng(SEED), device="cpu",
                         selfcheck=level, checks=checks)
    assert proof == golden
    assert [label for label, _ in checks] == _expected_labels(level)
    assert all(ok is True for _, ok in checks), checks
    err = capfd.readouterr().err
    lines = [ln for ln in err.splitlines() if ln.startswith("# selfcheck ")]
    assert len(lines) == len(checks) and all(ln.endswith(": ok") for ln in lines), lines
    assert sum(ln.startswith("# selfcheck gwc ") for ln in lines) == (3 if level >= 2 else 0)


def test_wrong_commitment_is_reported(port, monkeypatch, capfd):
    """The random polynomial's commitment is swapped for the generator
    before it is absorbed: that check, and no other, says MISMATCH."""
    from delay_enc_tpu_torch.curves.bn254 import G1_GEN
    from delay_enc_tpu_torch.plonk import create_proof, prover, verify_proof

    srs, pk, vk, b, golden = port
    commit = prover._commit

    def wrong(tables, coeffs):
        pts = commit(tables, coeffs)
        return [G1_GEN] if len(pts) == 1 else pts

    monkeypatch.setattr(prover, "_commit", wrong)
    checks = []
    proof = create_proof(srs, pk, b, np.random.default_rng(SEED), device="cpu", selfcheck=1,
                         checks=checks)
    assert [label for label, ok in checks if not ok] == ["random[0]"]
    assert len(checks) == sum(COMMITS.values())
    assert "# selfcheck random[0]: MISMATCH" in capfd.readouterr().err
    assert proof != golden and not verify_proof(srs, vk, proof)


def test_unknown_level_raises(port):
    from delay_enc_tpu_torch.plonk import create_proof

    srs, pk, _, b, _ = port
    with pytest.raises(ValueError, match="selfcheck level"):
        create_proof(srs, pk, b, np.random.default_rng(SEED), device="cpu", selfcheck=3)
