"""The split quotient held to the benchmark's plain reference
(`gpubench/reference/`: Python integers and hashlib, nothing of the port
and nothing of JAX) on the CPU.  The k=7 test circuit is proved with a key
forced split and with the fused one: the port's verifying key is the
reference's on keygen's domain, the reference accepts each proof and
rejects it with a byte changed, the bytes are the committed golden's, and
the split proof alone has the span `prove/quotient/split` (no wait for
the device inside it) and 8 on the counter `split cosets`."""

import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))  # gpubench
from test_torch_prover import GOLDEN, K, SEED, TAU, _build_circuit, one_thread  # noqa: E402,F401

from gpubench.harness import statement_of, vk_entries  # noqa: E402
from gpubench.reference import plonk as ref  # noqa: E402

MODES = ("split", "fused")
SPLIT = "prove/quotient/split"
COSETS = "#split cosets"
# where a byte is changed: a commitment, an evaluation, the last opening,
# or 32 bytes appended
ALTERED = {"point": 32 * 2 + 5, "evaluation": 32 * 30 + 3, "opening": -40, "tail": None}


@pytest.fixture(scope="module")
def statement():
    """The SRS, the circuit, and the reference's key of the circuit at TAU
    on keygen's domain (the circuit's smallest, 2^5, on the SRS of 2^7)."""
    from delay_enc_tpu_torch import cs
    from delay_enc_tpu_torch.fields import FR
    from delay_enc_tpu_torch.plonk import SRS
    from delay_enc_tpu_torch.plonk.keygen import min_k

    srs = SRS.setup(K, tau=TAU, device="cpu")
    b = _build_circuit(cs, FR)
    return srs, b, ref.verifying_key(statement_of(b, min_k(b)), TAU)


@pytest.fixture(scope="module", params=MODES)
def proved(request, statement):
    """keygen in the mode and one proof under `record()`: the spans, the
    counters' growth, and the span path open at every wait for the device."""
    from delay_enc_tpu_torch.plonk import create_proof, keygen
    from delay_enc_tpu_torch.utils import device as D
    from delay_enc_tpu_torch.utils.timers import GLOBAL_METRICS

    srs, b, _ = statement
    pk, vk = keygen(b, srs, split=request.param == "split", device="cpu")
    waits = []

    def spy(inner):
        def wait(device):
            waits.append(getattr(GLOBAL_METRICS._local, "path", None))
            return inner(device)
        return wait

    patch = pytest.MonkeyPatch()
    for module, name in ((D, "sync_stream"), (D, "synchronize")):
        patch.setattr(module, name, spy(getattr(module, name)))
    before = GLOBAL_METRICS.snapshot()
    try:
        with GLOBAL_METRICS.record() as records:
            proof = create_proof(srs, pk, b, np.random.default_rng(SEED), device="cpu")
    finally:
        patch.undo()
    after = GLOBAL_METRICS.snapshot()
    grown = {k: v - before.get(k, 0) for k, v in after.items() if k.startswith("#")}
    return {"mode": request.param, "pk": pk, "vk": vk, "proof": proof,
            "records": list(records), "counters": grown, "waits": waits}


def test_key_is_in_the_mode(proved):
    assert proved["pk"].split == (proved["mode"] == "split")


def test_vk_equals_the_reference(proved, statement):
    assert dict(vk_entries(proved["vk"])) == dict(statement[2].entries())


def test_reference_accepts_the_proof(proved, statement):
    _, b, rvk = statement
    assert ref.verify(rvk, TAU, proved["proof"], b.instance) == (True, "")


@pytest.mark.parametrize("where", sorted(ALTERED))
def test_reference_rejects_an_altered_proof(proved, statement, where):
    _, b, rvk = statement
    bad = bytearray(proved["proof"])
    at = ALTERED[where]
    if at is None:
        bad += b"\x00" * 32
    else:
        bad[at] ^= 1
    ok, why = ref.verify(rvk, TAU, bytes(bad), b.instance)
    assert not ok and why


def test_proof_bytes_equal_the_golden(proved):
    with np.load(GOLDEN) as z:
        want = z["proof"].tobytes()
    assert proved["proof"] == want


def test_split_span_and_counter(proved):
    """One `split` span inside `prove/quotient`, with no read back and no
    wait for the device while it is open, and 8 cosets counted; a fused
    proof has neither."""
    recs, grown = proved["records"], proved["counters"]
    split = [r for r in recs if r.name == SPLIT]
    if proved["mode"] == "split":
        assert len(split) == 1 and split[0].parent == "prove/quotient"
        # no read back inside it (the plain path's K6 makes a tensor of the
        # challenges, `to_mont` and `htod`; the card's takes them as launch
        # arguments)
        assert not [r for r in recs if r.name.startswith(SPLIT + "/")
                    and r.name.endswith("device wait")]
        assert grown[COSETS] == 8
    else:
        assert not split and grown.get(COSETS, 0) == 0
    assert not [r for r in recs if r.name.split("/")[-1] == "split" and r.name != SPLIT]
    assert not [w for w in proved["waits"] if w and w.startswith(SPLIT)]
