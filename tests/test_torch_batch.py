"""Batched and pipelined proving of delay_enc_tpu_torch on the CPU against the
JAX package: `create_proofs_batched` (plonk/batch_prover.py) and
`create_proofs_pipelined` (plonk/pipeline.py).

The JAX side of the batched proofs is a committed golden,
tests/data/torch_port_batch_k7.npz: the JAX package's create_proofs_batched
of two witnesses of the k=7 circuit of tests/test_torch_prover.py, (7, 11)
and (3, 5), keyed on the first, with tau=123456789 and rng=default_rng(1).
Its XLA:CPU compile takes minutes, so test_batch_golden_matches_jax (marked
slow) makes it again and asserts it is unchanged.  Regenerate the file with
    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_batch.py

Every comparison is exact: equal proof bytes, equal Montgomery words.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_prover import K, TAU, _build_circuit, one_thread  # noqa: E402,F401

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "torch_port_batch_k7.npz")
WITNESSES = ((7, 11), (3, 5))
SEED = 1


def jax_golden() -> dict:
    """The JAX package's batched proofs of the two witnesses."""
    from delay_enc_tpu import cs
    from delay_enc_tpu.fields import FR
    from delay_enc_tpu.plonk import SRS, keygen
    from delay_enc_tpu.plonk.batch_prover import create_proofs_batched

    srs = SRS.setup(K, tau=TAU)
    builders = [_build_circuit(cs, FR, *w) for w in WITNESSES]
    pk, _ = keygen(builders[0], srs)
    proofs = create_proofs_batched(srs, pk, builders, np.random.default_rng(SEED))
    return {"proofs": np.stack([np.frombuffer(p, np.uint8) for p in proofs]),
            "witnesses": np.array(WITNESSES), "seed": np.array(SEED)}


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def port():
    """The port's SRS, keys and the golden's builders on the CPU."""
    from delay_enc_tpu_torch import cs
    from delay_enc_tpu_torch.fields import FR
    from delay_enc_tpu_torch.plonk import SRS, keygen

    srs = SRS.setup(K, tau=TAU, device="cpu")
    builders = [_build_circuit(cs, FR, *w) for w in WITNESSES]
    pk, vk = keygen(builders[0], srs, device="cpu")
    return srs, pk, vk, builders


@pytest.fixture(scope="module")
def batched(port):
    """The port's batched proofs, base 4."""
    from delay_enc_tpu_torch.plonk import create_proofs_batched

    srs, pk, _, builders = port
    return create_proofs_batched(srs, pk, builders, np.random.default_rng(SEED), device="cpu")


def _port_cs():
    from delay_enc_tpu_torch import cs
    from delay_enc_tpu_torch.fields import FR

    return cs, FR


@pytest.mark.parametrize("msm", ["b4", "b16"])
def test_batched_proofs_equal_golden(port, batched, golden, msm):
    """The port's batch equals the JAX package's, byte for byte, in both
    MSM bases."""
    from delay_enc_tpu_torch.plonk import create_proofs_batched

    assert [tuple(w) for w in golden["witnesses"]] == list(WITNESSES)
    assert int(golden["seed"]) == SEED
    srs, pk, _, builders = port
    proofs = batched if msm == "b4" else create_proofs_batched(
        srs, pk, builders, np.random.default_rng(SEED), device="cpu", msm=msm)
    assert len(proofs) == len(golden["proofs"])
    for p, g in zip(proofs, golden["proofs"]):
        assert p == g.tobytes()


def test_batched_proofs_verify_alone(port, batched):
    """Each proof verifies with the port's verifier; one byte of the other
    instance's proof breaks it."""
    from delay_enc_tpu_torch.plonk import verify_proof

    srs, _, vk, _ = port
    assert batched[0] != batched[1]
    for p in batched:
        assert verify_proof(srs, vk, p)
    bad = batched[1][:40] + batched[0][40:41] + batched[1][41:]
    assert bad != batched[1]
    assert not verify_proof(srs, vk, bad)


def test_pipelined_equals_serial(port):
    """Depth 2 over 3 builders: each proof equals create_proof with its
    seed, in builder order, with on_proof called in order; the phase spans
    of the concurrent proofs all land."""
    from delay_enc_tpu_torch.plonk import create_proof, create_proofs_pipelined
    from delay_enc_tpu_torch.utils.timers import GLOBAL_METRICS

    cs, FR = _port_cs()
    srs, pk, _, _ = port
    builders = [_build_circuit(cs, FR, *w) for w in ((4, 9), (6, 13), (2, 3))]
    seeds = [11, 22, 33]
    done = []
    GLOBAL_METRICS.clear()
    proofs = create_proofs_pipelined(srs, pk, builders, seeds=seeds, depth=2, device="cpu",
                                     on_proof=lambda i, p: done.append((i, p)))
    spans = GLOBAL_METRICS.snapshot()
    serial = [create_proof(srs, pk, b, np.random.default_rng(s), device="cpu")
              for b, s in zip(builders, seeds)]
    assert proofs == serial
    assert done == list(enumerate(serial))
    for name in ("advice commit", "lookup permuted", "grand products", "quotient", "evals",
                 "gwc"):
        assert spans[f"prove/{name}"] > 0
    with pytest.raises(ValueError, match="seeds"):
        create_proofs_pipelined(srs, pk, builders, seeds=seeds[:2], device="cpu")


def test_shared_counts_under_threads(monkeypatch):
    """The launch counts and the spans are shared by every thread: adds
    from concurrent threads are none of them lost."""
    import threading

    from delay_enc_tpu_torch.ops import _cuda
    from delay_enc_tpu_torch.utils.timers import Metrics

    k = _cuda.Kernel("test_kernel", "test_symbol", "nothing", "nowhere")
    monkeypatch.setitem(_cuda._fns, "test_symbol", lambda *args: 0)
    metrics = Metrics()
    threads, calls = 8, 2000

    def work():
        for _ in range(calls):
            k()
            metrics.add("span", 1.0)

    ts = [threading.Thread(target=work) for _ in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert k.launches == threads * calls
    assert metrics.snapshot() == {"span": float(threads * calls)}
    metrics.clear()
    assert metrics.snapshot() == {}


def test_batched_refusals(port):
    """A split-mode key, no builders, and a builder of another shape."""
    import dataclasses

    from delay_enc_tpu_torch.plonk import create_proofs_batched

    cs, FR = _port_cs()
    srs, pk, _, builders = port
    rng = np.random.default_rng(0)
    split = dataclasses.replace(pk, split=True)
    with pytest.raises(ValueError, match="fused-quotient key"):
        create_proofs_batched(srs, split, builders, rng, device="cpu")
    with pytest.raises(ValueError, match="no builders"):
        create_proofs_batched(srs, pk, [], rng, device="cpu")
    other = _build_circuit(cs, FR, 2, 9)
    cs.MainGate(other).assign_value(5)  # one row more
    with pytest.raises(ValueError, match="circuit shape"):
        create_proofs_batched(srs, pk, [builders[0], other], rng, device="cpu")


# ------------------------------- K5, K6 and K7 over instances, against JAX

N = 32  # k = 5
B = 3


def _words(rng, *shape):
    from delay_enc_tpu_torch.ops import limbs as TL
    from delay_enc_tpu.fields import FR

    count = int(np.prod(shape))
    return TL.FR_CTX.to_mont_np([FR.random(rng) for _ in range(count)]).reshape(*shape, 8)


def _t(w):
    from delay_enc_tpu_torch.ops import limbs as TL

    return TL.to_tensor(w, "cpu")


def _j(w):
    import jax.numpy as jnp

    from delay_enc_tpu_torch.ops import limbs as TL

    return jnp.asarray(TL.words_to_limbs_np(np.asarray(w)))


def _w(a):
    """JAX limbs -> (…, 8) words."""
    from delay_enc_tpu_torch.ops import limbs as TL

    return TL.limbs_to_words_np(np.asarray(a))


class Instances:
    """B instances' operands at n = 32 (and n_ext = 256), each with its own
    challenges, as numpy words, with the key's shared rows."""

    def __init__(self, seed=5):
        from delay_enc_tpu.fields import FR
        from delay_enc_tpu_torch.plonk import kernels as TK
        from delay_enc_tpu_torch.plonk.keygen import ALL_FIXED, KEY_ROWS

        rng = np.random.default_rng(seed)
        self.usable = N - 7
        self.raw6, self.lk = _words(rng, B, 6, N), _words(rng, B, 8, N)
        self.sigma, self.omega = _words(rng, 6, N), _words(rng, N)
        self.key = _words(rng, len(ALL_FIXED), N)
        self.chals = [[FR.random(rng) for _ in range(4)] for _ in range(B)]
        self.deltas = [FR.random(rng) for _ in range(6)]
        self.consts = np.stack([TK.challenge_words(*c, self.deltas) for c in self.chals])
        ne = 8 * N
        self.wit, self.key_ext = _words(rng, B, 19, ne), _words(rng, len(KEY_ROWS), ne)
        self.x_ext, self.zh8 = _words(rng, ne), _words(rng, 8)
        self.stacks = _words(rng, B, 5, N)
        self.points = [FR.random(rng) for _ in range(B)]
        self.vs = [FR.random(rng) for _ in range(B)]


@pytest.fixture(scope="module")
def inst():
    """The operands and the JAX package's vmapped functions on them, each
    compiled once."""
    from delay_enc_tpu.fields import FR
    from delay_enc_tpu.plonk import batch_prover as JB
    from delay_enc_tpu.plonk.domain import Domain as JDomain
    from delay_enc_tpu.plonk.keygen import _zeta_inv_powers
    from delay_enc_tpu_torch.ops import limbs as TL
    from delay_enc_tpu_torch.plonk.keygen import ALL_FIXED

    ctx = TL.FR_CTX
    c = Instances()
    m = lambda vals: _j(ctx.to_mont_np(vals))
    theta, beta, gamma, y = (m([ch[i] for ch in c.chals])[:, None] for i in range(4))
    key = dict(zip(ALL_FIXED, c.key))
    raw6 = _j(c.raw6)
    num_p, den_p = JB._jit_perm_fracs_batch(raw6, _j(c.sigma), _j(c.omega), beta, gamma,
                                            m(c.deltas))
    s_raw = JB._jit_compress_b(_j(key["table_tag"])[None], _j(key["table_value"])[None], theta)
    tags = _j(np.stack([key[f"tag_{l}"] for l in "abcd"]))[None]
    a_raw = JB._jit_compress_b(tags, raw6[:, :4], theta[:, None])
    numl, denl = JB._jit_lookup_fracs_batch(a_raw, s_raw, _j(c.lk[:, :4]), _j(c.lk[:, 4:]),
                                            beta, gamma)
    one = ctx.to_mont_np([1])[0]
    fracs = []
    for p, l in ((num_p, numl), (den_p, denl)):
        w = np.concatenate([_w(p)[:, None], _w(l)], axis=1).reshape(B * 5, N, 8)
        w[:, c.usable:] = one
        fracs.append(w)

    jd = JDomain(5)
    wit, ke = _j(c.wit), _j(c.key_ext)
    nf = len(ALL_FIXED)
    y_pows = m([pow(ch[3], 23 - i, FR.p) for ch in c.chals for i in range(24)]).reshape(B, 24, 16)
    h = JB._jit_quotient_batch(
        [wit[:, i] for i in range(5)], wit[:, 5], wit[:, 6],
        {l: wit[:, 7 + i] for i, l in enumerate("abcd")},
        {l: wit[:, 11 + i] for i, l in enumerate("abcd")},
        {l: wit[:, 15 + i] for i, l in enumerate("abcd")},
        {name: ke[i] for i, name in enumerate(ALL_FIXED)}, [ke[nf + i] for i in range(6)],
        (ke[nf + 6], ke[nf + 7], ke[nf + 8], _j(c.x_ext)),
        (theta[:, 0], beta[:, 0], gamma[:, 0]), [d[None] for d in m(c.deltas)],
        _j(np.tile(c.zh8, (N, 1))), _zeta_inv_powers(jd), y_pows,
        jd.plan_ext.tw_inv, jd.plan_ext.n_inv)

    pts = m(c.points)
    evals = JB._jit_eval_stack_batch(_j(c.stacks), pts)
    gwc = JB._jit_gwc_witness_batch(_j(c.stacks), m(c.vs), pts,
                                    m([pow(z, -1, FR.p) for z in c.points]))
    return c, {"fracs": fracs, "quotient": _w(h), "evals": _w(evals), "gwc": _w(gwc)}


def test_gp_fracs_batch_matches_jax(inst):
    """K5's batch (its plain version here) against _jit_perm_fracs_batch,
    _jit_compress_b and _jit_lookup_fracs_batch, and against the port's
    single-instance calls."""
    from delay_enc_tpu_torch.ops import limbs as TL
    from delay_enc_tpu_torch.plonk import kernels as TK

    c, want = inst
    args = (_t(c.sigma), _t(c.omega), _t(c.key))
    num, den = TK.gp_fracs(_t(c.raw6), *args, _t(c.lk), c.consts, c.usable)
    assert np.array_equal(TL.to_numpy(num), want["fracs"][0])
    assert np.array_equal(TL.to_numpy(den), want["fracs"][1])
    for b in range(B):
        one = TK.gp_fracs(_t(c.raw6[b]), *args, _t(c.lk[b]), c.consts[b], c.usable)
        assert np.array_equal(TL.to_numpy(one[0]), want["fracs"][0][5 * b : 5 * b + 5])
        assert np.array_equal(TL.to_numpy(one[1]), want["fracs"][1][5 * b : 5 * b + 5])


def test_quotient_batch_matches_jax(inst):
    """K6's batch and the inverse over B rows (`quotient_stacked`) against
    _jit_quotient_batch, and K6's batch against its single-instance calls."""
    from delay_enc_tpu_torch.fields import FR
    from delay_enc_tpu_torch.ops import limbs as TL
    from delay_enc_tpu_torch.ops.ntt import powers
    from delay_enc_tpu_torch.plonk import kernels as TK
    from delay_enc_tpu_torch.plonk.domain import Domain

    c, want = inst
    d = Domain(5)
    unscale = powers(TL.FR_CTX, FR.inv(d.zeta), d.n_ext, "cpu", start=FR.inv(d.n_ext))
    args = (_t(c.key_ext), _t(c.x_ext), _t(c.zh8))
    h = TK.quotient_stacked(_t(c.wit), *args, c.consts, unscale, d.plan_ext("cpu"))
    assert np.array_equal(TL.to_numpy(h), want["quotient"])
    h_ext = TK.quotient_h(_t(c.wit), *args, c.consts)
    for b in range(B):
        assert np.array_equal(TL.to_numpy(h_ext[b]),
                              TL.to_numpy(TK.quotient_h(_t(c.wit[b]), *args, c.consts[b])))


def test_openings_batch_match_jax(inst):
    """K7's batched forms: `_eval_stack_batch` against
    _jit_eval_stack_batch, `_gwc_witness_batch` against
    _jit_gwc_witness_batch, each instance with its own point and v."""
    from delay_enc_tpu.fields import FR
    from delay_enc_tpu_torch.ops import limbs as TL
    from delay_enc_tpu_torch.ops import poly as TP
    from delay_enc_tpu_torch.plonk import kernels as TK

    c, want = inst
    ctx = TL.FR_CTX
    stacks_b = [[list(_t(c.stacks[b]))] for b in range(B)]
    pows = TP.powers_rows(ctx, _t(ctx.to_mont_np(c.points)), N)
    pows_b = [[pows[b]] for b in range(B)]
    evals = TK._eval_stack_batch(stacks_b, pows_b)
    assert np.array_equal(TL.to_numpy(evals), want["evals"].reshape(B * 5, 8))
    ws = TK._gwc_witness_batch(stacks_b, pows_b, _t(ctx.to_mont_np(c.vs)),
                               _t(ctx.to_mont_np([pow(z, -1, FR.p) for z in c.points])))
    assert np.array_equal(TL.to_numpy(ws), want["gwc"])
    for b in range(B):  # each instance alone
        assert np.array_equal(TL.to_numpy(TK._eval_stack_batch([stacks_b[b]], [pows_b[b]])),
                              want["evals"][b])


def test_open_stacks_refusals():
    """K7's tables past their limits, and batches that do not line up."""
    from delay_enc_tpu_torch.plonk import kernels as TK

    rng = np.random.default_rng(7)
    rows = list(_t(_words(rng, 2, 16)))
    pows = _t(_words(rng, 16))
    ok = [[rows]]
    with pytest.raises(ValueError, match="rows in all"):
        TK.open_stacks("eval", [[rows], [rows * 33]], [[pows], [pows]])
    with pytest.raises(ValueError, match="points"):
        TK.open_stacks("eval", ok + [[rows] * 5], [[pows], [pows] * 5])
    with pytest.raises(ValueError, match="instances"):
        TK.open_stacks("eval", ok, [[pows], [pows]])
    with pytest.raises(ValueError, match="instances"):
        TK.open_stacks("eval", [], [])
    with pytest.raises(ValueError, match="powers of v"):
        TK.open_stacks("combine", ok + ok, [[pows], [pows]], [pows[:2], None])
    with pytest.raises(ValueError, match=r"stacks\[1\]"):
        TK.open_stacks("eval", [[rows], [[r[:8] for r in rows]]], [[pows], [pows]])


def test_batched_kernel_refusals():
    """K5 and K6 over instances: the challenge words must carry the
    instance axis, and K6's batch takes the fused form only."""
    from delay_enc_tpu_torch.plonk import kernels as TK

    c = Instances(seed=8)
    fr = (_t(c.raw6), _t(c.sigma), _t(c.omega), _t(c.key), _t(c.lk))
    with pytest.raises(ValueError, match="challenge words"):
        TK.gp_fracs(*fr, c.consts[0], c.usable)
    with pytest.raises(ValueError, match="lk_raw"):
        TK.gp_fracs(*fr[:4], fr[4][:2], c.consts, c.usable)
    q = (_t(c.wit), _t(c.key_ext), _t(c.x_ext), _t(c.zh8))
    with pytest.raises(ValueError, match="challenge words"):
        TK.quotient_h(*q, c.consts[:2])
    with pytest.raises(ValueError, match="fused form"):
        TK.quotient_h(*q[:3], q[3][:1], c.consts, rot=1)


@pytest.mark.slow
def test_batch_golden_matches_jax(golden):
    want = jax_golden()
    assert set(want) == set(golden)
    for key in want:
        assert np.array_equal(want[key], golden[key]), key


if __name__ == "__main__":
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(GOLDEN, **jax_golden())
    print("wrote", GOLDEN)
