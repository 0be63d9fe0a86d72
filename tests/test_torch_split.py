"""Port parity for the split quotient (k >= 18 in keygen's choice): the coset
shifts, `split_quotient` against the JAX package's `_split_quotient` and the
port's own fused quotient, and the slice as a whole at k=7 with a forced
split-mode key against the committed JAX golden (tests/data/torch_port_k7.npz,
the JAX package's fused proof, which tests/test_plonk_e2e.py shows equal to
its split proof).  No tolerance: the words and bytes are equal.  The K6
coset form itself (rot 1, strided store) is held to `_jit_quotient_coset`
in tests/test_torch_quotient_kernel.py."""

import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from delay_enc_tpu.fields import FR
from delay_enc_tpu.plonk import prover as JP
from delay_enc_tpu.plonk.domain import Domain as JDomain
from delay_enc_tpu.plonk.keygen import ALL_FIXED, _zeta_inv_powers
from delay_enc_tpu_torch.ops import limbs as TL
from delay_enc_tpu_torch.ops.ntt import powers
from delay_enc_tpu_torch.plonk import kernels as TK
from delay_enc_tpu_torch.plonk.domain import MAX_DEGREE, SPLIT_QUOTIENT_K
from delay_enc_tpu_torch.plonk.domain import Domain as TDomain
from delay_enc_tpu_torch.plonk.keygen import coset_tables, ext_tables, use_split

from test_torch_prover import (GOLDEN, K, SEED, TAU, _build_circuit, _record,  # noqa: F401
                               one_thread)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # bench.py

CTX = TL.FR_CTX
SMALL_K = 5
NF = len(ALL_FIXED)


def t(w):
    return TL.to_tensor(w, "cpu")


def j(w):
    return jnp.asarray(TL.words_to_limbs_np(w))


def words(rng, *shape):
    count = int(np.prod(shape))
    return CTX.to_mont_np([FR.random(rng) for _ in range(count)]).reshape(*shape, 8)


@pytest.mark.parametrize("coset", range(MAX_DEGREE))
def test_coset_shift_matches_jax(coset):
    for k in (SMALL_K, SPLIT_QUOTIENT_K):
        assert TDomain(k).coset_shift(coset) == JDomain(k).coset_shift(coset)


def test_split_chosen_from_k18():
    assert not use_split(SPLIT_QUOTIENT_K - 1)
    assert use_split(SPLIT_QUOTIENT_K) and use_split(SPLIT_QUOTIENT_K + 1)
    assert use_split(K, True) and not use_split(SPLIT_QUOTIENT_K + 1, False)


def test_split_quotient_matches_jax_and_fused():
    """Random witness coefficients and key coefficient rows at k=5: the
    port's `split_quotient` (its key tables from keygen's `coset_tables`),
    the JAX package's `_split_quotient` and the port's fused
    `quotient_stacked` give the same quotient coefficients."""
    rng = np.random.default_rng(7)
    td, jd = TDomain(SMALL_K), JDomain(SMALL_K)
    wit = words(rng, TK.WIT_ROWS, td.n)
    key = words(rng, len(TK.KEY_ROWS), td.n)
    theta, beta, gamma, y = (FR.random(rng) for _ in range(4))
    deltas = [FR.random(rng) for _ in range(6)]
    consts = TK.challenge_words(theta, beta, gamma, y, deltas)
    plan, plan_ext = td.plan("cpu"), td.plan_ext("cpu")

    unscale = powers(CTX, FR.inv(td.zeta), td.n_ext, "cpu", start=FR.inv(td.n_ext))
    pows, xs, zh = coset_tables(td, "cpu")
    pk = SimpleNamespace(coeff_stack=t(key), coset_powers=pows, coset_x=xs, coset_zh_inv=zh,
                         quotient_unscale=unscale)
    got = TK.split_quotient(list(t(wit)), pk, consts, plan, plan_ext)
    assert got.shape == (td.n_ext, 8)

    m = lambda *v: j(CTX.to_mont_np(list(v)))
    jpk = SimpleNamespace(
        fixed_coeff={n: j(key[i]) for i, n in enumerate(ALL_FIXED)},
        sigma_coeff=[j(key[NF + c]) for c in range(6)],
        l0_coeff=j(key[NF + 6]), l_last_coeff=j(key[NF + 7]), l_blind_coeff=j(key[NF + 8]),
        zeta_inv_powers=_zeta_inv_powers(jd))
    want = JP._split_quotient(jpk, jd, [j(w) for w in wit], (m(theta), m(beta), m(gamma)),
                              [m(d) for d in deltas],
                              m(*(pow(y, 23 - i, FR.p) for i in range(24))))
    assert np.array_equal(TL.words_to_limbs_np(TL.to_numpy(got)), np.asarray(want))

    zeta_powers, x_ext, zh_inv_ext = ext_tables(td, "cpu")
    fused = TK.quotient_stacked(TK._ext(t(wit), zeta_powers, plan_ext),
                                TK._ext(t(key), zeta_powers, plan_ext), x_ext,
                                zh_inv_ext[:MAX_DEGREE], consts, unscale, plan_ext)
    assert torch.equal(got, fused)


@pytest.fixture(scope="module")
def split_port():
    """keygen with a forced split-mode key and create_proof of the k=7 test
    circuit on the CPU."""
    from delay_enc_tpu_torch import cs
    from delay_enc_tpu_torch.fields import FR as TFR
    from delay_enc_tpu_torch.plonk import SRS, create_proof, keygen

    srs = SRS.setup(K, tau=TAU, device="cpu")
    b = _build_circuit(cs, TFR)
    pk, vk = keygen(b, srs, split=True, device="cpu")
    proof = create_proof(srs, pk, b, np.random.default_rng(SEED), device="cpu")
    return srs, pk, vk, proof


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return {key: z[key] for key in z.files}


def test_split_key_holds_coset_tables(split_port):
    _, pk, _, _ = split_port
    n = pk.vk.domain.n
    assert pk.split and pk.ext_stack is None and pk.fixed_ext is None and pk.x_ext is None
    assert pk.coeff_stack.shape == (len(TK.KEY_ROWS), n, 8)
    assert pk.coset_powers.shape == pk.coset_x.shape == (MAX_DEGREE, n, 8)
    assert pk.coset_zh_inv.shape == (MAX_DEGREE, 8) and pk.device.type == "cpu"
    for row, name in enumerate(ALL_FIXED):
        assert pk.fixed_coeff[name].data_ptr() == pk.coeff_stack[row].data_ptr()
    assert pk.l_blind_coeff.data_ptr() == pk.coeff_stack[-1].data_ptr()


def test_split_vk_matches_golden(split_port, golden):
    from delay_enc_tpu_torch.curves.bn254 import g1_to_bytes

    _, _, vk, proof = split_port
    rec = _record(g1_to_bytes, [], vk, proof)
    assert np.array_equal(rec["fixed"], golden["fixed"])
    assert np.array_equal(rec["sigma"], golden["sigma"])
    assert str(vk.transcript_repr) == str(golden["transcript_repr"])


def test_split_proof_bytes_match_golden(split_port, golden):
    assert np.array_equal(np.frombuffer(split_port[3], np.uint8), golden["proof"])


def test_both_verifiers_accept_split_proof(split_port):
    from delay_enc_tpu.curves.bn254 import G2_GEN as J_G2_GEN
    from delay_enc_tpu.fields.bn254 import Fq2 as JFq2
    from delay_enc_tpu.plonk.keygen import VerifyingKey as JVerifyingKey
    from delay_enc_tpu.plonk.kzg import SRS as JSRS
    from delay_enc_tpu.plonk.verifier import verify_proof as jax_verify
    from delay_enc_tpu_torch.plonk import verify_proof

    srs, _, vk, proof = split_port
    jvk = JVerifyingKey(JDomain(vk.domain.k), dict(vk.fixed_commitments),
                        list(vk.sigma_commitments), vk.transcript_repr)
    jsrs = JSRS(srs.k, None, tuple(JFq2(c.c0, c.c1) for c in srs.tau_g2), J_G2_GEN)
    assert jax_verify(jsrs, jvk, proof)
    assert verify_proof(srs, vk, proof)
    bad = bytearray(proof)
    bad[-40] ^= 1
    assert not verify_proof(srs, vk, bytes(bad))


def test_k18_circuit_is_bench_row():
    """chip_smoke.py phase 6's circuit, the port's DelayEncryptCircuit from
    its copy of bench.py's draw (`runtime/workloads.py`: seed 42,
    T_BITS[("delay_enc", 18)] = 31),
    equals the JAX package's circuit from bench.py build_circuit: rows,
    columns, permutation cycles and lookup widths; keygen then picks the
    split quotient."""
    import bench
    from delay_enc_tpu.utils.config import Config
    from delay_enc_tpu_torch.plonk.keygen import min_k
    from delay_enc_tpu_torch.runtime import workloads

    k = SPLIT_QUOTIENT_K
    assert bench.T_BITS[("delay_enc", k)] == workloads.T_BITS[("delay_enc", k)] == 31
    want = bench.build_circuit("delay_enc", Config(), seed=42, k=k)
    got = workloads.build_circuit("delay_enc", k)
    assert got.rows == want.rows == 241348 and min_k(got) == k and use_split(min_k(got))
    assert list(got.fixed) == list(want.fixed)
    for g, w in zip([*got.advice, *got.fixed.values(), got.instance],
                    [*want.advice, *want.fixed.values(), want.instance]):
        assert [int(v) for v in g] == [int(v) for v in w]
    assert got.permutation_cycles() == want.permutation_cycles()
    assert got.lookup_widths == want.lookup_widths
