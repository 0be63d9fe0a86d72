"""Port parity: the NTT of delay_enc_tpu_torch (plain version of kernel K-b)
and the batched transforms of its plonk/kernels.py against the JAX
package, bit-exact."""

import numpy as np
import pytest
import torch

import jax

from delay_enc_tpu.fields import FR
from delay_enc_tpu.ops import limbs as JL
from delay_enc_tpu.ops import ntt as JN
from delay_enc_tpu.plonk import kernels as JK
from delay_enc_tpu.plonk.domain import Domain as JDomain
from delay_enc_tpu.plonk.keygen import _zeta_powers as jax_zeta_powers
from delay_enc_tpu_torch.ops import limbs as TL
from delay_enc_tpu_torch.ops import ntt as TN
from delay_enc_tpu_torch.plonk import kernels as TK
from delay_enc_tpu_torch.plonk.domain import Domain as TDomain


def _rand_mont(rng, shape):
    vals = [FR.random(rng) for _ in range(int(np.prod(shape)))]
    return TL.FR_CTX.to_mont_np(vals).reshape(*shape, 8)


def _limbs(t):
    return TL.words_to_limbs_np(TL.to_numpy(t))


@pytest.mark.parametrize("k", range(4, 11))
def test_ntt_intt_match_jax(k):
    rng = np.random.default_rng(k)
    a = _rand_mont(rng, (1 << k,))
    tplan = TN.NTTPlan.make(TL.FR_CTX, k, "cpu")
    jplan = JN.NTTPlan.make(JL.FR_CTX, k)
    at = TL.to_tensor(a, "cpu")
    fwd = TN.ntt(tplan, at)
    want = jax.jit(lambda x: JN.ntt(jplan, x))(TL.words_to_limbs_np(a))
    assert np.array_equal(_limbs(fwd), np.asarray(want))
    inv = TN.intt(tplan, at)
    want = jax.jit(lambda x: JN.intt(jplan, x))(TL.words_to_limbs_np(a))
    assert np.array_equal(_limbs(inv), np.asarray(want))
    assert torch.equal(TN.intt(tplan, fwd), at)


def test_ext_batch_matches_jax_every_lane():
    """The (19, n) -> (19, 8n) extended-coset transform at n = 2^6, every
    lane including the last."""
    k = 6
    rng = np.random.default_rng(19)
    coeff = _rand_mont(rng, (19, 1 << k))
    jd, td = JDomain(k), TDomain(k)
    zp_j = jax_zeta_powers(jd)
    zp_t = TN.powers(TL.FR_CTX, td.zeta, td.n_ext, "cpu")
    got = TK._ext(TL.to_tensor(coeff, "cpu"), zp_t, td.plan_ext("cpu"))
    want = np.asarray(JK._jit_ext_batch(TL.words_to_limbs_np(coeff), zp_j, jd.plan_ext.tw))
    assert got.shape == (19, 8 << k, 8)
    for lane in range(19):
        assert np.array_equal(_limbs(got[lane]), want[lane]), lane


def test_coeff_batch_matches_jax():
    k = 6
    rng = np.random.default_rng(20)
    evals = _rand_mont(rng, (6, 1 << k))
    jd, td = JDomain(k), TDomain(k)
    got = TK._coeff(TL.to_tensor(evals, "cpu"), td.plan("cpu"))
    want = np.asarray(JK._jit_coeff_batch(TL.words_to_limbs_np(evals),
                                          jd.plan.tw_inv, jd.plan.n_inv))
    assert np.array_equal(_limbs(got), want)


def test_evals_batch_matches_jax():
    k = 5
    rng = np.random.default_rng(21)
    coeff = _rand_mont(rng, (6, 1 << k))
    jd, td = JDomain(k), TDomain(k)
    got = TK._evals_batch(TL.to_tensor(coeff, "cpu"), td.plan("cpu"))
    want = np.asarray(JK._jit_evals_batch(TL.words_to_limbs_np(coeff), jd.plan.tw))
    assert np.array_equal(_limbs(got), want)
