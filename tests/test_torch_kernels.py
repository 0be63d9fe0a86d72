"""Port parity: the prover building blocks of delay_enc_tpu_torch.plonk.kernels
(compress, fracs, batched grand products, the fused quotient, eval_stack,
gwc_witness) against the JAX package's jitted functions at n = 2^6,
bit-exact, on random Montgomery inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from delay_enc_tpu.fields import FR
from delay_enc_tpu.plonk import kernels as JK
from delay_enc_tpu.plonk.domain import Domain as JDomain
from delay_enc_tpu.plonk.keygen import ALL_FIXED
from delay_enc_tpu_torch.ops import limbs as TL
from delay_enc_tpu_torch.plonk import kernels as TK
from delay_enc_tpu_torch.plonk.domain import Domain as TDomain

K = 6
N = 1 << K
N_EXT = 8 * N
CTX = TL.FR_CTX


class Inputs:
    """Random Montgomery words, handed to both packages."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def words(self, *shape):
        count = int(np.prod(shape))
        return CTX.to_mont_np([FR.random(self.rng) for _ in range(count)]).reshape(*shape, 8)


def t(w):
    return TL.to_tensor(w, "cpu")


def j(w):
    return jnp.asarray(TL.words_to_limbs_np(w))


def same(got, want):
    return np.array_equal(TL.words_to_limbs_np(TL.to_numpy(got)), np.asarray(want))


def test_compress_matches_jax():
    x = Inputs(1)
    tag, adv, theta = x.words(N), x.words(N), x.words(1)
    assert same(TK._compress(t(tag), t(adv), t(theta)), JK._jit_compress(j(tag), j(adv), j(theta)))


def test_fracs_match_jax():
    x = Inputs(2)
    cols, sig, omega = x.words(6, N), x.words(6, N), x.words(N)
    beta, gamma, deltas = x.words(1), x.words(1), x.words(6, 1)
    num, den = TK._perm_fracs([t(c) for c in cols], [t(s) for s in sig], t(omega),
                              t(beta), t(gamma), [t(d) for d in deltas])
    jnum, jden = JK._jit_perm_fracs([j(c) for c in cols], [j(s) for s in sig], j(omega),
                                    j(beta), j(gamma), [j(d) for d in deltas])
    assert same(num, jnum) and same(den, jden)
    a, s, ap, sp = (x.words(N) for _ in range(4))
    num, den = TK._lookup_fracs(t(a), t(s), t(ap), t(sp), t(beta), t(gamma))
    jnum, jden = JK._jit_lookup_fracs(j(a), j(s), j(ap), j(sp), j(beta), j(gamma))
    assert same(num, jnum) and same(den, jden)


@pytest.mark.parametrize("impl", ["block", "hs"])
def test_grand_products_match_jax(impl):
    x = Inputs(3)
    num, den = x.words(5, N), x.words(5, N)
    active_np = np.arange(N) < N - 7
    tn, tpre, tsuf, ttot = TK._gp_partials(t(num), t(den), torch.from_numpy(active_np), impl)
    jn, jpre, jsuf, jtot = JK._jit_gp_partials_batch(j(num), j(den), jnp.asarray(active_np))
    for got, want in ((tn, jn), (tpre, jpre), (tsuf, jsuf), (ttot, jtot)):
        assert same(got, want)
    tot_inv = CTX.to_mont_np([pow(v, -1, FR.p) for v in CTX.from_mont_np(TL.to_numpy(ttot))])
    blind = x.words(5, 6)
    z = TK._gp_finish(tn, tpre, tsuf, t(tot_inv), t(blind), impl)
    jz = JK._jit_gp_finish_batch(jn, jpre, jsuf, j(tot_inv), j(blind))
    assert same(z, jz)


def test_quotient_matches_jax():
    x = Inputs(4)
    adv, inst, zp = x.words(5, N_EXT), x.words(N_EXT), x.words(N_EXT)
    zl, ap, sp = x.words(4, N_EXT), x.words(4, N_EXT), x.words(4, N_EXT)
    fe = {name: x.words(N_EXT) for name in ALL_FIXED}
    sig = x.words(6, N_EXT)
    masks = x.words(4, N_EXT)
    chals = x.words(3, 1)
    deltas = x.words(6, 1)
    zh_inv, zeta_inv, y_pows = x.words(N_EXT), x.words(N_EXT), x.words(24)
    lk = ("a", "b", "c", "d")

    def args(f):
        return ([f(a) for a in adv], f(inst), f(zp), {l: f(zl[i]) for i, l in enumerate(lk)},
                {l: f(ap[i]) for i, l in enumerate(lk)}, {l: f(sp[i]) for i, l in enumerate(lk)},
                {n: f(v) for n, v in fe.items()}, [f(s) for s in sig], tuple(f(m) for m in masks),
                tuple(f(c) for c in chals), [f(d) for d in deltas], f(zh_inv), f(zeta_inv),
                f(y_pows))

    td, jd = TDomain(K), JDomain(K)
    got = TK._quotient(*args(t), td.plan_ext("cpu"))
    want = JK._jit_quotient(*args(j), jd.plan_ext.tw_inv, jd.plan_ext.n_inv)
    assert got.shape == (N_EXT, 8)
    assert same(got, want)


def test_eval_stack_matches_jax():
    x = Inputs(5)
    stack, pt = x.words(9, N), x.words(1)[0]
    assert same(TK._eval_stack(t(stack), t(pt)), JK._jit_eval_stack(j(stack), j(pt)))


def test_gwc_witness_matches_jax():
    x = Inputs(6)
    stack = x.words(6, N)
    v, z = FR.random(x.rng), FR.random(x.rng)
    vm, zm, zim = (CTX.to_mont_np([c])[0] for c in (v, z, pow(z, -1, FR.p)))
    got = TK._gwc_witness(t(stack), t(vm), t(zm), t(zim))
    want = JK._jit_gwc_witness(j(stack), j(vm), j(zm), j(zim))
    assert same(got, want)
