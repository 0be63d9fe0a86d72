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
from delay_enc_tpu_torch.ops import poly as TP
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
    # the port keeps the exclusive products: row i of the JAX package's
    # inclusive ones shifted by one, with Montgomery 1 where nothing precedes
    one = jnp.broadcast_to(j(CTX.to_mont_np([1])), (5, 1, 16))
    jpre_excl = jnp.concatenate([one, jpre[:, :-1]], axis=1)
    jsuf_excl = jnp.concatenate([jsuf[:, 1:], one], axis=1)
    for got, want in ((tn, jn), (tpre, jpre_excl), (tsuf, jsuf_excl), (ttot, jtot)):
        assert same(got, want)
    tot_inv = CTX.to_mont_np([pow(v, -1, FR.p) for v in CTX.from_mont_np(TL.to_numpy(ttot))])
    blind = x.words(5, 6)
    z = TK._gp_finish(tn, tpre, tsuf, t(tot_inv), t(blind), impl)
    jz = JK._jit_gp_finish_batch(jn, jpre, jsuf, j(tot_inv), j(blind))
    assert same(z, jz)


def test_quotient_matches_jax():
    """The plain path of `quotient_stacked`: the stacks and challenge words
    that the kernel takes, against the JAX package's separate columns."""
    x = Inputs(4)
    wit = x.words(TK.WIT_ROWS, N_EXT)
    key = x.words(len(TK.KEY_ROWS), N_EXT)
    x_ext = x.words(N_EXT)
    zh8, zeta_inv = x.words(8), x.words(N_EXT)
    theta, beta, gamma, y = (FR.random(x.rng) for _ in range(4))
    deltas = [FR.random(x.rng) for _ in range(6)]
    consts = TK.challenge_words(theta, beta, gamma, y, deltas)
    lk = ("a", "b", "c", "d")
    nf = len(ALL_FIXED)
    w = lambda *v: CTX.to_mont_np(list(v))
    y_pows = w(*(pow(y, 23 - i, FR.p) for i in range(24)))
    jargs = ([j(a) for a in wit[:5]], j(wit[5]), j(wit[6]),
             {l: j(wit[7 + i]) for i, l in enumerate(lk)},
             {l: j(wit[11 + i]) for i, l in enumerate(lk)},
             {l: j(wit[15 + i]) for i, l in enumerate(lk)},
             {n: j(key[i]) for i, n in enumerate(ALL_FIXED)}, [j(s) for s in key[nf : nf + 6]],
             (j(key[nf + 6]), j(key[nf + 7]), j(key[nf + 8]), j(x_ext)),
             tuple(j(w(v)) for v in (theta, beta, gamma)), [j(w(d)) for d in deltas],
             j(np.tile(zh8, (N_EXT // 8, 1))), j(zeta_inv), j(y_pows))

    td, jd = TDomain(K), JDomain(K)
    # the port takes zeta^-i and 1/n_ext as one table
    unscale = TK._mul(t(zeta_inv), td.plan_ext("cpu").n_inv)
    got = TK.quotient_stacked(t(wit), t(key), t(x_ext), t(zh8), consts, unscale,
                              td.plan_ext("cpu"))
    want = JK._jit_quotient(*jargs, jd.plan_ext.tw_inv, jd.plan_ext.n_inv)
    assert got.shape == (N_EXT, 8)
    assert same(got, want)


def test_eval_stack_matches_jax():
    x = Inputs(5)
    stack, pt = x.words(9, N), x.words(1)[0]
    got = TK._eval_stack([t(stack)], [TP.powers_of(CTX, t(pt), N)])
    assert same(got, JK._jit_eval_stack(j(stack), j(pt)))


def test_gwc_witness_matches_jax():
    x = Inputs(6)
    stack = x.words(6, N)
    v, z = FR.random(x.rng), FR.random(x.rng)
    vm, zm, zim = (CTX.to_mont_np([c])[0] for c in (v, z, pow(z, -1, FR.p)))
    got = TK._gwc_witness([t(stack)], [TP.powers_of(CTX, t(zm), N)], t(vm), [t(zim)])
    want = JK._jit_gwc_witness(j(stack), j(vm), j(zm), j(zim))
    assert len(got) == 1 and same(got[0], want)
