"""Port parity: Fr / Fq word arithmetic of delay_enc_tpu_torch.ops.limbs
(plain version of kernel K-a) against delay_enc_tpu.ops.limbs, bit-exact."""

import numpy as np
import pytest
import torch

from delay_enc_tpu.ops import limbs as JL
from delay_enc_tpu_torch.ops import limbs as TL

N = 4096


def _ctxs(name):
    return {"fr": (JL.FR_CTX, TL.FR_CTX), "fq": (JL.FQ_CTX, TL.FQ_CTX)}[name]


def _operands(ctx, seed):
    """N random canonical values below p plus the edge values 0, 1, p-1,
    as Montgomery words (numpy uint32 (N+3, 8)), two independent draws."""
    rng = np.random.default_rng(seed)
    p = ctx.p

    def draw():
        raw = rng.integers(0, 1 << 32, (N, 8), dtype=np.uint64).astype(np.uint32)
        vals = [v % p for v in TL.words_to_ints_np(raw)] + [0, 1, p - 1]
        return ctx.to_mont_np(vals)

    a, b = draw(), draw()
    b[-3:] = a[-3:][::-1]  # edge values meet each other too
    return a, b


def _jax(fn, *args):
    return np.asarray(fn(*[np.asarray(x) for x in args]))


@pytest.mark.parametrize("field", ["fr", "fq"])
@pytest.mark.parametrize("op", ["mont_mul", "add", "sub"])
def test_binary_matches_jax(field, op):
    jctx, tctx = _ctxs(field)
    a, b = _operands(tctx, seed=["fr", "fq"].index(field) * 3 + ["mont_mul", "add", "sub"].index(op))
    got = getattr(TL, op)(tctx, TL.to_tensor(a, "cpu"), TL.to_tensor(b, "cpu"))
    want = _jax(lambda x, y: getattr(JL, op)(jctx, x, y),
                TL.words_to_limbs_np(a), TL.words_to_limbs_np(b))
    assert np.array_equal(TL.words_to_limbs_np(TL.to_numpy(got)), want)


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_broadcast_scalar_operand(field):
    jctx, tctx = _ctxs(field)
    a, b = _operands(tctx, seed=5)
    got = TL.mont_mul(tctx, TL.to_tensor(a, "cpu"), TL.to_tensor(b[7:8], "cpu"))
    want = _jax(lambda x, y: JL.mont_mul(jctx, x, y),
                TL.words_to_limbs_np(a), TL.words_to_limbs_np(b[7:8]))
    assert np.array_equal(TL.words_to_limbs_np(TL.to_numpy(got)), want)


@pytest.mark.parametrize("field", ["fr", "fq"])
@pytest.mark.parametrize("op", ["neg", "mont_to_canonical", "canonical_to_mont"])
def test_unary_matches_jax(field, op):
    jctx, tctx = _ctxs(field)
    a, _ = _operands(tctx, seed=11)
    got = getattr(TL, op)(tctx, TL.to_tensor(a, "cpu"))
    want = _jax(lambda x: getattr(JL, op)(jctx, x), TL.words_to_limbs_np(a))
    assert np.array_equal(TL.words_to_limbs_np(TL.to_numpy(got)), want)


def test_word_limb_round_trip():
    rng = np.random.default_rng(3)
    w = rng.integers(0, 1 << 32, (64, 3, 8), dtype=np.uint64).astype(np.uint32)
    limbs = TL.words_to_limbs_np(w)
    assert limbs.shape == (64, 3, 16) and limbs.max() < (1 << 16)
    assert np.array_equal(TL.limbs_to_words_np(limbs), w)
    # the JAX package's integer view of the same limbs
    assert JL.limbs_to_ints_np(limbs.reshape(-1, 16)) == TL.words_to_ints_np(w)
    t = TL.to_tensor(w, "cpu")
    assert t.dtype == torch.int32 and np.array_equal(TL.to_numpy(t), w)


def test_host_conversions_match_jax():
    vals = [0, 1, JL.FR_CTX.field.p - 1, 12345678901234567890]
    mont = TL.FR_CTX.to_mont_np(vals)
    assert np.array_equal(TL.words_to_limbs_np(mont), JL.FR_CTX.to_mont_np(vals))
    assert TL.FR_CTX.from_mont_np(mont) == vals
