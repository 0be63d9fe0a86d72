"""Port parity: the scans, powers_of and divide_by_linear of
delay_enc_tpu_torch.ops.poly against delay_enc_tpu.ops.poly at n = 16384
(the size tests/test_poly.py pins), bit-exact."""

import numpy as np
import pytest
import torch

import jax

from delay_enc_tpu.fields import FR
from delay_enc_tpu.ops import limbs as JL
from delay_enc_tpu.ops import poly as JP
from delay_enc_tpu_torch.ops import limbs as TL
from delay_enc_tpu_torch.ops import poly as TP

N = 16384
JCTX, TCTX = JL.FR_CTX, TL.FR_CTX


@pytest.fixture(scope="module")
def column():
    rng = np.random.default_rng(2024)
    return TCTX.to_mont_np([FR.random(rng) for _ in range(N)])


def _limbs(t):
    return TL.words_to_limbs_np(TL.to_numpy(t))


@pytest.mark.parametrize("name", ["prefix_product", "suffix_product"])
@pytest.mark.parametrize("impl", ["block", "hs"])
def test_products_match_jax(column, name, impl):
    got = getattr(TP, name)(TCTX, TL.to_tensor(column, "cpu"), impl)
    want = jax.jit(lambda a: getattr(JP, name)(JCTX, a, "block"))(TL.words_to_limbs_np(column))
    assert np.array_equal(_limbs(got), np.asarray(want))


def test_suffix_sum_matches_jax(column):
    got = TP.suffix_sum(TCTX, TL.to_tensor(column, "cpu"), "block")
    want = jax.jit(lambda a: JP.suffix_sum(JCTX, a))(TL.words_to_limbs_np(column))
    assert np.array_equal(_limbs(got), np.asarray(want))


def test_batched_scan_matches_rows(column):
    """A (3, n) stack scans each row as the single-row call does, and an n
    that is not a multiple of the block pads exactly."""
    stack = TL.to_tensor(column.reshape(4, N // 4, 8)[:3, :1000], "cpu")
    got = TP.prefix_product(TCTX, stack, "block")
    for r in range(3):
        assert torch.equal(got[r], TP.prefix_product(TCTX, stack[r], "hs"))


def test_unknown_scan_raises(column):
    with pytest.raises(ValueError, match="unknown scan"):
        TP.prefix_product(TCTX, TL.to_tensor(column[:16], "cpu"), "blocks")


def test_powers_of_matches_jax(column):
    x = column[5]
    got = TP.powers_of(TCTX, TL.to_tensor(x, "cpu"), N)
    want = jax.jit(lambda v: JP.powers_of(JCTX, v, N))(TL.words_to_limbs_np(x))
    assert np.array_equal(_limbs(got), np.asarray(want))


def test_divide_by_linear_matches_jax(column):
    z = FR.random(np.random.default_rng(7))
    zp = TCTX.to_mont_np([pow(z, i, FR.p) for i in range(N)])
    zinv = TCTX.to_mont_np([pow(z, -i, FR.p) for i in range(N + 1)])
    got = TP.divide_by_linear(TCTX, TL.to_tensor(column, "cpu"), TL.to_tensor(zp, "cpu"),
                              TL.to_tensor(zinv, "cpu"))
    want = jax.jit(lambda c, a, b: JP.divide_by_linear(JCTX, c, a, b))(
        TL.words_to_limbs_np(column), TL.words_to_limbs_np(zp), TL.words_to_limbs_np(zinv))
    assert np.array_equal(_limbs(got), np.asarray(want))
