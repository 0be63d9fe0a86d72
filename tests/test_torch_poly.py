"""Port parity: the scans, powers_of and divide_scaled of
delay_enc_tpu_torch.ops.poly against delay_enc_tpu.ops.poly (divide_scaled
against divide_by_linear) at n = 16384
(the size tests/test_poly.py pins), bit-exact.  Every JAX comparison of a
scan is a case of `test_matches_jax`; each case also runs `scan_tiles_plain`,
the kernel's own steps, at the kernel's tile and at a small one.  The JAX
package's results are computed once a module and sliced: the ladder scans
run over a 2048-element end of the column, whose prefixes (or suffixes) are
those of the whole column."""

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
SHORT = 2048  # elements the ladder ("hs") cases scan
KERNEL_TILE = (128, 8)  # the kernel's tile for one row of N (tests/test_torch_scan.py)
JCTX, TCTX = JL.FR_CTX, TL.FR_CTX
CASES = ([(name, impl, ex) for name in ("prefix_product", "suffix_product", "suffix_sum")
          for impl in ("block", "hs") for ex in (False, True)]
         + [("powers_of", count, True) for count in (1, 2, 3, 65, N)]
         + [("divide_by_linear", "block", False)])


@pytest.fixture(scope="module")
def column():
    rng = np.random.default_rng(2024)
    return TCTX.to_mont_np([FR.random(rng) for _ in range(N)])


@pytest.fixture(scope="module")
def jax_results(column):
    """Each JAX function once over the column, on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            col = TL.words_to_limbs_np(column)
            if name == "suffix_sum":
                fn = lambda a: JP.suffix_sum(JCTX, a)
            elif name == "powers_of":
                col, fn = col[5], lambda v: JP.powers_of(JCTX, v, N)
            else:
                fn = lambda a: getattr(JP, name)(JCTX, a, "block")
            cache[name] = np.asarray(jax.jit(fn)(col))
        return cache[name]

    return get


def _limbs(t):
    return TL.words_to_limbs_np(TL.to_numpy(t))


def _exclusive(want, reverse, identity):
    """The JAX package's inclusive scan shifted, as its callers shift it
    (kernels.py _gp_finish, poly.py divide_by_linear)."""
    ident = np.broadcast_to(identity, want[:1].shape)
    return np.concatenate([want[1:], ident] if reverse else [ident, want[:-1]])


def _divide_by_linear(column):
    z = FR.random(np.random.default_rng(7))
    zp = TCTX.to_mont_np([pow(z, i, FR.p) for i in range(N)])
    zinv = TCTX.to_mont_np([pow(z, -i, FR.p) for i in range(N + 1)])
    want = np.asarray(jax.jit(lambda c, a, b: JP.divide_by_linear(JCTX, c, a, b))(
        TL.words_to_limbs_np(column), TL.words_to_limbs_np(zp), TL.words_to_limbs_np(zinv)))
    # the port's divide_scaled takes a_j z^j, the product that K7 makes
    t = TL.mont_mul(TCTX, TL.to_tensor(column, "cpu"), TL.to_tensor(zp, "cpu"))
    got = TP.divide_scaled(TCTX, t, TL.to_tensor(zinv, "cpu"))
    assert np.array_equal(_limbs(got), want)
    # and through the kernel's steps: the exclusive reverse sum of a_j z^j
    above = TP.scan_tiles_plain(TCTX, t, "add", tile=KERNEL_TILE, exclusive=True, reverse=True)
    scaled = TL.mont_mul(TCTX, above, TL.to_tensor(zinv, "cpu")[1:])
    assert torch.equal(scaled, got)


@pytest.mark.parametrize("name,impl,exclusive", CASES,
                         ids=[f"{c[0]}-{c[1]}-{'excl' if c[2] else 'incl'}" for c in CASES])
def test_matches_jax(column, jax_results, name, impl, exclusive):
    if name == "divide_by_linear":
        _divide_by_linear(column)
        return
    if name == "powers_of":
        x = TL.to_tensor(column[5], "cpu")
        want = jax_results(name)[:impl]
        assert np.array_equal(_limbs(TP.powers_of(TCTX, x, impl)), want)
        for tile in (KERNEL_TILE, (4, 2)):
            got = TP.scan_tiles_plain(TCTX, x, "mul", tile=tile, exclusive=True, n=impl)
            assert np.array_equal(_limbs(got), want), tile
        return
    op, reverse = ("add", True) if name == "suffix_sum" else ("mul", name == "suffix_product")
    want = jax_results(name)
    if exclusive:
        want = _exclusive(want, reverse, np.asarray(JCTX.one_mont()) if op == "mul"
                          else np.zeros_like(want[0]))
    a = column
    if impl == "hs":  # a 2048-element end of the column: the same prefixes
        a, want = (column[-SHORT:], want[-SHORT:]) if reverse else (column[:SHORT],
                                                                     want[:SHORT])
    a = TL.to_tensor(a, "cpu")
    got = getattr(TP, name)(TCTX, a, impl, exclusive=exclusive)
    assert np.array_equal(_limbs(got), want)
    for tile in (KERNEL_TILE, (4, 2)):
        tiled = TP.scan_tiles_plain(TCTX, a, op, tile=tile, exclusive=exclusive, reverse=reverse)
        assert np.array_equal(_limbs(tiled), want), tile


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
