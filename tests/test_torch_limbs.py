"""Port parity: Fr / Fq word arithmetic of delay_enc_tpu_torch.ops.limbs
(plain version of kernel K-a) against delay_enc_tpu.ops.limbs, bit-exact."""

import functools

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


# --------------------------------------- to_mont_np: the C reader and its fallback

@functools.lru_cache(maxsize=2)
def _cases(p):
    """name -> (elements, how many of them the C pass takes), drawn once a
    field."""
    rng = np.random.default_rng(17)

    def below(count, hi):
        return [int.from_bytes(rng.bytes(32), "little") % hi for _ in range(count)]

    r = 1 << 256
    above = [p + v % (r - p) for v in below(512, r)]
    odd = [-1, -p, -(r + 5), r, r + 1, 3 * r + p, True, False,
           np.uint64(2**64 - 1), np.uint64(0), np.int64(-7), np.int64(2**63 - 1)]
    # every width: a compact int (below 2^30) is read from its one word
    widths = [v >> int(rng.integers(0, 256)) for v in below(2000, r)]
    words = [(1 << b) + d for b in (29, 30, 31, 32, 62, 63, 64, 128) for d in (-1, 0, 1)]
    return {
        "edges": ([0, 1, p - 1, p, 2 * p, r - 1], 6),
        "every_width": (list(range(300)) + words + widths, 300 + len(words) + len(widths)),
        "below_p": (below(1000, p), 1000),
        "above_p": (above, 512),
        "negative_and_wide": (odd[:6] + [5], 1),
        "bool_and_numpy_scalars": (odd[6:] + [p - 2], 1),
        "mixed_tuple": (tuple([7, *odd, p + 1, *below(5, p)]), 7),
        "ndarray": (np.array(below(64, 2**64), dtype=np.uint64), 0),
        "empty": ([], 0),
        "one": ([p - 1], 1),
        "long": (below((1 << 16) + 3, r), (1 << 16) + 3),
    }


CASES = ["edges", "every_width", "below_p", "above_p", "negative_and_wide", "bool_and_numpy_scalars",
         "mixed_tuple", "ndarray", "empty", "one", "long"]


def _python_rule(ctx, xs):
    """The conversion in Python alone: int(x) * R mod p as words."""
    return TL.ints_to_words_np([(int(x) << 256) % ctx.p for x in xs])


def _counts():
    c = TL.GLOBAL_METRICS.counters
    return c.get("to_mont native", 0), c.get("to_mont python", 0)


@pytest.mark.parametrize("field", ["fr", "fq"])
@pytest.mark.parametrize("case", CASES)
def test_to_mont_np_native_matches_python_and_jax(field, case):
    """The C reader gives the words of the Python rule and of the JAX
    package's to_mont_np, bit for bit, and counts each element once, under
    the way it took."""
    from delay_enc_tpu_torch import native

    jctx, tctx = _ctxs(field)
    assert native.get_lib() is not None and native.get_pyints() is not None
    xs, n_native = _cases(tctx.p)[case]
    before = _counts()
    got = tctx.to_mont_np(xs)
    after = _counts()
    assert got.dtype == np.uint32 and got.shape == (len(xs), TL.NW)
    assert np.array_equal(got, _python_rule(tctx, xs))
    assert np.array_equal(TL.words_to_limbs_np(got), jctx.to_mont_np([int(x) for x in xs]))
    assert (after[0] - before[0], after[1] - before[1]) == (n_native, len(xs) - n_native)


@pytest.mark.parametrize("absent", ["pyints", "pyints_and_limbops"])
@pytest.mark.parametrize("case", CASES)
def test_to_mont_np_fallback_gives_the_same_words(case, absent, monkeypatch):
    """Without the reader (or without both C libraries) the same elements
    give the same words, every one through Python."""
    from delay_enc_tpu_torch import native

    xs, _ = _cases(TL.FR_CTX.p)[case]
    want = TL.FR_CTX.to_mont_np(xs)
    monkeypatch.setattr(native, "get_pyints", lambda: None)
    if absent == "pyints_and_limbops":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    before = _counts()
    got = TL.FR_CTX.to_mont_np(xs)
    after = _counts()
    assert got.dtype == np.uint32 and np.array_equal(got, want)
    assert (after[0] - before[0], after[1] - before[1]) == (0, len(xs))
