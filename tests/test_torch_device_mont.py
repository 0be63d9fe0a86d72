"""The Montgomery conversions that the prover leaves to the card: the
advice and instance columns go up as canonical words (`to_words_np`) and
`canonical_to_mont` (K-a by R^2) turns them into the words the host's
`to_mont_np` gives; the random polynomials go up as their 64-byte draws and
`wide_to_mont` (`field_wide_to_mont`) turns them into the words of the
host's wide reduction (`native/ec.py:uniform_to_fr_mont`).  On the CPU with
the C libraries and without them, and on a card (`card`, skipped without
one).  This file imports no JAX, so the card's cases run where the JAX
package is not installed (`--noconftest`: the tests' conftest sets JAX up):

    python -m pytest -q -m card --noconftest tests/test_torch_device_mont.py
"""

import numpy as np
import pytest
import torch

from delay_enc_tpu_torch import native
from delay_enc_tpu_torch.fields.bn254 import FR
from delay_enc_tpu_torch.native import ec
from delay_enc_tpu_torch.ops import limbs as TL
from delay_enc_tpu_torch.utils.timers import GLOBAL_METRICS

R = 1 << 256


def _ctx(field):
    return {"fr": TL.FR_CTX, "fq": TL.FQ_CTX}[field]


def _ints(p: int, case: str, seed: int = 0):
    """A column's ints: the edges 0, 1, p - 1, p, 2^256 - 1; small ints;
    random 254-bit ints; and a mix with the elements only Python reads."""
    rng = np.random.default_rng(seed + sum(map(ord, case)))
    wide = [int.from_bytes(rng.bytes(32), "little") >> 2 for _ in range(300)]
    small = [int(v) for v in rng.integers(0, 1 << 20, 300)]
    edges = [0, 1, p - 1, p, R - 1]
    return {
        "edges": edges,
        "small": small,
        "wide_254_bit": wide,
        "mixed": edges + small[:50] + wide[:50] + [p + 1, 2 * p, -1, -p, R, R + 7, True,
                                                   np.uint64(2**64 - 1), np.int64(-3)],
        "tuple": tuple(edges + wide[:20] + small[:20]),
    }[case]


CASES = ["edges", "small", "wide_254_bit", "mixed", "tuple"]
ABSENT = ["none", "pyints", "pyints_and_limbops"]


def _counts():
    c = GLOBAL_METRICS.counters
    return c.get("to_mont native", 0), c.get("to_mont python", 0)


def _absent(monkeypatch, absent: str) -> None:
    if "pyints" in absent:
        monkeypatch.setattr(native, "get_pyints", lambda: None)
    if "limbops" in absent:
        monkeypatch.setattr(native, "get_lib", lambda: None)


@pytest.mark.parametrize("absent", ABSENT)
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("field", ["fr", "fq"])
def test_canonical_words_through_k_a_equal_to_mont_np(field, case, absent, monkeypatch):
    """to_words_np's words through canonical_to_mont are to_mont_np's
    words, the host's conversion with the C libraries; to_words_np counts
    each element under the way to_mont_np reads it."""
    ctx = _ctx(field)
    xs = _ints(ctx.p, case)
    want = ctx.to_mont_np(xs)
    _absent(monkeypatch, absent)
    before = _counts()
    ctx.to_mont_np(xs)
    as_mont = tuple(a - b for a, b in zip(_counts(), before))
    before = _counts()
    words = ctx.to_words_np(xs)
    assert tuple(a - b for a, b in zip(_counts(), before)) == as_mont
    assert words.dtype == np.uint32 and words.shape == (len(xs), TL.NW)
    got = TL.canonical_to_mont(ctx, TL.to_tensor(words, "cpu"))
    assert np.array_equal(TL.to_numpy(got), want)


@pytest.mark.parametrize("absent", ABSENT)
def test_to_words_np_into_rows(absent, monkeypatch):
    """to_words_np(out=rows) writes its words in those rows and no other,
    and returns them."""
    _absent(monkeypatch, absent)
    xs = _ints(FR.p, "mixed")
    want = TL.FR_CTX.to_words_np(xs)
    buf = np.full((len(xs) + 3, TL.NW), 0xA5A5A5A5, dtype=np.uint32)
    got = TL.FR_CTX.to_words_np(xs, out=buf[1 : 1 + len(xs)])
    assert got.base is buf and np.array_equal(got, want)
    assert (buf[0] == 0xA5A5A5A5).all() and (buf[1 + len(xs) :] == 0xA5A5A5A5).all()


def test_reader_takes_every_width_below_2_256_as_it_is():
    """The C reader puts every exact int in [0, 2^256) into its words as it
    is, whatever its width (one digit or nine, each digit boundary), and
    leaves 2^256 and more, and negative ints, to Python's int(x) % p."""
    if native.get_pyints() is None:
        pytest.skip("the C reader did not build here")
    rng = np.random.default_rng(3)
    taken = [0, 1, R - 1] + [(1 << b) + d for b in range(1, 256) for d in (-1, 0, 1)] + \
        [int.from_bytes(rng.bytes(32), "little") >> int(s) for s in rng.integers(0, 256, 500)]
    left = [R, R + 1, 2 * R - 1, (1 << 270) + 5, R << 40, -1, -(1 << 64), -R]
    xs = taken + left
    before = _counts()
    words = TL.FR_CTX.to_words_np(xs)
    assert tuple(a - b for a, b in zip(_counts(), before)) == (len(taken), len(left))
    assert TL.words_to_ints_np(words) == taken + [x % FR.p for x in left]


def _wide_rows(case: str, count: int = 400) -> np.ndarray:
    """(count, 64) bytes: all zero, all 0xFF, random, or all three."""
    rng = np.random.default_rng(sum(map(ord, case)))
    rand = rng.integers(0, 256, (count, 64), dtype="uint8")
    return {
        "zero": np.zeros((count, 64), dtype=np.uint8),
        "ones": np.full((count, 64), 0xFF, dtype=np.uint8),
        "random": rand,
        "mixed": np.concatenate([np.zeros((3, 64), np.uint8), np.full((3, 64), 0xFF, np.uint8),
                                 rand[:50]]),
    }[case]


@pytest.mark.parametrize("absent", ["none", "ecops_and_limbops"])
@pytest.mark.parametrize("case", ["zero", "ones", "random", "mixed"])
def test_wide_rows_through_the_reduction_equal_the_hosts(case, absent, monkeypatch):
    """64-byte rows as (…, 16) words through wide_to_mont give the host's
    wide reduction: uniform_to_fr_mont with the C library, from_uniform_bytes
    and to_mont_np in Python without the C libraries."""
    raw = _wide_rows(case)
    if absent == "none":
        want = ec.uniform_to_fr_mont(raw)
        assert want is not None
    else:
        monkeypatch.setattr(ec, "get_eclib", lambda: None)
        _absent(monkeypatch, "pyints_and_limbops")
        assert ec.uniform_to_fr_mont(raw) is None
        want = TL.FR_CTX.to_mont_np([FR.from_uniform_bytes(bytes(r)) for r in raw])
    words = raw.view(np.uint32).reshape(2, -1, 2 * TL.NW)  # a batch of two
    got = TL.wide_to_mont(TL.FR_CTX, TL.to_tensor(words, "cpu"))
    assert got.shape == (2, len(raw) // 2, TL.NW)
    assert np.array_equal(TL.to_numpy(got).reshape(-1, TL.NW), want)


@pytest.mark.parametrize("shape", [(3, 8), (3, 15), (3, 16, 2)])
def test_wide_to_mont_refuses_other_rows(shape):
    with pytest.raises(ValueError):
        TL.wide_to_mont(TL.FR_CTX, torch.zeros(shape, dtype=torch.int32))


# ------------------------------------------------------------- on a card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    return torch.device("cuda")


@pytest.mark.card
def test_canonical_to_mont_on_the_card(card):
    """K-a by R^2 over a (6, 2^18) stack of canonical words, as a k=18
    proof sends them: every edge case, random 254-bit, 256-bit and small
    ints, and ints above 2^256 - p, against the host's to_mont_np and the
    plain version; one launch."""
    from delay_enc_tpu_torch.ops import _cuda

    ctx, n = TL.FR_CTX, 1 << 18
    xs = _ints(ctx.p, "mixed")
    rng = np.random.default_rng(7)
    words = rng.integers(0, 1 << 32, (6 * n, TL.NW), dtype=np.uint64).astype(np.uint32)
    words[1::4, 7] &= 0x3FFFFFFF  # 254-bit ints; every fourth row from 0 any 256-bit one
    words[2::4, 1:] = 0  # small ones
    words[3::4, 7] |= 0xF0000000  # above 2^256 - p
    words[: len(xs)] = ctx.to_words_np(xs)
    words = words.reshape(6, n, TL.NW)
    before = _cuda.launch_counts()["field_mont_mul"]
    got = TL.canonical_to_mont(ctx, TL.to_tensor(words, card))
    assert _cuda.launch_counts()["field_mont_mul"] == before + 1
    got = TL.to_numpy(got).reshape(-1, TL.NW)
    assert np.array_equal(got[: len(xs)], ctx.to_mont_np(xs))
    want = ctx.to_mont_np(TL.words_to_ints_np(words[1, :4096]))
    assert np.array_equal(got[n : n + 4096], want)
    plain = TL.canonical_to_mont(ctx, TL.to_tensor(words[:, :8192], "cpu"))
    assert np.array_equal(got.reshape(6, n, TL.NW)[:, :8192], TL.to_numpy(plain))


@pytest.mark.card
def test_wide_to_mont_on_the_card(card):
    """field_wide_to_mont over (2, 2^17) rows of 64 bytes, zero, all-0xFF
    and random rows among them, against the host's C wide reduction and
    the plain version; one launch."""
    from delay_enc_tpu_torch.ops import _cuda

    raw = np.random.default_rng(9).integers(0, 256, (1 << 18, 64), dtype="uint8")
    raw[:5] = 0
    raw[5:10] = 0xFF
    words = raw.view(np.uint32).reshape(2, 1 << 17, 2 * TL.NW)
    before = _cuda.launch_counts()["field_wide_to_mont"]
    got = TL.wide_to_mont(TL.FR_CTX, TL.to_tensor(words, card))
    assert _cuda.launch_counts()["field_wide_to_mont"] == before + 1
    got = TL.to_numpy(got).reshape(-1, TL.NW)
    want = ec.uniform_to_fr_mont(raw)
    assert want is not None and np.array_equal(got, want)
    plain = TL.wide_to_mont(TL.FR_CTX, TL.to_tensor(words[:, :8192], "cpu"))
    assert np.array_equal(got.reshape(2, -1, TL.NW)[:, :8192], TL.to_numpy(plain))
