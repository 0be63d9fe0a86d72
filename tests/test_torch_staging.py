"""The prover's host staging buffer (`plonk/prover.py:staging`): each writer
of a proof's host words gives in the rows it is handed the words it gives
as an array (`FieldCtx.to_mont_np(out=)`, `_permuted_columns(ap=, sp=)`),
on the C paths and without the C libraries; the random polynomials' rows
are their draws as drawn (`_rand_wide_rows`); the buffer grows once a
thread and shape and is reused after; two threads hold two buffers;
`to_tensor` to the CPU never aliases its source; and the proofs keep the
golden bytes."""

import os
import sys
import threading

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_lookup_permute import _case, _refused, _tables  # noqa: E402
from test_torch_prover import GOLDEN, K, SEED, TAU, _build_circuit, one_thread  # noqa: E402,F401

from delay_enc_tpu_torch import native  # noqa: E402
from delay_enc_tpu_torch.fields.bn254 import FR  # noqa: E402
from delay_enc_tpu_torch.ops import limbs as TL  # noqa: E402
from delay_enc_tpu_torch.plonk import prover as TP  # noqa: E402
from delay_enc_tpu_torch.utils.timers import GLOBAL_METRICS  # noqa: E402

SENTINEL = 0xA5A5A5A5


class Column:
    """A sequence that is neither a list nor a tuple: Python reads it all."""

    def __init__(self, items):
        self.items = list(items)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def __iter__(self):
        return iter(self.items)


def _elements(name: str):
    p, r = FR.p, 1 << 256
    rng = np.random.default_rng(sum(map(ord, name)))
    wide = [int.from_bytes(rng.bytes(32), "little") for _ in range(40)]
    small = [int(v) for v in rng.integers(0, 1 << 20, 200)]
    mixed = small[:20] + [-1, -p, r, r + 1, 3 * r + p, True, False, np.uint64(2**64 - 1),
                          np.int64(-7), np.uint32(5)] + wide[:20]
    return {
        "small": small,
        "wide": wide,
        "negative": [-1, -2, -p, -(r + 5), 7],
        "bool_and_numpy_scalar": [True, False, np.uint64(2**64 - 1), np.int64(-7), np.int32(3)],
        "list": mixed,
        "tuple": tuple(mixed),
        "sequence": Column(mixed),
    }[name]


ELEMENTS = ["small", "wide", "negative", "bool_and_numpy_scalar", "list", "tuple", "sequence"]


def _counts(*names):
    c = GLOBAL_METRICS.counters
    return tuple(c.get(n, 0) for n in names)


def _delta(before, after):
    return tuple(a - b for a, b in zip(after, before))


@pytest.mark.parametrize("absent", ["none", "pyints", "pyints_and_limbops"])
@pytest.mark.parametrize("case", ELEMENTS)
def test_to_mont_np_into_rows_equals_the_array(case, absent, monkeypatch):
    """to_mont_np(xs, out=rows) writes the words to_mont_np(xs) returns, in
    the rows handed to it and nowhere else, returns those rows, and counts
    each element under the way it would take as an array."""
    if absent != "none":
        monkeypatch.setattr(native, "get_pyints", lambda: None)
    if absent == "pyints_and_limbops":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    ctx = TL.FR_CTX
    xs = _elements(case)
    names = ("to_mont native", "to_mont python")
    before = _counts(*names)
    want = ctx.to_mont_np(xs)
    as_array = _delta(before, _counts(*names))
    buf = np.full((len(xs) + 3, TL.NW), SENTINEL, dtype=np.uint32)
    before = _counts(*names)
    got = ctx.to_mont_np(xs, out=buf[2 : 2 + len(xs)])
    assert _delta(before, _counts(*names)) == as_array
    assert got.base is buf or got.base is buf.base
    assert np.array_equal(buf[2 : 2 + len(xs)], want)
    assert (buf[:2] == SENTINEL).all() and (buf[2 + len(xs) :] == SENTINEL).all()


@pytest.mark.parametrize("out", ["short", "int32", "strided"])
def test_to_mont_np_refuses_rows_it_cannot_fill(out):
    buf = np.zeros((8, 2 * TL.NW), dtype=np.uint32)
    rows = {"short": buf[:3, : TL.NW].copy(), "int32": buf[:4, : TL.NW].astype(np.int32),
            "strided": buf[:4, : TL.NW]}[out]
    with pytest.raises(ValueError):
        TL.FR_CTX.to_mont_np([1, 2, 3, 4], out=rows)


@pytest.mark.parametrize("absent", ["none", "limbops", "pyints_and_limbops"])
@pytest.mark.parametrize("case", ["k7_circuit", "random_duplicates", "every_key", "no_tagged",
                                  "usable_minus_one", "python_items"])
def test_permuted_columns_into_rows_equal_the_arrays(case, absent, monkeypatch):
    """A' and S' written into a stacked array's rows (the staging layout:
    the rows of one column, a pad left after them) equal the arrays
    `_permuted_columns` returns, with the C counting and the numpy one."""
    lookups, usable, widths = _case(case)
    tkeys, _, fwords = _tables(usable, widths)
    want = [TP._permuted_columns(t, a, usable, tkeys, fwords, l) for t, a, l, _ in lookups]
    if "pyints" in absent:
        monkeypatch.setattr(native, "get_pyints", lambda: None)
    if "limbops" in absent:
        monkeypatch.setattr(native, "get_lib", lambda: None)
    for (t, a, l, _), (wa, ws) in zip(lookups, want):
        stack = np.full((2, usable + 5, TL.NW), SENTINEL, dtype=np.uint32)
        got = TP._permuted_columns(t, a, usable, tkeys, fwords, l,
                                   stack[0, :usable], stack[1, :usable])
        assert got[0].base is stack and got[1].base is stack
        assert np.array_equal(stack[0, :usable], wa) and np.array_equal(stack[1, :usable], ws)
        assert (stack[:, usable:] == SENTINEL).all()


@pytest.mark.parametrize("absent", ["none", "limbops"])
@pytest.mark.parametrize("case", ["tagged_wide", "not_in_table", "tagged_negative"])
def test_permuted_columns_into_rows_refuse_alike(case, absent, monkeypatch):
    """A lookup failure raises the text of the array form, rows given."""
    tags, wire, usable, widths = _refused(case)
    tkeys, _, fwords = _tables(usable, widths)
    with pytest.raises(ValueError) as want:
        TP._permuted_columns(tags, wire, usable, tkeys, fwords, "d")
    if absent == "limbops":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    rows = np.zeros((2, usable, TL.NW), dtype=np.uint32)
    with pytest.raises(ValueError) as got:
        TP._permuted_columns(tags, wire, usable, tkeys, fwords, "d", rows[0], rows[1])
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith("lookup failure: ")


@pytest.mark.parametrize("absent", ["none", "ecops"])
def test_random_polynomial_into_rows(absent, monkeypatch):
    """`_rand_wide_rows` gives the draws of 64 bytes as they lie, with no
    copy, as (B, n, 16) words, and leaves the generator where the draw
    does; through the wide reduction they are the words of the host's wide
    reduction of the same draws, with the C library and in Python."""
    from delay_enc_tpu_torch.native import ec

    if absent == "ecops":
        monkeypatch.setattr(ec, "get_eclib", lambda: None)
    B, n = 3, 100
    rng, ref = np.random.default_rng(5), np.random.default_rng(5)
    raw = ref.integers(0, 256, (B * n, 64), dtype="uint8")
    want = ec.uniform_to_fr_mont(raw)
    if want is None:
        want = TL.FR_CTX.to_mont_np([FR.from_uniform_bytes(bytes(r)) for r in raw])
    got = TP._rand_wide_rows(rng, B, n)
    assert got.dtype == np.uint32 and got.shape == (B, n, 2 * TL.NW)
    assert got.flags.c_contiguous and got.base is not None
    assert np.array_equal(got.reshape(B * n, 2 * TL.NW).view(np.uint8), raw)
    assert rng.integers(0, 1 << 62) == ref.integers(0, 1 << 62)
    mont = TL.wide_to_mont(TL.FR_CTX, TL.to_tensor(got, "cpu"))
    assert np.array_equal(TL.to_numpy(mont).reshape(B * n, TL.NW), want)


@pytest.mark.parametrize("shape", ["vector", "rows", "stack"])
def test_to_tensor_to_the_cpu_does_not_alias(shape):
    """A CPU tensor from `to_tensor` is a copy: rewriting the source
    afterwards leaves it as it was."""
    words = np.arange({"vector": 8, "rows": 5 * 8, "stack": 2 * 3 * 4 * 8}[shape],
                      dtype=np.uint32)
    words = words.reshape({"vector": (8,), "rows": (5, 8), "stack": (2, 3, 4, 8)}[shape])
    want = words.copy()
    t = TL.to_tensor(words, "cpu")
    words[...] = SENTINEL
    assert np.array_equal(t.numpy().view(np.uint32), want)


def _in_thread(fn):
    """fn() on a fresh thread (a staging buffer of its own); its result."""
    out = []
    th = threading.Thread(target=lambda: out.append(fn()))
    th.start()
    th.join(timeout=600)
    assert not th.is_alive() and len(out) == 1
    return out[0]


STAGING = ("staging grow", "staging grow bytes", "staging reuse")


def _words(B, n):
    return B * (6 + 8) * n * TL.NW


@pytest.mark.parametrize("runs, counts", [
    ([(1, 128), (1, 128)], (1, 1)),
    ([(1, 128), (1, 256), (1, 128)], (2, 1)),
    ([(2, 128), (1, 256), (1, 128)], (1, 2)),
    ([(1, 256), (1, 128), (4, 128)], (2, 1)),
])
def test_staging_grows_to_the_largest_run_and_is_reused(runs, counts):
    """A thread's buffer grows only when a run needs more than it holds,
    to that run's size, and is reused by every run it holds; the views
    tile its front in the order advice, lookups."""
    def go():
        sizes = []
        for B, n in runs:
            a, lk = TP.staging(B, n)
            assert (a.shape, lk.shape) == ((B, 6, n, 8), (B, 8, n, 8))
            assert a.ctypes.data + a.nbytes == lk.ctypes.data
            assert lk.ctypes.data + lk.nbytes == a.ctypes.data + 4 * _words(B, n)
            sizes.append(a.base.size)
        return sizes

    before = _counts(*STAGING)
    sizes = _in_thread(go)
    grow, nbytes, reuse = _delta(before, _counts(*STAGING))
    assert (grow, reuse) == counts
    largest = 0
    want_bytes = 0
    for (B, n), size in zip(runs, sizes):
        if _words(B, n) > largest:
            largest = _words(B, n)
            want_bytes += 4 * largest
        assert size == largest
    assert nbytes == want_bytes


def test_two_threads_hold_two_buffers():
    """Threads alive at once get distinct buffers; each keeps its own."""
    ready = threading.Barrier(2, timeout=60)
    seen = {}

    def go(name):
        a, _ = TP.staging(1, 64)
        ready.wait()
        a2, _ = TP.staging(1, 64)
        seen[name] = (a.ctypes.data, a2.ctypes.data)
        ready.wait()

    threads = [threading.Thread(target=go, args=(name,)) for name in "xy"]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads) and len(seen) == 2
    assert seen["x"][0] == seen["x"][1] and seen["y"][0] == seen["y"][1]
    assert seen["x"][0] != seen["y"][0]


@pytest.fixture(scope="module")
def keys():
    from delay_enc_tpu_torch import cs
    from delay_enc_tpu_torch.plonk import SRS, keygen

    srs = SRS.setup(K, tau=TAU, device="cpu")
    b = _build_circuit(cs, FR)
    pk, _ = keygen(b, srs, device="cpu")
    with np.load(GOLDEN) as z:
        golden = bytes(z["proof"])
    return srs, pk, b, golden


def test_two_proofs_grow_once_then_reuse(keys):
    """Two k=7 proofs on one thread: the first grows the buffer to the
    proof's words, the second reuses it, and both are the golden bytes."""
    from delay_enc_tpu_torch.plonk import create_proof

    srs, pk, b, golden = keys
    prove = lambda: create_proof(srs, pk, b, np.random.default_rng(SEED), device="cpu")
    before = _counts(*STAGING)
    proofs = _in_thread(lambda: [prove(), prove()])
    assert _delta(before, _counts(*STAGING)) == (1, 4 * _words(1, pk.vk.domain.n), 1)
    assert proofs == [golden, golden]


def test_pipelined_proofs_equal_serial(keys):
    """Worker threads, a buffer each, give the bytes of serial proofs."""
    from delay_enc_tpu_torch.plonk import create_proof, create_proofs_pipelined

    srs, pk, b, golden = keys
    seeds = [SEED, 3, SEED + 1]
    before = _counts(*STAGING)
    got = create_proofs_pipelined(srs, pk, [b] * 3, seeds=seeds, depth=2, device="cpu")
    grow, _, reuse = _delta(before, _counts(*STAGING))
    assert grow + reuse == 3 and 1 <= grow <= 2
    want = [create_proof(srs, pk, b, np.random.default_rng(s), device="cpu") for s in seeds]
    assert got == want and got[0] == golden
