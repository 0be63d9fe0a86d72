"""Port parity: the lookup permutation (`plonk/prover.py:_permuted_columns`,
the keys read in C by `native/pyints.c:lookup_keys` and the columns written
by counting in `native/limbops.c:lookup_permute`) against the JAX package's
`_permuted_columns`, word for word, on real circuits' columns and on
columns made to reach each branch; the inputs the JAX package refuses are
refused with its text; without the C libraries the same words come back,
every row read in Python."""

import functools

import numpy as np
import pytest

from delay_enc_tpu.plonk import prover as JP
from delay_enc_tpu_torch import native
from delay_enc_tpu_torch.cs.range import build_table
from delay_enc_tpu_torch.fields.bn254 import FR
from delay_enc_tpu_torch.ops import limbs as TL
from delay_enc_tpu_torch.plonk import prover as TP
from delay_enc_tpu_torch.utils.timers import GLOBAL_METRICS

THETA = 0x1234_5678_9ABC_DEF0_0FED_CBA9_8765_4321


@functools.lru_cache(maxsize=None)
def _real(name: str):
    """The four lookups (tag column, advice wire, wire name) of a real
    circuit, its usable rows and lookup widths."""
    if name == "k7_circuit":
        from test_torch_prover import _build_circuit

        from delay_enc_tpu_torch import cs

        b, k = _build_circuit(cs, FR), 7
    else:
        from delay_enc_tpu_torch.runtime.workloads import build_circuit

        workload, k = name.rsplit("_k", 1)
        b, k = build_circuit(workload, int(k)), int(k)
    lookups = [(b.fixed[f"tag_{l}"], b.advice[TP.WIRE_COL[l]], l) for l in TP.LOOKUPS]
    return lookups, (1 << k) - 7, frozenset(b.lookup_widths)


def _synthetic(name: str):
    """One lookup over the widths {1, 3, 6}: (tag column, advice wire, wire
    name), usable rows, widths, and the rows the C reader takes."""
    rng = np.random.default_rng(sum(map(ord, name)))
    widths = (1, 3, 6)
    usable = 500
    rows = 400
    tags = [0] * rows
    wire = [int(v) for v in rng.integers(0, 1 << 20, rows)]  # untagged: any width
    if name == "random_duplicates":
        for i in rng.choice(rows, 300, replace=False):
            w = int(rng.choice(widths))
            tags[i], wire[i] = w, int(rng.integers(0, 1 << w))
    elif name == "every_key":
        keys = [(w, v) for w in widths for v in range(1 << w)]
        for i, (w, v) in zip(rng.permutation(rows), keys * 4):
            tags[int(i)], wire[int(i)] = w, v
    elif name == "one_tagged":
        tags[137], wire[137] = 3, 5
    elif name == "last_key":
        for i in (3, rows - 1):
            tags[i], wire[i] = 6, 63
    elif name == "usable_minus_one":
        rows = usable - 1
        tags = [int(t) for t in rng.choice([0, 1, 3, 6], rows)]
        wire = [int(rng.integers(0, 1 << t)) if t else 0 for t in tags]
    elif name == "untagged_wide":
        tags[10], wire[10] = 1, 1
        wire[0], wire[5], wire[rows - 1] = 1 << 64, FR.p - 1, (1 << 300) + 7
    elif name == "python_items":
        # a bool tag, a numpy value, a np.uint32 tag: Python reads from the
        # first of them, row 50, to the end
        tags[10], wire[10] = 6, 40
        tags[50], wire[50] = True, 1
        tags[60], wire[60] = 3, np.int64(7)
        tags[70], wire[70] = np.uint32(6), 63
        tags[80], wire[80] = 6, 62
        return [(tags, wire, "c")], usable, frozenset(widths), 50
    elif name != "no_tagged":
        raise KeyError(name)
    return [(tags, wire, "b")], usable, frozenset(widths), len(tags)


REAL = ["k7_circuit", "pose_enc_k11", "delay_enc_k16"]
SYNTHETIC = ["random_duplicates", "every_key", "no_tagged", "one_tagged", "last_key",
             "usable_minus_one", "untagged_wide", "python_items"]


def _case(name: str):
    """[(tag column, wire, name, rows the C reader takes)], usable, widths."""
    if name in REAL:
        lookups, usable, widths = _real(name)
        return [(t, a, l, len(t)) for t, a, l in lookups], usable, widths
    lookups, usable, widths, native_rows = _synthetic(name)
    return [(t, a, l, native_rows) for t, a, l in lookups], usable, widths


@functools.lru_cache(maxsize=None)
def _tables(usable: int, widths: frozenset):
    """The padded table's keys, the JAX package's (usable, 16) limbs of each
    key's compressed value, and the same as the port's (usable, 8) words."""
    tt, tv = build_table(widths)
    tkeys, flimbs = JP._table_keys(tt, tv, usable, THETA)
    return tkeys, np.asarray(flimbs), TL.limbs_to_words_np(np.asarray(flimbs))


def _counts():
    c = GLOBAL_METRICS.counters
    return c.get("permute native", 0), c.get("permute python", 0)


@pytest.mark.parametrize("case", REAL + SYNTHETIC)
def test_permuted_columns_match_jax(case):
    """A' and S' equal the JAX package's for every lookup of the case, and
    each row's key is counted once, under the way it was read."""
    assert native.get_lib() is not None and native.get_pyints() is not None
    lookups, usable, widths = _case(case)
    tkeys, flimbs, fwords = _tables(usable, widths)
    for tags, wire, name, native_rows in lookups:
        want = JP._permuted_columns(tags, wire, usable, tkeys, flimbs, name)
        before = _counts()
        got = TP._permuted_columns(tags, wire, usable, tkeys, fwords, name)
        after = _counts()
        for g, w in zip(got, want):
            assert g.dtype == np.uint32 and g.shape == (usable, TL.NW)
            assert np.array_equal(g, TL.limbs_to_words_np(np.asarray(w))), name
        assert (after[0] - before[0], after[1] - before[1]) == \
            (native_rows, len(tags) - native_rows), name


def _refused(name: str):
    """A lookup the JAX package refuses: (tag column, wire), usable, widths."""
    rows, usable, widths = 300, 400, frozenset((1, 3, 6))
    tags, wire = [0] * rows, [0] * rows
    tags[20], wire[20] = 6, 17
    if name == "tagged_wide":
        tags[150], wire[150] = 3, 1 << 16
        tags[151], wire[151] = 3, 1 << 20  # the first row is named
    elif name == "not_in_table":
        tags[40], wire[40] = 3, 9
        tags[41], wire[41] = 1, 2  # the smaller key is named
    elif name == "tagged_negative":
        tags[99], wire[99] = 6, -3  # masked to 2^16 - 3, then not in the table
    else:
        raise KeyError(name)
    return tags, wire, usable, widths


@pytest.mark.parametrize("case", ["tagged_wide", "not_in_table", "tagged_negative"])
def test_refused_lookups_raise_the_jax_text(case):
    tags, wire, usable, widths = _refused(case)
    tkeys, flimbs, fwords = _tables(usable, widths)
    with pytest.raises(ValueError) as want:
        JP._permuted_columns(tags, wire, usable, tkeys, flimbs, "d")
    with pytest.raises(ValueError) as got:
        TP._permuted_columns(tags, wire, usable, tkeys, fwords, "d")
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith("lookup failure: ")


@pytest.mark.parametrize("absent", ["pyints", "limbops", "pyints_and_limbops"])
@pytest.mark.parametrize("case", ["k7_circuit", "pose_enc_k11", "random_duplicates", "every_key",
                                  "no_tagged", "usable_minus_one", "python_items"])
def test_without_the_c_libraries_the_same_words(case, absent, monkeypatch):
    """Without the reader, the counting or both, the same words come back;
    without the reader every row is counted under `permute python`."""
    lookups, usable, widths = _case(case)
    tkeys, _, fwords = _tables(usable, widths)
    want = [TP._permuted_columns(t, a, usable, tkeys, fwords, l) for t, a, l, _ in lookups]
    if "pyints" in absent:
        monkeypatch.setattr(native, "get_pyints", lambda: None)
    if "limbops" in absent:
        monkeypatch.setattr(native, "get_lib", lambda: None)
    rows = sum(len(t) for t, _, _, _ in lookups)
    python_rows = rows if "pyints" in absent else sum(len(t) - k for t, _, _, k in lookups)
    before = _counts()
    got = [TP._permuted_columns(t, a, usable, tkeys, fwords, l) for t, a, l, _ in lookups]
    after = _counts()
    for g, w in zip(got, want):
        assert np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])
    assert (after[0] - before[0], after[1] - before[1]) == (rows - python_rows, python_rows)


@pytest.mark.parametrize("case", ["tagged_wide", "not_in_table", "tagged_negative"])
def test_without_the_c_libraries_the_same_refusals(case, monkeypatch):
    tags, wire, usable, widths = _refused(case)
    tkeys, _, fwords = _tables(usable, widths)
    with pytest.raises(ValueError) as want:
        TP._permuted_columns(tags, wire, usable, tkeys, fwords, "d")
    monkeypatch.setattr(native, "get_pyints", lambda: None)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    with pytest.raises(ValueError) as got:
        TP._permuted_columns(tags, wire, usable, tkeys, fwords, "d")
    assert str(got.value) == str(want.value)
