"""K7, the openings' contractions (`open_stack`, csrc/open.cu), without a
card: its plain version and the port's `_eval_stack_batch` and
`_gwc_witness_batch` with one instance against the JAX package's
`_jit_eval_stack` and `_jit_gwc_witness` at
m in {1, 5} rows and n in {64, 1000}, bit-exact; several points in one call
against one call a point; and the kernel's row bodies (csrc/open_row.cuh is
__host__ __device__), built by the host C++ compiler with the blocks and
their add trees as loops, against Python integers, for one instance and for
a batch of instances with their own tables (points, powers of v) in one
launch.  No tolerance."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from delay_enc_tpu.fields import FR
from delay_enc_tpu.plonk import kernels as JK
from delay_enc_tpu_torch.ops import limbs as TL
from delay_enc_tpu_torch.ops import poly as TP
from delay_enc_tpu_torch.plonk import kernels as TK

CTX = TL.FR_CTX
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "delay_enc_tpu_torch", "csrc")
SHAPES = [(1, 64), (5, 64), (1, 1000), (5, 1000)]


def _words(rng, *shape):
    count = int(np.prod(shape))
    return CTX.to_mont_np([FR.random(rng) for _ in range(count)]).reshape(*shape, 8)


def _t(w):
    return TL.to_tensor(w, "cpu")


def _j(w):
    return jnp.asarray(TL.words_to_limbs_np(w))


def _same(got, want):
    return np.array_equal(TL.words_to_limbs_np(TL.to_numpy(got)), np.asarray(want))


@pytest.mark.parametrize("m,n", SHAPES)
def test_eval_stack_matches_jax_at(m, n):
    rng = np.random.default_rng(m * 7 + n)
    stack, x = _words(rng, m, n), _words(rng, 1)[0]
    want = JK._jit_eval_stack(_j(stack), _j(x))
    pows = TP.powers_of_plain(CTX, _t(x), n + 3)  # more powers than rows: the first n count
    assert _same(TK._eval_stack_batch([[_t(stack)]], [[pows]]), want)
    assert _same(TK.open_stack_plain("eval", [list(_t(stack))], [pows]), want)


@pytest.mark.parametrize("m,n", SHAPES)
def test_gwc_witness_matches_jax_at(m, n):
    rng = np.random.default_rng(m * 11 + n)
    stack = _words(rng, m, n)
    v, z = FR.random(rng), FR.random(rng)
    vm, zm, zim = (CTX.to_mont_np([c])[0] for c in (v, z, pow(z, -1, FR.p)))
    want = JK._jit_gwc_witness(_j(stack), _j(vm), _j(zm), _j(zim))
    zp = TP.powers_of_plain(CTX, _t(zm), n)
    got = TK._gwc_witness_batch([[_t(stack)]], [[zp]], _t(vm)[None], _t(zim)[None])
    assert len(got) == 1 and _same(got[0], want)
    # the plain contraction itself, then divide_scaled
    scaled = TK.open_stack_plain("combine", [list(_t(stack))], [zp],
                                 TP.powers_of_plain(CTX, _t(vm), m))
    assert _same(TP.divide_scaled(CTX, scaled[0], TP.powers_of_plain(CTX, _t(zim), n + 1)), want)


def test_points_in_one_call_match_one_call_each():
    """Three points with 5, 2 and 1 rows, as the prover passes them: the
    contractions and the GWC witnesses."""
    rng = np.random.default_rng(5)
    n = 100
    stacks = [list(_t(_words(rng, m, n))) for m in (5, 2, 1)]
    pows = [TP.powers_of_plain(CTX, _t(_words(rng, 1)[0]), n) for _ in range(3)]
    v_pows = TP.powers_of_plain(CTX, _t(_words(rng, 1)[0]), 5)
    evals = TK.open_stack("eval", stacks, pows)
    scaled = TK.open_stack("combine", stacks, pows, v_pows)
    assert evals.shape == (8, 8) and scaled.shape == (3, n, 8)
    row = 0
    for s in range(3):
        one = TK.open_stack("eval", [stacks[s]], [pows[s]])
        assert torch.equal(evals[row : row + len(stacks[s])], one)
        row += len(stacks[s])
        assert torch.equal(scaled[s], TK.open_stack("combine", [stacks[s]], [pows[s]], v_pows)[0])
    # the GWC witnesses of the three points, as one call and one call a point
    vm = _t(_words(rng, 1)[0])
    zinvs = [_t(w) for w in _words(rng, 3)]
    ws = TK._gwc_witness_batch([stacks], [pows], vm[None], torch.stack(zinvs))
    for s in range(3):
        assert torch.equal(ws[s], TK._gwc_witness_batch([[stacks[s]]], [[pows[s]]], vm[None],
                                                        zinvs[s][None])[0])


def test_bad_tables_raise():
    rng = np.random.default_rng(6)
    rows = list(_t(_words(rng, 2, 16)))
    pows = TP.powers_of_plain(CTX, rows[0][0], 16)
    with pytest.raises(ValueError, match="unknown contraction"):
        TK.open_stack("sum", [rows], [pows])
    with pytest.raises(ValueError, match="powers of v"):
        TK.open_stack("combine", [rows], [pows])
    with pytest.raises(ValueError, match="must be int32"):
        TK.open_stack("eval", [rows], [pows[:8]])
    with pytest.raises(ValueError, match="rows in all"):
        TK.open_stack("eval", [rows * 33], [pows])
    with pytest.raises(ValueError, match="points"):
        TK.open_stack("eval", [rows] * 5, [pows] * 5)


# ------------------------------------- the kernel's row bodies, host-compiled

HARNESS = r"""
#include <algorithm>
#include <cstdio>
#include <vector>
#include "open_row.cuh"
// stdin: the instances, then for each: points n, the points' row counts,
// the rows' words, each point's n powers, the largest stack's powers of v.
// Prints each instance's eval results (one a row), then each instance's
// combine results (points x n).  The eval blocks of csrc/open.cu one after
// another, each block's threads summed by the kernel's add tree; the last
// block folds the partials.  A first line "layout" prints the tables' sizes
// and constants instead.
using opening::Table;
static void tree(std::vector<uint32_t>& red, unsigned threads) {
  for (unsigned w = threads / 2; w > 0; w /= 2)
    for (unsigned tid = 0; tid < w; tid++)
      fld::add<fld::FR>(&red[tid * 8], &red[tid * 8], &red[(tid + w) * 8]);
}
static bool read_table(Table& t, std::vector<std::vector<uint32_t>>& data) {
  unsigned points = 0, n = 0;
  if (scanf("%u %u", &points, &n) != 2) return false;
  t = {};
  t.points = points;
  t.n = n;
  for (unsigned s = 0; s < points; s++) {
    unsigned m;
    if (scanf("%u", &m) != 1) return false;
    t.first[s + 1] = t.first[s] + m;
  }
  const unsigned rows = opening::rows(t);
  unsigned m_max = 0;
  for (unsigned s = 0; s < points; s++)
    if (t.first[s + 1] - t.first[s] > m_max) m_max = t.first[s + 1] - t.first[s];
  data.resize(rows + points + 1);
  for (unsigned k = 0; k < rows + points + 1; k++) {
    data[k].resize((size_t)(k == rows + points ? m_max : n) * 8);
    for (auto& w : data[k]) if (scanf("%u", &w) != 1) return false;
  }
  for (unsigned r = 0; r < rows; r++) t.row[r] = (uint64_t)(uintptr_t)data[r].data();
  for (unsigned s = 0; s < points; s++) t.pows[s] = (uint64_t)(uintptr_t)data[rows + s].data();
  t.vpows = (uint64_t)(uintptr_t)data[rows + points].data();
  return true;
}
int main() {
  char word[16];
  if (scanf("%15s", word) != 1) return 1;
  if (word[0] == 'l') {
    printf("%zu %d %d %u %d %zu\n", sizeof(Table), opening::MAX_ROWS, opening::MAX_POINTS,
           opening::EVAL_CHUNK, opening::MAX_TABLES, sizeof(opening::Tables));
    return 0;
  }
  unsigned count = 0;
  if (sscanf(word, "%u", &count) != 1 || count > (unsigned)opening::MAX_TABLES) return 1;
  opening::Tables all;
  std::vector<std::vector<std::vector<uint32_t>>> data(count);
  for (unsigned b = 0; b < count; b++)
    if (!read_table(all.t[b], data[b])) return 1;
  const unsigned threads = opening::EVAL_THREADS;
  for (unsigned b = 0; b < count; b++) {  // blockIdx.z of the launch
    const Table& t = all.t[b];
    const unsigned chunks = opening::chunks(t);
    for (unsigned r = 0; r < opening::rows(t); r++) {
      std::vector<uint32_t> partial((size_t)chunks * 8), red((size_t)threads * 8);
      for (unsigned c = 0; c < chunks; c++) {
        for (unsigned tid = 0; tid < threads; tid++) opening::eval_thread(&red[tid * 8], t, r, c, tid);
        tree(red, threads);
        fld::copy(&partial[c * 8], &red[0]);
      }
      std::fill(red.begin(), red.end(), 0u);
      for (unsigned c = 0; c < chunks; c++)
        fld::add<fld::FR>(&red[(c % threads) * 8], &red[(c % threads) * 8], &partial[c * 8]);
      tree(red, threads);
      for (int j = 0; j < 8; j++) printf("%u ", red[j]);
      printf("\n");
    }
  }
  for (unsigned b = 0; b < count; b++) {
    const Table& t = all.t[b];
    for (unsigned s = 0; s < t.points; s++)
      for (size_t i = 0; i < t.n; i++) {
        uint32_t o[8];
        opening::combine_column(o, t, s, i, opening::at(t.vpows));
        for (int j = 0; j < 8; j++) printf("%u ", o[j]);
        printf("\n");
      }
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def open_harness(tmp_path_factory):
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("open_row")
    src, exe = d / "harness.cpp", d / "harness"
    src.write_text(HARNESS)
    subprocess.run([cxx, "-O1", "-std=c++17", "-Wall", "-Werror", "-Wno-unknown-pragmas",
                    f"-I{CSRC}", "-DFLD_EMULATE_PTX", "-o", str(exe), str(src)],
                   check=True, capture_output=True)

    def run(text):
        return subprocess.run([str(exe)], input=text, text=True, capture_output=True,
                              check=True, timeout=300).stdout

    return run


def test_table_layout_matches_wrapper(open_harness):
    size, max_rows, max_points, chunk, max_tables, all_size = \
        map(int, open_harness("layout\n").split())
    assert size == ctypes.sizeof(TK._OpenTable)
    assert (max_rows, max_points, chunk) == (TK.OPEN_MAX_ROWS, TK.OPEN_MAX_POINTS,
                                             TK.OPEN_EVAL_CHUNK)
    assert max_tables == TK.MAX_INSTANCES and all_size == max_tables * size


def _instance(rng, counts, n):
    """One table's input text and its expected outputs as Python ints: the
    eval sums (a row each) and the combine columns (points x n)."""
    p = FR.p
    rows = [[FR.random(rng) for _ in range(n)] for _ in range(sum(counts))]
    rows[0][0] = p - 1
    if n > 2:
        rows[-1][1:3] = [p - 2, (1 << 256) % p]
    xs = [FR.random(rng) for _ in counts]
    v = FR.random(rng)
    pows = [[pow(x, i, p) for i in range(n)] for x in xs]
    vp = [pow(v, j, p) for j in range(max(counts))]
    words = [CTX.to_mont_np(r) for r in rows + pows + [vp]]
    text = f"{len(counts)} {n}\n{' '.join(map(str, counts))}\n" + "\n".join(
        " ".join(map(str, w.reshape(-1))) for w in words) + "\n"
    evals, combine, first = [], [], 0
    for s, m in enumerate(counts):
        evals += [sum(c * x for c, x in zip(rows[first + j], pows[s])) % p for j in range(m)]
        combine += [sum(vp[j] * rows[first + j][i] for j in range(m)) * pows[s][i] % p
                    for i in range(n)]
        first += m
    return text, evals, combine


def _run(open_harness, instances) -> list:
    text = f"{len(instances)}\n" + "".join(t for t, _, _ in instances)
    out = np.array([list(map(int, ln.split())) for ln in open_harness(text).strip().split("\n")],
                   dtype=np.uint32)
    return CTX.from_mont_np(out)


@pytest.mark.parametrize("counts,n", [((1,), 1), ((3, 1, 2), 37), ((47, 6, 4), 64),
                                      ((2, 1), 4096 + 5), ((1,), 3 * 4096)])
def test_row_bodies_match_python_ints(open_harness, counts, n):
    """One row of one element; three points of ragged n; the delay_enc
    stacks at small n; rows of more than one eval block (a ragged last
    chunk, and three whole ones); carry-heavy values among the words."""
    text, evals, combine = _instance(np.random.default_rng(n), counts, n)
    assert _run(open_harness, [(text, evals, combine)]) == evals + combine


def test_row_bodies_batch_match_python_ints(open_harness):
    """Three instances in one launch, each its own table: other row counts,
    points, powers of v and lengths (one of them of two eval blocks)."""
    rng = np.random.default_rng(9)
    instances = [_instance(rng, counts, n)
                 for counts, n in (((5, 2, 1), 40), ((1,), 4096 + 3), ((2, 3), 17))]
    assert _run(open_harness, instances) == \
        [v for _, e, _ in instances for v in e] + [v for _, _, c in instances for v in c]
