"""The scan kernel of delay_enc_tpu_torch (`field_scan`) without a card: the
plain version that follows the kernel's own steps (each thread's elements,
the scan of the threads' totals, the tile's prefix from its predecessors or,
for a constant input, by squaring, each thread's elements again) with small
tiles and the kernel's own, against the block and ladder scans, for
inclusive, exclusive, reverse and ragged lengths; and the kernel's tile body
itself (csrc/scan_tile.cuh is __host__ __device__), built by the host C++
compiler with the look-back walked in an order drawn from a seed, and checked
against Python integers.  The JAX comparisons of the scans are in
tests/test_torch_poly.py.  No tolerance: the words are equal."""

import itertools
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from delay_enc_tpu.fields import FR
from delay_enc_tpu.fields.bn254 import FQ
from delay_enc_tpu_torch.ops import limbs as TL
from delay_enc_tpu_torch.ops import poly as TP

CTX = TL.FR_CTX
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "delay_enc_tpu_torch", "csrc")
N = 64
# the kernel's tiles, (threads, elements a thread), which csrc/scan_tile.cuh
# holds and test_kernel_tile_choice reads back from it
SMALL, LARGE = (128, 8), (256, 8)
FORMS = list(itertools.product(("mul", "add"), (False, True), (False, True)))


def _rand_mont(rng, *shape):
    vals = [FR.random(rng) for _ in range(int(np.prod(shape)))]
    return CTX.to_mont_np(vals).reshape(*shape, 8)


def _t(w):
    return TL.to_tensor(w, "cpu")


@pytest.fixture(scope="module")
def column():
    return _rand_mont(np.random.default_rng(2025), N)


# ---------------------------------------------- the tile-following plain form

@pytest.mark.parametrize("op,exclusive,reverse", FORMS)
@pytest.mark.parametrize("n", [1, 2, 7, 64, 100])
def test_tiles_plain_matches_block_and_ladder(op, exclusive, reverse, n):
    """Tiles of one element, of a few, and the kernel's small tile; a row of
    100 in tiles of one walks the look-back over four windows."""
    rng = np.random.default_rng(n)
    a = _t(_rand_mont(rng, 3, n))
    want = TP.scan(CTX, a, op, "block", exclusive=exclusive, reverse=reverse)
    assert torch.equal(TP.scan(CTX, a, op, "hs", exclusive=exclusive, reverse=reverse), want)
    for tile in ((1, 1), (2, 2), (4, 2), SMALL):
        got = TP.scan_tiles_plain(CTX, a, op, tile=tile, exclusive=exclusive, reverse=reverse)
        assert torch.equal(got, want), tile


def test_zero_inside_a_product_scan():
    rng = np.random.default_rng(11)
    a = _rand_mont(rng, 2, 40)
    a[0, 13] = 0
    a[1, 0] = 0
    for exclusive, reverse in itertools.product((False, True), repeat=2):
        want = TP.scan(CTX, _t(a), "mul", "hs", exclusive=exclusive, reverse=reverse)
        got = TP.scan_tiles_plain(CTX, _t(a), "mul", tile=(2, 2), exclusive=exclusive,
                                  reverse=reverse)
        assert torch.equal(got, want)
    incl = TP.prefix_product(CTX, _t(a), "block")
    assert not incl[0, :13].eq(0).all(-1).any() and incl[0, 13:].eq(0).all()
    assert incl[1].eq(0).all()


def test_unknown_names_raise(column):
    with pytest.raises(ValueError, match="unknown scan"):
        TP.scan(CTX, _t(column), "mul", "blocks")
    with pytest.raises(ValueError, match="unknown scan operator"):
        TP.scan(CTX, _t(column), "max", "block")


# ------------------------------------- the kernel's tile body, host-compiled

HARNESS = r"""
#include <algorithm>
#include <cstdio>
#include <random>
#include <vector>
#include "scan_tile.cuh"
// stdin: op field rows n flags threads items seed, then the input's words
// (one element a row with the CONSTANT flag); op 9 prints the kernel's plan for
// rows, n and flags: threads, elements a thread, tiles, scratch words.  The
// blocks of csrc/scan.cu with `threads` threads of `items` elements: first
// every block up to its published total, in tile order; then every block's
// look-back, prefix and stores, in an order drawn from `seed`, so that a
// look-back meets predecessors with and without their inclusive prefix.  The
// scans across a block and across a look-back window, which the card does
// with shuffles, are loops here.
static void publish(const scan::Records& recs, size_t rec, uint32_t state, const uint32_t v[8]) {
  scan::st8((state == scan::PREFIX ? recs.prefix : recs.total) + rec * 8, v);
  recs.state[rec] = state;
}
template <int F, int OP, int ITEMS>
void run(const uint32_t* in, uint32_t* out, unsigned rows, unsigned n, unsigned flags,
         unsigned threads, unsigned seed) {
  const unsigned TILE = threads * ITEMS, nt = (n + TILE - 1) / TILE;
  const size_t tiles = (size_t)rows * nt, words = threads * (ITEMS * 8 + 4);
  const bool lookback = nt > 1 && !(flags & scan::CONSTANT);
  std::vector<uint32_t> scratch(scan::records_words(tiles), 0);
  const scan::Records recs(scratch.data(), tiles);
  std::vector<uint32_t> mem(tiles * words), before(tiles * threads * 8), all(tiles * 8);
  for (size_t rec = 0; rec < tiles; rec++) {
    const unsigned row = rec / nt, t = rec % nt;
    const uint32_t* in_row = in + (size_t)row * ((flags & scan::CONSTANT) ? 1u : n) * 8;
    uint32_t* tile = &mem[rec * words];
    for (unsigned q = 0; q < 2 * TILE; q++)
      scan::load_quad<F, OP, ITEMS>(tile, in_row, n, t * TILE, q, flags);
    uint32_t run[8];
    scan::identity<F, OP>(run);
    for (unsigned tid = 0; tid < threads; tid++) {
      uint32_t total[8];
      scan::thread_reduce<F, OP, ITEMS>(total, tile, tid);
      fld::copy(&before[(rec * threads + tid) * 8], run);
      scan::combine<F, OP>(run, run, total);
    }
    fld::copy(&all[rec * 8], run);
    if (lookback) publish(recs, rec, t == 0 ? scan::PREFIX : scan::AGGREGATE, run);
  }
  std::vector<size_t> order(tiles);
  for (size_t i = 0; i < tiles; i++) order[i] = i;
  std::shuffle(order.begin(), order.end(), std::mt19937(seed));
  for (size_t rec : order) {
    const unsigned row = rec / nt, t = rec % nt;
    uint32_t pre[8];
    scan::identity<F, OP>(pre);
    if (!lookback && (flags & scan::CONSTANT)) scan::power<F, OP>(pre, &all[rec * 8], t);
    if (lookback && t > 0) {
      for (long long last = (long long)t - 1;; last -= scan::WINDOW) {
        long long r[scan::WINDOW];
        int stop = scan::WINDOW;
        for (int lane = scan::WINDOW - 1; lane >= 0; lane--) {
          const long long p = last - lane;
          r[lane] = p >= 0 ? (long long)rec - t + p : -1;
          const uint32_t state = r[lane] >= 0 ? recs.state[r[lane]] : (uint32_t)scan::PREFIX;
          if (state == scan::EMPTY) return;  // never: every total is published
          if (state == scan::PREFIX) stop = lane;
        }
        uint32_t sum[8];
        scan::identity<F, OP>(sum);
        for (int lane = 0; lane < scan::WINDOW; lane++) {
          uint32_t v[8];
          scan::window_value<F, OP>(v, recs, r[lane], lane, stop);
          scan::combine<F, OP>(sum, sum, v);
        }
        scan::combine<F, OP>(pre, sum, pre);
        if (stop < scan::WINDOW) break;
      }
      uint32_t inc[8];
      scan::combine<F, OP>(inc, pre, &all[rec * 8]);
      publish(recs, rec, scan::PREFIX, inc);
    }
    uint32_t* tile = &mem[rec * words];
    for (unsigned tid = 0; tid < threads; tid++) {
      uint32_t p[8];
      scan::combine<F, OP>(p, pre, &before[(rec * threads + tid) * 8]);
      scan::thread_apply<F, OP, ITEMS>(tile, tid, p, flags);
    }
    for (unsigned q = 0; q < 2 * TILE; q++)
      scan::store_quad<ITEMS>(out + (size_t)row * n * 8, tile, n, t * TILE, q, flags);
  }
}
template <int F, int OP>
void items(unsigned it, const uint32_t* in, uint32_t* out, unsigned rows, unsigned n,
           unsigned flags, unsigned threads, unsigned seed) {
  if (it == 1) run<F, OP, 1>(in, out, rows, n, flags, threads, seed);
  if (it == 2) run<F, OP, 2>(in, out, rows, n, flags, threads, seed);
  if (it == 4) run<F, OP, 4>(in, out, rows, n, flags, threads, seed);
  if (it == 8) run<F, OP, 8>(in, out, rows, n, flags, threads, seed);
}
int main() {
  unsigned op, f, rows, n, flags, threads, it, seed;
  if (scanf("%u %u %u %u %u %u %u %u", &op, &f, &rows, &n, &flags, &threads, &it, &seed) != 8)
    return 1;
  if (op == 9) {
    const scan::Plan p = scan::plan(rows, n, flags);
    printf("%u %u %zu %zu\n", p.threads, p.items, p.tiles, p.scratch_words);
    return 0;
  }
  std::vector<uint32_t> in((size_t)rows * ((flags & scan::CONSTANT) ? 1 : (size_t)n) * 8);
  for (auto& w : in) if (scanf("%u", &w) != 1) return 1;
  std::vector<uint32_t> out((size_t)rows * n * 8, 0xdeadbeefu);
  if (f == 0 && op == 0) items<0, 0>(it, in.data(), out.data(), rows, n, flags, threads, seed);
  if (f == 0 && op == 1) items<0, 1>(it, in.data(), out.data(), rows, n, flags, threads, seed);
  if (f == 1 && op == 0) items<1, 0>(it, in.data(), out.data(), rows, n, flags, threads, seed);
  if (f == 1 && op == 1) items<1, 1>(it, in.data(), out.data(), rows, n, flags, threads, seed);
  for (size_t e = 0; e < (size_t)rows * n; e++) {
    for (int j = 0; j < 8; j++) printf("%u ", out[e * 8 + j]);
    printf("\n");
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def scan_harness(tmp_path_factory):
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("scan_tile")
    src, exe = d / "harness.cpp", d / "harness"
    src.write_text(HARNESS)
    subprocess.run([cxx, "-O1", "-std=c++17", "-Wall", "-Werror", "-Wno-unknown-pragmas",
                    f"-I{CSRC}", "-DFLD_EMULATE_PTX", "-o", str(exe), str(src)],
                   check=True, capture_output=True)

    def run(op, fid, rows, n, flags, tile, seed, words=()):
        text = f"{op} {fid} {rows} {n} {flags} {tile[0]} {tile[1]} {seed}\n" + \
            " ".join(map(str, np.asarray(words, dtype=np.uint32).reshape(-1))) + "\n"
        out = subprocess.run([str(exe)], input=text, text=True, capture_output=True,
                             check=True, timeout=300).stdout
        if op == 9:
            return tuple(map(int, out.split()))
        return np.array([list(map(int, ln.split())) for ln in out.strip().split("\n")],
                        dtype=np.uint32).reshape(rows, n, 8)

    return run


def _scan_ints(row, p, op, exclusive, reverse):
    row = row[::-1] if reverse else list(row)
    acc, out = (1 if op == 0 else 0), []
    for v in row:
        if exclusive:
            out.append(acc)
        acc = acc * v % p if op == 0 else (acc + v) % p
        if not exclusive:
            out.append(acc)
    return out[::-1] if reverse else out


@pytest.mark.parametrize("fid,field", [(0, FR), (1, FQ)], ids=["fr", "fq"])
@pytest.mark.parametrize("n,tile", [(1, (2, 1)), (2, (2, 1)), (5, (1, 1)), (16, (2, 2)),
                                    (37, (2, 4)), (100, (1, 1)), (300, (4, 2)),
                                    (3000, SMALL), (4500, LARGE)])
def test_thread_body_matches_python_ints(scan_harness, fid, field, n, tile):
    """Every form of the scan through the C++ that the card runs, at one,
    a few and many tiles a row (100 tiles of one element walk four look-back
    windows), a ragged last tile, a zero inside, the kernel's two tiles; and
    the constant input, the powers of one element."""
    ctx = TL.FR_CTX if fid == 0 else TL.FQ_CTX
    rng = np.random.default_rng(n)
    rows = [[field.random(rng) for _ in range(n)] for _ in range(2)]
    if n > 3:
        rows[1][n // 2] = 0
    words = np.stack([ctx.to_mont_np(r) for r in rows])
    for i, (op, exclusive, reverse) in enumerate(itertools.product((0, 1), (False, True),
                                                                   (False, True))):
        flags = (TP.EXCLUSIVE if exclusive else 0) | (TP.REVERSE if reverse else 0)
        got = scan_harness(op, fid, 2, n, flags, tile, n + i, words)
        want = [v for r in rows for v in _scan_ints(r, field.p, op, exclusive, reverse)]
        assert ctx.from_mont_np(got) == want, (op, exclusive, reverse)
    x = field.random(rng)
    got = scan_harness(0, fid, 1, n, TP.EXCLUSIVE | TP.CONSTANT, tile, n, ctx.to_mont_np([x]))
    assert ctx.from_mont_np(got) == [pow(x, i, field.p) for i in range(n)]
    # one element a row: each row the powers of its own
    xs = [field.random(rng) for _ in range(2)]
    got = scan_harness(0, fid, 2, n, TP.EXCLUSIVE | TP.CONSTANT, tile, n, ctx.to_mont_np(xs))
    assert ctx.from_mont_np(got) == [pow(x, i, field.p) for x in xs for i in range(n)]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_lookback_in_any_order(scan_harness, seed):
    """Three rows of 70 one-element tiles, the look-backs walked in three
    orders: each tile's prefix is the same whichever predecessors have
    published theirs."""
    rng = np.random.default_rng(seed)
    rows = [[FR.random(rng) for _ in range(70)] for _ in range(3)]
    words = np.stack([CTX.to_mont_np(r) for r in rows])
    for op in (0, 1):
        got = scan_harness(op, 0, 3, 70, TP.REVERSE, (1, 1), seed, words)
        want = [v for r in rows for v in _scan_ints(r, FR.p, op, False, True)]
        assert CTX.from_mont_np(got) == want


def test_kernel_tile_choice(scan_harness):
    """The large tile where it gives at least 264 blocks: (5, 2^16) does
    not, (1, 2^20) and 264 rows of one do."""
    plan = lambda rows, n: scan_harness(9, 0, rows, n, 0, (1, 1), 0)[:2]
    assert plan(1, 1 << 16) == SMALL
    assert plan(5, 1 << 16) == SMALL
    assert plan(263, 1) == SMALL
    assert plan(1, 1 << 20) == LARGE
    assert plan(264, 1) == LARGE


def test_scratch_size_matches_records(scan_harness):
    """The plan's scratch, which the wrapper allocates: a counter, a state a
    tile rounded up to 8 words, a total and an inclusive prefix a tile, where
    a row is more than one tile and the input is not constant; else none."""
    for rows, n, flags in ((1, 1, 0), (3, 1024, 0), (3, 1025, 0), (1, 1 << 16, 0),
                           (5, 1 << 16, TP.REVERSE), (1, 1 << 20, TP.EXCLUSIVE),
                           (7, 9000, 0), (1, 1 << 16, TP.CONSTANT | TP.EXCLUSIVE)):
        threads, items, tiles, words = scan_harness(9, 0, rows, n, flags, (1, 1), 0)
        nt = -(-n // (threads * items))
        assert tiles == rows * nt
        records = 8 + -(-tiles // 8) * 8 + 16 * tiles
        assert words == (records if nt > 1 and not flags & TP.CONSTANT else 0)
