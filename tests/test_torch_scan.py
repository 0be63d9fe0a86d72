"""The scan kernel of delay_enc_tpu_torch (`field_scan`) without a card: the
plain version that follows the kernel's own steps (tile totals, their
exclusive scan, the tiles again) with a small tile, against the block and
ladder scans and against the JAX package's prefix_product, suffix_product,
suffix_sum, powers_of and divide_by_linear, for inclusive, exclusive,
reverse and ragged lengths; and the kernel's per-thread body itself
(csrc/scan_tile.cuh is __host__ __device__), built by the host C++ compiler
and checked against Python integers.  No tolerance: the words are equal."""

import itertools
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax

from delay_enc_tpu.fields import FR
from delay_enc_tpu.fields.bn254 import FQ
from delay_enc_tpu.ops import limbs as JL
from delay_enc_tpu.ops import poly as JP
from delay_enc_tpu_torch.ops import limbs as TL
from delay_enc_tpu_torch.ops import poly as TP

JCTX, CTX = JL.FR_CTX, TL.FR_CTX
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "delay_enc_tpu_torch", "csrc")
N = 64
FORMS = list(itertools.product(("mul", "add"), (False, True), (False, True)))


def _rand_mont(rng, *shape):
    vals = [FR.random(rng) for _ in range(int(np.prod(shape)))]
    return CTX.to_mont_np(vals).reshape(*shape, 8)


def _t(w):
    return TL.to_tensor(w, "cpu")


def _limbs(t):
    return TL.words_to_limbs_np(TL.to_numpy(t))


def _j(w):
    return TL.words_to_limbs_np(w)


@pytest.fixture(scope="module")
def column():
    return _rand_mont(np.random.default_rng(2025), N)


# ---------------------------------------------- the tile-following plain form

@pytest.mark.parametrize("op,exclusive,reverse", FORMS)
@pytest.mark.parametrize("n", [1, 2, 7, 64, 100])
def test_tiles_plain_matches_block_and_ladder(op, exclusive, reverse, n):
    rng = np.random.default_rng(n)
    a = _t(_rand_mont(rng, 3, n))
    want = TP.scan(CTX, a, op, "block", exclusive=exclusive, reverse=reverse)
    assert torch.equal(TP.scan(CTX, a, op, "hs", exclusive=exclusive, reverse=reverse), want)
    for tile in (1, 4, 16, 1024):
        got = TP.scan_tiles_plain(CTX, a, op, tile=tile, exclusive=exclusive, reverse=reverse)
        assert torch.equal(got, want), tile


@pytest.mark.parametrize("exclusive", [False, True])
def test_prefix_and_suffix_products_match_jax(column, exclusive):
    one = np.asarray(JCTX.one_mont())[None]
    for name, reverse in (("prefix_product", False), ("suffix_product", True)):
        want = np.asarray(jax.jit(lambda a: getattr(JP, name)(JCTX, a, "block"))(_j(column)))
        if exclusive:  # the JAX package shifts its inclusive scans (kernels.py _gp_finish)
            want = np.concatenate([want[1:], one] if reverse else [one, want[:-1]])
        got = getattr(TP, name)(CTX, _t(column), "block", exclusive=exclusive)
        assert np.array_equal(_limbs(got), want)
        tiled = TP.scan_tiles_plain(CTX, _t(column), "mul", tile=8, exclusive=exclusive,
                                    reverse=reverse)
        assert np.array_equal(_limbs(tiled), want)


@pytest.mark.parametrize("exclusive", [False, True])
def test_suffix_sum_matches_jax(column, exclusive):
    want = np.asarray(jax.jit(lambda a: JP.suffix_sum(JCTX, a))(_j(column)))
    if exclusive:
        want = np.concatenate([want[1:], np.zeros_like(want[:1])])
    got = TP.suffix_sum(CTX, _t(column), "block", exclusive=exclusive)
    assert np.array_equal(_limbs(got), want)
    tiled = TP.scan_tiles_plain(CTX, _t(column), "add", tile=8, exclusive=exclusive, reverse=True)
    assert np.array_equal(_limbs(tiled), want)


@pytest.mark.parametrize("n", [1, 2, 3, 64, 65])
def test_powers_are_the_exclusive_scan_of_a_constant(column, n):
    """powers_of as the kernel computes it, against the JAX package's ladder."""
    x = column[5]
    want = np.asarray(jax.jit(lambda v: JP.powers_of(JCTX, v, n))(_j(x)))
    assert np.array_equal(_limbs(TP.powers_of(CTX, _t(x), n)), want)
    const = _t(x).expand(n, 8)
    for tile in (4, 1024):
        got = TP.scan_tiles_plain(CTX, const, "mul", tile=tile, exclusive=True)
        assert np.array_equal(_limbs(got), want)


def test_divide_by_linear_matches_jax(column):
    z = FR.random(np.random.default_rng(7))
    zp = CTX.to_mont_np([pow(z, i, FR.p) for i in range(N)])
    zinv = CTX.to_mont_np([pow(z, -i, FR.p) for i in range(N + 1)])
    got = TP.divide_by_linear(CTX, _t(column), _t(zp), _t(zinv))
    want = jax.jit(lambda c, a, b: JP.divide_by_linear(JCTX, c, a, b))(
        _j(column), _j(zp), _j(zinv))
    assert np.array_equal(_limbs(got), np.asarray(want))
    # and through the kernel's steps: the exclusive reverse sum of a_j z^j
    t = TL.mont_mul(CTX, _t(column), _t(zp))
    above = TP.scan_tiles_plain(CTX, t, "add", tile=8, exclusive=True, reverse=True)
    assert np.array_equal(_limbs(TL.mont_mul(CTX, above, _t(zinv)[1:])), np.asarray(want))


def test_zero_inside_a_product_scan():
    rng = np.random.default_rng(11)
    a = _rand_mont(rng, 2, 40)
    a[0, 13] = 0
    a[1, 0] = 0
    for exclusive, reverse in itertools.product((False, True), repeat=2):
        want = TP.scan(CTX, _t(a), "mul", "hs", exclusive=exclusive, reverse=reverse)
        got = TP.scan_tiles_plain(CTX, _t(a), "mul", tile=8, exclusive=exclusive, reverse=reverse)
        assert torch.equal(got, want)
    incl = TP.prefix_product(CTX, _t(a), "block")
    assert not incl[0, :13].eq(0).all(-1).any() and incl[0, 13:].eq(0).all()
    assert incl[1].eq(0).all()


def test_unknown_names_raise(column):
    with pytest.raises(ValueError, match="unknown scan"):
        TP.scan(CTX, _t(column), "mul", "blocks")
    with pytest.raises(ValueError, match="unknown scan operator"):
        TP.scan(CTX, _t(column), "max", "block")


# ------------------------------------ the kernel's thread body, host-compiled

HARNESS = r"""
#include <cstdio>
#include <vector>
#include "scan_tile.cuh"
// stdin: op field rows n flags threads, then the input's words (one element
// with the CONSTANT flag).  The three launches of csrc/scan.cu with blocks of
// `threads` threads; the scan of the threads' totals across a block, which
// the card does with shuffles, is a loop here.
template <int F, int OP>
void launch(const uint32_t* in, uint32_t* out, const uint32_t* start, uint32_t* totals,
            unsigned blocks, unsigned n, unsigned in_stride, unsigned blocks_a_row,
            unsigned tiles, unsigned flags, unsigned threads) {
  for (unsigned b = 0; b < blocks; b++) {
    const unsigned row = b / blocks_a_row, blk = b - row * blocks_a_row;
    const uint32_t* in_row = in + (size_t)row * in_stride * 8;
    uint32_t* out_row = out + (size_t)row * n * 8;
    uint32_t carry[8];
    if (start) scan::ld8(carry, start + (size_t)b * 8); else scan::identity<F, OP>(carry);
    for (unsigned t = 0; t < tiles; t++) {
      std::vector<uint32_t> xs((size_t)threads * scan::ITEMS * 8);
      auto x = [&](unsigned tid) { return (uint32_t(*)[8])(xs.data() + (size_t)tid * scan::ITEMS * 8); };
      auto base = [&](unsigned tid) { return ((blk * tiles + t) * threads + tid) * scan::ITEMS; };
      for (unsigned tid = 0; tid < threads; tid++)
        scan::thread_load<F, OP>(x(tid), in_row, n, base(tid), flags);
      uint32_t run[8];
      fld::copy(run, carry);
      for (unsigned tid = 0; tid < threads; tid++) {
        if (!totals) scan::thread_store<F, OP>(x(tid), run, out_row, n, base(tid), flags);
        scan::combine<F, OP>(run, run, x(tid)[scan::ITEMS - 1]);
      }
      fld::copy(carry, run);
    }
    if (totals) scan::st8(totals + (size_t)b * 8, carry);
  }
}
template <int F, int OP>
void run(const uint32_t* in, uint32_t* out, unsigned rows, unsigned n, unsigned flags,
         unsigned threads) {
  const unsigned tile = threads * scan::ITEMS, nt = (n + tile - 1) / tile;
  const unsigned in_stride = (flags & scan::CONSTANT) ? 0u : n;
  if (nt == 1) {
    launch<F, OP>(in, out, nullptr, nullptr, rows, n, in_stride, 1, 1, flags, threads);
    return;
  }
  std::vector<uint32_t> scratch((size_t)rows * nt * 8);
  launch<F, OP>(in, out, nullptr, scratch.data(), rows * nt, n, in_stride, nt, 1, flags, threads);
  launch<F, OP>(scratch.data(), scratch.data(), nullptr, nullptr, rows, nt, nt, 1,
                (nt + tile - 1) / tile, scan::EXCLUSIVE, threads);
  launch<F, OP>(in, out, scratch.data(), nullptr, rows * nt, n, in_stride, nt, 1, flags, threads);
}
int main() {
  unsigned op, f, rows, n, flags, threads;
  if (scanf("%u %u %u %u %u %u", &op, &f, &rows, &n, &flags, &threads) != 6) return 1;
  std::vector<uint32_t> in(((flags & scan::CONSTANT) ? 1 : (size_t)rows * n) * 8);
  for (auto& w : in) if (scanf("%u", &w) != 1) return 1;
  std::vector<uint32_t> out((size_t)rows * n * 8, 0xdeadbeefu);
  if (f == 0 && op == 0) run<0, 0>(in.data(), out.data(), rows, n, flags, threads);
  if (f == 0 && op == 1) run<0, 1>(in.data(), out.data(), rows, n, flags, threads);
  if (f == 1 && op == 0) run<1, 0>(in.data(), out.data(), rows, n, flags, threads);
  if (f == 1 && op == 1) run<1, 1>(in.data(), out.data(), rows, n, flags, threads);
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

    def run(op, fid, rows, n, flags, threads, words):
        text = f"{op} {fid} {rows} {n} {flags} {threads}\n" + \
            " ".join(map(str, np.asarray(words, dtype=np.uint32).reshape(-1))) + "\n"
        out = subprocess.run([str(exe)], input=text, text=True, capture_output=True,
                             check=True, timeout=300).stdout
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
@pytest.mark.parametrize("n,threads", [(1, 2), (2, 2), (5, 1), (16, 4), (37, 2), (300, 4),
                                       (1000, 256)])
def test_thread_body_matches_python_ints(scan_harness, fid, field, n, threads):
    """Every form of the scan through the C++ that the card runs: one, a few
    and many tiles a row (300 elements in tiles of 16 make the totals' own
    scan run over two tiles), a ragged last tile, a zero inside."""
    ctx = TL.FR_CTX if fid == 0 else TL.FQ_CTX
    rng = np.random.default_rng(n)
    rows = [[field.random(rng) for _ in range(n)] for _ in range(2)]
    if n > 3:
        rows[1][n // 2] = 0
    words = np.stack([ctx.to_mont_np(r) for r in rows])
    for op, exclusive, reverse in itertools.product((0, 1), (False, True), (False, True)):
        flags = (TP.EXCLUSIVE if exclusive else 0) | (TP.REVERSE if reverse else 0)
        got = scan_harness(op, fid, 2, n, flags, threads, words)
        want = [v for r in rows for v in _scan_ints(r, field.p, op, exclusive, reverse)]
        assert ctx.from_mont_np(got) == want, (op, exclusive, reverse)
    # the constant input: the powers of one element
    x = field.random(rng)
    got = scan_harness(0, fid, 1, n, TP.EXCLUSIVE | TP.CONSTANT, threads, ctx.to_mont_np([x]))
    assert ctx.from_mont_np(got) == [pow(x, i, field.p) for i in range(n)]
