"""Port parity of the base-16 MSM: delay_enc_tpu_torch.ops.msm16 (plain
selectors, pair tables, plane sums and the fold) against
delay_enc_tpu.ops.msm16 on the CPU, the selector kernel's per-pair body
(csrc/sel_row.cuh, __host__ __device__) built by the host C++ compiler
against `pair_sel_plain`, and the choice of tables by name.  Selectors and
table words are compared exactly, points as affine."""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from delay_enc_tpu.curves.bn254 import G1, G1_GEN
from delay_enc_tpu.fields import FR
from delay_enc_tpu.ops import msm as JM
from delay_enc_tpu.ops import msm16 as JM16
from delay_enc_tpu_torch.ops import limbs as TL
from delay_enc_tpu_torch.ops import msm as TM
from delay_enc_tpu_torch.ops import msm16 as TM16
from delay_enc_tpu_torch.ops import msm_tree as TT

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "delay_enc_tpu_torch", "csrc")


def _host_points(n, seed):
    rng = np.random.default_rng(seed)
    return [G1.mul(G1_GEN, int(rng.integers(1, 1 << 62))) for _ in range(n)]


def _to_jax(t):
    return jnp.asarray(TL.words_to_limbs_np(TL.to_numpy(t)))


def _scalars(rng, count):
    """Random Fr scalars with the edges among them: 0, 1, r - 1, 2^253."""
    vals = [0, 1, FR.p - 1, 1 << 253] + [FR.random(rng) for _ in range(count - 4)]
    rng.shuffle(vals)
    return vals


@pytest.fixture(scope="module")
def pts8():
    pts = _host_points(8, 31)
    return pts, TM.points_to_device(pts, "cpu")


@pytest.fixture(scope="module")
def tables8(pts8):
    return TM16.pair_tables16(pts8[1])


def test_pair_sel16_matches_jax():
    rng = np.random.default_rng(32)
    words = torch.stack([TM.scalars_to_words(_scalars(rng, 16), "cpu") for _ in range(2)])
    got = TM16.pair_sel16(words)
    want = np.asarray(JM16._jit_pair_sel16(_to_jax(words)))
    assert got.shape == (2, TM16.PLANES, 8) and got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("digit_bits", [2, 4])
def test_pair_sel_plain_drops_bits_past_253(digit_bits):
    """Words with bits 254 and 255 set give the selectors of the same words
    without them, as the JAX package's zero padding does."""
    rng = np.random.default_rng(33)
    vals = [FR.random(rng) for _ in range(6)]
    words = TM.scalars_to_words(vals, "cpu")
    high = words.clone()
    high[:, 7] |= torch.tensor(0xC0000000 - (1 << 32), dtype=torch.int32)
    assert torch.equal(TM.pair_sel_plain(high, digit_bits), TM.pair_sel_plain(words, digit_bits))


def test_pair_tables16_match_jax(pts8, tables8):
    want = np.asarray(JM16._jit_pair_tables16(_to_jax(pts8[1]))).astype(np.uint32)
    assert tables8.shape == (TM16.OPTS, 4, 3, 8)
    assert np.array_equal(TL.words_to_limbs_np(TL.to_numpy(tables8)), want)


def test_pair_tables16_options_are_the_multiples(pts8, tables8):
    pts = pts8[0]
    got = TM.points_from_device(tables8[:, 1])  # pair 1: points 2 and 3
    for opt in (0, 1, 15, 16, 17, 255, 16 * 7 + 9):
        ce, co = opt % 16, opt // 16
        want = G1.add(G1.mul(pts[2], ce) if ce else None, G1.mul(pts[3], co) if co else None)
        assert got[opt] == want


def test_plane_sums16_match_jax(pts8, tables8):
    rng = np.random.default_rng(34)
    words = torch.stack([TM.scalars_to_words(_scalars(rng, 8), "cpu") for _ in range(2)])
    got = TM16.plane_sums_batch16(tables8, words)
    assert got.shape == (2, TM16.PLANES, 3, 8)
    tab_i8 = JM16._jit_tables_to_i8(JM16._jit_pair_tables16(_to_jax(pts8[1])))
    want = JM16.plane_sums_batch16(tab_i8, _to_jax(words))
    assert TM.points_from_device(got) == JM.points_from_device(want)


def test_tree_reduce_256_options_every_selector(tables8):
    """All 256 selectors, the identity option 0 and 255 included, against
    the sum of the selected options on the host."""
    sel = torch.arange(256, dtype=torch.uint8).reshape(64, 4)
    sel[5] = 0
    got = TM.points_from_device(TT.tree_reduce(tables8, sel))
    options = [TM.points_from_device(tables8[:, i]) for i in range(4)]
    for row, s in zip(got, sel.tolist()):
        acc = None
        for lane, o in enumerate(s):
            acc = G1.add(acc, options[lane][o])
        assert row == acc
    assert got[5] is None


def test_msm16_matches_host_and_jax():
    n = 16
    pts = _host_points(n - 1, 35) + [None]
    rng = np.random.default_rng(36)
    scalars = [FR.random(rng) for _ in range(n)]
    scalars[4] = 0
    scalars[9] = FR.p - 1
    dev = TM.points_to_device(pts, "cpu")
    got = TM16.msm16(dev, TM.scalars_to_words(scalars, "cpu"))
    assert got == [G1.msm(scalars, pts)]
    assert got == JM16.msm16(_to_jax(dev), JM.scalars_to_limbs(scalars))


def test_msm16_pads_non_power_of_two():
    pts = _host_points(5, 37)
    scalars = [3, 0, 7, FR.p - 2, 1 << 253]
    got = TM16.msm16(TM.points_to_device(pts, "cpu"), TM.scalars_to_words(scalars, "cpu"))
    assert got == [G1.msm(scalars, pts)]


@pytest.mark.parametrize("base_bits", [2, 4])
def test_python_fold_matches_c_fold(monkeypatch, base_bits):
    from delay_enc_tpu_torch.native import ec

    pts = _host_points(10, 38) + [None, None]
    planes = TM.points_to_device(pts, "cpu").reshape(2, 6, 3, 8)
    want = TM.fold_planes_host(planes, base_bits)
    assert want[0] is not None and want != TM.fold_planes_host(planes, 6 - base_bits)
    monkeypatch.setattr(ec, "fold_planes_batch", lambda *a: None)
    assert TM.fold_planes_host(planes, base_bits) == want
    for b, row in enumerate(planes):
        acc = None
        for p, pt in enumerate(TM.points_from_device(row)):
            acc = G1.add(acc, G1.mul(pt, 1 << (base_bits * p)) if pt else None)
        assert want[b] == acc


def test_msm_tables_by_name():
    from delay_enc_tpu_torch.plonk import SRS
    from delay_enc_tpu_torch.plonk.kernels import msm_commit_batch

    srs = SRS.setup(3, tau=77, device="cpu")
    kind, tab = srs.msm_tables("b16")
    assert kind == "b16" and tab.shape == (256, 4, 3, 8)
    assert srs.truncated(3).pair_tables16() is tab  # built once, shared by views
    assert srs.msm_tables()[0] == "b4" and srs.msm_tables("b4")[1] is srs.pair_tables()
    for bad in ("b5", "B16", ""):
        with pytest.raises(ValueError, match="unknown MSM"):
            srs.msm_tables(bad)
    with pytest.raises(ValueError, match="unknown MSM"):
        msm_commit_batch(("b8", tab), torch.zeros((1, 8, 8), dtype=torch.int32))
    rng = np.random.default_rng(39)
    coeffs = torch.stack([TM.scalars_to_words(_scalars(rng, 8), "cpu") for _ in range(3)])
    b4 = msm_commit_batch(srs.pair_tables(), coeffs)
    assert msm_commit_batch(srs.msm_tables("b4"), coeffs) == b4
    assert msm_commit_batch(srs.msm_tables("b16"), coeffs) == b4


def test_wrappers_refuse_off_the_cpu():
    words = TM.scalars_to_words([1, 2, 3, 4], "cpu")
    with pytest.raises(ValueError, match="CUDA kernel"):
        TM.pair_sel(words.to("meta"), 4)
    with pytest.raises(ValueError, match="digits of 2 or 4 bits"):
        TM.pair_sel(words, 3)
    table = torch.zeros((17, 4, 3, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA kernel"):
        TT.tree_reduce(table, torch.zeros((1, 4), dtype=torch.uint8, device="meta"))


HARNESS = r"""
#include <cstdio>
#include <vector>
#include "sel_row.cuh"
// stdin: B m, then B * 2m scalars of 8 words; stdout: the selectors of
// digit widths 2 and 4, (B, planes, m) bytes each, one plane row a line.
template <uint32_t DB>
static void emit(const std::vector<uint32_t>& s, unsigned b, unsigned m) {
  const uint32_t planes = psel::planes<DB>();
  std::vector<uint8_t> out((size_t)b * planes * m, 0xee);
  for (size_t g = 0; g < (size_t)b * m; g++) {
    const uint32_t* e = &s[g * 16];
    psel::pair_sel_row<DB>(e, e + 8, &out[(g / m) * planes * m + g % m], m);
  }
  for (size_t r = 0; r < (size_t)b * planes; r++) {
    for (unsigned i = 0; i < m; i++) printf("%u ", out[r * m + i]);
    printf("\n");
  }
}
int main() {
  unsigned b, m;
  if (scanf("%u %u", &b, &m) != 2) return 1;
  std::vector<uint32_t> s((size_t)b * m * 16);
  for (auto& w : s)
    if (scanf("%u", &w) != 1) return 1;
  emit<2>(s, b, m);
  emit<4>(s, b, m);
  return 0;
}
"""


def test_sel_row_body_matches_plain(tmp_path):
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    src, exe = tmp_path / "harness.cpp", tmp_path / "harness"
    src.write_text(HARNESS)
    subprocess.run([cxx, "-O1", "-std=c++17", "-Wall", "-Werror", "-Wno-unknown-pragmas",
                    f"-I{CSRC}", "-o", str(exe), str(src)], check=True, capture_output=True)
    rng = np.random.default_rng(40)
    b, n = 3, 64
    words = torch.stack([TM.scalars_to_words(_scalars(rng, n), "cpu") for _ in range(b)])
    words[2, 7, 7] |= torch.tensor(0xC0000000 - (1 << 32), dtype=torch.int32)  # bits 254, 255
    flat = words.numpy().astype(np.uint32).reshape(-1)
    out = subprocess.run([str(exe)], input=f"{b} {n // 2}\n" + " ".join(map(str, flat)) + "\n",
                         text=True, capture_output=True, check=True, timeout=120).stdout
    rows = np.array([list(map(int, ln.split())) for ln in out.strip().split("\n")], np.uint8)
    for digit_bits, planes, lo in ((2, 127, 0), (4, 64, 3 * 127)):
        got = rows[lo : lo + b * planes].reshape(b, planes, n // 2)
        assert np.array_equal(got, TM.pair_sel_plain(words, digit_bits).numpy()), digit_bits
