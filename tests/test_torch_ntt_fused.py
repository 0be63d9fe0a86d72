"""The multi-stage NTT of delay_enc_tpu_torch (kernel K-b) without a card:
the pass plan for every k, the plain version that follows the kernel's own
passes against the one-stage plain version and against the JAX package
(transforms, `_coeff`, `_ext` on every lane), bit for bit, and the kernel's
per-tile body itself (csrc/ntt_tile.cuh is __host__ __device__), built by the
host C++ compiler and checked against Python integers.  No tolerance: the
words are equal."""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax

from delay_enc_tpu.fields import FR
from delay_enc_tpu.ops import limbs as JL
from delay_enc_tpu.ops import ntt as JN
from delay_enc_tpu.plonk import kernels as JK
from delay_enc_tpu.plonk.domain import Domain as JDomain
from delay_enc_tpu.plonk.keygen import _zeta_powers as jax_zeta_powers
from delay_enc_tpu_torch.ops import limbs as TL
from delay_enc_tpu_torch.ops import ntt as TN
from delay_enc_tpu_torch.plonk import kernels as TK
from delay_enc_tpu_torch.plonk.domain import Domain as TDomain

CTX = TL.FR_CTX
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "delay_enc_tpu_torch", "csrc")
# (tile_log, max_stages) of the plans the small transforms are cut into: the
# port's own, and small tiles that give k <= 9 two to five passes
SMALL_PLANS = [(TN.TILE_LOG, TN.MAX_STAGES), (4, 3), (5, 2), (3, 3)]


def _rand_mont(rng, *shape):
    vals = [FR.random(rng) for _ in range(int(np.prod(shape)))]
    return CTX.to_mont_np(vals).reshape(*shape, 8)


def _t(w):
    return TL.to_tensor(w, "cpu")


def _limbs(t):
    return TL.words_to_limbs_np(TL.to_numpy(t))


# ------------------------------------------------------------------ the plan

@pytest.mark.parametrize("k", range(0, 21))
def test_plan_runs_every_stage_once(k):
    n = 1 << k
    for n_in in {n, max(1, n // 8), max(1, n - 3)}:
        passes = TN.plan(k, n_in)
        assert passes[0].first and passes[-1].last
        assert len(passes) == max(1, -(-k // TN.MAX_STAGES))
        t0 = 0
        for p in passes:
            assert p.t0 == t0 and 0 <= p.s <= TN.MAX_STAGES
            assert p.tile <= 1 << TN.TILE_LOG and p.groups * p.tile == n
            assert p.shared_bytes <= TN.SHARED_LIMIT
            assert 32 <= p.threads <= TN.THREADS and p.threads % 32 == 0
            t0 += p.s
        assert t0 == k
        # padding: local row q of the first pass covers indices q*L .. q*L + L - 1
        first = passes[0]
        span = n >> first.s
        assert first.n_in == n_in and all(p.n_in == n and p.nz == 1 << p.s for p in passes[1:])
        assert (first.nz - 1) * span < n_in <= first.nz * span or first.nz == 1 << first.s
        assert 1 <= first.nz <= 1 << first.s


def test_main_path_shapes_are_two_launches():
    """2^16 and 2^19, the lengths of a delay_enc k=16 proof, and pose_enc's
    2^11 and 2^14."""
    assert [(p.s, p.c_log) for p in TN.plan(16)] == [(8, 2), (8, 2)]
    assert [(p.s, p.c_log) for p in TN.plan(19, 1 << 16)] == [(10, 0), (9, 1)]
    assert TN.plan(19, 1 << 16)[0].nz == 128  # 2^16 coefficients in rows of 2^9
    assert [(p.s, p.c_log) for p in TN.plan(11)] == [(6, 4), (5, 5)]
    assert [(p.s, p.c_log) for p in TN.plan(14, 1 << 11)] == [(7, 3), (7, 3)]
    assert [p.s for p in TN.plan(10)] == [10] and [p.s for p in TN.plan(1)] == [1]


def test_pass_indices_touch_every_element_once():
    for k, tile_log, stages in ((9, 5, 3), (7, 4, 3), (6, 10, 10), (10, 4, 2)):
        for p in TN.plan(k, tile_log=tile_log, max_stages=stages):
            ix = TN.pass_indices(p)
            n = 1 << k
            assert sorted(ix["load"].reshape(-1).tolist()) == list(range(n))
            assert sorted(ix["store"].reshape(-1).tolist()) == list(range(n))
            assert sorted(ix["store_pos"].tolist()) == list(range(p.tile))
            for pa, pb, ex, _, _ in ix["stages"]:
                assert sorted(pa.tolist() + pb.tolist()) == list(range(p.tile))
                assert int(ex.min()) >= 0 and int(ex.max()) < max(1, n // 2)


def test_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError):
        TN.plan(4, 17)
    with pytest.raises(ValueError):
        TN.plan(4, 0)
    with pytest.raises(ValueError):
        TN.plan(16, tile_log=13, max_stages=8)  # 256 KB of shared memory
    with pytest.raises(ValueError):
        TN.plan(8, tile_log=4, max_stages=5)


# ------------------------------------------- the pass-following plain version

@pytest.mark.parametrize("k", range(0, 10))
def test_passes_plain_matches_stockham_plain(k):
    rng = np.random.default_rng(100 + k)
    a = _t(_rand_mont(rng, 2, 1 << k))
    tw = TN.NTTPlan.make(CTX, k, "cpu").tw
    want = TN.stockham_plain(CTX, a, tw)
    for tile_log, stages in SMALL_PLANS:
        passes = TN.plan(k, tile_log=tile_log, max_stages=stages)
        got = TN.stockham_passes_plain(CTX, a, tw, passes=passes)
        assert torch.equal(got, want), (tile_log, stages)


@pytest.mark.parametrize("k", [1, 4, 7, 9])
def test_passes_plain_matches_jax_stockham(k):
    rng = np.random.default_rng(200 + k)
    a = _rand_mont(rng, 1 << k)
    tplan = TN.NTTPlan.make(CTX, k, "cpu")
    jplan = JN.NTTPlan.make(JL.FR_CTX, k)
    want = np.asarray(jax.jit(lambda x: JN.stockham(JL.FR_CTX, x, jplan.tw))(
        TL.words_to_limbs_np(a)))
    for tile_log, stages in SMALL_PLANS[:2]:
        got = TN.stockham_passes_plain(CTX, _t(a), tplan.tw,
                                       passes=TN.plan(k, tile_log=tile_log, max_stages=stages))
        assert np.array_equal(_limbs(got), want)


@pytest.mark.parametrize("n_in", [1, 5, 8, 16, 37, 64])
def test_passes_plain_reads_short_rows_as_padded(n_in):
    """Any row length up to n, with and without the input table; where whole
    local rows are padding the plan skips them."""
    k = 6
    rng = np.random.default_rng(300 + n_in)
    a = _t(_rand_mont(rng, 3, n_in))
    tab = _t(_rand_mont(rng, 1 << k))
    tw = TN.NTTPlan.make(CTX, k, "cpu").tw
    for table in (None, tab):
        want = TN.stockham(CTX, a, tw, n=1 << k, in_table=table)
        for tile_log, stages in SMALL_PLANS:
            passes = TN.plan(k, n_in, tile_log=tile_log, max_stages=stages)
            got = TN.stockham_passes_plain(CTX, a, tw, n=1 << k, in_table=table, passes=passes)
            assert torch.equal(got, want), (tile_log, stages, table is None)


def test_passes_plain_output_sides():
    k = 7
    rng = np.random.default_rng(400)
    a = _t(_rand_mont(rng, 2, 1 << k))
    tplan = TN.NTTPlan.make(CTX, k, "cpu")
    table = _t(_rand_mont(rng, 1 << k))
    for scale in (tplan.n_inv, tplan.n_inv[0], table):
        want = TL.mont_mul_plain(CTX, TN.stockham_plain(CTX, a, tplan.tw_inv), scale)
        assert torch.equal(TN.stockham(CTX, a, tplan.tw_inv, out_scale=scale), want)
        for tile_log, stages in SMALL_PLANS:
            passes = TN.plan(k, tile_log=tile_log, max_stages=stages)
            got = TN.stockham_passes_plain(CTX, a, tplan.tw_inv, out_scale=scale, passes=passes)
            assert torch.equal(got, want)


def test_coeff_form_matches_jax():
    """`_coeff` as the kernel makes it: the inverse transform with 1/n in the
    last store."""
    k = 8
    rng = np.random.default_rng(20)
    evals = _rand_mont(rng, 6, 1 << k)
    jd, td = JDomain(k), TDomain(k)
    want = np.asarray(JK._jit_coeff_batch(TL.words_to_limbs_np(evals),
                                          jd.plan.tw_inv, jd.plan.n_inv))
    plan = td.plan("cpu")
    assert np.array_equal(_limbs(TK._coeff(_t(evals), plan)), want)
    for tile_log, stages in SMALL_PLANS[:2]:
        got = TN.stockham_passes_plain(CTX, _t(evals), plan.tw_inv, out_scale=plan.n_inv,
                                       passes=TN.plan(k, tile_log=tile_log, max_stages=stages))
        assert np.array_equal(_limbs(got), want)


def test_ext_form_matches_jax_every_lane():
    """`_ext` as the kernel makes it, (19, 2^6) -> (19, 2^9): zeta^i in the
    first load, rows read as zero-padded, every lane including the last."""
    k = 6
    rng = np.random.default_rng(19)
    coeff = _rand_mont(rng, 19, 1 << k)
    jd, td = JDomain(k), TDomain(k)
    zp_t = TN.powers(CTX, td.zeta, td.n_ext, "cpu")
    want = np.asarray(JK._jit_ext_batch(TL.words_to_limbs_np(coeff), jax_zeta_powers(jd),
                                        jd.plan_ext.tw))
    plan_ext = td.plan_ext("cpu")
    got = TK._ext(_t(coeff), zp_t, plan_ext)
    assert got.shape == (19, 8 << k, 8)
    assert np.array_equal(_limbs(got), want)
    for tile_log, stages in SMALL_PLANS:
        passes = TN.plan(k + 3, 1 << k, tile_log=tile_log, max_stages=stages)
        assert passes[0].nz < 1 << passes[0].s  # the padding is skipped
        got = TN.stockham_passes_plain(CTX, _t(coeff), plan_ext.tw, n=8 << k, in_table=zp_t,
                                       passes=passes)
        for lane in range(19):
            assert np.array_equal(_limbs(got[lane]), want[lane]), (lane, tile_log, stages)


def test_wrapper_refuses_bad_operands():
    tw = TN.NTTPlan.make(CTX, 3, "cpu").tw
    a = torch.zeros(2, 8, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two"):
        TN.stockham(CTX, a[:, :6], tw, n=6)
    with pytest.raises(ValueError, match="do not fit"):
        TN.stockham(CTX, a, tw, n=4)
    with pytest.raises(ValueError, match="twiddle"):
        TN.stockham(CTX, a, tw[:2])
    with pytest.raises(ValueError, match="input table"):
        TN.stockham(CTX, a, tw, in_table=a[0, :4])
    with pytest.raises(ValueError, match="output scale"):
        TN.stockham(CTX, a, tw, out_scale=a[0, :3])


# -------------------------------------- the kernel's tile body, host-compiled

HARNESS = r"""
#include <cstdio>
#include <vector>
#include "ntt_tile.cuh"
// stdin: passes batch n_in log_n has_in_tab out_mode threads order, then a line
// "t0 s c_log n_in nz" for each pass, then the words of tw, in_tab, out_tab
// and the source rows.  The "threads" of a block run one after another,
// from the last to the first when order is 1.
static std::vector<uint32_t> words(size_t count) {
  std::vector<uint32_t> v(count * 8);
  for (auto& w : v) if (scanf("%u", &w) != 1) return {};
  return v;
}
int main() {
  unsigned np, batch, n_in, log_n, has_in, out_mode, nth, order;
  if (scanf("%u %u %u %u %u %u %u %u", &np, &batch, &n_in, &log_n, &has_in, &out_mode, &nth,
            &order) != 8) return 1;
  const size_t n = (size_t)1 << log_n;
  std::vector<ntt::Pass> passes(np);
  for (auto& p : passes) {
    p.log_n = log_n;
    p.out_mode = ntt::OUT_NONE;
    if (scanf("%u %u %u %u %u", &p.t0, &p.s, &p.c_log, &p.n_in, &p.nz) != 5) return 1;
  }
  passes.back().out_mode = out_mode;
  std::vector<uint32_t> tw = words(n / 2 ? n / 2 : 1);
  std::vector<uint32_t> in_tab = words(has_in ? n_in : 0);
  std::vector<uint32_t> out_tab = words(out_mode == ntt::OUT_CONST ? 1 : out_mode ? n : 0);
  std::vector<uint32_t> cur = words((size_t)batch * n_in);
  for (unsigned i = 0; i < np; i++) {
    const ntt::Pass& P = passes[i];
    const unsigned T = 1u << (P.s + P.c_log), groups = 1u << (log_n - P.s - P.c_log);
    std::vector<uint32_t> dst((size_t)batch * n * 8, 0xdeadbeefu);
    for (unsigned row = 0; row < batch; row++)
      for (unsigned g = 0; g < groups; g++) {
        std::vector<uint32_t> sm((size_t)8 * ntt::plane_words(T), 0xdeadbeefu);
        auto each = [&](auto fn) {
          for (unsigned t = 0; t < nth; t++) fn(order ? nth - 1 - t : t);
        };
        each([&](unsigned t) {
          ntt::tile_load(P, g, t, nth, sm.data(), cur.data() + (size_t)row * P.n_in * 8,
                         i == 0 && has_in ? in_tab.data() : nullptr);
        });
        for (unsigned u = 0; u < P.s; u++)
          each([&](unsigned t) { ntt::tile_stage(P, u, g, t, nth, sm.data(), tw.data()); });
        each([&](unsigned t) {
          ntt::tile_store(P, g, t, nth, sm.data(), dst.data() + (size_t)row * n * 8,
                          out_tab.data());
        });
      }
    cur.swap(dst);
  }
  for (size_t e = 0; e < (size_t)batch * n; e++) {
    for (int j = 0; j < 8; j++) printf("%u ", cur[e * 8 + j]);
    printf("\n");
  }
  return 0;
}
"""

BODIES = {"portable": [], "carry_chain": ["-DFLD_EMULATE_PTX"]}


@pytest.fixture(scope="module", params=list(BODIES))
def tile_harness(request, tmp_path_factory):
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("ntt_tile_" + request.param)
    src, exe = d / "harness.cpp", d / "harness"
    src.write_text(HARNESS)
    subprocess.run([cxx, "-O1", "-std=c++17", "-Wall", "-Werror", "-Wno-unknown-pragmas",
                    f"-I{CSRC}", *BODIES[request.param], "-o", str(exe), str(src)],
                   check=True, capture_output=True)

    def run(passes, batch, k, src_words, tw, in_tab, out_scale, threads, order):
        n_in = src_words.shape[1]
        mode = 0 if out_scale is None else (1 if out_scale.shape[0] == 1 else 2)
        head = [f"{len(passes)} {batch} {n_in} {k} {int(in_tab is not None)} {mode} "
                f"{threads} {order}"]
        head += [f"{p.t0} {p.s} {p.c_log} {p.n_in} {p.nz}" for p in passes]
        arrays = [tw] + [x for x in (in_tab, out_scale) if x is not None] + [src_words]
        body = [" ".join(map(str, np.asarray(x, dtype=np.uint32).reshape(-1))) for x in arrays]
        out = subprocess.run([str(exe)], input="\n".join(head + body) + "\n", text=True,
                             capture_output=True, check=True, timeout=300).stdout
        return np.array([list(map(int, ln.split())) for ln in out.strip().split("\n")],
                        dtype=np.uint32).reshape(batch, 1 << k, 8)

    return run


def _dft_ints(rows, w, n, in_tab, scale):
    """A[j] = scale_j * sum_i tab_i a_i w^(i j) over Python integers."""
    p = FR.p
    out = []
    for row in rows:
        row = [a * t % p for a, t in zip(row, in_tab)] if in_tab else list(row)
        for j in range(n):
            wj = pow(w, j, p)
            acc, x = 0, 1
            for a in row:
                acc = (acc + a * x) % p
                x = x * wj % p
            out.append(acc * (scale[j % len(scale)] if scale else 1) % p)
    return out


@pytest.mark.parametrize("k,tile_log,stages,threads", [
    (0, 4, 3, 32), (1, 4, 3, 32), (3, 4, 3, 4), (5, 4, 3, 8), (6, 4, 2, 32), (7, 5, 3, 16),
    (7, 10, 10, 64),
])
def test_tile_body_matches_python_ints(tile_harness, k, tile_log, stages, threads):
    """The C++ that the card runs, a block's threads in either order, on a
    plain transform, then with a short row, the input table and the output
    table, then with the constant."""
    n = 1 << k
    rng = np.random.default_rng(500 + k)
    tplan = TN.NTTPlan.make(CTX, k, "cpu")
    tw = TL.to_numpy(tplan.tw)
    w = tplan.omega
    cases = [(n, False, None), (max(1, n // 4), True, n), (max(1, n - 3), False, 1)]
    for order, (n_in, with_tab, scale_len) in enumerate(cases):
        rows = [[FR.random(rng) for _ in range(n_in)] for _ in range(2)]
        tab = [FR.random(rng) for _ in range(n_in)] if with_tab else None
        scale = [FR.random(rng) for _ in range(scale_len)] if scale_len else None
        passes = TN.plan(k, n_in, tile_log=tile_log, max_stages=stages)
        got = tile_harness(
            passes, 2, k, np.stack([CTX.to_mont_np(r) for r in rows]), tw,
            CTX.to_mont_np(tab) if tab else None, CTX.to_mont_np(scale) if scale else None,
            threads, order % 2)
        assert CTX.from_mont_np(got) == _dft_ints(rows, w, n, tab, scale)
