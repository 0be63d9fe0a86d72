"""Proving over a mesh of shards (delay_enc_tpu_torch/parallel/) against the
JAX package, on the CPU.

The CPU mesh is `Mesh.shared("cpu", D)`: D shards on one device, which runs
every stage of the algorithms (the exchanges are copies that stay on the
device), as the JAX tests run 8 virtual CPU devices.  Inputs come from
numpy seeds; every comparison is exact: Montgomery words for field data,
affine points for curve points, bytes for proofs.  K12's kernel bodies
(csrc/shard_row.cuh) are built by the host C++ compiler and run over the
wrapper's own argument tables.  The comparison with the JAX package's own
sharded functions takes minutes of XLA:CPU compile and is marked slow.
"""

import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from delay_enc_tpu.fields import FR
from delay_enc_tpu.ops import limbs as JL
from delay_enc_tpu.ops import ntt as JN
from delay_enc_tpu_torch.curves.bn254 import G1, G1_GEN
from delay_enc_tpu_torch.ops import limbs as TL
from delay_enc_tpu_torch.ops import msm as TM
from delay_enc_tpu_torch.ops import ntt as TN
from delay_enc_tpu_torch.parallel import (
    Mesh,
    ShardedNTTPlan,
    batch_commit,
    dryrun_multichip,
    make_mesh,
    sharded_intt,
    sharded_msm,
    sharded_ntt,
    sharded_plane_sums,
)
from delay_enc_tpu_torch.parallel import mesh as PM
from delay_enc_tpu_torch.parallel import ntt as PN

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_batch import SEED, golden, port  # noqa: E402,F401
from test_torch_prover import one_thread  # noqa: E402,F401

K = 7  # N = 128: D = 8 gives shards of 16, the JAX tests' size
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "delay_enc_tpu_torch", "csrc")


def _rand_mont(rng, count):
    return TL.FR_CTX.to_mont_np([FR.random(rng) for _ in range(count)])


def _limbs(t):
    return TL.words_to_limbs_np(TL.to_numpy(t))


@pytest.fixture(scope="module")
def coeffs():
    """The k=7 coefficients and their JAX single-chip NTT."""
    a = _rand_mont(np.random.default_rng(1), 1 << K)
    jplan = JN.NTTPlan.make(JL.FR_CTX, K)
    want = np.asarray(jax.jit(lambda x: JN.ntt(jplan, x))(TL.words_to_limbs_np(a)))
    return TL.to_tensor(a, "cpu"), want


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_sharded_ntt_matches_jax_and_roundtrips(coeffs, ndev):
    """The sharded NTT equals the JAX package's single-chip NTT and the
    port's own; the sharded iNTT returns the input."""
    a, want = coeffs
    mesh = Mesh.shared("cpu", ndev)
    plan = ShardedNTTPlan.make(K, ndev, mesh.devices)
    evals = sharded_ntt(mesh, plan, a)
    assert len(evals) == ndev and all(e.shape == ((1 << K) // ndev, 8) for e in evals)
    got = mesh.gather(evals)
    assert np.array_equal(_limbs(got), want)
    assert torch.equal(got, TN.ntt(TN.NTTPlan.make(TL.FR_CTX, K, "cpu"), a))
    assert torch.equal(mesh.gather(sharded_intt(mesh, plan, evals)), a)
    # the shards as a list go in as the whole tensor does
    assert torch.equal(mesh.gather(sharded_ntt(mesh, plan, mesh.scatter(a))), got)


def test_sharded_ntt_preconditions(coeffs):
    a, _ = coeffs
    with pytest.raises(ValueError, match="power of two"):
        ShardedNTTPlan.make(K, 3, "cpu")
    with pytest.raises(ValueError, match="D\\^2 <= N"):
        ShardedNTTPlan.make(K, 16, "cpu")
    with pytest.raises(ValueError, match="devices for"):
        ShardedNTTPlan.make(K, 4, ["cpu"] * 2)
    plan = ShardedNTTPlan.make(K, 4, "cpu")
    with pytest.raises(ValueError, match="plan for"):
        sharded_ntt(Mesh.shared("cpu", 2), plan, a)
    with pytest.raises(ValueError, match="shards for a plan"):
        sharded_intt(Mesh.shared("cpu", 4), plan, Mesh.shared("cpu", 2).scatter(a))
    with pytest.raises(ValueError, match="a shard must be"):
        sharded_ntt(Mesh.shared("cpu", 4), plan, a[:64])


def _stage_rows(plan, s, inverse=False):
    """Stage s's twiddle row of every shard, as the JAX plan's stage_tw[s]
    holds them: the bottom shards' rows of the device's table, ones for the
    top shards."""
    table = plan.rows_inv if inverse else plan.rows
    l_len = (1 << plan.k) // plan.ndev
    out = []
    for d in range(plan.ndev):
        r = PN.row_index(plan.ndev, s, d)
        out.append(TL.FR_CTX.one_mont(plan.devices[d]).expand(l_len, 8) if r is None
                   else table[d][r])
    return out


def test_plan_rows_match_jax():
    """The twiddle rows, made on the device by powers, equal the JAX plan's
    per-element Python pow, top rows (ones) included; each device keeps the
    D - 1 distinct rows of a direction once, shared by its shards; so do
    the reshuffle's reversal and the local plan's root."""
    from delay_enc_tpu.parallel.ntt import ShardedNTTPlan as JPlan

    ndev = 8
    want = JPlan.make(K, ndev)
    got = ShardedNTTPlan.make(K, ndev, "cpu")
    assert got.m == len(want.stage_tw) == 3
    for table in (got.rows, got.rows_inv):
        assert table[0].shape == (ndev - 1, (1 << K) // ndev, 8)
        assert all(t is table[0] for t in table)
    for inverse, theirs in ((False, want.stage_tw), (True, want.stage_tw_inv)):
        for s, jrows in enumerate(theirs):
            rows = _stage_rows(got, s, inverse)
            assert np.array_equal(_limbs(torch.stack(rows)), np.asarray(jrows))
    # every distinct bottom row of the JAX plan is one row of the table
    used = {PN.row_index(ndev, s, d) for s in range(3) for d in range(ndev)} - {None}
    assert used == set(range(ndev - 1))
    assert [PN._bit_rev(d, 3) for d in range(ndev)] == [int(r) for r in np.asarray(want.rev_idx)]
    assert got.local_plan.omega == want.local_plan.omega
    assert _limbs(got.n_inv[0])[0].tolist() == np.asarray(want.n_inv).tolist()
    assert got.groups == [(torch.device("cpu"), tuple(range(ndev)))]


def _carry_heavy():
    """Words that make the carry and borrow chains run long, each against
    each: p - 1, 0, 1, 2^255 - 1 reduced, R mod p, all-ones words."""
    ones = (1 << 256) - 1
    vals = [FR.p - 1, 0, 1, ((1 << 255) - 1) % FR.p, (1 << 256) % FR.p, FR.p - 2,
            ones >> 3, 0xFFFFFFFF << 64, (1 << 224) + 1]
    m = len(vals)
    x = [v for v in vals for _ in range(m)]
    r = [v for _ in range(m) for v in vals]
    return TL.ints_to_words_np(x), TL.ints_to_words_np(r)


@pytest.mark.parametrize("table", ["none", "const", "row"])
@pytest.mark.parametrize("top", [True, False])
def test_shard_butterfly_plain_matches_jax(top, table):
    """The plain butterfly equals the JAX stage's L.add / L.sub and
    L.mont_mul, on carry-heavy operands, in both positions, with a row,
    with one element and with no table."""
    x, r = _carry_heavy()
    n = x.shape[0]
    rng = np.random.default_rng(7)
    tab = {"none": None, "const": _rand_mont(rng, 1), "row": _rand_mont(rng, n)}[table]
    got = PN.shard_butterfly_plain(TL.to_tensor(x, "cpu"), TL.to_tensor(r, "cpu"), top,
                                   None if tab is None else TL.to_tensor(tab, "cpu"))
    jx, jr = TL.words_to_limbs_np(x), TL.words_to_limbs_np(r)
    want = JL.add(JL.FR_CTX, jx, jr) if top else JL.sub(JL.FR_CTX, jr, jx)
    if tab is not None:
        want = JL.mont_mul(JL.FR_CTX, want, TL.words_to_limbs_np(tab))
    assert np.array_equal(_limbs(got), np.asarray(want))


def _stage_blocks(seed, ndev, l_len):
    """D (l_len, 8) blocks of random reduced words with the carry-heavy
    pairs (`_carry_heavy`) spread over them."""
    x, r = _carry_heavy()
    heavy = np.concatenate([x, r])
    words = _rand_mont(np.random.default_rng(seed), ndev * l_len)
    spots = np.random.default_rng(seed + 1).choice(ndev * l_len, min(len(heavy), ndev * l_len // 2),
                                                   replace=False)
    words[spots] = heavy[:len(spots)]
    return list(TL.to_tensor(words, "cpu").reshape(ndev, l_len, 8))


def _jax_stages(jplan, blocks, inverse):
    """The JAX package's cross-shard stages as its shard_map runs them on
    each shard (`_dif_stages`; the loop of `sharded_intt` and its 1/N),
    over the D blocks as (L, 16) limbs."""
    ctx = JL.FR_CTX
    ndev = jplan.ndev
    m = ndev.bit_length() - 1
    x = [TL.words_to_limbs_np(TL.to_numpy(b)) for b in blocks]
    for s in (range(m - 1, -1, -1) if inverse else range(m)):
        g = ndev >> s
        half = g // 2
        bottom = [d % g >= half for d in range(ndev)]
        if not inverse:
            x = [JL.mont_mul(ctx, JL.sub(ctx, x[d ^ half], x[d]), jplan.stage_tw[s][d])
                 if bottom[d] else JL.add(ctx, x[d], x[d ^ half]) for d in range(ndev)]
        else:
            val = [JL.mont_mul(ctx, x[d], jplan.stage_tw_inv[s][d]) if bottom[d] else x[d]
                   for d in range(ndev)]
            x = [JL.sub(ctx, val[d ^ half], val[d]) if bottom[d]
                 else JL.add(ctx, val[d], val[d ^ half]) for d in range(ndev)]
    if inverse:
        x = [JL.mont_mul(ctx, v, jplan.n_inv[None, :]) for v in x]
    return np.stack([np.asarray(v) for v in x])


@pytest.fixture(scope="module")
def jax_intt(coeffs):
    """The JAX package's single-chip iNTT of the k=7 evaluations."""
    _, want = coeffs
    jplan = JN.NTTPlan.make(JL.FR_CTX, K)
    return np.asarray(jax.jit(lambda x: JN.intt(jplan, x))(want))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_shard_stages_plain_matches_jax(coeffs, jax_intt, ndev, inverse):
    """The stages' plain version equals the JAX package's stages composed
    shard by shard, and with K-b over the stack and the reshuffle it gives
    the JAX package's single-chip NTT (forward) or iNTT (inverse)."""
    from delay_enc_tpu.parallel.ntt import ShardedNTTPlan as JPlan

    a, want = coeffs
    l_len = (1 << K) // ndev
    plan = ShardedNTTPlan.make(K, ndev, "cpu")
    every = range(ndev)
    if not inverse:
        blocks = list(a.reshape(ndev, l_len, 8))
    else:
        evals = list(TL.to_tensor(TL.limbs_to_words_np(want), "cpu").reshape(ndev, l_len, 8))
        blocks = list(TN.stockham(TL.FR_CTX, PN.shard_reshuffle_plain(evals, every, inverse=True),
                                  plan.local_plan.tw_inv))
    got = PN.shard_stages_plain(blocks, (plan.rows_inv if inverse else plan.rows)[0], every,
                                inverse=inverse, n_inv=plan.n_inv[0])
    assert np.array_equal(_limbs(got), _jax_stages(JPlan.make(K, ndev), blocks, inverse))
    if not inverse:
        y = TN.stockham(TL.FR_CTX, got, plan.local_plan.tw)
        out = PN.shard_reshuffle_plain(list(y), every)
        assert np.array_equal(_limbs(out.reshape(-1, 8)), want)
    else:
        assert np.array_equal(_limbs(got.reshape(-1, 8)), jax_intt)
        assert torch.equal(got.reshape(-1, 8), a)


def _groupings(ndev):
    """Ways to spread D shards over devices: all on one (in order and
    reversed), one a device, and g devices (g = 2, 4 below D) holding runs
    of shards or every g-th shard."""
    out = [[tuple(range(ndev))], [tuple(reversed(range(ndev)))], [(d,) for d in range(ndev)]]
    for g in (2, 4):
        if g < ndev:
            run = ndev // g
            out.append([tuple(range(i * run, (i + 1) * run)) for i in range(g)])
            out.append([tuple(range(i, ndev, g)) for i in range(g)])
    return out


def _stages_index(blocks, rows, shards, *, inverse=False, n_inv=None):
    """`shard_stages` as csrc/shard_row.cuh stages_at computes it, every
    position at once: the pointer table's D blocks, the slot map of the
    card's shards, the steps' node masks (`PN.node_masks`), each node's row
    (`PN.row_index`), the butterflies of the nodes a mask keeps (a node
    outside it keeps a stale value, as its registers do), and the stores."""
    ndev = len(blocks)
    m = ndev.bit_length() - 1
    slot = [-1] * ndev
    for i, d in enumerate(shards):
        slot[d] = i
    need = PN.node_masks(ndev, shards, inverse)
    v = [b.clone() for b in blocks]
    for i, s in enumerate(PN.stage_order(m, inverse)):
        h = ndev >> (s + 1)
        for t in range(ndev):
            if t & h:
                continue
            b = t + h
            want_t, want_b = need[i] >> t & 1, need[i] >> b & 1
            if not (want_t or want_b):
                continue
            w = rows[PN.row_index(ndev, s, b)]
            if inverse:
                v[b] = TL.mont_mul_plain(TL.FR_CTX, v[b], w)
            total = TL.add_plain(TL.FR_CTX, v[t], v[b]) if want_t else None
            if want_b:
                diff = TL.sub_plain(TL.FR_CTX, v[t], v[b])
                v[b] = diff if inverse else TL.mont_mul_plain(TL.FR_CTX, diff, w)
            if want_t:
                v[t] = total
    out = blocks[0].new_empty((len(shards), blocks[0].shape[0], 8))
    for d in range(ndev):
        if slot[d] >= 0:
            out[slot[d]] = (TL.mont_mul_plain(TL.FR_CTX, v[d], n_inv.reshape(-1, 8)) if inverse
                            else v[d])
    return out


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("ndev", [2, 4, 8, 16])
def test_shard_stages_index_matches_plain(ndev, inverse):
    """The kernel's index arithmetic (`_stages_index`: the node
    masks, rows and slots) equals the composed stages for every way of
    spreading the shards over devices, carry-heavy operands among them."""
    l_len = 32
    m = ndev.bit_length() - 1
    plan = ShardedNTTPlan.make(5 + m, ndev, "cpu")
    rows = (plan.rows_inv if inverse else plan.rows)[0]
    blocks = _stage_blocks(ndev, ndev, l_len)
    full = PN.shard_stages_plain(blocks, rows, range(ndev), inverse=inverse, n_inv=plan.n_inv[0])
    for groups in _groupings(ndev):
        for shards in groups:
            got = _stages_index(blocks, rows, shards, inverse=inverse, n_inv=plan.n_inv[0])
            assert torch.equal(got, full[list(shards)]), (groups, shards)
            # the wrapper on the CPU is the plain version
            assert torch.equal(PN.shard_stages("cpu", blocks, shards, rows, inverse=inverse,
                                               n_inv=plan.n_inv[0]), got)


def test_node_masks_follow_one_path():
    """A card that holds one of D shards computes D - 1 butterfly halves
    (one path), a card that holds all of them the whole network."""
    for ndev in (2, 4, 8, 16):
        m = ndev.bit_length() - 1
        for inverse in (False, True):
            for d in range(ndev):
                masks = PN.node_masks(ndev, [d], inverse)
                assert masks[-1] == 1 << d
                assert sum(bin(x).count("1") for x in masks) == ndev - 1
            assert PN.node_masks(ndev, range(ndev), inverse) == [(1 << ndev) - 1] * m


def _torch_form(blocks, inverse):
    """The reshuffle as the mesh's exchanges make it (the JAX package's
    form): an all_to_all of the blocks' chunks, a bit-reversed source
    order and a transpose; the inverse undoes each."""
    ndev = len(blocks)
    l_len = blocks[0].shape[0]
    rev = torch.tensor([PN._bit_rev(d, ndev.bit_length() - 1) for d in range(ndev)])
    if not inverse:
        recv = PM.all_to_all([x.reshape(ndev, l_len // ndev, 8) for x in blocks])
        return [r.index_select(0, rev).transpose(0, 1).reshape(l_len, 8) for r in recv]
    y = [x.reshape(l_len // ndev, ndev, 8).transpose(0, 1).index_select(0, rev) for x in blocks]
    return [t.reshape(l_len, 8) for t in PM.all_to_all(y)]


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_shard_reshuffle_plain_matches_torch_form(ndev, inverse):
    """The reshuffle's plain version equals the exchanges' form, for every
    way of spreading the shards, and the other direction undoes it."""
    blocks = _stage_blocks(ndev + 100, ndev, 64)
    want = torch.stack(_torch_form(blocks, inverse))
    for groups in _groupings(ndev):
        for shards in groups:
            got = PN.shard_reshuffle_plain(blocks, shards, inverse=inverse)
            assert torch.equal(got, want[list(shards)])
            assert torch.equal(PN.shard_reshuffle("cpu", blocks, shards, inverse=inverse), got)
    back = PN.shard_reshuffle_plain(list(want), range(ndev), inverse=not inverse)
    assert torch.equal(back, torch.stack(blocks))


SHARD_HARNESS = r"""
#include <cstdio>
#include <cstddef>
#include <vector>
#include "shard_row.cuh"
using shard::Args;
// stdin: kind (0 stages, 1 reshuffle, 2 layout), inverse; then the wrapper's
// Args fields but the addresses (slot, shard, need, n, log_d, count, log_n),
// the D blocks, and for the stages the D - 1 rows and, inverse, 1/N
static bool words(std::vector<uint32_t>& v, size_t n) {
  v.resize(n);
  for (auto& w : v)
    if (scanf("%u", &w) != 1) return false;
  return true;
}
template <bool INV>
static void stages(const Args& a) {
  for (uint32_t l = 0; l < a.n; l++) switch (a.log_d) {
      case 0: shard::stages_at<0, INV>(a, l); break;
      case 1: shard::stages_at<1, INV>(a, l); break;
      case 2: shard::stages_at<2, INV>(a, l); break;
      case 3: shard::stages_at<3, INV>(a, l); break;
      default: shard::stages_at<4, INV>(a, l); break;
    }
}
int main() {
  int kind, inv;
  if (scanf("%d %d", &kind, &inv) != 2) return 1;
  if (kind == 2) {
    printf("%zu %zu %zu %zu %zu %zu %zu %zu %zu %d %d\n", sizeof(Args), offsetof(Args, rows),
           offsetof(Args, scale), offsetof(Args, out), offsetof(Args, slot),
           offsetof(Args, shard), offsetof(Args, need), offsetof(Args, n),
           offsetof(Args, log_n), shard::MAX_SHARDS, shard::MAX_LOG);
    return 0;
  }
  Args a{};
  for (int d = 0; d < shard::MAX_SHARDS; d++)
    if (scanf("%d", &a.slot[d]) != 1) return 1;
  for (int d = 0; d < shard::MAX_SHARDS; d++)
    if (scanf("%u", &a.shard[d]) != 1) return 1;
  for (int i = 0; i < shard::MAX_LOG; i++)
    if (scanf("%u", &a.need[i]) != 1) return 1;
  if (scanf("%u %u %u %u", &a.n, &a.log_d, &a.count, &a.log_n) != 4) return 1;
  const unsigned D = 1u << a.log_d;
  std::vector<std::vector<uint32_t>> blocks(D);
  for (unsigned d = 0; d < D; d++) {
    if (!words(blocks[d], (size_t)a.n * 8)) return 1;
    a.block[d] = (uint64_t)(uintptr_t)blocks[d].data();
  }
  std::vector<uint32_t> rows, scale, out((size_t)a.count * a.n * 8);
  a.out = (uint64_t)(uintptr_t)out.data();
  if (kind == 0) {
    if (!words(rows, (size_t)(D - 1) * a.n * 8)) return 1;
    a.rows = (uint64_t)(uintptr_t)rows.data();
    if (inv) {
      if (!words(scale, 8)) return 1;
      a.scale = (uint64_t)(uintptr_t)scale.data();
      stages<true>(a);
    } else {
      stages<false>(a);
    }
  } else {
    for (size_t i = 0; i < (size_t)a.count * a.n; i++) {
      if (inv) shard::reshuffle_at<true>(a, i);
      else shard::reshuffle_at<false>(a, i);
    }
  }
  for (size_t i = 0; i < out.size(); i++) printf("%u%c", out[i], i % 8 == 7 ? '\n' : ' ');
  return 0;
}
"""


@pytest.fixture(scope="module")
def shard_harness(tmp_path_factory):
    """csrc/shard_row.cuh built by the host C++ compiler, with the
    carry-chain field bodies the card runs (FLD_EMULATE_PTX)."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("shard_row")
    src, exe = d / "harness.cpp", d / "harness"
    src.write_text(SHARD_HARNESS)
    subprocess.run([cxx, "-O1", "-std=c++17", "-Wall", "-Werror", "-Wno-unknown-pragmas",
                    f"-I{CSRC}", "-DFLD_EMULATE_PTX", "-o", str(exe), str(src)],
                   check=True, capture_output=True)

    def run(kind, inverse, args, tensors):
        text = [f"{kind} {int(inverse)}"]
        if args is not None:
            text.append(" ".join(map(str, list(args.slot) + list(args.shard) + list(args.need)
                                     + [args.n, args.log_d, args.count, args.log_n])))
        for t in tensors:
            text.append(" ".join(map(str, TL.to_numpy(t).reshape(-1).view(np.uint32).tolist())))
        out = subprocess.run([str(exe)], input="\n".join(text) + "\n", text=True,
                             capture_output=True, check=True, timeout=300).stdout
        if args is None:
            return out
        words = np.array(out.split(), dtype=np.uint64).astype(np.uint32).view(np.int32)
        return torch.from_numpy(words.reshape(-1, args.n, 8).copy())

    return run


def test_shard_args_layout_matches_wrapper(shard_harness):
    size, rows, scale, out, slot, shard, need, n, log_n, max_shards, max_log = \
        map(int, shard_harness(2, False, None, []).split())
    A = PN._Args
    assert size == ctypes.sizeof(A)
    assert (rows, scale, out, slot, shard, need, n, log_n) == tuple(
        getattr(A, f).offset for f in ("rows", "scale", "out", "slot", "shard", "need", "n",
                                       "log_n"))
    assert (max_shards, max_log) == (PN.MAX_SHARDS, PN.MAX_LOG)


@pytest.mark.parametrize("ndev", [1, 2, 4, 8, 16])
def test_shard_kernel_bodies_match_plain(shard_harness, ndev):
    """The kernels' bodies (csrc/shard_row.cuh stages_at and reshuffle_at)
    over the wrapper's own Args, in both directions and for every way of
    spreading the shards, equal the plain versions; carry-heavy operands."""
    l_len = 32
    m = ndev.bit_length() - 1
    plan = ShardedNTTPlan.make(5 + m, ndev, "cpu")
    blocks = _stage_blocks(3 * ndev, ndev, l_len)
    for inverse in (False, True):
        rows = (plan.rows_inv if inverse else plan.rows)[0]
        extra = [rows] + ([plan.n_inv[0]] if inverse else [])
        full = PN.shard_stages_plain(blocks, rows, range(ndev), inverse=inverse,
                                     n_inv=plan.n_inv[0])
        shuffled = PN.shard_reshuffle_plain(blocks, range(ndev), inverse=inverse)
        for groups in _groupings(ndev):
            for shards in groups:
                out = torch.empty((len(shards), l_len, 8), dtype=torch.int32)
                args = PN._args(blocks, shards, out, rows, plan.n_inv[0], inverse)
                got = shard_harness(0, inverse, args, blocks + extra)
                assert torch.equal(got, full[list(shards)]), ("stages", inverse, shards)
                got = shard_harness(1, inverse, PN._args(blocks, shards, out), blocks)
                assert torch.equal(got, shuffled[list(shards)]), ("reshuffle", inverse, shards)


def test_shard_stages_refusals():
    blocks = [torch.zeros((16, 8), dtype=torch.int32) for _ in range(4)]
    rows = torch.zeros((3, 16, 8), dtype=torch.int32)
    one = torch.zeros((1, 8), dtype=torch.int32)
    f = PN.shard_stages
    with pytest.raises(ValueError, match="1 to 16 blocks"):
        f("cpu", [torch.zeros((32, 8), dtype=torch.int32)] * 32, [0],
          torch.zeros((31, 32, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match="a power of two, not 3"):
        f("cpu", blocks[:3], [0], rows[:2])
    with pytest.raises(ValueError, match="D \\(L, 8\\) blocks"):
        f("cpu", [blocks[0][:8]] + blocks[1:], [0], rows)
    with pytest.raises(ValueError, match="at least D"):
        f("cpu", [torch.zeros((2, 8), dtype=torch.int32)] * 4, [0], rows[:, :2])
    with pytest.raises(ValueError, match="field operand"):
        f("cpu", [b.long() for b in blocks], [0], rows)
    for shards in ([], [0, 0], [4]):
        with pytest.raises(ValueError, match="not distinct indices"):
            f("cpu", blocks, shards, rows)
    with pytest.raises(ValueError, match="rows must be"):
        f("cpu", blocks, [0], rows[:2])
    with pytest.raises(ValueError, match="1/N"):
        f("cpu", blocks, [0], rows, inverse=True)
    with pytest.raises(ValueError, match="blocks on"):
        f("cpu", blocks[:3] + [blocks[3].to("meta")], [0], rows)
    with pytest.raises(ValueError, match="blocks on"):
        f("cuda", blocks, [0], rows)
    with pytest.raises(ValueError, match="not contiguous"):
        f("cpu", [torch.zeros((8, 16), dtype=torch.int32).t()] + blocks[1:], [0], rows)
    with pytest.raises(ValueError, match="16-byte aligned"):
        f("cpu", [torch.zeros(16 * 8 + 1, dtype=torch.int32)[1:].view(16, 8)] + blocks[1:], [0],
          rows)
    assert f("cpu", blocks, [0], rows, inverse=True, n_inv=one).shape == (1, 16, 8)


def test_shard_reshuffle_refusals():
    blocks = [torch.zeros((16, 8), dtype=torch.int32) for _ in range(4)]
    f = PN.shard_reshuffle
    with pytest.raises(ValueError, match="1 to 16 blocks"):
        f("cpu", [torch.zeros((32, 8), dtype=torch.int32)] * 32, [0])
    with pytest.raises(ValueError, match="D \\(L, 8\\) blocks"):
        f("cpu", blocks[:3] + [blocks[3][:8]], [0])
    with pytest.raises(ValueError, match="not distinct indices"):
        f("cpu", blocks, [1, 5])
    with pytest.raises(ValueError, match="blocks on"):
        f("cpu", [b.to("meta") for b in blocks], [0], inverse=True)
    with pytest.raises(ValueError, match="16-byte aligned"):
        f("cpu", blocks[:3] + [torch.zeros(16 * 8 + 2, dtype=torch.int32)[2:].view(16, 8)], [0])
    with pytest.raises(ValueError, match="at most 16 shards"):
        ShardedNTTPlan.make(10, 32, "cpu")


def test_peer_access_refusals(monkeypatch):
    """A mesh of cards without peer access is refused when the plan is
    made (there is no copy path), and so is a launch that would read a card
    it was not given access to; one card, or the CPU, needs none."""
    monkeypatch.setattr(torch.cuda, "can_device_access_peer", lambda a, b: False)
    with pytest.raises(RuntimeError, match="cuda:0 cannot read cuda:1"):
        PN.enable_peer_access(["cuda:0", "cuda:1"])
    monkeypatch.setattr(PN, "resolve", torch.device)
    with pytest.raises(RuntimeError, match="no peer access"):
        ShardedNTTPlan.make(K, 4, ["cuda:0", "cuda:1", "cuda:2", "cuda:3"])
    with pytest.raises(RuntimeError, match="cuda:0 has no peer access to cuda:1"):
        PN._check_peers(torch.device("cuda", 0), {torch.device("cuda", 1)})
    PN.enable_peer_access(["cuda:0", "cuda:0", "cpu"])
    PN._check_peers(torch.device("cuda", 2), {torch.device("cuda", 2)})

def _host_points(rng, n):
    return [G1.mul(G1_GEN, int(rng.integers(1, 1 << 60))) for _ in range(n)]


@pytest.mark.parametrize("n", [16, 1 << 10])
def test_sharded_msm_matches_host(n):
    """The sharded MSM over 8 shards equals the host's MSM."""
    rng = np.random.default_rng(n)
    pts = _host_points(rng, n)
    scalars = [FR.random(rng) for _ in range(n)]
    want = G1.msm(scalars, pts) if n <= 16 else G1.multi_scalar_mul(scalars, pts)
    mesh = Mesh.shared("cpu", 8)
    p, s = TM.points_to_device(pts, "cpu"), TM.scalars_to_words(scalars, "cpu")
    assert TM.points_from_device(sharded_msm(mesh, p, s)[None]) == [want]


def test_sharded_msm_refusals():
    p = TM.points_to_device([G1_GEN] * 12, "cpu")
    s = TM.scalars_to_words([1] * 12, "cpu")
    with pytest.raises(ValueError, match="not divisible"):
        sharded_msm(Mesh.shared("cpu", 8), p, s)
    with pytest.raises(ValueError, match="even"):
        sharded_msm(Mesh.shared("cpu", 4), p, s)
    with pytest.raises(ValueError, match="12 points and 10 scalars"):
        sharded_msm(Mesh.shared("cpu", 2), p, s[:10])


def test_batch_commit_matches_serial():
    """Commitments of 8 rows over 8 shards, one row a shard, equal the
    port's serial MSM of each row; a batch that does not split raises."""
    rng = np.random.default_rng(3)
    n, batch = 8, 8
    g1 = TM.points_to_device(_host_points(rng, n), "cpu")
    coeffs = torch.stack([TM.scalars_to_words([FR.random(rng) for _ in range(n)], "cpu")
                          for _ in range(batch)])
    got = batch_commit(Mesh.shared("cpu", 8), g1, coeffs)
    want = [TM.points_from_device(TM.msm(g1, row)[None])[0] for row in coeffs]
    assert TM.points_from_device(got) == want
    assert TM.points_from_device(batch_commit(Mesh.shared("cpu", 2), g1, coeffs)) == want
    with pytest.raises(ValueError, match="does not split"):
        batch_commit(Mesh.shared("cpu", 3), g1, coeffs)


def test_mesh_and_exchanges():
    """make_mesh takes devices that exist and refuses to share one quietly;
    the exchanges move blocks as JAX's collectives do."""
    assert make_mesh(1, "cpu").devices == (torch.device("cpu"),)
    with pytest.raises(RuntimeError, match="Mesh.shared"):
        make_mesh(4, "cpu")
    mesh = Mesh.shared("cpu", 4, axis="dp")
    assert mesh.size == 4 and mesh.axis_names == ("dp",)
    assert mesh.distinct == [torch.device("cpu")]
    with pytest.raises(ValueError, match="one shard or more"):
        Mesh.shared("cpu", 0)
    shards = [torch.full((4, 2), i) for i in range(4)]
    perm = PM.ppermute(shards, [(i, i ^ 1) for i in range(4)])
    assert [int(t[0, 0]) for t in perm] == [1, 0, 3, 2]
    gathered = PM.all_gather(shards)
    assert all(g is gathered[0] for g in gathered)  # one device: one stack
    assert torch.equal(gathered[0][:, 0, 0], torch.arange(4))
    blocks = [torch.arange(4 * 3).reshape(4, 3) + 100 * i for i in range(4)]
    out = PM.all_to_all(blocks)
    for j in range(4):
        for i in range(4):
            assert torch.equal(out[j][i], blocks[i][j])
    with pytest.raises(ValueError, match="blocks along axis"):
        PM.all_to_all(blocks[:3])
    with pytest.raises(ValueError, match="do not split"):
        mesh.scatter(torch.zeros(6, 8))


@pytest.mark.parametrize("msm", ["b4", "b16"])
def test_sharded_batch_equals_golden(port, golden, msm):
    """The batch of the two witnesses split over two shards gives the JAX
    package's batch bytes (tests/data/torch_port_batch_k7.npz), in both
    bases."""
    from delay_enc_tpu_torch.plonk import create_proofs_batched

    srs, pk, _, builders = port
    mesh = Mesh.shared("cpu", 2, axis="dp")
    proofs = create_proofs_batched(srs, pk, builders, np.random.default_rng(SEED), msm=msm,
                                   mesh=mesh)
    assert [np.frombuffer(p, np.uint8).tolist() for p in proofs] == \
        [g.tolist() for g in golden["proofs"]]


def test_sharded_batch_refusals(port):
    from delay_enc_tpu_torch.plonk import create_proofs_batched

    srs, pk, _, builders = port
    with pytest.raises(ValueError, match="does not split over 2"):
        create_proofs_batched(srs, pk, builders[:1], mesh=Mesh.shared("cpu", 2, axis="dp"))
    with pytest.raises(ValueError, match="axis is 'shard'"):
        create_proofs_batched(srs, pk, builders, mesh=Mesh.shared("cpu", 2))


def test_key_replica_proves_the_same_bytes(port, golden):
    """A key copied to another device (here a copy on the CPU) keeps its
    views of one stack as views, and proves the golden bytes."""
    from delay_enc_tpu_torch.plonk import create_proofs_batched
    from delay_enc_tpu_torch.plonk.batch_prover import _key_to, _srs_to

    srs, pk, _, builders = port
    pk2, srs2 = _key_to(pk, torch.device("cpu")), _srs_to(srs, torch.device("cpu"))
    assert pk2.raw_stack.data_ptr() != pk.raw_stack.data_ptr()
    first = next(iter(pk2.fixed_raw.values()))
    assert first.untyped_storage().data_ptr() == pk2.raw_stack.untyped_storage().data_ptr()
    proofs = create_proofs_batched(srs2, pk2, builders, np.random.default_rng(SEED),
                                   device="cpu")
    assert [np.frombuffer(p, np.uint8).tolist() for p in proofs] == \
        [g.tolist() for g in golden["proofs"]]


def test_dryrun_fast_on_two_cpu_shards(capsys):
    dryrun_multichip(2, devices=["cpu"] * 2, fast=True)
    assert "dryrun_multichip(2): ok" in capsys.readouterr().out


@pytest.mark.slow
def test_parallel_matches_jax_parallel():
    """sharded_ntt, sharded_intt, sharded_plane_sums and batch_commit equal
    the JAX package's parallel.* on its 8-device CPU mesh."""
    import jax.numpy as jnp

    from delay_enc_tpu.ops import msm as JM
    from delay_enc_tpu.parallel import batch_commit as jbatch_commit
    from delay_enc_tpu.parallel import make_mesh as jmake_mesh
    from delay_enc_tpu.parallel.msm import sharded_plane_sums as jsharded_plane_sums
    from delay_enc_tpu.parallel.ntt import ShardedNTTPlan as JPlan
    from delay_enc_tpu.parallel.ntt import sharded_intt as jsharded_intt
    from delay_enc_tpu.parallel.ntt import sharded_ntt as jsharded_ntt

    jmesh = jmake_mesh(8)
    mesh = Mesh.shared("cpu", 8)
    rng = np.random.default_rng(11)
    a = _rand_mont(rng, 1 << K)
    jplan, plan = JPlan.make(K, 8), ShardedNTTPlan.make(K, 8, mesh.devices)
    jevals = jsharded_ntt(jmesh, jplan, TL.words_to_limbs_np(a))
    evals = sharded_ntt(mesh, plan, TL.to_tensor(a, "cpu"))
    assert np.array_equal(_limbs(mesh.gather(evals)), np.asarray(jevals))
    jback = jsharded_intt(jmesh, jplan, jevals)
    assert np.array_equal(_limbs(mesh.gather(sharded_intt(mesh, plan, evals))),
                          np.asarray(jback))

    n = 16
    pts = _host_points(rng, n)
    scalars = [FR.random(rng) for _ in range(n)]
    jsums = jsharded_plane_sums(jmesh, JM.points_to_device(pts), JM.scalars_to_limbs(scalars))
    sums = sharded_plane_sums(mesh, TM.points_to_device(pts, "cpu"),
                              TM.scalars_to_words(scalars, "cpu"))
    assert TM.points_from_device(sums) == JM.points_from_device(jsums)

    coeff_rows = [[FR.random(rng) for _ in range(8)] for _ in range(8)]
    jout = jbatch_commit(jmesh, JM.points_to_device(pts[:8]),
                         jnp.stack([JM.scalars_to_limbs(r) for r in coeff_rows]))
    out = batch_commit(mesh, TM.points_to_device(pts[:8], "cpu"),
                       torch.stack([TM.scalars_to_words(r, "cpu") for r in coeff_rows]))
    assert TM.points_from_device(out) == JM.points_from_device(jout)
