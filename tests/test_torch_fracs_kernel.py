"""K5, the grand-product fractions kernel of delay_enc_tpu_torch, without a
card: its row body (csrc/fracs_row.cuh is __host__ __device__) built by the
host C++ compiler, with the portable field bodies and with the carry chains
the card runs (FLD_EMULATE_PTX), and the CPU path of `gp_fracs`, each
against the JAX package's _jit_compress, _jit_perm_fracs and
_jit_lookup_fracs on the same words; a batch of instances, each with its
own witness columns and challenges over one key, as one launch takes it
(csrc/fracs_row.cuh fracs_instance), against each instance's.  No
tolerance: the words are equal."""

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
from delay_enc_tpu_torch.plonk import kernels as TK
from delay_enc_tpu_torch.plonk.keygen import ALL_FIXED

CTX = TL.FR_CTX
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "delay_enc_tpu_torch", "csrc")
LOOKUPS = ("a", "b", "c", "d")
NF = len(ALL_FIXED)


def field_words(rng, *shape, heavy=0.0):
    """Random reduced Montgomery words; a share `heavy` of the elements
    replaced by words that make the carry chains run long, and zeros."""
    count = int(np.prod(shape))
    w = CTX.to_mont_np([FR.random(rng) for _ in range(count)])
    if heavy:
        ones = (1 << 256) - 1
        edge = TL.ints_to_words_np([0, 1, FR.p - 1, FR.p - 2, (1 << 256) % FR.p, ones >> 3,
                                    (ones >> 3) - 0xFFFFFFFF, 0xFFFFFFFF << 64, 1 << 32,
                                    CTX.r_mod_p])
        pick = rng.random(count) < heavy
        w[pick] = edge[rng.integers(0, len(edge), int(pick.sum()))]
    return w.reshape(*shape, 8)


class Case:
    """The kernel's inputs as numpy words: raw6, sigma, omega, the key's raw
    stack, lk, and the challenges as ints and as `challenge_words`."""

    count = 1  # instances

    def __init__(self, seed, n, usable, heavy=0.0):
        rng = np.random.default_rng(seed)
        self.n, self.usable = n, usable
        self.raw6 = field_words(rng, 6, n, heavy=heavy)
        self.sigma = field_words(rng, 6, n, heavy=heavy)
        self.omega = field_words(rng, n, heavy=heavy)
        self.key = field_words(rng, NF, n, heavy=heavy)
        self.lk = field_words(rng, 8, n, heavy=heavy)
        self.theta, self.beta, self.gamma = (FR.random(rng) for _ in range(3))
        self.deltas = [FR.random(rng) for _ in range(6)]
        if heavy:  # a challenge of Montgomery words p - 1
            self.beta = CTX.from_mont_np(TL.ints_to_words_np([FR.p - 1]))[0]
        self.consts = TK.challenge_words(self.theta, self.beta, self.gamma, 0, self.deltas)

    def jax(self):
        """(num, den) as (5, n, 8) words from the JAX package's functions."""
        j = lambda w: jnp.asarray(TL.words_to_limbs_np(w))
        m = lambda v: j(CTX.to_mont_np([v]))
        theta, beta, gamma = m(self.theta), m(self.beta), m(self.gamma)
        num_p, den_p = JK._jit_perm_fracs([j(c) for c in self.raw6], [j(s) for s in self.sigma],
                                          j(self.omega), beta, gamma,
                                          [m(d) for d in self.deltas])
        key = dict(zip(ALL_FIXED, self.key))
        s = JK._jit_compress(j(key["table_tag"]), j(key["table_value"]), theta)
        nums, dens = [num_p], [den_p]
        for i, l in enumerate(LOOKUPS):
            a = JK._jit_compress(j(key[f"tag_{l}"]), j(self.raw6[i]), theta)
            num, den = JK._jit_lookup_fracs(a, s, j(self.lk[i]), j(self.lk[4 + i]), beta, gamma)
            nums.append(num)
            dens.append(den)
        out = []
        for parts in (nums, dens):
            w = TL.limbs_to_words_np(np.stack([np.asarray(p) for p in parts]))
            w[:, self.usable:] = CTX.to_mont_np([1])[0]
            out.append(w)
        return out

    def tensors(self):
        t = lambda w: TL.to_tensor(w, "cpu")
        return t(self.raw6), t(self.sigma), t(self.omega), t(self.key), t(self.lk)


class Batch:
    """Instances of one shape, each a Case with its own witness columns and
    challenges, over the first one's key rows, sigma and omega: the batched
    operands (B, ...) and challenge words (B, 16, 8)."""

    def __init__(self, cases):
        first = cases[0]
        for c in cases[1:]:
            c.sigma, c.omega, c.key = first.sigma, first.omega, first.key
        self.cases, self.count = cases, len(cases)
        self.n, self.usable = first.n, first.usable
        self.sigma, self.omega, self.key = first.sigma, first.omega, first.key
        self.raw6 = np.stack([c.raw6 for c in cases])
        self.lk = np.stack([c.lk for c in cases])
        self.consts = np.stack([c.consts for c in cases])

    def jax(self):
        """(num, den) as (B*5, n, 8) words: each instance's, in order."""
        outs = [c.jax() for c in self.cases]
        return [np.concatenate([o[i] for o in outs]) for i in range(2)]

    tensors = Case.tensors


CASES = {
    "random": lambda: Case(1, 64, 57),
    "carry-heavy": lambda: Case(2, 64, 57, heavy=0.4),
    "all rows active": lambda: Case(3, 16, 16, heavy=0.2),
    "one row, inactive": lambda: Case(4, 1, 0),
    "3 instances, each its own challenges": lambda: Batch(
        [Case(11, 32, 27), Case(12, 32, 27, heavy=0.3), Case(13, 32, 27)]),
}


@pytest.fixture(scope="module")
def cases():
    return {name: (c := make(), c.jax()) for name, make in CASES.items()}


HARNESS = r"""
#include <cstdio>
#include <vector>
#include "fracs_row.cuh"
// stdin: instances n usable, then the words of each instance's 16
// challenges, raw6 (instances 6 n), sigma (6 n), omega (n), the key's raw
// stack (15 n), lk (instances 8 n).  The instances and their rows run from
// the last to the first, each instance's pointers from fracs_instance;
// stdout: num (instances 5 n) then den, a row a line.
static bool words(std::vector<uint32_t>& v, size_t count) {
  v.resize(count * 8);
  for (auto& w : v)
    if (scanf("%u", &w) != 1) return false;
  return true;
}
int main() {
  unsigned long long count, n, usable;
  if (scanf("%llu %llu %llu", &count, &n, &usable) != 3) return 1;
  std::vector<uint32_t> c, raw6, sigma, omega, key, lk;
  if (!words(c, count * prow::NCONST) || !words(raw6, count * 6 * n) || !words(sigma, 6 * n) ||
      !words(omega, n) || !words(key, 15 * n) || !words(lk, count * 8 * n))
    return 1;
  std::vector<prow::Consts> consts(count);
  for (size_t b = 0; b < count; b++)
    for (int r = 0; r < prow::NCONST; r++)
      for (int j = 0; j < 8; j++) consts[b].w[r][j] = c[(b * prow::NCONST + r) * 8 + j];
  std::vector<uint32_t> num(count * 5 * n * 8, 0xdeadbeefu), den(count * 5 * n * 8, 0xdeadbeefu);
  const prow::FracsIn in{raw6.data(), sigma.data(), omega.data(), key.data(), lk.data(),
                         num.data(), den.data(), (size_t)n, (size_t)usable};
  for (size_t b = count; b-- > 0;)
    for (size_t i = n; i-- > 0;) prow::fracs_row(i, prow::fracs_instance(in, b), consts[b]);
  for (const auto* out : {&num, &den})
    for (size_t e = 0; e < count * 5 * n; e++) {
      for (int j = 0; j < 8; j++) printf("%u ", (*out)[e * 8 + j]);
      printf("\n");
    }
  return 0;
}
"""

BODIES = {"portable": [], "carry_chain": ["-DFLD_EMULATE_PTX"]}


@pytest.fixture(scope="module", params=list(BODIES))
def harness(request, tmp_path_factory):
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("fracs_row_" + request.param)
    src, exe = d / "harness.cpp", d / "harness"
    src.write_text(HARNESS)
    subprocess.run([cxx, "-O1", "-std=c++17", "-Wall", "-Werror", "-Wno-unknown-pragmas",
                    f"-I{CSRC}", *BODIES[request.param], "-o", str(exe), str(src)],
                   check=True, capture_output=True)

    def run(case: Case):
        arrays = (case.consts, case.raw6, case.sigma, case.omega, case.key, case.lk)
        lines = [f"{case.count} {case.n} {case.usable}"]
        lines += [" ".join(map(str, np.asarray(a, np.uint32).reshape(-1))) for a in arrays]
        out = subprocess.run([str(exe)], input="\n".join(lines) + "\n", text=True,
                             capture_output=True, check=True, timeout=300).stdout
        w = np.array([list(map(int, ln.split())) for ln in out.strip().split("\n")],
                     dtype=np.uint32).reshape(2, case.count * 5, case.n, 8)
        return w[0], w[1]

    return run


@pytest.mark.parametrize("name", list(CASES))
def test_row_body_matches_jax(harness, cases, name):
    """The C++ that the card runs, every row (inactive rows included), on
    random, carry-heavy and zero operands."""
    case, (want_num, want_den) = cases[name]
    num, den = harness(case)
    assert np.array_equal(num, want_num)
    assert np.array_equal(den, want_den)


@pytest.mark.parametrize("name", list(CASES))
def test_cpu_path_matches_jax(cases, name):
    case, (want_num, want_den) = cases[name]
    num, den = TK.gp_fracs(*case.tensors(), case.consts, case.usable)
    assert np.array_equal(TL.to_numpy(num), want_num)
    assert np.array_equal(TL.to_numpy(den), want_den)


def test_challenge_words_rows():
    theta, beta, gamma, y = 3, 5, 7, 11
    deltas = [13, 17, 19, 23, 29, 31]
    got = CTX.from_mont_np(TK.challenge_words(theta, beta, gamma, y, deltas))
    assert got == [theta, beta, gamma, y, *deltas, *(beta * d for d in deltas)]
    with pytest.raises(ValueError, match="powers of delta"):
        TK.challenge_words(theta, beta, gamma, y, deltas[:5])


def test_wrapper_refuses_bad_operands():
    case = Case(5, 8, 5)
    raw6, sigma, omega, key, lk = case.tensors()
    with pytest.raises(ValueError, match="sigma_raw"):
        TK.gp_fracs(raw6, sigma[:5], omega, key, lk, case.consts, case.usable)
    with pytest.raises(ValueError, match="lk_raw"):
        TK.gp_fracs(raw6, sigma, omega, key, lk.to(torch.int64), case.consts, case.usable)
    with pytest.raises(ValueError, match="challenge words"):
        TK.gp_fracs(raw6, sigma, omega, key, lk, case.consts[:15], case.usable)
    with pytest.raises(ValueError, match="usable"):
        TK.gp_fracs(raw6, sigma, omega, key, lk, case.consts, 9)
    # a tensor on neither the CPU nor a card reaches no plain version
    meta = [t.to("meta") for t in (raw6, sigma, omega, key, lk)]
    with pytest.raises(ValueError, match="CUDA kernel"):
        TK.gp_fracs(*meta, case.consts, case.usable)
