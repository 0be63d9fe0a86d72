"""K6, the fused quotient kernel of delay_enc_tpu_torch, without a card: its
row body (csrc/quotient_row.cuh is __host__ __device__) built by the host
C++ compiler, with the portable field bodies and with the carry chains the
card runs (FLD_EMULATE_PTX), and the CPU path of `quotient_h`, each against
the JAX package's _quotient_expr times 1/Z_H (as _jit_quotient computes it
before its inverse transform) on the same words.  Every row is run, the
wrap rows 0..7 and n_ext - 8 .. n_ext - 1 among them.  The coset form of
the split quotient (rot 1, one value of 1/Z_H, rows stored at stride 8 and
offset j of the interleaved extended coset) is held the same way to
_jit_quotient_coset, at cosets 0 and 7; the places it does not own must
keep what they held.  A batch of instances, each with its own witness stack
and challenges over one key, as one fused launch takes it
(csrc/quotient_row.cuh quotient_instance), is held to each instance's.  No
tolerance: the words are equal."""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from delay_enc_tpu.fields import FR
from delay_enc_tpu.ops import limbs as JL
from delay_enc_tpu.plonk import kernels as JK
from delay_enc_tpu_torch.ops import limbs as TL
from delay_enc_tpu_torch.plonk import kernels as TK
from delay_enc_tpu_torch.plonk.keygen import ALL_FIXED, KEY_ROWS

from test_torch_fracs_kernel import BODIES, field_words

CTX = TL.FR_CTX
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "delay_enc_tpu_torch", "csrc")
LOOKUPS = ("a", "b", "c", "d")
NF = len(ALL_FIXED)


@jax.jit
def _jax_h(args, zh):
    return JL.mont_mul(JL.FR_CTX, JK._quotient_expr(*args), zh)


SENTINEL = 0xDEADBEEF  # the words of an output place no launch owns


class Case:
    """The kernel's inputs as numpy words: the witness and key stacks, X,
    the `rot` values of 1/Z_H, and the challenges as ints and as
    `challenge_words`; where the rows go (stride and offset into an output
    of `out_rows` rows, as coset `offset` of the split quotient stores)."""

    count = 1  # instances

    def __init__(self, seed, n_ext, heavy=0.0, zero_rows=(), rot=8, coset=None):
        rng = np.random.default_rng(seed)
        self.n_ext = n_ext
        self.rot = rot
        self.stride, self.offset = (1, 0) if coset is None else (8, coset)
        self.out_rows = n_ext * self.stride
        self.wit = field_words(rng, TK.WIT_ROWS, n_ext, heavy=heavy)
        self.key = field_words(rng, len(KEY_ROWS), n_ext, heavy=heavy)
        self.x = field_words(rng, n_ext, heavy=heavy)
        self.zh8 = field_words(rng, rot, heavy=heavy)
        for r in zero_rows:  # a witness row and a key row of zeros
            self.wit[:, r] = 0
            self.key[:, r] = 0
        self.theta, self.beta, self.gamma, self.y = (FR.random(rng) for _ in range(4))
        self.deltas = [FR.random(rng) for _ in range(6)]
        if heavy:  # challenges of Montgomery words p - 1 and 0
            self.gamma = CTX.from_mont_np(TL.ints_to_words_np([FR.p - 1]))[0]
            self.theta = 0
        self.consts = TK.challenge_words(self.theta, self.beta, self.gamma, self.y, self.deltas)

    def jax(self):
        """h as (n_ext, 8) words from the JAX package's _quotient_expr times
        1/Z_H, or its _jit_quotient_coset for the coset form."""
        j = lambda w: jnp.asarray(TL.words_to_limbs_np(w))
        m = lambda *v: j(CTX.to_mont_np(list(v)))
        wit, key = self.wit, self.key
        y_pows = m(*(pow(self.y, 23 - i, FR.p) for i in range(24)))
        args = ([j(a) for a in wit[:5]], j(wit[5]), j(wit[6]),
                {l: j(wit[7 + i]) for i, l in enumerate(LOOKUPS)},
                {l: j(wit[11 + i]) for i, l in enumerate(LOOKUPS)},
                {l: j(wit[15 + i]) for i, l in enumerate(LOOKUPS)},
                {n: j(key[i]) for i, n in enumerate(ALL_FIXED)},
                [j(s) for s in key[NF : NF + 6]],
                (j(key[NF + 6]), j(key[NF + 7]), j(key[NF + 8]), j(self.x)),
                (m(self.theta), m(self.beta), m(self.gamma)), [m(d) for d in self.deltas],
                y_pows)
        if self.rot == 1:
            h = JK._jit_quotient_coset(*args[:11], j(self.zh8), y_pows)
        else:
            h = _jax_h(args, j(np.tile(self.zh8, (self.n_ext // 8, 1))))
        return TL.limbs_to_words_np(np.asarray(h))

    def placed(self, h):
        """h stored as the kernel stores it: its rows at stride and offset
        in an output of SENTINEL words."""
        out = np.full((self.out_rows, 8), SENTINEL, dtype=np.uint32)
        out[self.offset :: self.stride] = h
        return out

    def tensors(self):
        t = lambda w: TL.to_tensor(w, "cpu")
        return t(self.wit), t(self.key), t(self.x), t(self.zh8)

    def store(self):
        """quotient_h's keyword arguments for the case's store."""
        if self.stride == 1:
            return {"rot": self.rot}
        out = TL.to_tensor(np.full((self.out_rows, 8), SENTINEL, dtype=np.uint32), "cpu")
        return {"rot": self.rot, "out": out, "out_stride": self.stride,
                "out_offset": self.offset}


class Batch:
    """Instances of the fused form, each a Case with its own witness stack
    and challenges, over the first one's key stack, X and 1/Z_H: the
    batched witness (B, 19, n, 8) and challenge words (B, 16, 8); h is
    (B * n, 8), instance after instance."""

    stride, offset, rot = 1, 0, 8

    def __init__(self, cases):
        first = cases[0]
        for c in cases[1:]:
            c.key, c.x, c.zh8 = first.key, first.x, first.zh8
        self.cases, self.count = cases, len(cases)
        self.n_ext, self.out_rows = first.n_ext, len(cases) * first.n_ext
        self.key, self.x, self.zh8 = first.key, first.x, first.zh8
        self.wit = np.stack([c.wit for c in cases])
        self.consts = np.stack([c.consts for c in cases])

    def jax(self):
        return np.concatenate([c.jax() for c in self.cases])

    def placed(self, h):
        return h

    def store(self):
        return {}

    tensors = Case.tensors


CASES = {
    "random, 2^6 rows": lambda: Case(1, 64),
    "carry-heavy, 2^6 rows": lambda: Case(2, 64, heavy=0.4),
    "zero rows at both wraps": lambda: Case(3, 64, heavy=0.1, zero_rows=(0, 5, 58, 63)),
    "one row of the row domain": lambda: Case(4, 8, heavy=0.2),
    "coset 0 of the split quotient, carry-heavy, 2^5 rows":
        lambda: Case(6, 32, heavy=0.4, zero_rows=(0, 31), rot=1, coset=0),
    "coset 7 of the split quotient, 2^5 rows": lambda: Case(7, 32, heavy=0.1, rot=1, coset=7),
    "3 instances, each its own challenges, 2^5 rows": lambda: Batch(
        [Case(8, 32), Case(9, 32, heavy=0.3, zero_rows=(0, 31)), Case(10, 32)]),
}


@pytest.fixture(scope="module")
def cases():
    return {name: (c := make(), c.placed(c.jax())) for name, make in CASES.items()}


HARNESS = r"""
#include <cstdio>
#include <vector>
#include "quotient_row.cuh"
// stdin: instances, n, rot, the output's stride and offset, then the words
// of each instance's 16 challenges, the witness stacks (instances 19 n), the
// key stack (24 n), X (n) and 1/Z_H (rot).  The instances and their rows run
// from the last to the first, each instance's pointers from
// quotient_instance; stdout: the output of instances * n * stride rows, a
// row a line, 0xdeadbeef where no row was stored.
static bool words(std::vector<uint32_t>& v, size_t count) {
  v.resize(count * 8);
  for (auto& w : v)
    if (scanf("%u", &w) != 1) return false;
  return true;
}
int main() {
  unsigned long long count, n, rot, stride, offset;
  if (scanf("%llu %llu %llu %llu %llu", &count, &n, &rot, &stride, &offset) != 5) return 1;
  std::vector<uint32_t> c, wit, key, x, zh;
  if (!words(c, count * prow::NCONST) || !words(wit, count * prow::WIT_ROWS * n) ||
      !words(key, prow::KEY_ROWS * n) || !words(x, n) || !words(zh, rot))
    return 1;
  std::vector<prow::Consts> consts(count);
  for (size_t b = 0; b < count; b++)
    for (int r = 0; r < prow::NCONST; r++)
      for (int j = 0; j < 8; j++) consts[b].w[r][j] = c[(b * prow::NCONST + r) * 8 + j];
  std::vector<uint32_t> h(count * n * stride * 8, 0xdeadbeefu);
  const prow::QuotientIn in{wit.data(), key.data(), x.data(), zh.data(), h.data(),
                            (size_t)n, (size_t)rot, (size_t)stride, (size_t)offset};
  for (size_t b = count; b-- > 0;)
    for (size_t i = n; i-- > 0;) prow::quotient_row(i, prow::quotient_instance(in, b), consts[b]);
  for (size_t e = 0; e < count * n * stride; e++) {
    for (int j = 0; j < 8; j++) printf("%u ", h[e * 8 + j]);
    printf("\n");
  }
  return 0;
}
"""


@pytest.fixture(scope="module", params=list(BODIES))
def harness(request, tmp_path_factory):
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("quotient_row_" + request.param)
    src, exe = d / "harness.cpp", d / "harness"
    src.write_text(HARNESS)
    subprocess.run([cxx, "-O1", "-std=c++17", "-Wall", "-Werror", "-Wno-unknown-pragmas",
                    f"-I{CSRC}", *BODIES[request.param], "-o", str(exe), str(src)],
                   check=True, capture_output=True)

    def run(case: Case):
        arrays = (case.consts, case.wit, case.key, case.x, case.zh8)
        lines = [f"{case.count} {case.n_ext} {case.rot} {case.stride} {case.offset}"]
        lines += [" ".join(map(str, np.asarray(a, np.uint32).reshape(-1))) for a in arrays]
        out = subprocess.run([str(exe)], input="\n".join(lines) + "\n", text=True,
                             capture_output=True, check=True, timeout=300).stdout
        return np.array([list(map(int, ln.split())) for ln in out.strip().split("\n")],
                        dtype=np.uint32).reshape(case.out_rows, 8)

    return run


@pytest.mark.parametrize("name", list(CASES))
def test_row_body_matches_jax(harness, cases, name):
    """The C++ that the card runs, every row, on random, carry-heavy and
    zero operands."""
    case, want = cases[name]
    assert np.array_equal(harness(case), want)


@pytest.mark.parametrize("name", list(CASES))
def test_cpu_path_matches_jax(cases, name):
    case, want = cases[name]
    got = TK.quotient_h(*case.tensors(), case.consts, **case.store())
    assert np.array_equal(TL.to_numpy(got).reshape(-1, 8), want)  # a batch's instances in order


def test_wrapper_refuses_bad_operands():
    case = Case(5, 16)
    wit, key, x, zh8 = case.tensors()
    with pytest.raises(ValueError, match="wit_ext"):
        TK.quotient_h(wit[:18], key, x, zh8, case.consts)
    with pytest.raises(ValueError, match="key_ext"):
        TK.quotient_h(wit, key[:, :8], x, zh8, case.consts)
    with pytest.raises(ValueError, match="zh_inv"):
        TK.quotient_h(wit, key, x, zh8[:4], case.consts)
    with pytest.raises(ValueError, match="zh_inv"):  # one value on a coset
        TK.quotient_h(wit, key, x, zh8, case.consts, rot=1)
    with pytest.raises(ValueError, match="next row"):
        TK.quotient_h(wit, key, x, zh8[:2], case.consts, rot=2)
    with pytest.raises(ValueError, match="needs its `out`"):
        TK.quotient_h(wit, key, x, zh8[:1], case.consts, rot=1, out_stride=8, out_offset=3)
    with pytest.raises(ValueError, match="does not take"):
        TK.quotient_h(wit, key, x, zh8[:1], case.consts, rot=1, out=x.repeat(8, 1),
                      out_stride=8, out_offset=8)
    with pytest.raises(ValueError, match="out must be"):
        TK.quotient_h(wit, key, x, zh8[:1], case.consts, rot=1, out=x.repeat(8, 1).long(),
                      out_stride=8, out_offset=0)
    with pytest.raises(ValueError, match="challenge words"):
        TK.quotient_h(wit, key, x, zh8, case.consts.astype(np.int64))
    with pytest.raises(ValueError, match="multiple"):
        TK.quotient_h(wit[:, :12], key[:, :12], x[:12], zh8, case.consts)
    # a tensor on neither the CPU nor a card reaches no plain version
    with pytest.raises(ValueError, match="CUDA kernel"):
        TK.quotient_h(*(t.to("meta") for t in (wit, key, x, zh8)), case.consts)
    with pytest.raises(ValueError, match="different devices"):
        TK.quotient_h(wit, key, x.to("meta"), zh8, case.consts)
    assert torch.equal(TK.quotient_h(wit, key, x, zh8, case.consts),
                       TL.to_tensor(case.jax(), "cpu"))
