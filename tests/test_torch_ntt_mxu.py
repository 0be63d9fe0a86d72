"""The matmul NTT (K11, delay_enc_tpu_torch/ops/ntt_mxu.py) on the CPU against
the JAX package's ops/ntt_mxu.py: the plans' tables, the plain transforms
with every fold, the kernel's reduction on adversarial columns (in plain
PyTorch and as csrc/ntt_mxu_row.cuh built by the host C++ compiler), the
kernel's fragment layouts, and create_proof(ntt="mxu") of the k=7 test
circuit against the JAX golden's bytes."""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import delay_enc_tpu  # noqa: F401  (jax config)
from delay_enc_tpu.fields.bn254 import FR as JFR
from delay_enc_tpu.ops import limbs as JL
from delay_enc_tpu.ops import ntt_mxu as JX
from delay_enc_tpu_torch.ops import limbs as L
from delay_enc_tpu_torch.ops import ntt as N
from delay_enc_tpu_torch.ops import ntt_mxu as X
from test_torch_prover import GOLDEN, K, SEED, TAU, _build_circuit, one_thread  # noqa: F401

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "delay_enc_tpu_torch", "csrc")
CTX, JCTX = L.FR_CTX, JL.FR_CTX
P = JFR.p
R = 1 << 256
ZETA = JFR.generator
# the prover's four plans: (omega inverted, folds) for a domain of length 2^k
FOLDS = {
    "fwd": (False, lambda n: {}),
    "inv": (True, lambda n: {"out_mul": JFR.inv(n)}),
    "ext": (False, lambda n: {"in_scale": ZETA}),
    "ext_inv": (True, lambda n: {"out_mul": JFR.inv(n), "out_scale": JFR.inv(ZETA)}),
}


def _rand_mont(rng, n):
    """tests/test_ntt_mxu.py's operands: products of two 62-bit draws, and
    0 and p - 1, as Montgomery limbs."""
    vals = [int(rng.integers(0, 1 << 62)) * int(rng.integers(0, 1 << 62)) % P
            for _ in range(n - 2)] + [0, P - 1]
    return np.asarray(JCTX.to_mont_np(vals))


def _words(limbs: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(L.limbs_to_words_np(limbs).view(np.int32).copy())


def _omega(k: int, inverse: bool) -> int:
    w = JFR.root_of_unity(k)
    return JFR.inv(w) if inverse else w


def _plans(k: int, fold: str):
    inverse, folds = FOLDS[fold]
    omega = _omega(k, inverse)
    return (JX.make_plan(JCTX, k, omega, **folds(1 << k)),
            X.make_plan(CTX, k, omega, "cpu", **folds(1 << k)))


# ---------------------------------------------------------------- plan tables

@pytest.mark.parametrize("fold", list(FOLDS))
@pytest.mark.parametrize("k", [4, 5, 7])
def test_plan_tables_match_jax(k, fold):
    """W1's and W2's byte planes are the JAX nibble planes paired; T is the
    JAX table's limbs as words; the quotient constant is the JAX mu."""
    jp, tp = _plans(k, fold)
    assert (tp.n1, tp.n2, X.MU) == (jp.n1, jp.n2, jp.mu)
    for jplanes, frag, m in ((jp.w1_planes, tp.w1_frag, tp.n1), (jp.w2_planes, tp.w2_frag, tp.n2)):
        nib = np.asarray(jplanes)
        want = nib[0::2] | (nib[1::2] << 4)  # (32, m, m) bytes
        got = X.fixed_planes(frag)[:, :m, :m].numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(X.fixed_planes(frag)[:, m:].numpy(), 0)
    assert torch.equal(tp.t, _words(np.asarray(jp.t_table)))


def test_plan_words_and_fragments_round_trip():
    tp = X.make_plan(CTX, 7, JFR.root_of_unity(7), "cpu", in_scale=ZETA)
    assert torch.equal(X.frag_fixed(tp.w1), tp.w1_frag)
    assert torch.equal(X.frag_fixed(tp.w2), tp.w2_frag)
    assert tp.w1.shape == (tp.n1, tp.n1, 8) and tp.w2.shape == (tp.n2, tp.n2, 8)


def test_k21_raises():
    with pytest.raises(ValueError, match="supports n <= 2"):
        X.make_plan(CTX, 21, JFR.root_of_unity(21), "cpu")


# ------------------------------------------------------- plain transforms

@pytest.fixture(scope="module")
def jax_single():
    """JAX ntt_mxu of one row at k = 4..8 with every fold (one XLA compile
    a k); {(k, fold): (input limbs, output limbs)}."""
    out = {}
    for k in range(4, 9):
        for i, fold in enumerate(FOLDS):
            jp, _ = _plans(k, fold)
            a = _rand_mont(np.random.default_rng(10 * k + i), 1 << k)
            out[k, fold] = (a, np.asarray(JX.ntt_mxu(jp, a)))
    return out


@pytest.mark.parametrize("fold", list(FOLDS))
@pytest.mark.parametrize("k", [4, 5, 6, 7, 8])
def test_plain_matches_jax(jax_single, k, fold):
    """Both plain versions equal the JAX transform and the port's Stockham
    plain version with the same scales, bit for bit."""
    a, want = jax_single[k, fold]
    _, tp = _plans(k, fold)
    x = _words(a)
    want_t = _words(want)
    assert torch.equal(X.ntt_mxu(tp, x), want_t)
    assert torch.equal(X.ntt_mxu_plain(tp, x[None])[0], want_t)
    n = 1 << k
    inverse, folds = FOLDS[fold]
    f = folds(n)
    if "in_scale" in f:
        x = L.mont_mul(CTX, x, N.powers(CTX, f["in_scale"], n, "cpu"))
    y = N.stockham_plain(CTX, x[None], N.powers(CTX, _omega(k, inverse), n // 2, "cpu"))[0]
    if "out_mul" in f:
        y = L.mont_mul(CTX, y, L.to_device_mont(CTX, [f["out_mul"]], "cpu"))
    if "out_scale" in f:
        y = L.mont_mul(CTX, y, N.powers(CTX, f["out_scale"], n, "cpu"))
    assert torch.equal(y, want_t)


@pytest.mark.parametrize("k", [5, 8])
def test_stack_matches_jax(k):
    """A stack of three rows against JAX ntt_mxu_stack, and the coset plan
    over rows of n/8 elements (the prover's zero-padded input) against the
    JAX stack of the padded rows."""
    rng = np.random.default_rng(k)
    n = 1 << k
    jp, tp = _plans(k, "ext")
    stack = np.stack([_rand_mont(rng, n) for _ in range(3)])
    stack[:, n // 8:] = 0
    want = _words(np.asarray(JX.ntt_mxu_stack(jp, stack)))
    assert torch.equal(X.ntt_mxu_stack(tp, _words(stack)), want)
    assert torch.equal(X.ntt_mxu_stack(tp, _words(stack[:, : n // 8].copy())), want)
    assert torch.equal(X.ntt_mxu_plain(tp, _words(stack[:, : n // 8].copy())), want)


@pytest.mark.parametrize("k", [4, 7, 10])
def test_round_trip(k):
    """The inverse plan undoes the forward one; the coset pair too."""
    n = 1 << k
    x = _words(_rand_mont(np.random.default_rng(3 + k), 2 * n)).reshape(2, n, 8)
    fwd, inv = (X.make_plan(CTX, k, _omega(k, i), "cpu", **FOLDS[f][1](n))
                for i, f in ((False, "fwd"), (True, "inv")))
    assert torch.equal(X.ntt_mxu_stack(inv, X.ntt_mxu_stack(fwd, x)), x)
    ext, ext_inv = (X.make_plan(CTX, k, _omega(k, i), "cpu", **FOLDS[f][1](n))
                    for i, f in ((False, "ext"), (True, "ext_inv")))
    assert torch.equal(X.ntt_mxu_stack(ext_inv, X.ntt_mxu_stack(ext, x)), x)


# ------------------------------------------------- the kernel's arithmetic

def _adversarial():
    """tests/test_ntt_mxu.py's V list, with random draws below 2^518."""
    n1_max = 1024
    vals = [0, 1, P - 1, P, P + 1, R - 1, R, R * P - 1,
            n1_max * (P - 1) * (P - 1), (1 << 518) - 1, ((1 << 262) - 1) * R,
            (3 * P - 1) * R, (3 * P) * R, (P - 1) * R]
    rng = np.random.default_rng(0)
    vals += [int(rng.integers(0, 1 << 62)) ** 9 % (1 << 518) for _ in range(32)]
    return vals


def _columns(vals) -> np.ndarray:
    """Each V as 63 byte columns: canonical low bytes, the top column wide."""
    cols = np.zeros((len(vals), X.COLS), dtype=np.int64)
    for r, v in enumerate(vals):
        for c in range(X.COLS - 1):
            cols[r, c] = (v >> (8 * c)) & 0xFF
        cols[r, X.COLS - 1] = v >> (8 * (X.COLS - 1))
    assert cols.max() < (1 << 31)
    return cols


def _spread(vals, rng) -> np.ndarray:
    """Each V as 63 columns up to 2^30 that still sum to V: each column
    lends up to 2^22 of its units to the one below it, as 2^8 times as many."""
    cols = _columns(vals)
    for r in range(len(vals)):
        for c in range(X.COLS - 2, -1, -1):
            take = min(cols[r, c + 1], int(rng.integers(0, 1 << 22)))
            cols[r, c + 1] -= take
            cols[r, c] += take << 8
    assert cols.max() < (1 << 31) and cols.min() >= 0
    return cols


def _value(cols) -> int:
    return sum(int(c) << (8 * i) for i, c in enumerate(cols))


def test_reduce_columns_plain_adversarial():
    vals = _adversarial()
    rng = np.random.default_rng(1)
    for cols in (_columns(vals), _spread(vals, rng)):
        assert [_value(c) for c in cols] == vals
        got = L.words_to_ints_np(L.to_numpy(X.reduce_columns(torch.from_numpy(cols).to(torch.int32))))
        assert got == [v * pow(R, -1, P) % P for v in vals]


def test_columns_at_the_bound():
    """Every entry p - 1 at n1 = 1024: the largest columns a step makes stay
    below 2^31 (the s32 accumulators), and they reduce to
    1024 (p - 1)^2 / 2^256 mod p."""
    assert 32 * X.MAX_SIDE * 255 ** 2 < 1 << 31
    kk = X.MAX_SIDE
    full = torch.from_numpy(L.ints_to_words_np([P - 1]).view(np.int32).copy())
    w = full.expand(X.TILE_M, kk, 8)
    d = full.expand(1, kk, 8)  # one source row of K elements: column 0
    s = X.StepShape(X.TILE_M, 1, kk, kk, 1, kk, kk)
    cols = X.columns_plain(X.frag_fixed(w), X.split_plain(d.contiguous(), s), s)
    assert cols.max().item() < (1 << 31)
    assert _value(cols[0, 0, 0].tolist()) == kk * (P - 1) ** 2
    got = L.words_to_ints_np(L.to_numpy(X.reduce_columns_plain(cols)))
    assert got == [kk * (P - 1) ** 2 * pow(R, -1, P) % P] * X.TILE_M


HARNESS = r"""
#include <cstdio>
#include "ntt_mxu_row.cuh"
// stdin: "0" then 63 columns -> the reduced words; "1" -> the layouts
int main() {
  int op;
  while (scanf("%d", &op) == 1) {
    if (op == 0) {
      uint32_t c[mxu::COLS], r[8];
      for (int i = 0; i < mxu::COLS; i++) scanf("%u", &c[i]);
      mxu::reduce_columns(r, [&](int i) { return c[i]; });
      for (int i = 0; i < 8; i++) printf("%u ", r[i]);
    } else {
      for (uint32_t lane = 0; lane < 32; lane++)
        for (uint32_t reg = 0; reg < 4; reg++) {
          for (uint32_t q = 0; q < 4; q++) {
            uint32_t row, k, col, kb;
            mxu::a_pos(lane, reg, q, row, k);
            printf("%u %u ", row, k);
            if (reg < 2) {
              mxu::b_pos(lane, reg, q, col, kb);
              printf("%u %u ", col, kb);
            }
          }
          printf("%u ", mxu::acc_elem(lane, reg));
        }
    }
    printf("\n");
  }
  return 0;
}
"""


@pytest.fixture(scope="module", params=["portable", "carry_chain"])
def harness(request, tmp_path_factory):
    """csrc/ntt_mxu_row.cuh built by the host compiler, with field.cuh's
    portable bodies and with its carry-chain bodies (FLD_EMULATE_PTX)."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("ntt_mxu_row_" + request.param)
    src, exe = d / "harness.cpp", d / "harness"
    src.write_text(HARNESS)
    flags = ["-DFLD_EMULATE_PTX"] if request.param == "carry_chain" else []
    subprocess.run([cxx, "-O1", "-std=c++17", "-Wall", "-Werror", "-Wno-unknown-pragmas",
                    "-Wno-unused-result", f"-I{CSRC}", *flags, "-o", str(exe), str(src)],
                   check=True, capture_output=True)

    def run(lines):
        out = subprocess.run([str(exe)], input="\n".join(lines) + "\n", text=True,
                             capture_output=True, check=True).stdout
        return [[int(v) for v in line.split()] for line in out.strip().splitlines()]

    return run


def test_header_reduction_adversarial(harness):
    """The kernel's own reduction on the adversarial list, as canonical and
    as spread columns."""
    vals = _adversarial()
    for cols in (_columns(vals), _spread(vals, np.random.default_rng(2))):
        got = harness(["0 " + " ".join(str(int(c)) for c in row) for row in cols])
        want = [v * pow(R, -1, P) % P for v in vals]
        assert [sum(w << (32 * i) for i, w in enumerate(g)) for g in got] == want


def test_header_layouts_match_the_fragments(harness):
    """a_pos, b_pos and acc_elem against the Python layouts: a matrix whose
    entry encodes its (row, k) goes through frag_fixed and split_plain, and
    each lane's bytes name the place the header says they hold."""
    (table,) = harness(["1"])
    m, kk = X.TILE_M, X.TILE_K
    ri, ki = torch.meshgrid(torch.arange(m), torch.arange(kk), indexing="ij")
    enc = torch.zeros(m, kk, 8, dtype=torch.int32)
    enc[..., 0] = (ri * 64 + ki).to(torch.int32)  # byte 0: 6 bits of k, 4 of the row
    fa = X.frag_fixed(enc)  # (1, 1, 32, 32, 16)
    ca, ka = torch.meshgrid(torch.arange(X.TILE_N), torch.arange(kk), indexing="ij")
    encb = torch.zeros(1, X.TILE_N * kk, 8, dtype=torch.int32)
    encb[0, :, 0] = (ca * 64 + ka).reshape(-1).to(torch.int32)  # element (k, col) at col*K + k
    s = X.StepShape(1, X.TILE_N, kk, X.TILE_N * kk, 1, kk, kk)
    fb = X.split_plain(encb, s)  # (1, 1, 1, 32, 32, 8)
    it = iter(table)
    for lane in range(32):
        for reg in range(4):
            for q in range(4):
                row, k = next(it), next(it)
                v = int(fa[0, 0, 0, lane, 4 * reg + q]) | (int(fa[0, 0, 1, lane, 4 * reg + q]) << 8)
                assert (v >> 6, v & 63) == (row, k)
                if reg < 2:
                    col, kb = next(it), next(it)
                    vb = int(fb[0, 0, 0, 0, lane, 4 * reg + q]) | \
                        (int(fb[0, 0, 0, 1, lane, 4 * reg + q]) << 8)
                    assert (vb >> 6, vb & 63) == (col, kb)
            e = next(it)
            assert e == ((lane >> 2) + 8 * (reg >> 1)) * X.TILE_N + 2 * (lane & 3) + (reg & 1)


# ----------------------------------------------------------------- proofs

@pytest.fixture(scope="module")
def keyed():
    from delay_enc_tpu_torch import cs
    from delay_enc_tpu_torch.fields import FR
    from delay_enc_tpu_torch.plonk import SRS, keygen

    srs = SRS.setup(K, tau=TAU, device="cpu")
    b = _build_circuit(cs, FR)
    pk, vk = keygen(b, srs, device="cpu")
    return srs, pk, vk, b


@pytest.fixture(scope="module")
def golden_proof():
    with np.load(GOLDEN) as z:
        return z["proof"].tobytes()


def test_mxu_proof_matches_golden(keyed, golden_proof):
    """Every transform through the matmul NTT's plain version: the JAX
    package's proof bytes."""
    from delay_enc_tpu_torch.plonk import create_proof, verify_proof

    srs, pk, vk, b = keyed
    proof = create_proof(srs, pk, b, np.random.default_rng(SEED), device="cpu", ntt="mxu")
    assert proof == golden_proof
    assert verify_proof(srs, vk, proof)


def test_mxu_pipelined_matches_golden(keyed, golden_proof):
    from delay_enc_tpu_torch.plonk import create_proofs_pipelined

    srs, pk, _, b = keyed
    assert create_proofs_pipelined(srs, pk, [b], seeds=[SEED], device="cpu",
                                   ntt="mxu") == [golden_proof]


def test_unknown_ntt_raises(keyed):
    from delay_enc_tpu_torch.plonk import create_proof

    srs, pk, _, b = keyed
    with pytest.raises(ValueError, match="unknown NTT"):
        create_proof(srs, pk, b, np.random.default_rng(SEED), device="cpu", ntt="bogus")


def test_split_key_with_mxu_raises(keyed):
    """A split key keeps K-b's cosets; asking it for the matmul NTT raises
    rather than quietly proving with K-b."""
    from delay_enc_tpu_torch.plonk import create_proof, keygen

    srs, _, _, b = keyed
    pk_split, _ = keygen(b, srs, split=True, device="cpu")
    with pytest.raises(ValueError, match="split"):
        create_proof(srs, pk_split, b, np.random.default_rng(SEED), device="cpu", ntt="mxu")


def test_domain_mxu_plans(keyed):
    """The four plans are cached per (kind, device) and fold as the JAX
    domain's mxu_* plans do."""
    from delay_enc_tpu.plonk.domain import Domain as JDomain

    domain = keyed[1].vk.domain
    jd = JDomain(domain.k)
    for kind in domain.MXU_KINDS:
        plan = domain.mxu_plan(kind, "cpu")
        assert domain.mxu_plan(kind, "cpu") is plan
        jp = getattr(jd, f"mxu_{kind}")
        assert torch.equal(plan.t, _words(np.asarray(jp.t_table)))
    with pytest.raises(ValueError, match="unknown MXU plan"):
        domain.mxu_plan("ext_fwd", "cpu")


@pytest.mark.parametrize("value,want", [("mxu", "mxu"), ("stockham", "stockham"),
                                        ("MXU", "stockham"), ("", "stockham"), (None, "mxu")])
def test_daemon_maps_delay_enc_ntt(value, want):
    """DELAY_ENC_NTT=mxu picks the matmul NTT, any other value K-b, null the
    command line's setting (mxu here)."""
    from delay_enc_tpu_torch.runtime.daemon import apply_env

    defaults = {"msm": "b4", "selfcheck": None, "ntt": "mxu"}
    settings = dict(defaults, ntt="other")
    assert apply_env(settings, {"DELAY_ENC_NTT": value}, defaults) == {"DELAY_ENC_NTT": value}
    assert settings == dict(defaults, ntt=want)
