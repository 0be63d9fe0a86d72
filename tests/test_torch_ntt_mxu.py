"""The matmul NTT (K11, delay_enc_tpu_torch/ops/ntt_mxu.py) on the CPU against
the JAX package's ops/ntt_mxu.py: the plans' tables, the plain transforms
with every fold, the kernel's reduction on adversarial columns (in plain
PyTorch and as csrc/ntt_mxu_row.cuh built by the host C++ compiler, with
the carry of each half of the columns), the kernel's operand layouts, the
runs of its warpgroup MMAs (csrc/ntt_mxu_wgmma.cuh), and
create_proof(ntt="mxu") of the k=7 test circuit against the JAX golden's
bytes."""

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
    """The plan's fixed operands in the product's order, (row tiles of 64,
    K tiles of 32, 32 planes, 2048 bytes), padded with zeros, and back to
    words; the data planes of a step back to the matrix
    they were cut from."""
    tp = X.make_plan(CTX, 7, JFR.root_of_unity(7), "cpu", in_scale=ZETA)
    assert torch.equal(X.frag_fixed(tp.w1), tp.w1_frag)
    assert torch.equal(X.frag_fixed(tp.w2), tp.w2_frag)
    assert tp.w1.shape == (tp.n1, tp.n1, 8) and tp.w2.shape == (tp.n2, tp.n2, 8)
    assert tp.w1_frag.shape == (1, 1, 32, 2048)  # n1 = 8: one tile, padded
    assert tp.w2_frag.shape == (1, 1, 32, 2048)
    rng = np.random.default_rng(4)
    w = _words(_rand_mont(rng, 96 * 80)).reshape(96, 80, 8)
    frag = X.frag_fixed(w)
    assert frag.shape == (2, 3, 32, 2048)
    assert torch.equal(X.fixed_words(frag, 96, 80), w)
    planes = X.fixed_planes(frag)
    assert torch.equal(planes[:, :96, :80], w.view(torch.uint8).permute(2, 0, 1))
    assert not planes[:, 96:].any() and not planes[:, :, 80:].any()
    # a data matrix (K = 40, q = 12) read with strides: column j, row k at 12 k + j
    x = _words(_rand_mont(rng, 2 * 480)).reshape(2, 480, 8)
    s = X.StepShape(1, 12, 40, 480, 12, 1, 40)
    d = X.split_plain(x, s)
    assert d.shape == (2, 2, 2, 32, 256)
    got = X.data_planes(d)  # (batch, 32, 16, 64)
    want = x.reshape(2, 40, 12, 8).view(torch.uint8).permute(0, 3, 2, 1)
    assert torch.equal(got[:, :, :12, :40], want)
    assert not got[:, :, 12:].any() and not got[:, :, :, 40:].any()


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
    below 2^31 (the s32 accumulators) in a whole 64-row tile, and they
    reduce to 1024 (p - 1)^2 / 2^256 mod p."""
    assert 32 * X.MAX_SIDE * 255 ** 2 < 1 << 31
    kk = X.MAX_SIDE
    full = torch.from_numpy(L.ints_to_words_np([P - 1]).view(np.int32).copy())
    w = full.expand(X.TILE_M, kk, 8)
    d = full.expand(1, kk * X.TILE_N, 8)  # one source row: column j, row k at k * 8 + j
    s = X.StepShape(X.TILE_M, X.TILE_N, kk, kk * X.TILE_N, X.TILE_N, 1, kk)
    cols = X.columns_plain(X.frag_fixed(w), X.split_plain(d.contiguous(), s), s)
    assert cols.shape == (1, X.TILE_M, X.TILE_N, X.COLS)
    assert cols.max().item() < (1 << 31)
    assert all(_value(c) == kk * (P - 1) ** 2 for c in cols.reshape(-1, X.COLS).tolist())
    got = L.words_to_ints_np(L.to_numpy(X.reduce_columns_plain(cols.reshape(-1, X.COLS))))
    assert got == [kk * (P - 1) ** 2 * pow(R, -1, P) % P] * (X.TILE_M * X.TILE_N)


HARNESS = r"""
#include <cstdio>
#include "ntt_mxu_row.cuh"
// stdin: "0" then 63 columns -> the reduced words; "2" then 63 columns ->
// the two carried halves (9 words each); "1" -> the layouts
int main() {
  int op;
  while (scanf("%d", &op) == 1) {
    if (op == 0 || op == 2) {
      uint32_t c[mxu::COLS], r[8], lo[mxu::HALF_WORDS], hi[mxu::HALF_WORDS];
      for (int i = 0; i < mxu::COLS; i++) scanf("%u", &c[i]);
      if (op == 0) {
        mxu::reduce_columns(r, [&](int i) { return c[i]; });
        for (int i = 0; i < 8; i++) printf("%u ", r[i]);
      } else {
        mxu::carry_half<0>(lo, [&](int i) { return c[i]; });
        mxu::carry_half<1>(hi, [&](int i) { return c[mxu::HALF_COLS + i]; });
        for (int i = 0; i < mxu::HALF_WORDS; i++) printf("%u ", lo[i]);
        for (int i = 0; i < mxu::HALF_WORDS; i++) printf("%u ", hi[i]);
      }
    } else {
      for (uint32_t o = 0; o < mxu::PLANE_A_BYTES; o++) {
        uint32_t row, k;
        mxu::plane_pos(o, row, k);
        printf("%u %u ", row, k);
      }
      for (uint32_t warp = 0; warp < 4; warp++)
        for (uint32_t lane = 0; lane < 32; lane++)
          for (uint32_t reg = 0; reg < 4; reg++) {
            uint32_t row, col;
            mxu::acc_elem(warp, lane, reg, row, col);
            printf("%u %u ", row, col);
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
    as spread columns; and its carry of each half of the columns (the two
    warpgroups' epilogue) against Python integers, on those columns and on
    columns at 2^31 - 1 (the ninth word of a half stays below 2^25)."""
    vals = _adversarial()
    rng = np.random.default_rng(2)
    full = np.full((1, X.COLS), (1 << 31) - 1, dtype=np.int64)
    for cols in (_columns(vals), _spread(vals, rng), full):
        lines = [" ".join(str(int(c)) for c in row) for row in cols]
        halves = harness(["2 " + line for line in lines])
        for row, got in zip(cols, halves):
            lo, hi = got[: X.HALF_WORDS], got[X.HALF_WORDS:]
            assert _value(row[: X.HALF_COLS]) == sum(w << (32 * i) for i, w in enumerate(lo))
            assert _value(row[X.HALF_COLS:]) == sum(w << (32 * i) for i, w in enumerate(hi))
            assert lo[-1] < 1 << 25 and hi[-1] < 1 << 25
        if cols is full:
            continue  # V above 2^518: not an input of the reduction
        got = harness(["0 " + line for line in lines])
        want = [v * pow(R, -1, P) % P for v in vals]
        assert [sum(w << (32 * i) for i, w in enumerate(g)) for g in got] == want


def test_header_layouts_match_the_fragments(harness):
    """plane_pos and acc_elem against the Python layouts: a matrix whose
    entry encodes its (row, k) goes through frag_fixed and split_plain, and
    each byte of a plane's tile names the place the header says it holds
    (the data's 256 bytes are the first 8 rows of the fixed operand's
    2048); the accumulator registers cover an 8-column slot's 64 x 8 tile
    once."""
    (table,) = harness(["1"])
    m, kk, nn = X.TILE_M, X.TILE_K, X.TILE_N
    ri, ki = torch.meshgrid(torch.arange(m), torch.arange(kk), indexing="ij")
    enc = torch.zeros(m, kk, 8, dtype=torch.int32)
    enc[..., 0] = (ri * 64 + ki).to(torch.int32)  # bytes 0-1: 6 bits of k, 6 of the row
    fa = X.frag_fixed(enc)
    assert fa.shape == (1, 1, 32, m * kk)
    ca, ka = torch.meshgrid(torch.arange(nn), torch.arange(kk), indexing="ij")
    encb = torch.zeros(1, nn * kk, 8, dtype=torch.int32)
    encb[0, :, 0] = (ca * 64 + ka).reshape(-1).to(torch.int32)  # element (k, col) at col*K + k
    s = X.StepShape(1, nn, kk, nn * kk, 1, kk, kk)
    fb = X.split_plain(encb, s)
    assert fb.shape == (1, 1, 1, 32, nn * kk)
    it = iter(table)
    for o in range(m * kk):
        row, k = next(it), next(it)
        v = int(fa[0, 0, 0, o]) | (int(fa[0, 0, 1, o]) << 8)
        assert (v >> 6, v & 63) == (row, k)
        if o < nn * kk:
            vb = int(fb[0, 0, 0, 0, o]) | (int(fb[0, 0, 0, 1, o]) << 8)
            assert (vb >> 6, vb & 63) == (row, k)
    seen = set()
    for warp in range(4):
        for lane in range(32):
            for reg in range(4):
                row, col = next(it), next(it)
                assert (row, col) == (16 * warp + (lane >> 2) + 8 * (reg >> 1),
                                      2 * (lane & 3) + (reg & 1))
                seen.add((row, col))
    assert seen == {(r, c) for r in range(m) for c in range(nn)}


def _wgmma_runs():
    """The product's wgmmas (csrc/ntt_mxu.cu mma_plane): for each half H and
    fixed plane a, the data planes b with a + b in the half, rounded to a
    width u8 wgmma takes (one more slot, over a zero tile, for an odd count
    from 5 on); every run starts at accumulator slot 0.  (H, a) -> the
    data plane of each slot (None: the zero tile); slot s is column 31 - s
    of the low half (planes descending), 32 + s of the high one."""
    out = {}
    for h in (0, 1):
        for a in range(X.PLANES):
            n = X.PLANES - a if h == 0 else a
            if n == 0:
                continue
            lw = n if n <= 4 or n % 2 == 0 else n + 1
            first = X.PLANES - 1 - a if h == 0 else X.PLANES - a
            step = -1 if h == 0 else 1
            out[h, a] = [first + step * s if s < n else None for s in range(lw)]
    return out


def test_wgmma_runs_cover_each_pair_once():
    """Every plane pair (a, b) lands once in the slot of column a + b of its
    half, the extra slots multiply the zero tile, every run starts at slot
    0 and fits the 32 slots, and every width is one u8 wgmma takes."""
    allowed = {8, 16, 24, 32} | set(range(48, 257, 16))
    seen = {}
    for (h, a), run in _wgmma_runs().items():
        assert 8 * len(run) in allowed and len(run) <= X.HALF_COLS
        for s, b in enumerate(run):
            if b is None:
                continue
            assert 0 <= b < X.PLANES
            assert a + b == (X.HALF_COLS - 1 - s if h == 0 else X.HALF_COLS + s)
            seen[a, b] = seen.get((a, b), 0) + 1
    assert seen == {(a, b): 1 for a in range(X.PLANES) for b in range(X.PLANES)}
    assert sum(len(run) for run in _wgmma_runs().values()) == 1052


def test_wgmma_header_follows_one_pattern():
    """csrc/ntt_mxu_wgmma.cuh: each width's asm names its 4L accumulator
    registers in order, then the two descriptors and the scale, and binds
    the L slots in order; it has every width the product issues."""
    import re

    text = open(os.path.join(CSRC, "ntt_mxu_wgmma.cuh")).read()
    bodies = re.findall(r"wgmma_ss<(\d+)>\(uint32_t \(\*d\)\[4\], uint64_t a, uint64_t b\) \{"
                        r"(.*?)\n\}", text, re.S)
    widths = {int(lw) for lw, _ in bodies}
    assert widths == {len(run) for run in _wgmma_runs().values()}
    for lw, body in bodies:
        n = 4 * int(lw)
        asm = "".join(re.findall(r'"([^"]*)"', body.split(":")[0]))
        assert f"setp.ne.b32 p, %{n + 2}, 0;" in asm
        regs = re.search(r"m64n(\d+)k32\.s32\.u8\.u8 \{([^}]*)\}, %(\d+), %(\d+), p;", asm)
        assert regs and int(regs.group(1)) == 8 * int(lw)
        assert [r.strip() for r in regs.group(2).split(",")] == [f"%{i}" for i in range(n)]
        assert (int(regs.group(3)), int(regs.group(4))) == (n, n + 1)
        assert re.findall(r"MXU_D4\((\d+)\)", body) == [str(i) for i in range(int(lw))]
        assert '"l"(a), "l"(b), "r"(1)' in body


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
