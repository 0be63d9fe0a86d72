"""Port parity: the JAX package's last field, polynomial and point functions
against their ports on the CPU, bit-exact: mont_sqr, mont_pow, inv and
batch_inv (delay_enc_tpu_torch.ops.limbs), batch_inv_log, eval_poly and
divide_by_linear (ops.poly), coset_scale (ops.ntt), point_double,
point_neg and point_select (ops.msm, compared as affine points); and the
body of the field_pow kernel (csrc/field.cuh mont_pow), built by the host
C++ compiler as tests/test_torch_field_cuh.py builds field.cuh, against
Python's pow in both fields.  That body test stands in for the card, where
chip_smoke.py phase 1 holds the kernel against mont_pow_plain.

The JAX functions run under jax.jit as tests/test_limbs.py runs them, but
for mont_pow with a 256-bit exponent: jit unrolls its loop of 384 products
into one graph that takes about a minute of XLA:CPU compile per field, so
that case runs JAX's mont_pow as written with its mont_mul jitted once."""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from delay_enc_tpu.curves.bn254 import G1, G1_GEN
from delay_enc_tpu.ops import limbs as JL
from delay_enc_tpu.ops import msm as JM
from delay_enc_tpu.ops import ntt as JN
from delay_enc_tpu.ops import poly as JP
from delay_enc_tpu_torch.ops import limbs as TL
from delay_enc_tpu_torch.ops import msm as TM
from delay_enc_tpu_torch.ops import ntt as TN
from delay_enc_tpu_torch.ops import poly as TP

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "delay_enc_tpu_torch", "csrc")
R = 1 << 256
FIELDS = ["fr", "fq"]
RAND_E = int.from_bytes(np.random.default_rng(256).bytes(32), "little")
EXPONENTS = {"0": 0, "1": 1, "3": 3, "rand256": RAND_E}


def _ctxs(name):
    return {"fr": (JL.FR_CTX, TL.FR_CTX), "fq": (JL.FQ_CTX, TL.FQ_CTX)}[name]


def _values(tctx, n, seed, zero_at=None):
    """n Montgomery words (numpy uint32 (n, 8)): random values below p with
    0, 1, p - 1 and R mod p among them, and 0 at `zero_at`."""
    rng = np.random.default_rng(seed)
    p = tctx.p
    vals = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]
    vals[1:5] = [1, p - 1, R % p, p - 2]
    vals[0 if zero_at is None else zero_at] = 0
    return tctx.to_mont_np(vals)


def _limbs(w):
    return TL.words_to_limbs_np(w)


def _port(fn, *words):
    return TL.to_numpy(fn(*[TL.to_tensor(w, "cpu") for w in words]))


def _same(got_words, want_limbs):
    assert np.array_equal(_limbs(got_words), np.asarray(want_limbs))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("field", FIELDS)
def test_mont_sqr_matches_jax(field):
    jctx, tctx = _ctxs(field)
    a = _values(tctx, 33, 1)
    _same(_port(lambda x: TL.mont_sqr(tctx, x), a),
          jax.jit(lambda x: JL.mont_sqr(jctx, x))(_limbs(a)))


@pytest.mark.parametrize("exp", list(EXPONENTS))
@pytest.mark.parametrize("field", FIELDS)
def test_mont_pow_matches_jax(field, exp, monkeypatch):
    jctx, tctx = _ctxs(field)
    e = EXPONENTS[exp]
    a = _values(tctx, 33, 2 + len(exp))
    got = _port(lambda x: TL.mont_pow(tctx, x, e), a)
    if e.bit_length() > 8:
        orig = JL.mont_mul
        fast = jax.jit(lambda x, y: orig(jctx, x, y))
        monkeypatch.setattr(JL, "mont_mul", lambda ctx, x, y: fast(x, y))
        want = JL.mont_pow(jctx, jnp.asarray(_limbs(a)), e)
    else:
        want = jax.jit(lambda x: JL.mont_pow(jctx, x, e))(_limbs(a))
    _same(got, want)
    p = tctx.p
    assert tctx.from_mont_np(got) == [pow(v, e, p) for v in tctx.from_mont_np(a)]


@pytest.mark.parametrize("field", FIELDS)
def test_inv_matches_jax(field):
    """Zero maps to zero, as Fermat gives and as the JAX scan does."""
    jctx, tctx = _ctxs(field)
    a = _values(tctx, 33, 3)
    _same(_port(lambda x: TL.inv(tctx, x), a), jax.jit(lambda x: JL.inv(jctx, x))(_limbs(a)))


@pytest.mark.parametrize("n", [1, 2, 33])
@pytest.mark.parametrize("name", ["batch_inv", "batch_inv_log"])
@pytest.mark.parametrize("field", FIELDS)
def test_batch_inverse_matches_jax(field, name, n):
    jctx, tctx = _ctxs(field)
    a = _values(tctx, max(n, 5), 4 + n, zero_at=n // 2)[:n]
    port_fn = TL.batch_inv if name == "batch_inv" else TP.batch_inv_log
    jax_fn = JL.batch_inv if name == "batch_inv" else JP.batch_inv_log
    got = _port(lambda x: port_fn(tctx, x), a)
    _same(got, jax.jit(lambda x: jax_fn(jctx, x))(_limbs(a)))
    p = tctx.p
    assert tctx.from_mont_np(got) == [pow(v, -1, p) if v else 0 for v in tctx.from_mont_np(a)]


def test_batch_inv_along_axis_0_of_a_stack():
    """A (n, m, 8) stack inverts along axis 0, each column on its own."""
    tctx = TL.FR_CTX
    a = _values(tctx, 24, 9, zero_at=7).reshape(8, 3, 8)
    got = TL.batch_inv(tctx, TL.to_tensor(a, "cpu"))
    cols = [TL.batch_inv(tctx, TL.to_tensor(np.ascontiguousarray(a[:, j]), "cpu"))
            for j in range(3)]
    assert torch.equal(got, torch.stack(cols, dim=1))


@pytest.fixture(scope="module")
def poly_inputs():
    """n = 16 Fr coefficients and the powers of a point z, of z^-1 and of
    a coset's zeta (one more than n each), as Montgomery words."""
    ctx = TL.FR_CTX
    p = ctx.p
    rng = np.random.default_rng(16)
    coeffs = _values(ctx, 16, 5)
    z = int.from_bytes(rng.bytes(32), "little") % p
    zi = pow(z, -1, p)
    zeta = 7
    pows = {name: ctx.to_mont_np([pow(b, i, p) for i in range(17)])
            for name, b in (("z", z), ("zinv", zi), ("zeta", zeta))}
    return coeffs, pows


def test_eval_poly_matches_jax(poly_inputs):
    coeffs, pows = poly_inputs
    got = _port(lambda c, x: TP.eval_poly(TL.FR_CTX, c, x), coeffs, pows["z"])
    want = jax.jit(lambda c, x: JP.eval_poly(JL.FR_CTX, c, x))(_limbs(coeffs), _limbs(pows["z"]))
    assert got.shape == (8,)
    _same(got, want)


def test_divide_by_linear_matches_jax(poly_inputs):
    coeffs, pows = poly_inputs
    got = _port(lambda c, z, zi: TP.divide_by_linear(TL.FR_CTX, c, z, zi),
                coeffs, pows["z"], pows["zinv"])
    want = jax.jit(lambda c, z, zi: JP.divide_by_linear(JL.FR_CTX, c, z, zi))(
        _limbs(coeffs), _limbs(pows["z"]), _limbs(pows["zinv"]))
    _same(got, want)


def test_coset_scale_matches_jax(poly_inputs):
    coeffs, pows = poly_inputs
    zeta = pows["zeta"][:16]
    got = _port(lambda c, t: TN.coset_scale(TL.FR_CTX, c, t), coeffs, zeta)
    _same(got, jax.jit(lambda c, t: JN.coset_scale(JL.FR_CTX, c, t))(_limbs(coeffs),
                                                                        _limbs(zeta)))


@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(40)
    pts = [G1.mul(G1_GEN, int(rng.integers(1, 1 << 62))) for _ in range(5)]
    return pts + [None, G1.neg(pts[0])]  # the identity and a negated point among them


def _jax_points(t):
    return jnp.asarray(_limbs(TL.to_numpy(t)))


def test_point_double_matches_jax(points):
    a = TM.points_to_device(points, "cpu")
    got = TM.points_from_device(TM.point_double(a))
    assert got == JM.points_from_device(jax.jit(JM.point_double)(_jax_points(a)))
    assert got == [G1.double(p) for p in points]


def test_point_neg_matches_jax(points):
    a = TM.points_to_device(points, "cpu")
    got = TM.points_from_device(TM.point_neg(a))
    assert got == JM.points_from_device(jax.jit(JM.point_neg)(_jax_points(a)))
    assert got == [G1.neg(p) for p in points]


def test_point_select_matches_jax(points):
    a = TM.points_to_device(points, "cpu")
    b = TM.points_to_device(points[::-1], "cpu")
    cond = np.array([True, False, True, True, False, False, True])
    got = TM.point_select(torch.from_numpy(cond), a, b)
    want = jax.jit(JM.point_select)(jnp.asarray(cond), _jax_points(a), _jax_points(b))
    assert np.array_equal(_limbs(TL.to_numpy(got)), np.asarray(want))
    assert TM.points_from_device(got) == [p if c else q
                                          for c, p, q in zip(cond, points, points[::-1])]


# ---------------------------------------------------- the kernel's own body

HARNESS = r"""
#include <cstdio>
#include "field.cuh"
// stdin: "field nbits" then the exponent's 8 words and the base's 8 words
int main() {
  int f;
  unsigned nbits;
  while (scanf("%d %u", &f, &nbits) == 2) {
    uint32_t e[8], a[8], r[8];
    for (int i = 0; i < 8; i++) scanf("%u", &e[i]);
    for (int i = 0; i < 8; i++) scanf("%u", &a[i]);
    if (f == 0) fld::mont_pow<0>(r, a, e, nbits);
    else fld::mont_pow<1>(r, a, e, nbits);
    for (int i = 0; i < 8; i++) printf("%u ", r[i]);
    printf("\n");
  }
  return 0;
}
"""

BODIES = {"portable": [], "carry_chain": ["-DFLD_EMULATE_PTX"]}


@pytest.fixture(scope="module", params=list(BODIES))
def pow_harness(request, tmp_path_factory):
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("field_pow_" + request.param)
    src, exe = d / "harness.cpp", d / "harness"
    src.write_text(HARNESS)
    subprocess.run([cxx, "-O1", "-std=c++17", "-Wno-unknown-pragmas", f"-I{CSRC}",
                    *BODIES[request.param], "-o", str(exe), str(src)],
                   check=True, capture_output=True)

    def run(lines):
        out = subprocess.run([str(exe)], input="\n".join(lines) + "\n", text=True,
                             capture_output=True, check=True, timeout=300).stdout
        return [list(map(int, ln.split())) for ln in out.strip().split("\n")]

    return run


def _w(x):
    return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)]


@pytest.mark.parametrize("field", FIELDS)
def test_field_pow_body_matches_python_pow(pow_harness, field):
    """Exponents 0, 1, 2, 3, p - 2 (inv), p - 1, 2^255 and random ones up to
    2^256 - 1; bases 0, 1, p - 1, R mod p, carry-heavy words and random."""
    tctx = _ctxs(field)[1]
    fid = ["fr", "fq"].index(field)
    p = tctx.p
    rng = np.random.default_rng(300 + fid)
    ones = R - 1
    bases = [0, 1, p - 1, p - 2, R % p, ones >> 3, (ones >> 3) ^ (0xFFFFFFFF << 96),
             0xFFFFFFFF << 64, 1 << 32] + [int.from_bytes(rng.bytes(32), "little") % p
                                           for _ in range(6)]
    exps = [0, 1, 2, 3, p - 2, p - 1, 1 << 255, R - 1, RAND_E] + [
        int.from_bytes(rng.bytes(32), "little") >> int(rng.integers(0, 250)) for _ in range(4)]
    lines, want = [], []
    for e in exps:
        for b in bases:
            lines.append(f"{fid} {e.bit_length()} "
                         + " ".join(map(str, _w(e) + _w(b * R % p))))
            want.append(pow(b, e, p) * R % p)
    got = [sum(v << (32 * i) for i, v in enumerate(row)) for row in pow_harness(lines)]
    assert got == want
