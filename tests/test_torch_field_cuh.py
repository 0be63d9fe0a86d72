"""The CUDA kernels' arithmetic on the CPU: delay_enc_tpu_torch/csrc/field.cuh
is __host__ __device__, so the host C++ compiler builds the Montgomery
product, addition, subtraction and complete addition of K-a..K-d.  The
header has two sets of bodies: portable C++, which a host compiler takes,
and PTX carry chains, which the card takes.  Both are built here, the
second with FLD_EMULATE_PTX, which puts C++ stand-ins with a carry flag
under the same chains, and both are checked against Python integers and
the host curve."""

import os
import shutil
import subprocess

import numpy as np
import pytest

from delay_enc_tpu_torch.curves.bn254 import G1, G1_GEN
from delay_enc_tpu_torch.fields.bn254 import FQ, FR

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "delay_enc_tpu_torch", "csrc")
R = 1 << 256

HARNESS = r"""
#include <cstdio>
#include "field.cuh"
// stdin: "op field" then the operands' words; op 0..2 = mul/add/sub of two
// elements, op 3 = complete addition of two points (field ignored)
int main() {
  int op, f;
  while (scanf("%d %d", &op, &f) == 2) {
    if (op < 3) {
      uint32_t a[8], b[8], r[8];
      for (int i = 0; i < 8; i++) scanf("%u", &a[i]);
      for (int i = 0; i < 8; i++) scanf("%u", &b[i]);
      if (f == 0) {
        if (op == 0) fld::mont_mul<0>(r, a, b);
        else if (op == 1) fld::add<0>(r, a, b);
        else fld::sub<0>(r, a, b);
      } else {
        if (op == 0) fld::mont_mul<1>(r, a, b);
        else if (op == 1) fld::add<1>(r, a, b);
        else fld::sub<1>(r, a, b);
      }
      for (int i = 0; i < 8; i++) printf("%u ", r[i]);
    } else {
      fld::G1 p, q;
      uint32_t* dst[6] = {p.x, p.y, p.z, q.x, q.y, q.z};
      for (int c = 0; c < 6; c++)
        for (int i = 0; i < 8; i++) scanf("%u", &dst[c][i]);
      fld::g1_add(p, p, q);  // in place, as the plane-sum loop calls it
      for (int i = 0; i < 8; i++) printf("%u ", p.x[i]);
      for (int i = 0; i < 8; i++) printf("%u ", p.y[i]);
      for (int i = 0; i < 8; i++) printf("%u ", p.z[i]);
    }
    printf("\n");
  }
  return 0;
}
"""


BODIES = {"portable": [], "carry_chain": ["-DFLD_EMULATE_PTX"]}


@pytest.fixture(scope="module", params=list(BODIES))
def harness(request, tmp_path_factory):
    """The harness built without __CUDACC__, once for each set of bodies."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("field_cuh_" + request.param)
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


def _unw(ws):
    return sum(v << (32 * i) for i, v in enumerate(ws))


@pytest.mark.parametrize("fid,field", [(0, FR), (1, FQ)], ids=["fr", "fq"])
def test_field_ops_match_python_ints(harness, fid, field):
    p = field.p
    rng = np.random.default_rng(fid)
    ones = (1 << 256) - 1
    carry_heavy = [
        p - 1, p - 2, R % p, (1 << 255) % p,
        ones >> 3,  # every word all ones below the top one (2^253 - 1 < p)
        (ones >> 3) - 0xFFFFFFFF,  # the same with a zero low word
        (ones >> 3) ^ (0xFFFFFFFF << 96),  # a zero word in the middle
        0xFFFFFFFF << 64, 1 << 32, (1 << 224) + 1, 0xFFFFFFFF,
    ]
    assert all(0 <= v < p for v in carry_heavy)
    vals = [0, 1] + carry_heavy + [field.random(rng) for _ in range(3000)]
    lines, want = [], []
    for i, a in enumerate(vals):
        b = vals[(7 * i + 3) % len(vals)]
        for op, w in ((0, a * b * pow(R, -1, p) % p), (1, (a + b) % p), (2, (a - b) % p)):
            lines.append(f"{op} {fid} " + " ".join(map(str, _w(a) + _w(b))))
            want.append(w)
    got = [_unw(r) for r in harness(lines)]
    assert got == want
    # every carry-heavy value against every other, both ways round
    lines, want = [], []
    for a in [0, 1] + carry_heavy:
        for b in [0, 1] + carry_heavy:
            for op, w in ((0, a * b * pow(R, -1, p) % p), (1, (a + b) % p), (2, (a - b) % p)):
                lines.append(f"{op} {fid} " + " ".join(map(str, _w(a) + _w(b))))
                want.append(w)
    assert [_unw(r) for r in harness(lines)] == want


def test_complete_add_matches_host_curve(harness):
    q = FQ.p
    rng = np.random.default_rng(7)

    def proj(pt, z):  # Montgomery projective, a random Z scale
        if pt is None:
            return [0, R % q, 0]
        return [pt[0] * z * R % q, pt[1] * z * R % q, z * R % q]

    pts = [G1.mul(G1_GEN, int(rng.integers(1, 1 << 60))) for _ in range(200)]
    lines, want = [], []
    for i, a in enumerate(pts):
        b = pts[(13 * i + 5) % len(pts)]
        a, b = {0: (a, a), 1: (a, None), 2: (None, b), 3: (a, G1.neg(a))}.get(i % 10, (a, b))
        words = proj(a, FQ.random(rng) or 1) + proj(b, FQ.random(rng) or 1)
        lines.append("3 1 " + " ".join(str(v) for c in words for v in _w(c)))
        want.append(G1.add(a, b))
    rinv = pow(R, -1, q)
    for row, w in zip(harness(lines), want):
        x, y, z = (_unw(row[8 * c : 8 * c + 8]) for c in range(3))
        assert max(x, y, z) < q  # fully reduced
        x, y, z = x * rinv % q, y * rinv % q, z * rinv % q
        got = None if z == 0 else (x * pow(z, -1, q) % q, y * pow(z, -1, q) % q)
        assert got == w


def test_header_compiles_without_cuda(tmp_path):
    """field.cuh alone, as a host compiler sees it (no __CUDACC__, no
    __CUDA_ARCH__), with warnings as errors, for each set of bodies."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    src = tmp_path / "only_header.cpp"
    src.write_text('#include "field.cuh"\n'
                   "#if defined(__CUDACC__) || defined(__CUDA_ARCH__)\n#error CUDA\n#endif\n"
                   "template void fld::mont_mul<0>(uint32_t*, const uint32_t*, const uint32_t*);\n"
                   "template void fld::mont_mul<1>(uint32_t*, const uint32_t*, const uint32_t*);\n"
                   "void both(fld::G1& o, const fld::G1& p, const fld::G1& q) "
                   "{ fld::g1_add(o, p, q); }\n")
    for flags in BODIES.values():
        subprocess.run([cxx, "-std=c++17", "-Wall", "-Werror", "-Wno-unknown-pragmas",
                        f"-I{CSRC}", *flags, "-c", "-o", str(tmp_path / "only_header.o"),
                        str(src)], check=True, capture_output=True)


@pytest.mark.parametrize("fid,field", [(0, FR), (1, FQ)], ids=["fr", "fq"])
def test_mont_mul_takes_a_second_operand_anywhere_below_2_256(harness, fid, field):
    """A reduced first operand (R^2, R^3, random ones) against a second
    anywhere below 2^256, [2^256 - p, 2^256) among them: the conversions of
    canonical words and of 64-byte draws (`canonical_to_mont`,
    `field_wide_to_mont`) rely on it, in both bodies."""
    p = field.p
    rng = np.random.default_rng(10 + fid)
    firsts = [R * R % p, R ** 3 % p, p - 1, 1] + [field.random(rng) for _ in range(4)]
    seconds = [0, 1, p - 1, p, 2 * p, R - p - 1, R - p, R - p + 1, R - 1] + \
        [int.from_bytes(rng.bytes(32), "little") for _ in range(400)] + \
        [R - 1 - int.from_bytes(rng.bytes(30), "little") for _ in range(200)]
    lines, want = [], []
    for a in firsts:
        for b in seconds:
            lines.append(f"0 {fid} " + " ".join(map(str, _w(a) + _w(b))))
            want.append(a * b * pow(R, -1, p) % p)
    assert [_unw(r) for r in harness(lines)] == want
