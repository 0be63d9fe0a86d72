"""The CUDA kernels' arithmetic on the CPU: delay_enc_tpu_torch/csrc/field.cuh
is __host__ __device__, so the host C++ compiler builds the same Montgomery
product, addition, subtraction and complete addition that K-a..K-d run on
the card.  Checked here against Python integers and the host curve."""

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


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("field_cuh")
    src, exe = d / "harness.cpp", d / "harness"
    src.write_text(HARNESS)
    subprocess.run([cxx, "-O1", "-std=c++17", "-Wno-unknown-pragmas", f"-I{CSRC}",
                    "-o", str(exe), str(src)], check=True, capture_output=True)

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
    vals = [0, 1, p - 1, p - 2, (1 << 255) % p] + [field.random(rng) for _ in range(3000)]
    lines, want = [], []
    for i, a in enumerate(vals):
        b = vals[(7 * i + 3) % len(vals)]
        for op, w in ((0, a * b * pow(R, -1, p) % p), (1, (a + b) % p), (2, (a - b) % p)):
            lines.append(f"{op} {fid} " + " ".join(map(str, _w(a) + _w(b))))
            want.append(w)
    got = [_unw(r) for r in harness(lines)]
    assert got == want


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
