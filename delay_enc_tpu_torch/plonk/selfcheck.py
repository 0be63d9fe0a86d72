"""Host-oracle checks of a proof on the card, as it is made.

Counterpart of `delay_enc_tpu/plonk/selfcheck.py`.  `create_proof(...,
selfcheck=1)` recomputes every commitment with the copied C MSM
(`native/ec.py:msm_host`, in chunks of 8192 points) on the same
coefficients and compares it with the point the prover is about to absorb;
`selfcheck=2` also checks each GWC witness W against its identity
W(r)(r - z) = Q(r) - Q(z) at a host point r.  A wrong kernel then shows as
a named commitment or opening, apart from a wrong polynomial or a wrong
verifier.  Each check prints `# selfcheck <tag>[j]: ok|MISMATCH` to stderr,
as the JAX package's does, and returns its results, which the prover adds
to the caller's `checks` list as (label, ok) pairs.  Pure host code: the
proof's bytes do not change.
"""

from __future__ import annotations

import sys

import numpy as np

from ..fields.bn254 import FR
from ..ops import limbs as L
from ..ops import msm as M

CTX = L.FR_CTX
CHUNK = 8192  # the most points msm_host takes a call


def _say(line: str) -> None:
    print(f"# selfcheck {line}", file=sys.stderr, flush=True)


def _g1_host(srs, n: int) -> list:
    """The first n SRS points as host affine ints, kept with the SRS (its
    truncated views share the cache)."""
    have = srs._prepared.get("g1_host")
    if have is None or len(have) < n:
        have = M.points_from_device(srs.g1_powers)
        srs._prepared["g1_host"] = have
    return have[:n]


def msm_chunked(scalars, points, threads: int | None = None):
    """sum scalars[i] points[i] by the C MSM, CHUNK points a call on
    `native.ec.verify_threads(threads)` threads, the chunks added on the
    host: an affine point, None for the identity, or "unavailable" without
    the C library."""
    from ..curves.bn254 import G1
    from ..native.ec import msm_host

    acc = None
    for i in range(0, len(points), CHUNK):
        r = msm_host(scalars[i : i + CHUNK], points[i : i + CHUNK], FR.p, threads=threads)
        if isinstance(r, str):
            return r
        if r is not None:
            acc = r if acc is None else G1.add(acc, r)
    return acc


def check_commits(srs, coeffs, got_pts, tag: str, threads: int | None = None) -> list:
    """Each commitment got_pts[j] against the C MSM of coeffs[j], a (n, 8)
    Montgomery coefficient row (a tensor of rows or a list), on `threads`
    threads (`msm_chunked`).  Returns one entry a commitment: True, False,
    or None where the C MSM is missing."""
    out = []
    for j, cf in enumerate(coeffs):
        sc = CTX.from_mont_np(L.to_numpy(cf))
        want = msm_chunked(sc, _g1_host(srs, len(sc)), threads)
        if isinstance(want, str):
            _say(f"{tag}[{j}]: C MSM unavailable, skipped")
            out.append(None)
            continue
        ok = want == got_pts[j]
        _say(f"{tag}[{j}]: {'ok' if ok else 'MISMATCH'}"
             + ("" if ok else f" device={got_pts[j]} host={want}"))
        out.append(ok)
    return out


def _eval_host(coeffs: list, x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % FR.p
    return acc


def check_gwc_witness(rows, w, v: int, z: int, tag: str) -> bool:
    """W(r) (r - z) == Q(r) - Q(z) at a fixed host point r, for Q = sum_i
    v^i rows[i] (the opened rows, (n, 8) Montgomery coefficients each) and
    W the witness (n, 8)."""
    rng = np.random.default_rng(0xC0FFEE)
    r = int.from_bytes(bytes(rng.integers(0, 256, 32, dtype="uint8")), "little") % FR.p
    q_r = q_z = 0
    vp = 1
    for row in rows:
        ci = CTX.from_mont_np(L.to_numpy(row))
        q_r = (q_r + vp * _eval_host(ci, r)) % FR.p
        q_z = (q_z + vp * _eval_host(ci, z)) % FR.p
        vp = vp * v % FR.p
    w_r = _eval_host(CTX.from_mont_np(L.to_numpy(w)), r)
    ok = w_r * ((r - z) % FR.p) % FR.p == (q_r - q_z) % FR.p
    _say(f"gwc {tag}: {'ok' if ok else 'MISMATCH'}")
    return ok
