"""verify_proof: host-side verifier (pairings via curves.pairing).

Replaces `halo2_proofs::verify_proof` + `VerifierGWC` (reference
benches/delay_enc.rs:147-165).  Mirrors prover.py's transcript order
exactly; all arithmetic is host Python ints + host G1 ops (ms-scale).

Checks:
  1. the y-folded constraint expression at x equals h(x) * (x^n - 1),
     with h(x) = sum_i x^(n*i) h_i(x),
  2. the GWC pairing equation over the three opening points
     e(sum_j u^j W_j, [tau]2) == e(sum_j u^j (z_j W_j + C_Q_j - e_j G), [1]2).
"""

from __future__ import annotations

from ..curves.bn254 import G1, G1_GEN, g1_from_bytes
from ..curves.pairing import pairing_check
from ..fields.bn254 import FR
from .domain import QUOTIENT_PIECES
from .keygen import ALL_FIXED, LOOKUPS, VerifyingKey
from .transcript import Transcript

P = FR.p
NUM_ADVICE = 5
WIRE_COL = {"a": 0, "b": 1, "c": 2, "d": 3}


class _Reader:
    def __init__(self, data: bytes, tr: Transcript, pre_pts=None):
        self.data = data
        self.off = 0
        self.tr = tr
        self.pre_pts = pre_pts  # batch-decompressed points, stream order

    def point(self):
        if self.pre_pts is not None:
            pt = self.pre_pts.pop(0)
            self.off += 32
        else:
            b = self.data[self.off : self.off + 32]
            self.off += 32
            pt = g1_from_bytes(b)
        self.tr.common_point(pt)
        return pt

    def scalar(self) -> int:
        b = self.data[self.off : self.off + 32]
        self.off += 32
        v = FR.from_repr(b)
        if v is None:
            raise ValueError("non-canonical scalar in proof")
        self.tr.common_scalar(v)
        return v


def _predecompress(vk, proof: bytes, threads: int | None):
    """Batch-decompress every G1 point in the proof stream in one C call.
    The stream layout is static per vk (every item is 32 bytes; point and
    scalar counts depend only on LOOKUPS/QUOTIENT_PIECES/sigma count), so
    all point offsets are known before parsing.  Returns the points in
    stream order, or None to fall back to per-point decompression."""
    from ..curves.bn254 import B1
    from ..native.ec import g1_decompress_batch

    L = len(LOOKUPS)
    n_head = 5 + 2 * L + 1 + L + 1 + QUOTIENT_PIECES
    n_scal = (
        (5 + len(ALL_FIXED) + len(vk.sigma_commitments) + 1 + 3 * L + 1
         + QUOTIENT_PIECES)   # names_x
        + (2 + L)             # names_wx
        + L                   # names_winvx
    )
    w_base = (n_head + n_scal) * 32
    if len(proof) < w_base + 3 * 32:
        raise ValueError("proof too short")
    blob = proof[: n_head * 32] + proof[w_base : w_base + 3 * 32]
    pts = g1_decompress_batch(blob, n_head + 3, B1, threads)
    if pts == "unavailable":
        return None
    return pts


def _fixed_first_msm(vk, fixed_pairs, var_pairs, threads: int | None):
    """MSM over fixed-first partitioned (scalar, point) pairs, using the
    per-vk precomputed wNAF tables when the C library is available.  The
    fixed partition order is deterministic per vk (names_x order + G), so
    the table blob is built once and cached on the vk object."""
    from ..native import ec

    scalars = [s for s, _ in fixed_pairs] + [s for s, _ in var_pairs]
    points = [p for _, p in fixed_pairs] + [p for _, p in var_pairs]
    pretab = getattr(vk, "_msm_pretab", None)
    if pretab is None and not getattr(vk, "_msm_pretab_failed", False):
        pretab = ec.msm_precompute([p for _, p in fixed_pairs])
        if pretab is None:
            vk._msm_pretab_failed = True  # no C library: don't retry
        else:
            vk._msm_pretab = pretab
    if pretab is not None:
        res = ec.msm_host(scalars, points, P, pretab=pretab,
                          npre=len(fixed_pairs), threads=threads)
        if res != "unavailable":
            return res
    return G1.multi_scalar_mul(scalars, points, threads)


def verify_proof(srs, vk: VerifyingKey, proof: bytes, instances=None,
                 threads: int | None = None) -> bool:
    """Whether the proof verifies under vk.  `threads` is the count of the
    host C kernels' threads (`native.ec.verify_threads`: by default
    min(4, cpu count))."""
    try:
        guard = _verify(srs, vk, proof, instances or [], threads)
    except (ValueError, AssertionError, IndexError):
        return False
    if guard is False:
        return False
    w_comb, p_comb = guard
    tau_prep, g2_prep = srs.prepared_pair()
    return pairing_check([(w_comb, tau_prep), (G1.neg(p_comb), g2_prep)], threads)


def verify_proofs_batched(srs, vk: VerifyingKey, proofs, instances=None,
                          rng=None, threads: int | None = None):
    """Batch verification: the AccumulatorStrategy analog (the reference
    verifies through `AccumulatorStrategy::finalize`, which defers the
    pairing work so it can amortize over many proofs —
    reference/benches/delay_enc.rs:153-165).

    Each proof's GWC equation reduces to a pair (w_i, p_i) with
    e(w_i, [tau]_2) == e(p_i, [1]_2); folding with verifier-local random
    scalars r_i gives ONE pairing check
        e(sum_i r_i w_i, [tau]_2) == e(sum_i r_i p_i, [1]_2),
    sound except with probability ~N/|Fr|.  All scalar/quotient identities
    are still checked per proof.  Returns one bool for the whole batch
    (finalize semantics); on a False the caller can fall back to
    per-proof verify_proof to locate the offender.  `threads` as in
    verify_proof."""
    import secrets

    instances = instances or [[] for _ in proofs]
    guards = []
    for proof, inst in zip(proofs, instances):
        try:
            g = _verify(srs, vk, proof, inst or [], threads)
        except (ValueError, AssertionError, IndexError):
            return False
        if g is False:
            return False
        guards.append(g)
    if not guards:
        return True
    if rng is not None:
        rs = [int(rng.integers(1, 1 << 62)) for _ in guards]
    else:
        rs = [secrets.randbelow(P - 1) + 1 for _ in guards]
    w_acc = G1.multi_scalar_mul(rs, [w for w, _ in guards], threads)
    p_acc = G1.multi_scalar_mul(rs, [p for _, p in guards], threads)
    tau_prep, g2_prep = srs.prepared_pair()
    return pairing_check([(w_acc, tau_prep), (G1.neg(p_acc), g2_prep)], threads)


def _verify(srs, vk: VerifyingKey, proof: bytes, instances, threads: int | None):
    """Scalar/quotient checks + GWC combination for one proof.  Returns
    False on any identity failure, else the pairing guard (w_comb, p_comb)
    satisfying e(w_comb, [tau]_2) == e(p_comb, [1]_2) iff the proof is
    valid (the caller runs — or batches — the pairing)."""
    domain = vk.domain
    n = domain.n
    tr = Transcript()
    # vk.hash_into(transcript), mirroring the prover
    tr.common_scalar(vk.transcript_repr)
    for v in instances:
        tr.common_scalar(v)
    rd = _Reader(proof, tr, pre_pts=_predecompress(vk, proof, threads))

    advice_c = [rd.point() for _ in range(NUM_ADVICE)]
    theta = tr.challenge()
    ap_c, sp_c = {}, {}
    for l in LOOKUPS:
        ap_c[l] = rd.point()
        sp_c[l] = rd.point()
    beta = tr.challenge()
    gamma = tr.challenge()
    z_perm_c = rd.point()
    z_l_c = {l: rd.point() for l in LOOKUPS}
    random_c = rd.point()
    y = tr.challenge()
    h_c = [rd.point() for _ in range(QUOTIENT_PIECES)]
    x = tr.challenge()

    # ---- read evals (same order as prover's opens lists) --------------
    names_x = (
        [("advice", c) for c in range(NUM_ADVICE)]
        + [("fixed", name) for name in ALL_FIXED]
        + [("sigma", c) for c in range(len(vk.sigma_commitments))]
        + [("z_perm", 0)]
        + [(f"ap_{l}", 0) for l in LOOKUPS]
        + [(f"sp_{l}", 0) for l in LOOKUPS]
        + [(f"z_{l}", 0) for l in LOOKUPS]
        + [("random", 0)]
        + [("h", i) for i in range(QUOTIENT_PIECES)]
    )
    names_wx = [("advice", 4), ("z_perm", 0)] + [(f"z_{l}", 0) for l in LOOKUPS]
    names_winvx = [(f"ap_{l}", 0) for l in LOOKUPS]

    ev_x = {nm: rd.scalar() for nm in names_x}
    ev_wx = {nm: rd.scalar() for nm in names_wx}
    ev_winvx = {nm: rd.scalar() for nm in names_winvx}

    # ---- 1. quotient identity at x ------------------------------------
    adv = [ev_x[("advice", c)] for c in range(NUM_ADVICE)]
    fx = {name: ev_x[("fixed", name)] for name in ALL_FIXED}
    sig = [ev_x[("sigma", c)] for c in range(len(vk.sigma_commitments))]
    # all Lagrange values this proof needs, with one shared inversion:
    # l_0, l_last, the blinding rows, and one per public input
    lag_idx = ([0, domain.usable_rows]
               + list(range(domain.usable_rows + 1, domain.n))
               + list(range(len(instances))))
    lag = domain.lagranges_at(sorted(set(lag_idx)), x)
    # instance polynomial evaluated directly from the public values
    inst_x = 0
    for j, v in enumerate(instances):
        inst_x = (inst_x + v * lag[j]) % P
    zp_x = ev_x[("z_perm", 0)]
    zp_wx = ev_wx[("z_perm", 0)]
    e_wx = ev_wx[("advice", 4)]

    l0 = lag[0]
    l_last = lag[domain.usable_rows]
    l_blind = sum(lag[i] for i in range(domain.usable_rows + 1, domain.n)) % P
    mask = (1 - l_last - l_blind) % P

    from .keygen import DELTA

    exprs = []
    gate = (
        fx["q_a"] * adv[0]
        + fx["q_b"] * adv[1]
        + fx["q_c"] * adv[2]
        + fx["q_d"] * adv[3]
        + fx["q_e"] * adv[4]
        + fx["q_mul_ab"] * adv[0] * adv[1]
        + fx["q_mul_cd"] * adv[2] * adv[3]
        + fx["q_e_next"] * e_wx
        + fx["q_constant"]
    ) % P
    exprs.append(gate)

    exprs.append(l0 * (1 - zp_x) % P)
    exprs.append(l_last * (zp_x * zp_x - zp_x) % P)
    left, right = zp_wx, zp_x
    perm_vals = adv + [inst_x]
    dpow = 1
    for c in range(len(perm_vals)):
        left = left * ((perm_vals[c] + beta * sig[c] + gamma) % P) % P
        right = right * ((perm_vals[c] + beta * dpow * x + gamma) % P) % P
        dpow = dpow * DELTA % P
    exprs.append(mask * (left - right) % P)

    s_exp = (fx["table_tag"] + theta * fx["table_tag"] * fx["table_value"]) % P
    for l in LOOKUPS:
        tag = fx[f"tag_{l}"]
        a_exp = (tag + theta * tag * adv[WIRE_COL[l]]) % P
        zl_x = ev_x[(f"z_{l}", 0)]
        zl_wx = ev_wx[(f"z_{l}", 0)]
        ap_x = ev_x[(f"ap_{l}", 0)]
        ap_winvx = ev_winvx[(f"ap_{l}", 0)]
        sp_x = ev_x[(f"sp_{l}", 0)]
        exprs.append(l0 * (1 - zl_x) % P)
        exprs.append(l_last * (zl_x * zl_x - zl_x) % P)
        lhs = zl_wx * (ap_x + beta) * (sp_x + gamma) % P
        rhs = zl_x * (a_exp + beta) * (s_exp + gamma) % P
        exprs.append(mask * (lhs - rhs) % P)
        exprs.append(l0 * (ap_x - sp_x) % P)
        exprs.append(mask * (ap_x - sp_x) * (ap_x - ap_winvx) % P)

    total = exprs[0]
    for e in exprs[1:]:
        total = (total * y + e) % P

    h_x = 0
    xn = pow(x, n, P)
    for i in range(QUOTIENT_PIECES - 1, -1, -1):
        h_x = (h_x * xn + ev_x[("h", i)]) % P
    if total != h_x * domain.vanishing_at(x) % P:
        return False

    # ---- 2. GWC pairing check -----------------------------------------
    v = tr.challenge()
    w_points = [rd.point() for _ in range(3)]
    u = tr.challenge()
    # the proof stream must be fully consumed: trailing bytes would make
    # proofs malleable (distinct byte strings verifying for one statement)
    if rd.off != len(proof):
        return False

    comm_map = {}
    for c in range(NUM_ADVICE):
        comm_map[("advice", c)] = advice_c[c]
    for c in range(len(vk.sigma_commitments)):
        comm_map[("sigma", c)] = vk.sigma_commitments[c]
    for name in ALL_FIXED:
        comm_map[("fixed", name)] = vk.fixed_commitments[name]
    comm_map[("z_perm", 0)] = z_perm_c
    for l in LOOKUPS:
        comm_map[(f"ap_{l}", 0)] = ap_c[l]
        comm_map[(f"sp_{l}", 0)] = sp_c[l]
        comm_map[(f"z_{l}", 0)] = z_l_c[l]
    comm_map[("random", 0)] = random_c
    for i in range(QUOTIENT_PIECES):
        comm_map[("h", i)] = h_c[i]

    x_w = x * domain.omega % P
    x_winv = x * domain.omega_inv % P
    sets = [
        (names_x, ev_x, x),
        (names_wx, ev_wx, x_w),
        (names_winvx, ev_winvx, x_winv),
    ]

    # Flatten the whole GWC combination into two host MSMs:
    #   p_comb = sum_s u^s (z_s W_s + sum_i v^i C_{s,i} - e_s G)
    #   w_comb = sum_s u^s W_s
    # (shared-doubling multi-exponentiation — one Jacobian chain instead of
    # ~40 independent 254-bit scalar muls).  The vk-fixed points (fixed
    # column + sigma commitments + the generator) are partitioned to the
    # front with wNAF tables precomputed ONCE per vk (cached on the vk
    # object): repeat verifications skip their per-call table build and
    # use a wider window.
    fixed_pairs, var_pairs = [], []
    g_scalar = 0
    u_pow = 1
    for (names, evs, z), w_pt in zip(sets, w_points):
        v_pow = 1
        for nm in names:
            sc = u_pow * v_pow % P
            (fixed_pairs if nm[0] in ("fixed", "sigma") else var_pairs).append(
                (sc, comm_map[nm])
            )
            g_scalar = (g_scalar + sc * evs[nm]) % P
            v_pow = v_pow * v % P
        var_pairs.append((u_pow * z % P, w_pt))
        u_pow = u_pow * u % P
    fixed_pairs.append(((-g_scalar) % P, G1_GEN))
    p_comb = _fixed_first_msm(vk, fixed_pairs, var_pairs, threads)
    w_comb = G1.multi_scalar_mul(
        [pow(u, s, P) for s in range(len(w_points))], w_points, threads
    )
    return (w_comb, p_comb)
