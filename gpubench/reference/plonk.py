"""The plain reference of a proof: the statement's verifying key worked out
again at the SRS's secret, and a verifier that reads a proof's bytes.

The protocol is halo2's PLONK with KZG on BN254 and GWC openings, over one
gate family and four tagged range lookups (the circuits of delay_enc,
mod_pow and pose_enc):

    q_a*a + q_b*b + q_c*c + q_d*d + q_e*e
      + q_mul_ab*a*b + q_mul_cd*c*d + q_e_next*e(wX) + q_constant = 0
    (tag_l, l * tag_l-active) in (table_tag, table_value),  l in a, b, c, d

with a permutation over the five advice columns and the instance column,
a Blake2b transcript (halo2's `Blake2bWrite<Challenge255>`), 7 quotient
pieces and 6 blinding rows.

The benchmark draws the SRS's secret tau from its seed and gives it to the
program's SRS setup, so the reference knows it.  A commitment to the
polynomial p is then p(tau) * G, which lets the reference

  * work out every commitment of the verifying key from the statement's
    columns alone: p(tau) = sum_i p(omega^i) L_i(tau), in Fr, and
  * close a proof's KZG check without a pairing: e(W, [tau]_2) = e(P, [1]_2)
    holds exactly when tau * W = P, since G1 has prime order.

A statement is plain data: {"k", "rows", "fixed": {name: [int]},
"copies": [((col, row), (col, row))], "lookup_widths": [int],
"instance": [int]}.  Nothing here imports the program under test.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from . import bn254 as C

R = C.R
NUM_ADVICE = 5
NUM_PERM_COLS = NUM_ADVICE + 1  # the five advice columns and the instance column
SELECTOR_NAMES = ("q_a", "q_b", "q_c", "q_d", "q_e", "q_mul_ab", "q_mul_cd", "q_e_next",
                  "q_constant")
TAG_NAMES = ("tag_a", "tag_b", "tag_c", "tag_d")
ALL_FIXED = SELECTOR_NAMES + TAG_NAMES + ("table_tag", "table_value")
LOOKUPS = ("a", "b", "c", "d")
WIRE_COL = {"a": 0, "b": 1, "c": 2, "d": 3}
QUOTIENT_PIECES = 7
BLINDING_ROWS = 6
EXT_LOG = 3
DELTA = pow(C.FR_GENERATOR, 1 << C.FR_TWO_ADICITY, R)


@dataclass
class Domain:
    k: int

    def __post_init__(self):
        self.n = 1 << self.k
        self.usable = self.n - BLINDING_ROWS - 1
        self.omega = C.root_of_unity(self.k)
        self.omega_inv = pow(self.omega, -1, R)

    def lagranges_at(self, idxs, x: int) -> dict:
        """{i: L_i(x)}, L_i(x) = omega^i (x^n - 1) / (n (x - omega^i))."""
        idxs = list(idxs)
        xn1 = (pow(x, self.n, R) - 1) % R
        ws = [pow(self.omega, i, R) for i in idxs]
        invs = C.batch_inverse([self.n * (x - w) % R for w in ws], R)
        return {i: w * xn1 % R * d % R for i, w, d in zip(idxs, ws, invs)}

    def omega_powers(self) -> list:
        ws, w = [], 1
        for _ in range(self.n):
            ws.append(w)
            w = w * self.omega % R
        return ws

    def all_lagranges_at(self, x: int, ws: list) -> list:
        """[L_0(x), ..., L_{n-1}(x)] with one inversion, given the powers
        of omega."""
        invs = C.batch_inverse([(x - wi) % R for wi in ws], R)
        c = (pow(x, self.n, R) - 1) * pow(self.n, -1, R) % R
        return [c * wi % R * d % R for wi, d in zip(ws, invs)]


@dataclass
class VerifyingKey:
    domain: Domain
    fixed_points: dict  # name -> affine point
    fixed_at_tau: dict  # name -> the column's polynomial at tau
    sigma_points: list
    sigma_at_tau: list
    transcript_repr: int

    def entries(self) -> list:
        """[(name, value)] of everything a vk is compared by."""
        return ([(f"fixed.{n}", self.fixed_points[n]) for n in ALL_FIXED]
                + [(f"sigma.{c}", p) for c, p in enumerate(self.sigma_points)]
                + [("transcript_repr", self.transcript_repr)])


def lookup_table(widths) -> tuple:
    """(table_tag, table_value): the inactive row (0, 0), then for each
    width w in increasing order the rows (w, 0 .. 2^w - 1)."""
    tags, values = [0], [0]
    for w in sorted(widths):
        tags.extend([w] * (1 << w))
        values.extend(range(1 << w))
    return tags, values


def copy_cycles(copies) -> list:
    """The equivalence classes of the copied cells, each sorted."""
    parent: dict = {}

    def find(a):
        while parent.get(a, a) != a:
            parent[a] = parent.get(parent[a], parent[a])
            a = parent[a]
        return a

    for u, v in copies:
        ru, rv = find(tuple(u)), find(tuple(v))
        if ru != rv:
            parent[ru] = rv
    groups: dict = {}
    for cell in {tuple(c) for pair in copies for c in pair}:
        groups.setdefault(find(cell), []).append(cell)
    return [sorted(g) for g in groups.values() if len(g) > 1]


def _pinned(domain: Domain, fixed_points: dict, sigma_points: list) -> bytes:
    """The description of the verifying key that the transcript hashes first."""
    def fe(v: int) -> str:
        return f"0x{v:064x}"

    def pt(p) -> str:
        return "(0x0, 0x0)" if p is None else f"({fe(p[0])}, {fe(p[1])})"

    return "".join([
        "PinnedVerificationKey { base_modulus: \"", fe(C.Q),
        "\", scalar_modulus: \"", fe(R),
        "\", domain: PinnedEvaluationDomain { k: ", str(domain.k),
        ", extended_k: ", str(domain.k + EXT_LOG),
        ", omega: ", fe(domain.omega),
        " }, cs: PinnedConstraintSystem { num_fixed_columns: ", str(len(ALL_FIXED)),
        ", num_advice_columns: ", str(NUM_ADVICE),
        ", num_instance_columns: 1, num_selectors: 0",
        ", gate: maingate5(q_a*a + q_b*b + q_c*c + q_d*d + q_e*e",
        " + q_mul_ab*a*b + q_mul_cd*c*d + q_e_next*e_next + q_constant)",
        ", lookups: [a, b, c, d] in (table_tag, table_value)",
        ", permutation: Argument { columns: [a, b, c, d, e, instance] } }",
        ", fixed_commitments: [", ", ".join(pt(fixed_points[n]) for n in ALL_FIXED),
        "], permutation: VerifyingKey { commitments: [",
        ", ".join(pt(p) for p in sigma_points), "] } }",
    ]).encode()


def transcript_repr(pinned: bytes) -> int:
    h = hashlib.blake2b(digest_size=64, person=b"Halo2-Verify-Key")
    h.update(len(pinned).to_bytes(8, "little"))
    h.update(pinned)
    return C.fr_from_uniform(h.digest())


def verifying_key(statement: dict, tau: int) -> VerifyingKey:
    """The statement's verifying key on the SRS of secret tau."""
    domain = Domain(statement["k"])
    n = domain.n
    if statement["rows"] > domain.usable:
        raise ValueError(f"{statement['rows']} rows exceed the {domain.usable} usable at "
                         f"k={domain.k}")
    if pow(tau, n, R) == 1:
        raise ValueError("tau lies in the domain")
    ws = domain.omega_powers()
    lag = domain.all_lagranges_at(tau, ws)
    cols = {name: statement["fixed"][name] for name in SELECTOR_NAMES + TAG_NAMES}
    cols["table_tag"], cols["table_value"] = lookup_table(statement["lookup_widths"])
    fixed_at_tau = {}
    for name in ALL_FIXED:
        col = cols[name]
        if len(col) > domain.usable:
            raise ValueError(f"column {name} has {len(col)} rows")
        fixed_at_tau[name] = sum(v * lag[i] for i, v in enumerate(col) if v) % R
    # sigma_c starts as the identity labelling delta^c omega^r, whose
    # polynomial is delta^c X; each copy cycle then rotates its labels
    deltas = [pow(DELTA, c, R) for c in range(NUM_PERM_COLS)]
    sigma_at_tau = [d * tau % R for d in deltas]
    for cycle in copy_cycles(statement["copies"]):
        labels = [deltas[c] * ws[r] % R for c, r in cycle]
        for i, (c, r) in enumerate(cycle):
            moved = labels[(i + 1) % len(cycle)] - labels[i]
            sigma_at_tau[c] = (sigma_at_tau[c] + moved * lag[r]) % R
    fixed_points = {name: C.mul(v, C.GEN) for name, v in fixed_at_tau.items()}
    sigma_points = [C.mul(v, C.GEN) for v in sigma_at_tau]
    return VerifyingKey(domain, fixed_points, fixed_at_tau, sigma_points, sigma_at_tau,
                        transcript_repr(_pinned(domain, fixed_points, sigma_points)))


class _Transcript:
    """halo2's Blake2b transcript: prefixes 0 (challenge), 1 (point), 2
    (scalar); a challenge hashes a copy of the state."""

    def __init__(self):
        self.state = hashlib.blake2b(digest_size=64, person=b"Halo2-Transcript")

    def point(self, pt) -> None:
        self.state.update(b"\x01")
        if pt is None:
            self.state.update(b"\x00" * 64)
        else:
            self.state.update(pt[0].to_bytes(32, "little") + pt[1].to_bytes(32, "little"))

    def scalar(self, v: int) -> None:
        self.state.update(b"\x02" + v.to_bytes(32, "little"))

    def challenge(self) -> int:
        self.state.update(b"\x00")
        return C.fr_from_uniform(self.state.digest())


class _Reader:
    def __init__(self, data: bytes, tr: _Transcript):
        self.data, self.off, self.tr = data, 0, tr

    def _next(self) -> bytes:
        if self.off + 32 > len(self.data):
            raise ValueError("proof too short")
        b = self.data[self.off:self.off + 32]
        self.off += 32
        return b

    def point(self):
        pt = C.from_bytes(self._next())
        self.tr.point(pt)
        return pt

    def scalar(self) -> int:
        v = int.from_bytes(self._next(), "little")
        if v >= R:
            raise ValueError("non-canonical scalar")
        self.tr.scalar(v)
        return v


def verify(vk: VerifyingKey, tau: int, proof: bytes, instance=()) -> tuple:
    """(True, "") if the proof verifies for the statement of vk and these
    public inputs, else (False, why)."""
    try:
        return _verify(vk, tau, proof, list(instance))
    except ValueError as e:
        return False, str(e)


def _verify(vk: VerifyingKey, tau: int, proof: bytes, instance: list) -> tuple:
    domain = vk.domain
    tr = _Transcript()
    tr.scalar(vk.transcript_repr)
    for v in instance:
        tr.scalar(v % R)
    rd = _Reader(proof, tr)

    advice_c = [rd.point() for _ in range(NUM_ADVICE)]
    theta = tr.challenge()
    ap_c, sp_c = {}, {}
    for l in LOOKUPS:
        ap_c[l], sp_c[l] = rd.point(), rd.point()
    beta, gamma = tr.challenge(), tr.challenge()
    z_perm_c = rd.point()
    z_l_c = {l: rd.point() for l in LOOKUPS}
    random_c = rd.point()
    y = tr.challenge()
    h_c = [rd.point() for _ in range(QUOTIENT_PIECES)]
    x = tr.challenge()

    names_x = ([("advice", c) for c in range(NUM_ADVICE)]
               + [("fixed", name) for name in ALL_FIXED]
               + [("sigma", c) for c in range(NUM_PERM_COLS)]
               + [("z_perm", 0)]
               + [(f"ap_{l}", 0) for l in LOOKUPS]
               + [(f"sp_{l}", 0) for l in LOOKUPS]
               + [(f"z_{l}", 0) for l in LOOKUPS]
               + [("random", 0)]
               + [("h", i) for i in range(QUOTIENT_PIECES)])
    names_wx = [("advice", 4), ("z_perm", 0)] + [(f"z_{l}", 0) for l in LOOKUPS]
    names_winvx = [(f"ap_{l}", 0) for l in LOOKUPS]
    ev_x = {nm: rd.scalar() for nm in names_x}
    ev_wx = {nm: rd.scalar() for nm in names_wx}
    ev_winvx = {nm: rd.scalar() for nm in names_winvx}

    # ---- the constraints at x against h(x) (x^n - 1) ----------------
    adv = [ev_x[("advice", c)] for c in range(NUM_ADVICE)]
    fx = {name: ev_x[("fixed", name)] for name in ALL_FIXED}
    sig = [ev_x[("sigma", c)] for c in range(NUM_PERM_COLS)]
    blind_rows = range(domain.usable + 1, domain.n)
    lag = domain.lagranges_at(sorted({0, domain.usable, *blind_rows, *range(len(instance))}), x)
    inst_x = sum(v * lag[j] for j, v in enumerate(instance)) % R
    zp_x, zp_wx = ev_x[("z_perm", 0)], ev_wx[("z_perm", 0)]
    e_wx = ev_wx[("advice", 4)]
    l0, l_last = lag[0], lag[domain.usable]
    mask = (1 - l_last - sum(lag[i] for i in blind_rows)) % R

    exprs = [(fx["q_a"] * adv[0] + fx["q_b"] * adv[1] + fx["q_c"] * adv[2]
              + fx["q_d"] * adv[3] + fx["q_e"] * adv[4]
              + fx["q_mul_ab"] * adv[0] * adv[1] + fx["q_mul_cd"] * adv[2] * adv[3]
              + fx["q_e_next"] * e_wx + fx["q_constant"]) % R,
             l0 * (1 - zp_x) % R,
             l_last * (zp_x * zp_x - zp_x) % R]
    left, right, dpow = zp_wx, zp_x, 1
    for c, val in enumerate(adv + [inst_x]):
        left = left * ((val + beta * sig[c] + gamma) % R) % R
        right = right * ((val + beta * dpow * x + gamma) % R) % R
        dpow = dpow * DELTA % R
    exprs.append(mask * (left - right) % R)
    s_exp = (fx["table_tag"] + theta * fx["table_tag"] * fx["table_value"]) % R
    for l in LOOKUPS:
        tag = fx[f"tag_{l}"]
        a_exp = (tag + theta * tag * adv[WIRE_COL[l]]) % R
        zl_x, zl_wx = ev_x[(f"z_{l}", 0)], ev_wx[(f"z_{l}", 0)]
        ap_x, ap_winvx = ev_x[(f"ap_{l}", 0)], ev_winvx[(f"ap_{l}", 0)]
        sp_x = ev_x[(f"sp_{l}", 0)]
        exprs += [l0 * (1 - zl_x) % R,
                  l_last * (zl_x * zl_x - zl_x) % R,
                  mask * (zl_wx * (ap_x + beta) * (sp_x + gamma)
                          - zl_x * (a_exp + beta) * (s_exp + gamma)) % R,
                  l0 * (ap_x - sp_x) % R,
                  mask * (ap_x - sp_x) * (ap_x - ap_winvx) % R]
    total = 0
    for e in exprs:
        total = (total * y + e) % R
    xn = pow(x, domain.n, R)
    h_x = 0
    for i in range(QUOTIENT_PIECES - 1, -1, -1):
        h_x = (h_x * xn + ev_x[("h", i)]) % R
    if total != h_x * (xn - 1) % R:
        return False, "the constraints at x differ from h(x) (x^n - 1)"

    # ---- the GWC openings, closed at tau ----------------------------
    v = tr.challenge()
    w_points = [rd.point() for _ in range(3)]
    u = tr.challenge()
    if rd.off != len(proof):
        return False, "trailing bytes after the proof"

    comm = {("advice", c): advice_c[c] for c in range(NUM_ADVICE)}
    comm[("z_perm", 0)] = z_perm_c
    for l in LOOKUPS:
        comm[(f"ap_{l}", 0)], comm[(f"sp_{l}", 0)] = ap_c[l], sp_c[l]
        comm[(f"z_{l}", 0)] = z_l_c[l]
    comm[("random", 0)] = random_c
    for i in range(QUOTIENT_PIECES):
        comm[("h", i)] = h_c[i]
    known = {("fixed", name): vk.fixed_at_tau[name] for name in ALL_FIXED}
    known.update({("sigma", c): vk.sigma_at_tau[c] for c in range(NUM_PERM_COLS)})

    # P = sum_s u^s (z_s W_s + sum_i v^i C_{s,i} - e_s G), W = sum_s u^s W_s;
    # the key's commitments enter as their polynomials at tau times G
    scalars, points, g_scalar, u_pow = [], [], 0, 1
    sets = [(names_x, ev_x, x), (names_wx, ev_wx, x * domain.omega % R),
            (names_winvx, ev_winvx, x * domain.omega_inv % R)]
    for (names, evs, z), w_pt in zip(sets, w_points):
        v_pow = 1
        for nm in names:
            sc = u_pow * v_pow % R
            if nm in known:
                g_scalar += sc * known[nm]
            else:
                scalars.append(sc)
                points.append(comm[nm])
            g_scalar -= sc * evs[nm]
            v_pow = v_pow * v % R
        scalars.append(u_pow * z % R)
        points.append(w_pt)
        u_pow = u_pow * u % R
    p_comb = C.msm(scalars + [g_scalar % R], points + [C.GEN])
    w_comb = C.msm([pow(u, s, R) for s in range(3)], w_points)
    if C.mul(tau, w_comb) != p_comb:
        return False, "the openings do not hold"
    return True, ""
