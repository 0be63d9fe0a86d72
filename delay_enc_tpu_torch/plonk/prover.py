"""create_proof: the proving pipeline on the card.

Counterpart of `delay_enc_tpu/plonk/prover.py`: the fused 8n quotient, or
the split one for a split-mode key (k >= 18).
Protocol (transcript order is the spec; the verifier mirrors it exactly):

 1. commit the 5 advice columns (blinding rows randomized),
 2. theta; per wire-lookup: build compressed input A = tag + theta*tag*adv
    and table S = table_tag + theta*table_tag*table_value, commit the
    permuted (A', S') pair (halo2 2021 lookup argument),
 3. beta, gamma; commit the permutation grand product Z_perm and the four
    lookup grand products Z_l,
 4. commit a random masking polynomial,
 5. y; build the quotient h = (sum_i y^i expr_i) / (X^n - 1) on the 8n
    extended coset (fused, or a size-n coset at a time in split mode),
    split into 7 size-n pieces, commit each,
 6. x; batch-evaluate every opened polynomial at x / omega*x / omega^-1*x,
 7. v; GWC multiopen: one witness commitment per point, W = (Q - Q(z))/(X-z).

`rng` is drawn from in exactly the JAX package's order (advice blinding,
lookup pads, grand-product blinds, the random poly), so the same circuit,
SRS and seed give the same proof bytes.  The helpers below the draws (the
columns, the commitments, the open sets, the phase spans) are shared with
the batched prover (`plonk/batch_prover.py`).
"""

from __future__ import annotations

import time as _time

import numpy as np
import torch

from ..cs.builder import Builder, NUM_ADVICE
from ..cs.range import build_table
from ..fields.bn254 import FR
from ..ops import limbs as L
from ..ops.ntt import powers
from ..ops.poly import powers_of
from ..utils.device import resolve, sync_stream
from ..utils.timers import GLOBAL_METRICS
from .domain import MAX_DEGREE, QUOTIENT_PIECES
from .keygen import ALL_FIXED, LOOKUPS, ProvingKey
from .kernels import (
    _canon_batch,
    _coeff,
    _eval_stack,
    _evals_batch,
    _ext,
    _gp_finish,
    _gp_partials,
    _gwc_witness,
    challenge_words,
    gp_fracs,
    msm_commit_batch,
    quotient_stacked,
    split_quotient,
)
from .transcript import Transcript

WIRE_COL = {"a": 0, "b": 1, "c": 2, "d": 3}
CTX = L.FR_CTX
SCAN = "block"  # the scan every grand product names (ops/poly.py)


def _rand_fr(rng) -> int:
    return FR.from_uniform_bytes(bytes(rng.integers(0, 256, 64, dtype="uint8")))


def _rand_fr_mont_bulk(rng, count: int) -> np.ndarray:
    """count wide-reduced random Fr as (count, 8) Montgomery words, through
    the copied C wide reduction (Python fallback)."""
    raw = rng.integers(0, 256, (count, 64), dtype="uint8")
    from ..native.ec import uniform_to_fr_mont

    out = uniform_to_fr_mont(raw)
    if out is not None:
        return L.limbs_to_words_np(out)
    return CTX.to_mont_np([FR.from_uniform_bytes(bytes(raw[i])) for i in range(count)])


def _table_keys(tbl_tags, tbl_vals, usable: int, theta: int):
    """Lookup permutation support: the range table's rows as u32 pair keys
    (tag << 16 | value) padded with zeros to `usable` rows, plus the
    compressed value tag + theta*tag*value of every key as Montgomery
    words.  Pair keys stand for the 254-bit compressed values: every
    looked-up (tag, value) pair is small (cs/range.py build_table), equal
    keys give equal compressed values, and distinct keys distinct ones
    except with negligible probability over theta."""
    assert all(int(t) < (1 << 16) and int(v) < (1 << 16) for t, v in zip(tbl_tags, tbl_vals)), \
        "u32 pair keys require 16-bit tags and values (cs/range.py widths <= 16)"
    keys = [(int(t) << 16) | int(v) for t, v in zip(tbl_tags, tbl_vals)]
    tkeys = np.asarray(keys, dtype=np.uint32)
    assert np.all(np.diff(tkeys.astype(np.int64)) >= 0), "table keys must be sorted"
    tkeys_padded = np.concatenate([np.zeros(usable - len(keys), np.uint32), tkeys])
    return tkeys_padded, _fvals_mont(tkeys_padded, theta)


def _fvals_mont(keys: np.ndarray, theta: int) -> np.ndarray:
    """(len(keys), 8) Montgomery words of tag + theta*tag*value for every
    u32 pair key (key 0 maps to 0), through the copied C lookup_fvals."""
    from ..native import get_lib

    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    lib = get_lib()
    if lib is not None and hasattr(lib, "lookup_fvals"):
        out = np.empty((len(keys), L.NLIMB), dtype=np.uint32)
        pw, r2w, n0 = CTX._native_consts()
        lib.lookup_fvals(
            keys.ctypes.data, len(keys), theta.to_bytes(32, "little"),
            pw.ctypes.data, r2w.ctypes.data, n0, out.ctypes.data,
        )
        return L.limbs_to_words_np(out)
    p = FR.p
    vals = [(int(k >> 16) + theta * int(k >> 16) % p * int(k & 0xFFFF)) % p for k in keys]
    return CTX.to_mont_np(vals)


def _permuted_columns(tag_col, adv_col, usable: int, tkeys_padded, fvals, wire):
    """halo2's lookup permutation (lookup/prover.rs permute_expression_pair):
    A' = A sorted (grouped by value), S' = the matching table value at each
    first occurrence, the remaining table rows filling the rest.  Computed
    in key space with numpy; returns (usable, 8) Montgomery word arrays
    gathered from `fvals`."""
    rows = len(tag_col)
    keys = np.zeros(usable, dtype=np.uint32)
    t = np.fromiter((int(x) for x in tag_col), dtype=np.uint32, count=rows)

    # tagged rows must hold sub-2^16 values (cs/range.py table widths); a
    # wider value is a buggy witness or gadget: raise here rather than
    # truncate into a possibly valid key
    def masked():
        for i, (tv, av) in enumerate(zip(tag_col, adv_col[:rows])):
            av = int(av)
            if av >= (1 << 16) and int(tv) != 0:
                raise ValueError(
                    f"lookup failure: tagged advice value >= 2^16 at row {i} "
                    f"(wire {wire}, tag={int(tv)}) — buggy witness/gadget"
                )
            yield av & 0xFFFF

    a = np.fromiter(masked(), dtype=np.uint32, count=rows)
    keys[:rows] = np.where(t != 0, (t << 16) | a, 0)

    ks = np.sort(keys)
    is_first = np.empty(usable, dtype=bool)
    is_first[0] = True
    is_first[1:] = ks[1:] != ks[:-1]
    firsts = ks[is_first]
    pos = np.searchsorted(tkeys_padded, firsts, side="left")
    ok = (pos < usable) & (tkeys_padded[np.minimum(pos, usable - 1)] == firsts)
    if not ok.all():
        bad = firsts[~ok][0]
        raise ValueError(
            f"lookup failure: (tag={bad >> 16}, value={bad & 0xFFFF}) not in table (wire {wire})"
        )
    used = np.zeros(usable, dtype=bool)
    used[pos] = True
    leftovers = tkeys_padded[~used]
    sp_keys = np.empty(usable, dtype=np.uint32)
    sp_keys[is_first] = firsts
    sp_keys[~is_first] = leftovers[: usable - len(firsts)]

    # key -> word row by one searchsorted gather per column (the zero pad
    # keys land on index 0, whose fvals row is 0 by the compression formula)
    ap = fvals[np.searchsorted(tkeys_padded, ks, side="left")]
    sp = fvals[np.searchsorted(tkeys_padded, sp_keys, side="left")]
    return ap, sp


def _advice_columns(builder: Builder, n: int, usable: int, rng) -> list:
    """The 5 advice columns, their rows from `usable` on drawn from rng, and
    the instance column (the public values padded with zeros, not blinded),
    as host ints."""
    cols = []
    for c in range(NUM_ADVICE):
        col = list(builder.advice[c]) + [0] * (n - builder.rows)
        for r in range(usable, n):
            col[r] = _rand_fr(rng)
        cols.append(col)
    return cols + [list(builder.instance) + [0] * (n - len(builder.instance))]


def _lookup_columns(builder: Builder, n: int, usable: int, theta: int, rng,
                    separate_pads: bool = False):
    """The permuted lookup columns A'_l and S'_l of the four lookups as
    (4, n, 8) Montgomery words each, their rows from `usable` on drawn from
    rng: one pad a lookup for both columns (the single prover), or a pad for
    A'_l then one for S'_l (the batched prover, JAX batch_prover.py:186)."""
    tbl_tags, tbl_vals = build_table(builder.lookup_widths)
    tkeys_padded, fvals = _table_keys(tbl_tags, tbl_vals, usable, theta)
    ap_cols, sp_cols = [], []
    for l in LOOKUPS:
        ap, sp = _permuted_columns(
            builder.fixed[f"tag_{l}"], builder.advice[WIRE_COL[l]],
            usable, tkeys_padded, fvals, l,
        )
        pad = CTX.to_mont_np([_rand_fr(rng) for _ in range(n - usable)])
        pad2 = CTX.to_mont_np([_rand_fr(rng) for _ in range(n - usable)]) if separate_pads \
            else pad
        ap_cols.append(np.concatenate([ap, pad]))
        sp_cols.append(np.concatenate([sp, pad2]))
    return np.stack(ap_cols), np.stack(sp_cols)


def _commit(pair_tables, coeffs) -> list:
    """Host affine commitments to (m, n, 8) Montgomery coefficient rows (a
    tensor or a list of rows), in one batch of MSMs."""
    stack = coeffs if isinstance(coeffs, torch.Tensor) else torch.stack(coeffs)
    return msm_commit_batch(pair_tables, _canon_batch(stack))


def _open_sets(pk: ProvingKey, advice, z_perm, z_l, ap, sp, random, h_pieces) -> list:
    """The rows opened at x, omega x and omega^-1 x, in the verifier's order.
    advice: the 5 advice rows; z_l, ap, sp: the 4 lookups' rows each;
    h_pieces: the quotient's 7 pieces."""
    opens_x = (list(advice) + [pk.fixed_coeff[name] for name in ALL_FIXED]
               + list(pk.sigma_coeff) + [z_perm] + list(ap) + list(sp) + list(z_l)
               + [random] + list(h_pieces))
    return [opens_x, [advice[4], z_perm] + list(z_l), list(ap)]


def _points(domain, x: int) -> list:
    """The opening points x, omega x and omega^-1 x."""
    return [x, x * domain.omega % FR.p, x * domain.omega_inv % FR.p]


class _Spans:
    """Phase spans of one proof (or batch) into GLOBAL_METRICS: each phase
    ends by waiting for the calling thread's stream on each of `devices`
    (one device, or a mesh's), not the whole device, so concurrent provers
    do not wait for each other."""

    def __init__(self, devices, prefix: str):
        self.devices = list(devices) if isinstance(devices, (list, tuple)) else [devices]
        self.prefix = prefix
        self.t = _time.time()

    def __call__(self, name: str) -> None:
        for device in self.devices:
            sync_stream(device)
        now = _time.time()
        GLOBAL_METRICS.add(f"{self.prefix}/{name}", now - self.t)
        self.t = now


def create_proof(srs, pk: ProvingKey, builder: Builder, rng=None, device="cuda",
                 msm: str = "b4", selfcheck: int = 0, checks: list | None = None) -> bytes:
    """A proof for the builder's witness.  `msm` picks the commitments' pair
    tables, "b4" or "b16" (`SRS.msm_tables`); both give the same bytes.
    `selfcheck` 1 checks every commitment against the host's C MSM, 2 also
    the GWC witnesses (`plonk/selfcheck.py`); each result goes to stderr
    and, as a (label, ok) pair, to `checks` where given.  The bytes do not
    change."""
    device = resolve(device)
    if selfcheck not in (0, 1, 2):
        raise ValueError(f"selfcheck level {selfcheck!r}: 0, 1 or 2")
    if pk.device != device or srs.device != device:
        raise ValueError(f"keys on {pk.device} and SRS on {srs.device}, proof asked for {device}")
    _phase = _Spans(device, "prove")

    if rng is None:
        rng = np.random.default_rng()
    ctx = CTX
    domain = pk.vk.domain
    n, usable = domain.n, domain.usable_rows
    srs = srs.truncated(domain.k)
    plan, plan_ext = domain.plan(device), domain.plan_ext(device)

    def mont1(x: int) -> torch.Tensor:
        return L.to_device_mont(ctx, [x], device)  # (1, 8)

    def dev(words: np.ndarray) -> torch.Tensor:
        return L.to_tensor(words, device)

    tr = Transcript()
    # vk.hash_into(transcript): the vk's transcript_repr comes first
    tr.common_scalar(pk.vk.transcript_repr)
    # bind the public inputs (instance column values)
    for v in builder.instance:
        tr.common_scalar(v)

    pair_tables = srs.msm_tables(msm)
    if selfcheck:
        from . import selfcheck as SC

    def record(label: str, results) -> None:
        if checks is not None:
            checks.extend((f"{label}[{j}]", ok) for j, ok in enumerate(results))

    def commit_many(coeffs, tag: str):
        pts = _commit(pair_tables, coeffs)
        if selfcheck:
            record(tag, SC.check_commits(srs, coeffs, pts, tag))
        return pts

    # ---- 1. advice columns -------------------------------------------
    raw6 = dev(np.stack([ctx.to_mont_np(col) for col in _advice_columns(builder, n, usable, rng)]))
    coeffs6 = _coeff(raw6, plan)
    advice_coeff = [coeffs6[c] for c in range(NUM_ADVICE)]
    instance_coeff = coeffs6[NUM_ADVICE]
    for pt in commit_many(coeffs6[:NUM_ADVICE], "advice"):
        tr.write_point(pt)
    _phase("advice commit")

    # ---- 2. lookups ---------------------------------------------------
    theta = tr.challenge()

    ap_host, sp_host = _lookup_columns(builder, n, usable, theta, rng)
    lk_raw = dev(np.concatenate([ap_host, sp_host]))
    lk8 = _coeff(lk_raw, plan)
    ap_coeff = {l: lk8[i] for i, l in enumerate(LOOKUPS)}
    sp_coeff = {l: lk8[4 + i] for i, l in enumerate(LOOKUPS)}
    for pt in commit_many([c for l in LOOKUPS for c in (ap_coeff[l], sp_coeff[l])], "lookup"):
        tr.write_point(pt)
    _phase("lookup permuted")

    # ---- 3. grand products -------------------------------------------
    beta = tr.challenge()
    gamma = tr.challenge()
    active = torch.arange(n, device=device) < usable

    omega_dev = powers(ctx, domain.omega, n, device)
    sigma_raw = _evals_batch(torch.stack(pk.sigma_coeff), plan)
    # all 5 grand products (permutation + 4 lookups) batched; y is not drawn yet
    num, den = gp_fracs(raw6, sigma_raw, omega_dev, pk.raw_stack, lk_raw,
                        challenge_words(theta, beta, gamma, 0, pk.delta_powers), usable)
    num_a, pre, suf, totals = _gp_partials(num, den, active, SCAN)
    del num, den
    total_ints = L.from_device_mont(ctx, totals)
    if any(t == 0 for t in total_ints):
        raise ValueError("grand product denominator vanished")
    total_inv_m = L.to_device_mont(ctx, [pow(t, -1, FR.p) for t in total_ints], device)
    blind = dev(ctx.to_mont_np([_rand_fr(rng) for _ in range(5 * (n - usable - 1))])
                ).reshape(5, n - usable - 1, L.NW)
    z5 = _gp_finish(num_a, pre, suf, total_inv_m, blind, SCAN)
    z5_coeff = _coeff(z5, plan)
    z_perm_coeff = z5_coeff[0]
    z_lookup_coeff = {l: z5_coeff[1 + i] for i, l in enumerate(LOOKUPS)}
    for pt in commit_many(z5_coeff, "gp"):
        tr.write_point(pt)
    _phase("grand products")

    # ---- 4. random poly ----------------------------------------------
    random_coeff = dev(_rand_fr_mont_bulk(rng, n))
    tr.write_point(commit_many([random_coeff], "random")[0])

    # ---- 5. quotient ---------------------------------------------------
    y = tr.challenge()

    witness_coeffs = (
        advice_coeff
        + [instance_coeff, z_perm_coeff]
        + [z_lookup_coeff[l] for l in LOOKUPS]
        + [ap_coeff[l] for l in LOOKUPS]
        + [sp_coeff[l] for l in LOOKUPS]
    )
    del lk_raw, num_a, pre, suf, omega_dev, sigma_raw
    consts = challenge_words(theta, beta, gamma, y, pk.delta_powers)
    if pk.split:
        h_coeff = split_quotient(witness_coeffs, pk, consts, plan, plan_ext)
    else:
        # one batched extended-coset NTT for every opened witness polynomial
        ext_stack = _ext(torch.stack(witness_coeffs), pk.zeta_powers, plan_ext)
        h_coeff = quotient_stacked(ext_stack, pk.ext_stack, pk.x_ext,
                                   pk.zh_inv_ext[:MAX_DEGREE], consts, pk.quotient_unscale,
                                   plan_ext)
        # the extended-domain arrays are not needed by the openings
        del ext_stack
    h_pieces = [h_coeff[i * n : (i + 1) * n] for i in range(QUOTIENT_PIECES)]
    for pt in commit_many(h_coeff[: QUOTIENT_PIECES * n].reshape(QUOTIENT_PIECES, n, L.NW),
                          "quotient"):
        tr.write_point(pt)
    _phase("quotient")

    # ---- 6. evaluations ------------------------------------------------
    x = tr.challenge()
    # the powers of each point serve its evaluations and its GWC witness; K7
    # takes the opened rows where they lie, every point in one launch
    stacks = _open_sets(pk, advice_coeff, z_perm_coeff,
                        [z_lookup_coeff[l] for l in LOOKUPS], [ap_coeff[l] for l in LOOKUPS],
                        [sp_coeff[l] for l in LOOKUPS], random_coeff, h_pieces)
    points = _points(domain, x)
    point_pows = [powers_of(ctx, mont1(p)[0], n) for p in points]
    for e in L.from_device_mont(ctx, _eval_stack(stacks, point_pows)):
        tr.write_scalar(e)
    _phase("evals")

    # ---- 7. GWC multiopen ---------------------------------------------
    # the three W commitments share one challenge, so their MSMs batch
    v = tr.challenge()
    ws = _gwc_witness(stacks, point_pows, mont1(v)[0],
                      [mont1(pow(p, -1, FR.p))[0] for p in points])
    if selfcheck >= 2:
        for rows, w, z, key in zip(stacks, ws, points, ("x", "wx", "winvx")):
            record(f"gwc {key}", [SC.check_gwc_witness(rows, w, v, z, key)])
    for pt in commit_many(ws, "gwc"):
        tr.write_point(pt)
    _phase("gwc")

    return bytes(tr.data)

