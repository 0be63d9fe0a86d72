"""create_proof: the proving pipeline on the card.

Counterpart of `delay_enc_tpu/plonk/prover.py`: the fused 8n quotient, or
the split one for a split-mode key (k >= 18).  The JAX package's
DELAY_ENC_NTT=mxu is the argument `ntt="mxu"` here: every transform of a
fused-quotient proof through the matmul NTT (K11); its
DELAY_ENC_PROFILE_FINE is `fine=True`: the sub-phase marks as spans.
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
columns, the commitments, the open sets) are shared with the batched prover
(`plonk/batch_prover.py`).

Spans (`utils/timers.py`): a proof is the root span `prove`, its phases
the spans `advice commit`, `lookup permuted`, `grand products` (each
from the phase's challenges to its commitments), `quotient` (the random
polynomial's commitment too), `evals` and `gwc`; they tile the root.  No
phase waits for the device to close: each ends by reading its result to
the host.  Inside them the host's work is named where it happens: the
spans `columns` (the advice columns, the lookups' table keys, the random
polynomial), `permute` (the lookup permutation) and `split` (a split-mode
key's quotient: its cosets and inverse, enqueued) here, `to_mont`, `htod`
and `device wait` in `ops/limbs.py`, `fold` in `ops/msm.py`.
"""

from __future__ import annotations

import time

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
    the copied C wide reduction (Python fallback); the span `columns`."""
    from ..native.ec import uniform_to_fr_mont

    with GLOBAL_METRICS.span("columns"):
        raw = rng.integers(0, 256, (count, 64), dtype="uint8")
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
    in key space over the table's keys; returns (usable, 8) Montgomery word
    arrays copied from `fvals`.

    Two passes.  The keys (`_lookup_keys`): the tag and wire columns read
    together into u32 pair keys, in C (`native/pyints.c:lookup_keys`, the
    GIL held) for as long as the rows hold small exact ints, in Python from
    the first row that does not.  The columns (`_permute_by_count`): each
    key counted against the table's sorted keys, then each row of A' and S'
    written once from `fvals` (`native/limbops.c:lookup_permute`, the GIL
    released; the same counting in numpy without the C library).  Nothing
    is kept across calls."""
    keys = _lookup_keys(tag_col, adv_col, wire)
    return _permute_by_count(keys, usable, tkeys_padded, fvals, wire)


def _lookup_keys(tag_col, adv_col, wire) -> np.ndarray:
    """The u32 pair keys tag << 16 | value of a lookup's rows (0 where the
    tag is 0), one a row of `tag_col`.  `native/pyints.c` reads lists and
    tuples while each tag, and each tagged row's value, is an exact int in
    [0, 2^16); from the first row that is not (a bool, a numpy scalar, a
    wide or negative int, any row of another sequence), Python reads to the
    end by the rule below.  The counters `permute native` and
    `permute python` count the rows that took each way."""
    from ..native import get_pyints

    rows = len(tag_col)
    keys = np.empty(rows, dtype=np.uint32)
    done = 0
    if isinstance(tag_col, (list, tuple)) and isinstance(adv_col, (list, tuple)):
        pyints = get_pyints()
        if pyints is not None:
            done = pyints.lookup_keys(tag_col, adv_col, rows, keys.ctypes.data)
    GLOBAL_METRICS.count("permute native", done)
    GLOBAL_METRICS.count("permute python", rows - done)
    if done == rows:
        return keys
    tags = tag_col[done:rows]
    t = np.fromiter((int(x) for x in tags), dtype=np.uint32, count=rows - done)

    # tagged rows must hold sub-2^16 values (cs/range.py table widths); a
    # wider value is a buggy witness or gadget: raise here rather than
    # truncate into a possibly valid key
    def masked():
        for i, (tv, av) in enumerate(zip(tags, adv_col[done:rows]), done):
            av = int(av)
            if av >= (1 << 16) and int(tv) != 0:
                raise ValueError(
                    f"lookup failure: tagged advice value >= 2^16 at row {i} "
                    f"(wire {wire}, tag={int(tv)}) — buggy witness/gadget"
                )
            yield av & 0xFFFF

    a = np.fromiter(masked(), dtype=np.uint32, count=rows - done)
    keys[done:] = np.where(t != 0, (t << 16) | a, 0)
    return keys


def _permute_by_count(keys, usable: int, tkeys_padded, fvals, wire):
    """A' and S' of the keys (the rows past them key 0) against the sorted
    padded table `tkeys_padded` by counting: A' is each table key repeated
    by its count, in the table's order; S' holds each used key at the first
    row of its run in A', and the table's other rows, in order, at the
    others.  Equal table keys (the zero padding) form a group, whose first
    row's `fvals` stand for it.  Raises the lookup failure of the smallest
    key not in the table."""
    from ..native import get_lib

    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    table = np.ascontiguousarray(tkeys_padded, dtype=np.uint32)
    fvals = np.ascontiguousarray(fvals, dtype=np.uint32)
    rows = len(keys)
    if rows > usable or table.shape != (usable,) or fvals.shape != (usable, L.NW):
        raise ValueError(f"lookup: {rows} keys, a table of {table.shape} and values of "
                         f"{fvals.shape} for {usable} usable rows (wire {wire})")
    lib = get_lib()
    if lib is not None:
        ap = np.empty((usable, L.NW), dtype=np.uint32)
        sp = np.empty((usable, L.NW), dtype=np.uint32)
        missing = lib.lookup_permute(keys.ctypes.data, rows, usable, table.ctypes.data,
                                     fvals.ctypes.data, ap.ctypes.data, sp.ctypes.data)
        if missing == -2:
            raise MemoryError("lookup_permute")
        if missing >= 0:
            _not_in_table(missing, wire)
        return ap, sp
    full = np.zeros(usable, dtype=np.uint32)
    full[:rows] = keys
    is_first = np.empty(usable, dtype=bool)
    is_first[:1] = True
    is_first[1:] = table[1:] != table[:-1]
    first = np.flatnonzero(is_first)
    group = np.cumsum(is_first) - 1  # each table row's group
    gkeys = table[first]
    j = np.searchsorted(gkeys, full)
    found = gkeys[np.minimum(j, len(gkeys) - 1)] == full
    if not found.all():
        _not_in_table(int(full[~found].min()), wire)
    count = np.bincount(j, minlength=len(first))
    ap = fvals[np.repeat(first, count)]
    used = count > 0
    starts = (np.cumsum(count) - count)[used]
    at_start = np.zeros(usable, dtype=bool)
    at_start[starts] = True
    taken = np.zeros(usable, dtype=bool)
    taken[first[used]] = True
    src = np.empty(usable, dtype=np.int64)
    src[starts] = first[used]
    src[~at_start] = first[group[~taken]]
    return ap, fvals[src]


def _not_in_table(key: int, wire):
    raise ValueError(
        f"lookup failure: (tag={key >> 16}, value={key & 0xFFFF}) not in table (wire {wire})"
    )


def _advice_columns(builder: Builder, n: int, usable: int, rng) -> list:
    """The 5 advice columns, their rows from `usable` on drawn from rng, and
    the instance column (the public values padded with zeros, not blinded),
    as host ints; the span `columns`."""
    with GLOBAL_METRICS.span("columns"):
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
    A'_l then one for S'_l (the batched prover, JAX batch_prover.py:186).
    The table's keys and the columns' assembly are the spans `columns`,
    each permutation `permute`."""
    with GLOBAL_METRICS.span("columns"):
        tbl_tags, tbl_vals = build_table(builder.lookup_widths)
        tkeys_padded, fvals = _table_keys(tbl_tags, tbl_vals, usable, theta)
    ap_cols, sp_cols = [], []
    for l in LOOKUPS:
        with GLOBAL_METRICS.span("permute"):
            ap, sp = _permuted_columns(
                builder.fixed[f"tag_{l}"], builder.advice[WIRE_COL[l]],
                usable, tkeys_padded, fvals, l,
            )
        pad = CTX.to_mont_np([_rand_fr(rng) for _ in range(n - usable)])
        pad2 = CTX.to_mont_np([_rand_fr(rng) for _ in range(n - usable)]) if separate_pads \
            else pad
        with GLOBAL_METRICS.span("columns"):
            ap_cols.append(np.concatenate([ap, pad]))
            sp_cols.append(np.concatenate([sp, pad2]))
    with GLOBAL_METRICS.span("columns"):
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


def _fine_marks(device):
    """`fine=True`'s marks: mark(name) adds the seconds since the mark
    before (the first: since this call) as `prove/fine/<name>`, having
    first waited for the calling thread's stream unless sync=False."""
    last = [time.perf_counter_ns()]

    def mark(name: str, sync: bool = True) -> None:
        if sync:
            sync_stream(device)
        now = time.perf_counter_ns()
        GLOBAL_METRICS.add(f"prove/fine/{name}", (now - last[0]) * 1e-9)
        last[0] = now

    return mark


def transform_plans(domain, device, ntt: str) -> tuple:
    """The plans of a fused-quotient proof's transforms: (inverse, forward,
    coset, quotient's inverse), the domain's NTT plans for "stockham" (K-b)
    or the matmul NTT's, one a transform, for "mxu" (K11)."""
    if ntt == "mxu":
        return tuple(domain.mxu_plan(kind, device) for kind in ("inv", "fwd", "ext", "ext_inv"))
    plan, plan_ext = domain.plan(device), domain.plan_ext(device)
    return plan, plan, plan_ext, plan_ext


def create_proof(srs, pk: ProvingKey, builder: Builder, rng=None, device="cuda",
                 msm: str = "b4", selfcheck: int = 0, checks: list | None = None,
                 ntt: str = "stockham", fine: bool = False) -> bytes:
    """A proof for the builder's witness.  `msm` picks the commitments' pair
    tables, "b4" or "b16" (`SRS.msm_tables`); both give the same bytes.
    `ntt` picks the transforms' kernel: "stockham" (K-b) or "mxu" (K11,
    the matmul NTT, fused-quotient keys only: a split key with "mxu"
    raises); both give the same bytes.  `selfcheck` 1 checks every
    commitment against the host's C MSM, 2 also the GWC witnesses
    (`plonk/selfcheck.py`); each result goes to stderr and, as a (label,
    ok) pair, to `checks` where given.  `fine` adds the JAX package's
    sub-phase marks (DELAY_ENC_PROFILE_FINE, `prover.py:366-551`) as spans
    `prove/fine/<mark>`, each the seconds since the mark before; where the
    JAX mark blocks on arrays, the span waits for the proof's stream first
    (a split proof has no "phase5 start" and "quotient ext NTT"; "gp omega
    host" times the powers of omega, made on the card here).  The bytes do
    not change with any of them."""
    device = resolve(device)
    if selfcheck not in (0, 1, 2):
        raise ValueError(f"selfcheck level {selfcheck!r}: 0, 1 or 2")
    if ntt not in ("stockham", "mxu"):
        raise ValueError(f"unknown NTT {ntt!r}: 'stockham' or 'mxu'")
    if ntt == "mxu" and pk.split:
        raise ValueError("ntt='mxu' takes a fused-quotient key; this key is split "
                         "(keygen(split=False) builds a fused one)")
    if pk.device != device or srs.device != device:
        raise ValueError(f"keys on {pk.device} and SRS on {srs.device}, proof asked for {device}")
    with GLOBAL_METRICS.span("prove"):
        return _prove(srs, pk, builder, rng, device, msm, selfcheck, checks, ntt, fine)


def _prove(srs, pk: ProvingKey, builder: Builder, rng, device, msm: str, selfcheck: int,
           checks: list | None, ntt: str, fine: bool) -> bytes:
    """create_proof's body, inside its root span `prove`."""
    span = GLOBAL_METRICS.span
    _fine = _fine_marks(device) if fine else lambda name, sync=False: None

    # ---- 1. advice columns -------------------------------------------
    with span("advice commit"):
        if rng is None:
            rng = np.random.default_rng()
        ctx = CTX
        domain = pk.vk.domain
        n, usable = domain.n, domain.usable_rows
        srs = srs.truncated(domain.k)
        plan_inv, plan_fwd, plan_coset, plan_quot = transform_plans(domain, device, ntt)

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

        _fine("phase1 start", sync=False)
        cols6 = _advice_columns(builder, n, usable, rng)
        _fine("advice host build", sync=False)
        words6 = [ctx.to_mont_np(col) for col in cols6]
        with span("columns"):
            words6 = np.stack(words6)
        raw6 = dev(words6)
        del words6, cols6
        _fine("advice to_mont", sync=False)
        coeffs6 = _coeff(raw6, plan_inv)
        _fine("advice iNTT")
        advice_coeff = [coeffs6[c] for c in range(NUM_ADVICE)]
        instance_coeff = coeffs6[NUM_ADVICE]
        for pt in commit_many(coeffs6[:NUM_ADVICE], "advice"):
            tr.write_point(pt)
        _fine("advice commit+fold", sync=False)

    # ---- 2. lookups ---------------------------------------------------
    with span("lookup permuted"):
        theta = tr.challenge()
        _fine("phase2 start", sync=False)

        ap_host, sp_host = _lookup_columns(builder, n, usable, theta, rng)
        with span("columns"):
            lk_host = np.concatenate([ap_host, sp_host])
        lk_raw = dev(lk_host)
        del lk_host
        _fine("lookup host permute+to_mont", sync=False)
        lk8 = _coeff(lk_raw, plan_inv)
        _fine("lookup iNTT")
        ap_coeff = {l: lk8[i] for i, l in enumerate(LOOKUPS)}
        sp_coeff = {l: lk8[4 + i] for i, l in enumerate(LOOKUPS)}
        for pt in commit_many([c for l in LOOKUPS for c in (ap_coeff[l], sp_coeff[l])],
                              "lookup"):
            tr.write_point(pt)
        _fine("lookup commit+fold", sync=False)

    # ---- 3. grand products -------------------------------------------
    with span("grand products"):
        beta = tr.challenge()
        gamma = tr.challenge()
        active = torch.arange(n, device=device) < usable
        _fine("phase3 start", sync=False)

        omega_dev = powers(ctx, domain.omega, n, device)
        _fine("gp omega host", sync=False)
        sigma_raw = _evals_batch(torch.stack(pk.sigma_coeff), plan_fwd)
        # all 5 grand products (permutation + 4 lookups) batched; y is not drawn yet
        num, den = gp_fracs(raw6, sigma_raw, omega_dev, pk.raw_stack, lk_raw,
                            challenge_words(theta, beta, gamma, 0, pk.delta_powers), usable)
        num_a, pre, suf, totals = _gp_partials(num, den, active, SCAN)
        del num, den
        _fine("gp fracs+partials launch", sync=False)
        total_ints = L.from_device_mont(ctx, totals)
        _fine("gp totals d2h", sync=False)
        if any(t == 0 for t in total_ints):
            raise ValueError("grand product denominator vanished")
        total_inv_m = L.to_device_mont(ctx, [pow(t, -1, FR.p) for t in total_ints], device)
        blind = dev(ctx.to_mont_np([_rand_fr(rng) for _ in range(5 * (n - usable - 1))])
                    ).reshape(5, n - usable - 1, L.NW)
        z5 = _gp_finish(num_a, pre, suf, total_inv_m, blind, SCAN)
        z5_coeff = _coeff(z5, plan_inv)
        _fine("gp finish+iNTT")
        z_perm_coeff = z5_coeff[0]
        z_lookup_coeff = {l: z5_coeff[1 + i] for i, l in enumerate(LOOKUPS)}
        for pt in commit_many(z5_coeff, "gp"):
            tr.write_point(pt)
        _fine("gp commit+fold", sync=False)

    with span("quotient"):
        # ---- 4. random poly ------------------------------------------
        random_coeff = dev(_rand_fr_mont_bulk(rng, n))
        tr.write_point(commit_many([random_coeff], "random")[0])

        # ---- 5. quotient -----------------------------------------------
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
            with span("split"):
                h_coeff = split_quotient(witness_coeffs, pk, consts, plan_fwd, plan_coset)
        else:
            # one batched extended-coset NTT for every opened witness polynomial
            _fine("phase5 start", sync=False)
            ext_stack = _ext(torch.stack(witness_coeffs), pk.zeta_powers, plan_coset)
            _fine("quotient ext NTT")
            h_coeff = quotient_stacked(ext_stack, pk.ext_stack, pk.x_ext,
                                       pk.zh_inv_ext[:MAX_DEGREE], consts, pk.quotient_unscale,
                                       plan_quot)
            # the extended-domain arrays are not needed by the openings
            del ext_stack
        _fine("quotient eval+iNTT")
        h_pieces = [h_coeff[i * n : (i + 1) * n] for i in range(QUOTIENT_PIECES)]
        for pt in commit_many(h_coeff[: QUOTIENT_PIECES * n].reshape(QUOTIENT_PIECES, n, L.NW),
                              "quotient"):
            tr.write_point(pt)
        _fine("quotient commit+fold", sync=False)

    # ---- 6. evaluations ------------------------------------------------
    with span("evals"):
        x = tr.challenge()
        # the powers of each point serve its evaluations and its GWC witness;
        # K7 takes the opened rows where they lie, every point in one launch
        stacks = _open_sets(pk, advice_coeff, z_perm_coeff,
                            [z_lookup_coeff[l] for l in LOOKUPS],
                            [ap_coeff[l] for l in LOOKUPS],
                            [sp_coeff[l] for l in LOOKUPS], random_coeff, h_pieces)
        points = _points(domain, x)
        point_pows = [powers_of(ctx, mont1(p)[0], n) for p in points]
        for e in L.from_device_mont(ctx, _eval_stack(stacks, point_pows)):
            tr.write_scalar(e)

    # ---- 7. GWC multiopen ---------------------------------------------
    with span("gwc"):
        # the three W commitments share one challenge, so their MSMs batch
        v = tr.challenge()
        ws = _gwc_witness(stacks, point_pows, mont1(v)[0],
                          [mont1(pow(p, -1, FR.p))[0] for p in points])
        if selfcheck >= 2:
            for rows, w, z, key in zip(stacks, ws, points, ("x", "wx", "winvx")):
                record(f"gwc {key}", [SC.check_gwc_witness(rows, w, v, z, key)])
        for pt in commit_many(ws, "gwc"):
            tr.write_point(pt)

    return bytes(tr.data)

