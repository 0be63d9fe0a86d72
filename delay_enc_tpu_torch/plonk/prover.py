"""The proving pipeline on the card: `prove_instances`, and create_proof on it.

Counterpart of `delay_enc_tpu/plonk/prover.py` and of the instance axis of
its `batch_prover.py`.  `prove_instances` is the one body of a proof.  It
proves B witnesses of one key's circuit, each with its own transcript, in
groups (`Group`): a group is a run of instances on one device.  Fiat-Shamir
brings every instance's commitments back to the host at each phase
boundary; between the boundaries each phase runs once over a group's
instances: one set of transforms over the stacked rows, one commitment call
(one `pair_sel` launch and one plane-sum launch plan for all its columns),
and K5, K6 and K7 with a leading instance axis (`plonk/kernels.py`).  Each
phase launches every group's device work before it reads any result back.
`create_proof` is a batch of one on one device; `create_proofs_batched`
(`plonk/batch_prover.py`) is a batch of B on one device or over a mesh;
`create_proofs_pipelined` (`plonk/pipeline.py`) runs create_proof on worker
threads.  The quotient is the fused 8n one, or the split one for a
split-mode key (k >= 18), an instance at a time.  The JAX package's
DELAY_ENC_NTT=mxu is the argument `ntt="mxu"` of create_proof: every
transform of a fused-quotient proof through the matmul NTT (K11).
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

`rng` is drawn from in the JAX package's batched order: (1) for each
instance, each advice column's blinded rows; (2) for each instance, each
lookup, a pad for A'_l and then one for S'_l; (3) one list of B * 5 * (n -
usable - 1) grand-product blinds; (4) B * n draws for the random
polynomials.  A single proof is a batch of one that shares each lookup's
pad between A'_l and S'_l, which is the JAX single prover's order.  So the
same circuit, SRS and seed give the JAX create_proof's bytes, and the same
builders the JAX create_proofs_batched's.

Every word a run sends to the card in its first two phases (the advice
and instance columns, the permuted lookup columns) is written once, in
place, into the calling thread's staging buffer (`staging`), kept across
runs, and sent from there with no host copy; the random polynomials' draws
are sent as drawn.  The card computes the Montgomery form of the bulk
words: the advice and instance columns go up as their canonical words
(`FieldCtx.to_words_np`) and K-a multiplies them by R^2
(`L.canonical_to_mont`); the random polynomials go up as their 64-byte
draws and `L.wide_to_mont` reduces them.  The counter `to_mont device`
counts those elements, 7 n an instance.  The host keeps `to_mont_np` for
the small conversions: the lookup pads, the grand products' blinds and
inverses, and the points.

Spans (`utils/timers.py`): a proof is the root span `prove` (a batch:
`prove_batch`), its phases the spans `advice commit`, `lookup permuted`,
`grand products` (each from the phase's challenges to its commitments),
`quotient` (the random polynomial's commitment too), `evals` and `gwc`;
they tile the root.  No phase waits for the device to close: each ends by
reading its result to the host.  Inside them the host's work is named where
it happens: the spans `columns` (the advice columns, the lookups' table
keys, the random polynomial), `permute` (the lookup permutation) and
`split` (a split-mode key's quotient: its cosets and inverse, enqueued)
here, `to_mont`, `htod` and `device wait` in `ops/limbs.py`, `fold` in
`ops/msm.py`.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from ..cs.builder import Builder, NUM_ADVICE
from ..cs.range import build_table
from ..fields.bn254 import FR
from ..ops import limbs as L
from ..ops.msm import fold_planes_host
from ..ops.ntt import powers
from ..ops.poly import powers_rows
from ..parallel.mesh import on
from ..utils.device import resolve
from ..utils.timers import GLOBAL_METRICS
from .domain import MAX_DEGREE, QUOTIENT_PIECES
from .keygen import ALL_FIXED, LOOKUPS, ProvingKey
from .kernels import (
    WIT_ROWS,
    _canon_batch,
    _coeff,
    _eval_stack_batch,
    _evals_batch,
    _ext,
    _gp_finish,
    _gp_partials,
    _gwc_witness_batch,
    challenge_words,
    gp_fracs,
    msm_plane_sums,
    quotient_stacked,
    split_quotient,
)
from .kzg import SRS
from .transcript import Transcript

WIRE_COL = {"a": 0, "b": 1, "c": 2, "d": 3}
CTX = L.FR_CTX
SCAN = "block"  # the scan every grand product names (ops/poly.py)
NL = len(LOOKUPS)
GP = 1 + NL  # grand products an instance: the permutation and the lookups
GWC_KEYS = ("x", "wx", "winvx")  # the opening points, as the selfcheck names them


def _rand_fr(rng) -> int:
    return FR.from_uniform_bytes(bytes(rng.integers(0, 256, 64, dtype="uint8")))


def _rand_wide_rows(rng, B: int, n: int) -> np.ndarray:
    """The random polynomials' B * n draws of 64 bytes, as drawn, viewed as
    (B, n, 16) uint32 words: each row the little-endian 512-bit integer
    whose reduction mod p is the coefficient (`L.wide_to_mont`, on the
    card); the span `columns`."""
    with GLOBAL_METRICS.span("columns"):
        raw = rng.integers(0, 256, (B * n, 64), dtype="uint8")
        return raw.view(np.uint32).reshape(B, n, 2 * L.NW)


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


def _permuted_columns(tag_col, adv_col, usable: int, tkeys_padded, fvals, wire,
                      ap: np.ndarray | None = None, sp: np.ndarray | None = None):
    """halo2's lookup permutation (lookup/prover.rs permute_expression_pair):
    A' = A sorted (grouped by value), S' = the matching table value at each
    first occurrence, the remaining table rows filling the rest.  Computed
    in key space over the table's keys; returns A' and S', (usable, 8)
    Montgomery words copied from `fvals`, written into the rows `ap` and
    `sp` where given (C-contiguous uint32 (usable, 8) each: the staging
    rows of a proof), each row once.

    Two passes.  The keys (`_lookup_keys`): the tag and wire columns read
    together into u32 pair keys, in C (`native/pyints.c:lookup_keys`, the
    GIL held) for as long as the rows hold small exact ints, in Python from
    the first row that does not.  The columns (`_permute_by_count`): each
    key counted against the table's sorted keys, then each row of A' and S'
    written once from `fvals` (`native/limbops.c:lookup_permute`, the GIL
    released; the same counting in numpy without the C library).  Nothing
    is kept across calls."""
    keys = _lookup_keys(tag_col, adv_col, wire)
    return _permute_by_count(keys, usable, tkeys_padded, fvals, wire, ap, sp)


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


def _permute_by_count(keys, usable: int, tkeys_padded, fvals, wire, ap=None, sp=None):
    """A' and S' of the keys (the rows past them key 0) against the sorted
    padded table `tkeys_padded` by counting: A' is each table key repeated
    by its count, in the table's order; S' holds each used key at the first
    row of its run in A', and the table's other rows, in order, at the
    others.  Equal table keys (the zero padding) form a group, whose first
    row's `fvals` stand for it.  Raises the lookup failure of the smallest
    key not in the table.  Writes into `ap` and `sp` where given."""
    from ..native import get_lib

    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    table = np.ascontiguousarray(tkeys_padded, dtype=np.uint32)
    fvals = np.ascontiguousarray(fvals, dtype=np.uint32)
    rows = len(keys)
    if rows > usable or table.shape != (usable,) or fvals.shape != (usable, L.NW):
        raise ValueError(f"lookup: {rows} keys, a table of {table.shape} and values of "
                         f"{fvals.shape} for {usable} usable rows (wire {wire})")
    ap, sp = (np.empty((usable, L.NW), dtype=np.uint32) if o is None
              else L.rows_to_write(o, usable) for o in (ap, sp))
    lib = get_lib()
    if lib is not None:
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
    np.take(fvals, np.repeat(first, count), axis=0, out=ap)
    used = count > 0
    starts = (np.cumsum(count) - count)[used]
    at_start = np.zeros(usable, dtype=bool)
    at_start[starts] = True
    taken = np.zeros(usable, dtype=bool)
    taken[first[used]] = True
    src = np.empty(usable, dtype=np.int64)
    src[starts] = first[used]
    src[~at_start] = first[group[~taken]]
    np.take(fvals, src, axis=0, out=sp)
    return ap, sp


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


def _lookup_columns(builder: Builder, n: int, usable: int, theta: int, rng, out: np.ndarray,
                    shared_pads: bool) -> None:
    """The permuted lookup columns A'_a..d then S'_a..d written to `out`,
    (8, n, 8) Montgomery words, each row once, their rows from `usable` on
    drawn from rng: one pad a lookup for both columns (`shared_pads`, a
    single proof), or a pad for A'_l then one for S'_l (a batch, JAX
    batch_prover.py:186).  The table's keys are the span `columns`, each
    permutation `permute`."""
    with GLOBAL_METRICS.span("columns"):
        tbl_tags, tbl_vals = build_table(builder.lookup_widths)
        tkeys_padded, fvals = _table_keys(tbl_tags, tbl_vals, usable, theta)
    for i, l in enumerate(LOOKUPS):
        a, s = out[i], out[NL + i]
        with GLOBAL_METRICS.span("permute"):
            _permuted_columns(builder.fixed[f"tag_{l}"], builder.advice[WIRE_COL[l]],
                              usable, tkeys_padded, fvals, l, a[:usable], s[:usable])
        CTX.to_mont_np([_rand_fr(rng) for _ in range(n - usable)], a[usable:])
        if shared_pads:
            s[usable:] = a[usable:]
        else:
            CTX.to_mont_np([_rand_fr(rng) for _ in range(n - usable)], s[usable:])


def _commit(groups: list, rows: list) -> list:
    """Host affine commitments to each group's (m, n, 8) Montgomery
    coefficient rows, group after group: every group's plane sums are
    launched, then each is folded on the host."""
    sums = []
    for g in groups:
        with on(g.device):
            sums.append(msm_plane_sums(g.tables, _canon_batch(rows[g.i])))
    return [pt for s, base_bits in sums for pt in fold_planes_host(s, base_bits)]


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


def transform_plans(domain, device, ntt: str) -> tuple:
    """The plans of a fused-quotient proof's transforms: (inverse, forward,
    coset, quotient's inverse), the domain's NTT plans for "stockham" (K-b)
    or the matmul NTT's, one a transform, for "mxu" (K11)."""
    if ntt == "mxu":
        return tuple(domain.mxu_plan(kind, device) for kind in ("inv", "fwd", "ext", "ext_inv"))
    plan, plan_ext = domain.plan(device), domain.plan_ext(device)
    return plan, plan, plan_ext, plan_ext


@dataclasses.dataclass
class Group:
    """The instances lo .. hi - 1 of a run, proved on one device: the key and
    the SRS there (truncated to the key's domain), the SRS's pair tables and
    the four `transform_plans`."""

    i: int
    lo: int
    hi: int
    device: torch.device
    pk: ProvingKey
    srs: SRS
    tables: tuple
    plans: tuple


def group(i: int, lo: int, hi: int, device, pk: ProvingKey, srs, msm: str,
          ntt: str = "stockham") -> Group:
    """The group of instances lo .. hi - 1 on `device`; its pair tables and
    plans are built there (and kept by the SRS and the domain)."""
    domain = pk.vk.domain
    with on(device):
        srs = srs.truncated(domain.k)
        return Group(i, lo, hi, device, pk, srs, srs.msm_tables(msm),
                     transform_plans(domain, device, ntt))


_STAGING = threading.local()


def staging(B: int, n: int) -> tuple:
    """The calling thread's host staging buffer, as the views (advice,
    lookups) of one proof run: (B, 6, n, 8) canonical words and (B, 8, n, 8)
    Montgomery words, uint32, one after the other.  The host prover work
    writes every word of the columns there, once, and `L.to_tensor` sends
    from there (the random polynomials' draws go up as drawn).  The
    buffer is one flat array a thread, kept across calls: it grows to the
    first run that needs more (the counter `staging grow`, its bytes under
    `staging grow bytes`), is never shrunk, and is otherwise reused
    (`staging reuse`).  A thread proves one run at a time, and a CUDA copy
    has read the words when `to_tensor` returns, so the next run may
    rewrite them."""
    sizes = (B * (NUM_ADVICE + 1) * n * L.NW, B * 2 * NL * n * L.NW)
    words = sum(sizes)
    buf = getattr(_STAGING, "buf", None)
    if buf is None or buf.size < words:
        _STAGING.buf = None  # the old buffer goes before the new one is made
        buf = _STAGING.buf = np.empty(words, dtype=np.uint32)
        GLOBAL_METRICS.count("staging grow")
        GLOBAL_METRICS.count("staging grow bytes", buf.nbytes)
    else:
        GLOBAL_METRICS.count("staging reuse")
    a, lk = np.split(buf[:words], sizes[:1])
    return a.reshape(B, NUM_ADVICE + 1, n, L.NW), lk.reshape(B, 2 * NL, n, L.NW)


def create_proof(srs, pk: ProvingKey, builder: Builder, rng=None, device="cuda",
                 msm: str = "b4", selfcheck: int = 0, checks: list | None = None,
                 ntt: str = "stockham") -> bytes:
    """A proof for the builder's witness.  `msm` picks the commitments' pair
    tables, "b4" or "b16" (`SRS.msm_tables`); both give the same bytes.
    `ntt` picks the transforms' kernel: "stockham" (K-b) or "mxu" (K11,
    the matmul NTT, fused-quotient keys only: a split key with "mxu"
    raises); both give the same bytes.  `selfcheck` 1 checks every
    commitment against the host's C MSM, 2 also the GWC witnesses
    (`plonk/selfcheck.py`); each result goes to stderr and, as a (label,
    ok) pair, to `checks` where given.  The bytes do not change with any of
    them."""
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
        return prove_instances(pk, [builder], rng,
                               lambda: [group(0, 0, 1, device, pk, srs, msm, ntt)],
                               shared_pads=True, selfcheck=selfcheck, checks=checks)[0]


def prove_instances(pk: ProvingKey, builders, rng, make_groups, shared_pads: bool,
                    selfcheck: int = 0, checks: list | None = None) -> list[bytes]:
    """The proofs of `builders`, instance i in the group with lo <= i < hi,
    inside the caller's root span; `make_groups()` gives the groups, and is
    called in the span `advice commit`, where a group's set-up (the SRS's
    truncation, pair tables and plans) is timed.  `shared_pads`: one pad a
    lookup for A'_l and S'_l (create_proof's draws); `selfcheck` and
    `checks` as create_proof's."""
    span = GLOBAL_METRICS.span
    B = len(builders)
    if rng is None:
        rng = np.random.default_rng()
    domain = pk.vk.domain
    n, usable = domain.n, domain.usable_rows
    if selfcheck:
        from . import selfcheck as SC

    def each(fn) -> list:
        """fn(group) for every group, its launches on the group's device."""
        out = []
        for g in groups:
            with on(g.device):
                out.append(fn(g))
        return out

    def per_device(fn) -> dict:
        """fn(group) once for each device: what its groups share."""
        out = {}
        for g in groups:
            if g.device not in out:
                with on(g.device):
                    out[g.device] = fn(g)
        return out

    def dev(words: np.ndarray) -> list:
        """(B, …) host words -> each group's rows on its device."""
        return each(lambda g: L.to_tensor(words[g.lo:g.hi], g.device))

    def record(label: str, results) -> None:
        if checks is not None:
            checks.extend((f"{label}[{j}]", ok) for j, ok in enumerate(results))

    def commit(rows: list, per: int, tag: str) -> None:
        """Commit each group's (b * per, n, 8) rows, instance after
        instance, each instance's `per` points into its transcript."""
        points = _commit(groups, rows)
        if selfcheck:
            record(tag, SC.check_commits(groups[0].srs, [r for g in groups for r in rows[g.i]],
                                         points, tag))
        for j, pt in enumerate(points):
            trs[j // per].write_point(pt)

    def from_mont(tensors: list) -> list:
        return [v for t in tensors for v in L.from_device_mont(CTX, t)]

    # ---- 1. advice --------------------------------------------------------
    with span("advice commit"):
        groups = make_groups()
        trs = [Transcript() for _ in range(B)]
        for tr, b in zip(trs, builders):
            # vk.hash_into(transcript), then the public inputs
            tr.common_scalar(pk.vk.transcript_repr)
            for v in b.instance:
                tr.common_scalar(v)
        adv_host, lk_host = staging(B, n)
        for i, b in enumerate(builders):
            for c, col in enumerate(_advice_columns(b, n, usable, rng)):
                CTX.to_words_np(col, adv_host[i, c])
        canonical = dev(adv_host)
        raw = each(lambda g: L.canonical_to_mont(CTX, canonical[g.i]))  # Montgomery words
        GLOBAL_METRICS.count("to_mont device", adv_host.size // L.NW)
        del canonical
        coeff = each(lambda g: _coeff(raw[g.i], g.plans[0]))  # (b, 6, n, 8) a group
        commit([c[:, :NUM_ADVICE].reshape(-1, n, L.NW) for c in coeff], NUM_ADVICE, "advice")

    # ---- 2. lookups -------------------------------------------------------
    with span("lookup permuted"):
        thetas = [tr.challenge() for tr in trs]
        for i, (b, theta) in enumerate(zip(builders, thetas)):  # A'_a..d, then S'_a..d
            _lookup_columns(b, n, usable, theta, rng, lk_host[i], shared_pads)
        lk_raw = dev(lk_host)
        lk_coeff = each(lambda g: _coeff(lk_raw[g.i], g.plans[0]))
        ap_coeff, sp_coeff = [c[:, :NL] for c in lk_coeff], [c[:, NL:] for c in lk_coeff]
        # each instance's commitments in the order A'_l, S'_l
        commit([torch.stack([a, s], dim=2).reshape(-1, n, L.NW)
                for a, s in zip(ap_coeff, sp_coeff)], 2 * NL, "lookup")

    # ---- 3. grand products ------------------------------------------------
    with span("grand products"):
        betas = [tr.challenge() for tr in trs]
        gammas = [tr.challenge() for tr in trs]
        active = per_device(lambda g: torch.arange(n, device=g.device) < usable)
        omega_dev = per_device(lambda g: powers(CTX, domain.omega, n, g.device))
        sigma_raw = per_device(lambda g: _evals_batch(torch.stack(g.pk.sigma_coeff),
                                                      g.plans[1]))
        # all 5 grand products of every instance batched; y is not drawn yet
        fracs_consts = np.stack([challenge_words(t, b, g, 0, pk.delta_powers)
                                 for t, b, g in zip(thetas, betas, gammas)])
        partials = each(lambda g: _gp_partials(
            *gp_fracs(raw[g.i], sigma_raw[g.device], omega_dev[g.device], g.pk.raw_stack,
                      lk_raw[g.i], fracs_consts[g.lo:g.hi], usable),  # (b * 5, n, 8) each
            active[g.device], SCAN))
        del omega_dev, sigma_raw
        total_ints = from_mont([p[3] for p in partials])
        if any(t == 0 for t in total_ints):
            raise ValueError("grand product denominator vanished")
        total_inv = CTX.to_mont_np([pow(t, -1, FR.p) for t in total_ints]).reshape(B, GP, L.NW)
        blind = CTX.to_mont_np([_rand_fr(rng) for _ in range(B * GP * (n - usable - 1))])
        blind = dev(blind.reshape(B, GP, n - usable - 1, L.NW))
        total_inv = dev(total_inv)
        z_coeff = each(lambda g: _coeff(_gp_finish(
            *partials[g.i][:3], total_inv[g.i].reshape(-1, L.NW),
            blind[g.i].reshape(-1, n - usable - 1, L.NW), SCAN), g.plans[0]).reshape(-1, GP, n,
                                                                                   L.NW))
        del partials, blind
        commit([z.reshape(-1, n, L.NW) for z in z_coeff], GP, "gp")

    with span("quotient"):
        # ---- 4. random polys ----------------------------------------------
        wide = dev(_rand_wide_rows(rng, B, n))
        random_coeff = each(lambda g: L.wide_to_mont(CTX, wide[g.i]))
        GLOBAL_METRICS.count("to_mont device", B * n)
        del wide
        commit(random_coeff, 1, "random")

        # ---- 5. quotient --------------------------------------------------
        ys = [tr.challenge() for tr in trs]
        consts = np.stack([challenge_words(t, b, g, y, pk.delta_powers)
                           for t, b, g, y in zip(thetas, betas, gammas, ys)])
        del raw, lk_raw, lk_coeff

        def quotient(g: Group) -> torch.Tensor:
            # each instance's 19 witness rows in the quotient kernel's order
            # (kernels.W_*): advice, instance, z_perm, z_l, A'_l, S'_l
            parts = (coeff[g.i], z_coeff[g.i], ap_coeff[g.i], sp_coeff[g.i])
            b = g.hi - g.lo
            if g.pk.split:
                with span("split"):
                    hs = [split_quotient([row for p in parts for row in p[j]], g.pk,
                                         consts[g.lo + j], g.plans[1], g.plans[2])
                          for j in range(b)]
                    h_coeff = torch.stack(hs) if b > 1 else hs[0][None]
            else:
                # one extended-coset transform for every opened witness row
                wit = torch.cat(parts, dim=1)
                ext = _ext(wit.reshape(b * WIT_ROWS, n, L.NW), g.pk.zeta_powers, g.plans[2])
                del wit
                h_coeff = quotient_stacked(ext.reshape(b, WIT_ROWS, domain.n_ext, L.NW),
                                           g.pk.ext_stack, g.pk.x_ext,
                                           g.pk.zh_inv_ext[:MAX_DEGREE], consts[g.lo:g.hi],
                                           g.pk.quotient_unscale, g.plans[3])  # (b, n_ext, 8)
            return h_coeff[:, : QUOTIENT_PIECES * n].reshape(b, QUOTIENT_PIECES, n, L.NW)

        h_pieces = each(quotient)
        commit([h.reshape(-1, n, L.NW) for h in h_pieces], QUOTIENT_PIECES, "quotient")

    # ---- 6. evaluations ---------------------------------------------------
    with span("evals"):
        xs = [tr.challenge() for tr in trs]
        stacks = each(lambda g: [
            _open_sets(g.pk, coeff[g.i][j, :NUM_ADVICE], z_coeff[g.i][j, 0],
                       z_coeff[g.i][j, 1:], ap_coeff[g.i][j], sp_coeff[g.i][j],
                       random_coeff[g.i][j], h_pieces[g.i][j])
            for j in range(g.hi - g.lo)])
        points = [p for x in xs for p in _points(domain, x)]  # 3 an instance

        def point_pows(g: Group) -> list:
            # the powers of every point serve its evaluations and its GWC
            # witness, one scan for the group
            pows = powers_rows(CTX, L.to_device_mont(CTX, points[3 * g.lo : 3 * g.hi],
                                                     g.device), n)
            return [list(pows[3 * j : 3 * j + 3]) for j in range(g.hi - g.lo)]

        pows = each(point_pows)
        evals = from_mont(each(lambda g: _eval_stack_batch(stacks[g.i], pows[g.i])))
        per = len(evals) // B
        for i, tr in enumerate(trs):
            for e in evals[i * per : (i + 1) * per]:
                tr.write_scalar(e)

    # ---- 7. GWC multiopen -------------------------------------------------
    with span("gwc"):
        # each instance's three W commitments share one challenge
        vs = [tr.challenge() for tr in trs]
        zinv = [pow(p, -1, FR.p) for p in points]
        ws = each(lambda g: _gwc_witness_batch(
            stacks[g.i], pows[g.i], L.to_device_mont(CTX, vs[g.lo:g.hi], g.device),
            L.to_device_mont(CTX, zinv[3 * g.lo : 3 * g.hi], g.device)))
        if selfcheck >= 2:
            rows = [r for g in groups for st in stacks[g.i] for r in st]  # 3 an instance
            for s, (r, w, z) in enumerate(zip(rows, [w for t in ws for w in t], points)):
                record(f"gwc {GWC_KEYS[s % 3]}",
                       [SC.check_gwc_witness(r, w, vs[s // 3], z, GWC_KEYS[s % 3])])
        commit(ws, 3, "gwc")
    return [bytes(tr.data) for tr in trs]
