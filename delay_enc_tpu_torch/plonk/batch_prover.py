"""create_proofs_batched: B proofs of one circuit and key in one device pipeline.

Counterpart of `delay_enc_tpu/plonk/batch_prover.py`.  Each proof has its
own transcript and verifies alone; Fiat-Shamir brings every instance's
commitments back to the host at each phase boundary, and between the
boundaries each phase runs once over all B instances: one set of transforms
over the stacked rows, one commitment call a phase (one `pair_sel` launch
and one plane-sum launch plan for all B * m columns), and K5, K6 and K7 with
a leading instance axis, one launch each for the batch (`plonk/kernels.py`,
up to MAX_INSTANCES instances a launch), as the JAX package's vmaps do.

`rng` is drawn from in the JAX package's batched order, which differs from
the single prover's: (1) for each instance, each advice column's blinded
rows; (2) for each instance, each lookup, a pad for A'_l and another for
S'_l (the single prover uses one for both); (3) one list of B * 5 * (n -
usable - 1) grand-product blinds; (4) B * n draws for the random
polynomials.  So a batch of one is not `create_proof`'s bytes, but each is
a proof of its statement.

Only a fused-quotient key (k < 18 by default) is taken: the JAX package's
batched prover reads the key's extended-coset tables and has no split mode.

With `mesh=` (a `parallel.Mesh` of D devices, B a multiple of D) the
instance axis is split into D contiguous groups, group i on the mesh's
device i, as the JAX package's NamedSharding(P(axis)) splits it: the key,
the SRS and its pair tables are replicated (shared by the groups on one
device), every draw from `rng` is made on the host for all B instances in
the order above, and then each group's transforms, commitments, K5, K6 and
K7 run on its device over its B/D instances.  Each phase launches every
group's device work before it reads any result back, so the devices of a
mesh of several cards work at once.  The proofs are independent, so no
group exchanges anything with another, and the bytes are the unsharded
batch's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..cs.builder import NUM_ADVICE
from ..fields.bn254 import FR
from ..ops import limbs as L
from ..ops.msm import fold_planes_host
from ..ops.ntt import powers
from ..ops.poly import powers_rows
from ..parallel.mesh import Mesh, on
from ..utils.device import resolve
from .domain import MAX_DEGREE, QUOTIENT_PIECES
from .keygen import LOOKUPS, ProvingKey, circuit_shape
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
)
from .prover import (
    CTX,
    SCAN,
    _advice_columns,
    _lookup_columns,
    _open_sets,
    _points,
    _rand_fr,
    _rand_fr_mont_bulk,
    _Spans,
)
from .transcript import Transcript

NL = len(LOOKUPS)
GP = 1 + NL  # grand products an instance: the permutation and the lookups


def _check_batch(pk: ProvingKey, builders) -> None:
    if not builders:
        raise ValueError("no builders: a batch proves one or more instances")
    if pk.split:
        raise ValueError("the batched prover takes a fused-quotient key (keygen split=False); "
                         "a split-mode key is proved one instance at a time by create_proof")
    want = pk.shape if pk.shape is not None else circuit_shape(builders[0])
    for i, b in enumerate(builders):
        got = circuit_shape(b)
        if got != want:
            raise ValueError(f"builder {i} has the circuit shape {got}, the key {want}")


def _key_to(pk: ProvingKey, device) -> ProvingKey:
    """A copy of the key's tensors on `device`; tensors that are views of
    one stack in the key stay views of one copied stack."""
    copies: dict = {}

    def move(t):
        if isinstance(t, torch.Tensor):
            base = t if t._base is None else t._base
            if id(base) not in copies:
                copies[id(base)] = (base, base.to(device, copy=True))
            moved = copies[id(base)][1]
            if t._base is None:
                return moved
            return moved.as_strided(t.shape, t.stride(),
                                    moved.storage_offset() + t.storage_offset()
                                    - base.storage_offset())
        if isinstance(t, dict):
            return {k: move(v) for k, v in t.items()}
        if isinstance(t, list):
            return [move(v) for v in t]
        return t

    return dataclasses.replace(pk, **{f.name: move(getattr(pk, f.name))
                                      for f in dataclasses.fields(pk) if f.name != "vk"})


def _srs_to(srs, device):
    from .kzg import SRS

    return SRS(srs.k, srs.g1_powers.to(device), srs.tau_g2, srs.g2)


@dataclasses.dataclass
class _Group:
    """The instances lo .. hi - 1 of a batch, proved on one device."""

    i: int
    lo: int
    hi: int
    device: torch.device
    pk: ProvingKey
    tables: tuple
    plan: object
    plan_ext: object


def _groups(srs, pk: ProvingKey, b: int, device, msm: str, mesh: Mesh | None,
            axis: str) -> list:
    domain = pk.vk.domain
    if mesh is None:
        device = resolve(device)
        if pk.device != device or srs.device != device:
            raise ValueError(f"keys on {pk.device} and SRS on {srs.device}, proofs asked for "
                             f"{device}")
        devices, keys, srss = [device], [pk], [srs]
    else:
        if axis not in mesh.axis_names:
            raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")
        if b % mesh.size:
            raise ValueError(f"a batch of {b} does not split over {mesh.size} shards")
        devices = mesh.devices
        keys, srss = mesh.replicas(pk, _key_to), mesh.replicas(srs, _srs_to)
    per = b // len(devices)
    groups = []
    for i, (dev, key, s) in enumerate(zip(devices, keys, srss)):
        with on(dev):
            groups.append(_Group(i, i * per, (i + 1) * per, dev, key,
                                 s.truncated(domain.k).msm_tables(msm), domain.plan(dev),
                                 domain.plan_ext(dev)))
    return groups


def create_proofs_batched(srs, pk: ProvingKey, builders, rng=None, device="cuda",
                          msm: str = "b4", mesh: Mesh | None = None,
                          axis: str = "dp") -> list[bytes]:
    """Prove every builder in one batched pipeline; returns B proof byte
    strings, each verifiable alone.  Every builder is a witness of the key's
    circuit: the same fixed columns, lookups and copies (the shape is
    checked, `keygen.circuit_shape`).  `msm` picks the commitments' pair
    tables, "b4" or "b16"; both give the same bytes.  `mesh` splits the
    instances over its devices (`axis` must name its axis; B a multiple of
    its size); the key and the SRS may then lie on any device, and
    `device` is not read.  The bytes do not depend on the mesh."""
    if mesh is None:
        device = resolve(device)
    _check_batch(pk, builders)
    B = len(builders)
    groups = _groups(srs, pk, B, device, msm, mesh, axis)
    distinct = list(dict.fromkeys(g.device for g in groups))
    _phase = _Spans(distinct, "prove_batch")
    if rng is None:
        rng = np.random.default_rng()
    ctx = CTX
    domain = pk.vk.domain
    n, usable = domain.n, domain.usable_rows

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

    def commit(rows: list, per: int) -> None:
        """Commit each group's (b * per, n, 8) rows, instance after
        instance, each instance's `per` points into its transcript: every
        group's plane sums are launched, then each is folded on the host."""
        sums = each(lambda g: msm_plane_sums(g.tables, _canon_batch(rows[g.i])))
        points = [pt for s, base_bits in sums for pt in fold_planes_host(s, base_bits)]
        for j, pt in enumerate(points):
            trs[j // per].write_point(pt)

    def from_mont(tensors: list) -> list:
        return [v for t in tensors for v in L.from_device_mont(ctx, t)]

    trs = [Transcript() for _ in range(B)]
    for tr, b in zip(trs, builders):
        tr.common_scalar(pk.vk.transcript_repr)
        for v in b.instance:
            tr.common_scalar(v)

    # ---- 1. advice --------------------------------------------------------
    cols = [col for b in builders for col in _advice_columns(b, n, usable, rng)]
    raw = dev(np.stack([ctx.to_mont_np(c) for c in cols]).reshape(B, NUM_ADVICE + 1, n, L.NW))
    coeff = each(lambda g: _coeff(raw[g.i], g.plan))  # (b, 6, n, 8) a group
    commit([c[:, :NUM_ADVICE].reshape(-1, n, L.NW) for c in coeff], NUM_ADVICE)
    _phase("advice commit")

    # ---- 2. lookups -------------------------------------------------------
    thetas = [tr.challenge() for tr in trs]
    lk_host = [np.concatenate(_lookup_columns(b, n, usable, theta, rng, separate_pads=True))
               for b, theta in zip(builders, thetas)]
    lk_raw = dev(np.stack(lk_host))  # (b, 8, n, 8): A'_a..d, then S'_a..d
    lk_coeff = each(lambda g: _coeff(lk_raw[g.i], g.plan))
    ap_coeff, sp_coeff = [c[:, :NL] for c in lk_coeff], [c[:, NL:] for c in lk_coeff]
    # each instance's commitments in the single prover's order: A'_l, S'_l
    commit([torch.stack([a, s], dim=2).reshape(-1, n, L.NW)
            for a, s in zip(ap_coeff, sp_coeff)], 2 * NL)
    _phase("lookup permuted")

    # ---- 3. grand products ------------------------------------------------
    betas = [tr.challenge() for tr in trs]
    gammas = [tr.challenge() for tr in trs]
    active = per_device(lambda g: torch.arange(n, device=g.device) < usable)
    omega_dev = per_device(lambda g: powers(ctx, domain.omega, n, g.device))
    sigma_raw = per_device(lambda g: _evals_batch(torch.stack(g.pk.sigma_coeff), g.plan))
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
    total_inv = ctx.to_mont_np([pow(t, -1, FR.p) for t in total_ints]).reshape(B, GP, L.NW)
    blind = ctx.to_mont_np([_rand_fr(rng) for _ in range(B * GP * (n - usable - 1))])
    blind = dev(blind.reshape(B, GP, n - usable - 1, L.NW))
    total_inv = dev(total_inv)
    z_coeff = each(lambda g: _coeff(_gp_finish(
        *partials[g.i][:3], total_inv[g.i].reshape(-1, L.NW),
        blind[g.i].reshape(-1, n - usable - 1, L.NW), SCAN), g.plan).reshape(-1, GP, n, L.NW))
    del partials, blind
    commit([z.reshape(-1, n, L.NW) for z in z_coeff], GP)
    _phase("grand products")

    # ---- 4. random polys --------------------------------------------------
    random_coeff = dev(_rand_fr_mont_bulk(rng, B * n).reshape(B, n, L.NW))
    commit(random_coeff, 1)

    # ---- 5. quotient ------------------------------------------------------
    ys = [tr.challenge() for tr in trs]
    consts = np.stack([challenge_words(t, b, g, y, pk.delta_powers)
                       for t, b, g, y in zip(thetas, betas, gammas, ys)])
    del raw, lk_raw, lk_coeff

    def quotient(g: _Group) -> torch.Tensor:
        # each instance's 19 witness rows in the quotient kernel's order
        # (kernels.W_*): advice, instance, z_perm, z_l, A'_l, S'_l
        i = g.i
        wit = torch.cat([coeff[i], z_coeff[i], ap_coeff[i], sp_coeff[i]], dim=1)
        b = wit.shape[0]
        ext = _ext(wit.reshape(b * WIT_ROWS, n, L.NW), g.pk.zeta_powers, g.plan_ext)
        del wit
        h_coeff = quotient_stacked(ext.reshape(b, WIT_ROWS, domain.n_ext, L.NW),
                                   g.pk.ext_stack, g.pk.x_ext, g.pk.zh_inv_ext[:MAX_DEGREE],
                                   consts[g.lo:g.hi], g.pk.quotient_unscale,
                                   g.plan_ext)  # (b, n_ext, 8)
        return h_coeff[:, : QUOTIENT_PIECES * n].reshape(b, QUOTIENT_PIECES, n, L.NW)

    h_pieces = each(quotient)
    commit([h.reshape(-1, n, L.NW) for h in h_pieces], QUOTIENT_PIECES)
    _phase("quotient")

    # ---- 6. evaluations ---------------------------------------------------
    xs = [tr.challenge() for tr in trs]
    stacks = each(lambda g: [
        _open_sets(g.pk, coeff[g.i][j, :NUM_ADVICE], z_coeff[g.i][j, 0], z_coeff[g.i][j, 1:],
                   ap_coeff[g.i][j], sp_coeff[g.i][j], random_coeff[g.i][j], h_pieces[g.i][j])
        for j in range(g.hi - g.lo)])
    points = [p for x in xs for p in _points(domain, x)]  # 3 an instance

    def point_pows(g: _Group) -> list:
        pows = powers_rows(ctx, L.to_device_mont(ctx, points[3 * g.lo : 3 * g.hi], g.device), n)
        return [list(pows[3 * j : 3 * j + 3]) for j in range(g.hi - g.lo)]

    pows = each(point_pows)
    evals = from_mont(each(lambda g: _eval_stack_batch(stacks[g.i], pows[g.i])))
    per = len(evals) // B
    for i, tr in enumerate(trs):
        for e in evals[i * per : (i + 1) * per]:
            tr.write_scalar(e)
    _phase("evals")

    # ---- 7. GWC multiopen -------------------------------------------------
    vs = [tr.challenge() for tr in trs]
    zinv = [pow(p, -1, FR.p) for p in points]
    ws = each(lambda g: _gwc_witness_batch(
        stacks[g.i], pows[g.i], L.to_device_mont(ctx, vs[g.lo:g.hi], g.device),
        L.to_device_mont(ctx, zinv[3 * g.lo : 3 * g.hi], g.device)))
    commit(ws, 3)
    _phase("gwc")
    return [bytes(tr.data) for tr in trs]
