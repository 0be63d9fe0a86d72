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
Its `mesh=` sharding of the instance axis over devices is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cs.builder import NUM_ADVICE
from ..fields.bn254 import FR
from ..ops import limbs as L
from ..ops.ntt import powers
from ..ops.poly import powers_rows
from ..utils.device import resolve
from .domain import MAX_DEGREE, QUOTIENT_PIECES
from .keygen import LOOKUPS, ProvingKey, circuit_shape
from .kernels import (
    WIT_ROWS,
    _coeff,
    _eval_stack_batch,
    _evals_batch,
    _ext,
    _gp_finish,
    _gp_partials,
    _gwc_witness_batch,
    challenge_words,
    gp_fracs,
    quotient_stacked,
)
from .prover import (
    CTX,
    SCAN,
    _advice_columns,
    _commit,
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


def create_proofs_batched(srs, pk: ProvingKey, builders, rng=None, device="cuda",
                          msm: str = "b4") -> list[bytes]:
    """Prove every builder in one batched pipeline; returns B proof byte
    strings, each verifiable alone.  Every builder is a witness of the key's
    circuit: the same fixed columns, lookups and copies (the shape is
    checked, `keygen.circuit_shape`).  `msm` picks the commitments' pair
    tables, "b4" or "b16"; both give the same bytes."""
    device = resolve(device)
    _check_batch(pk, builders)
    if pk.device != device or srs.device != device:
        raise ValueError(f"keys on {pk.device} and SRS on {srs.device}, proofs asked for {device}")
    _phase = _Spans(device, "prove_batch")
    if rng is None:
        rng = np.random.default_rng()
    B = len(builders)
    ctx = CTX
    domain = pk.vk.domain
    n, usable = domain.n, domain.usable_rows
    srs = srs.truncated(domain.k)
    plan, plan_ext = domain.plan(device), domain.plan_ext(device)
    pair_tables = srs.msm_tables(msm)

    def dev(words: np.ndarray) -> torch.Tensor:
        return L.to_tensor(words, device)

    def commit(rows: torch.Tensor, per: int) -> None:
        """Commit (B * per, n, 8) rows, instance after instance, each
        instance's `per` points into its transcript."""
        for i, pt in enumerate(_commit(pair_tables, rows)):
            trs[i // per].write_point(pt)

    trs = [Transcript() for _ in range(B)]
    for tr, b in zip(trs, builders):
        tr.common_scalar(pk.vk.transcript_repr)
        for v in b.instance:
            tr.common_scalar(v)

    # ---- 1. advice --------------------------------------------------------
    cols = [col for b in builders for col in _advice_columns(b, n, usable, rng)]
    raw = dev(np.stack([ctx.to_mont_np(c) for c in cols])).reshape(B, NUM_ADVICE + 1, n, L.NW)
    coeff = _coeff(raw, plan)  # (B, 6, n, 8)
    commit(coeff[:, :NUM_ADVICE].reshape(B * NUM_ADVICE, n, L.NW), NUM_ADVICE)
    _phase("advice commit")

    # ---- 2. lookups -------------------------------------------------------
    thetas = [tr.challenge() for tr in trs]
    lk_host = [np.concatenate(_lookup_columns(b, n, usable, theta, rng, separate_pads=True))
               for b, theta in zip(builders, thetas)]
    lk_raw = dev(np.stack(lk_host))  # (B, 8, n, 8): A'_a..d, then S'_a..d
    lk_coeff = _coeff(lk_raw, plan)
    ap_coeff, sp_coeff = lk_coeff[:, :NL], lk_coeff[:, NL:]
    # each instance's commitments in the single prover's order: A'_l, S'_l
    commit(torch.stack([ap_coeff, sp_coeff], dim=2).reshape(B * 2 * NL, n, L.NW), 2 * NL)
    _phase("lookup permuted")

    # ---- 3. grand products ------------------------------------------------
    betas = [tr.challenge() for tr in trs]
    gammas = [tr.challenge() for tr in trs]
    active = torch.arange(n, device=device) < usable
    omega_dev = powers(ctx, domain.omega, n, device)
    sigma_raw = _evals_batch(torch.stack(pk.sigma_coeff), plan)
    fracs_consts = np.stack([challenge_words(t, b, g, 0, pk.delta_powers)
                             for t, b, g in zip(thetas, betas, gammas)])
    num, den = gp_fracs(raw, sigma_raw, omega_dev, pk.raw_stack, lk_raw, fracs_consts,
                        usable)  # (B * 5, n, 8)
    num_a, pre, suf, totals = _gp_partials(num, den, active, SCAN)
    del num, den, omega_dev, sigma_raw
    total_ints = L.from_device_mont(ctx, totals)
    if any(t == 0 for t in total_ints):
        raise ValueError("grand product denominator vanished")
    total_inv = L.to_device_mont(ctx, [pow(t, -1, FR.p) for t in total_ints], device)
    blind = dev(ctx.to_mont_np([_rand_fr(rng) for _ in range(B * GP * (n - usable - 1))])
                ).reshape(B * GP, n - usable - 1, L.NW)
    z = _gp_finish(num_a, pre, suf, total_inv, blind, SCAN)
    del num_a, pre, suf
    z_coeff = _coeff(z, plan).reshape(B, GP, n, L.NW)
    commit(z_coeff.reshape(B * GP, n, L.NW), GP)
    _phase("grand products")

    # ---- 4. random polys --------------------------------------------------
    random_coeff = dev(_rand_fr_mont_bulk(rng, B * n)).reshape(B, n, L.NW)
    commit(random_coeff, 1)

    # ---- 5. quotient ------------------------------------------------------
    ys = [tr.challenge() for tr in trs]
    # each instance's 19 witness rows in the quotient kernel's order
    # (kernels.W_*): advice, instance, z_perm, z_l, A'_l, S'_l
    wit = torch.cat([coeff, z_coeff, ap_coeff, sp_coeff], dim=1)
    del raw, lk_raw, lk_coeff
    ext = _ext(wit.reshape(B * WIT_ROWS, n, L.NW), pk.zeta_powers, plan_ext)
    consts = np.stack([challenge_words(t, b, g, y, pk.delta_powers)
                       for t, b, g, y in zip(thetas, betas, gammas, ys)])
    h_coeff = quotient_stacked(ext.reshape(B, WIT_ROWS, domain.n_ext, L.NW), pk.ext_stack,
                               pk.x_ext, pk.zh_inv_ext[:MAX_DEGREE], consts,
                               pk.quotient_unscale, plan_ext)  # (B, n_ext, 8)
    del ext
    h_pieces = h_coeff[:, : QUOTIENT_PIECES * n].reshape(B, QUOTIENT_PIECES, n, L.NW)
    commit(h_pieces.reshape(B * QUOTIENT_PIECES, n, L.NW), QUOTIENT_PIECES)
    _phase("quotient")

    # ---- 6. evaluations ---------------------------------------------------
    xs = [tr.challenge() for tr in trs]
    stacks_b = [_open_sets(pk, coeff[i, :NUM_ADVICE], z_coeff[i, 0], z_coeff[i, 1:],
                           ap_coeff[i], sp_coeff[i], random_coeff[i], h_pieces[i])
                for i in range(B)]
    points = [p for x in xs for p in _points(domain, x)]  # 3 an instance
    point_pows = powers_rows(ctx, L.to_device_mont(ctx, points, device), n)
    pows_b = [list(point_pows[3 * i : 3 * i + 3]) for i in range(B)]
    evals = L.from_device_mont(ctx, _eval_stack_batch(stacks_b, pows_b))
    per = len(evals) // B
    for i, tr in enumerate(trs):
        for e in evals[i * per : (i + 1) * per]:
            tr.write_scalar(e)
    _phase("evals")

    # ---- 7. GWC multiopen -------------------------------------------------
    vs = [tr.challenge() for tr in trs]
    ws = _gwc_witness_batch(stacks_b, pows_b, L.to_device_mont(ctx, vs, device),
                            L.to_device_mont(ctx, [pow(p, -1, FR.p) for p in points], device))
    commit(ws, 3)
    _phase("gwc")
    return [bytes(tr.data) for tr in trs]
