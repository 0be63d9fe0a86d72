"""Proving over a mesh of shards (delay_enc_tpu_torch/parallel/) against the
JAX package, on the CPU.

The CPU mesh is `Mesh.shared("cpu", D)`: D shards on one device, which runs
every stage of the algorithms (the exchanges are copies that stay on the
device), as the JAX tests run 8 virtual CPU devices.  Inputs come from
numpy seeds; every comparison is exact: Montgomery words for field data,
affine points for curve points, bytes for proofs.  The comparison with the
JAX package's own sharded functions takes minutes of XLA:CPU compile and is
marked slow.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax

from delay_enc_tpu.fields import FR
from delay_enc_tpu.ops import limbs as JL
from delay_enc_tpu.ops import ntt as JN
from delay_enc_tpu_torch.curves.bn254 import G1, G1_GEN
from delay_enc_tpu_torch.ops import limbs as TL
from delay_enc_tpu_torch.ops import msm as TM
from delay_enc_tpu_torch.ops import ntt as TN
from delay_enc_tpu_torch.parallel import (
    Mesh,
    ShardedNTTPlan,
    batch_commit,
    dryrun_multichip,
    make_mesh,
    sharded_intt,
    sharded_msm,
    sharded_ntt,
    sharded_plane_sums,
)
from delay_enc_tpu_torch.parallel import mesh as PM
from delay_enc_tpu_torch.parallel import ntt as PN

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_batch import SEED, golden, port  # noqa: E402,F401
from test_torch_prover import one_thread  # noqa: E402,F401

K = 7  # N = 128: D = 8 gives shards of 16, the JAX tests' size


def _rand_mont(rng, count):
    return TL.FR_CTX.to_mont_np([FR.random(rng) for _ in range(count)])


def _limbs(t):
    return TL.words_to_limbs_np(TL.to_numpy(t))


@pytest.fixture(scope="module")
def coeffs():
    """The k=7 coefficients and their JAX single-chip NTT."""
    a = _rand_mont(np.random.default_rng(1), 1 << K)
    jplan = JN.NTTPlan.make(JL.FR_CTX, K)
    want = np.asarray(jax.jit(lambda x: JN.ntt(jplan, x))(TL.words_to_limbs_np(a)))
    return TL.to_tensor(a, "cpu"), want


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_sharded_ntt_matches_jax_and_roundtrips(coeffs, ndev):
    """The sharded NTT equals the JAX package's single-chip NTT and the
    port's own; the sharded iNTT returns the input."""
    a, want = coeffs
    mesh = Mesh.shared("cpu", ndev)
    plan = ShardedNTTPlan.make(K, ndev, mesh.devices)
    evals = sharded_ntt(mesh, plan, a)
    assert len(evals) == ndev and all(e.shape == ((1 << K) // ndev, 8) for e in evals)
    got = mesh.gather(evals)
    assert np.array_equal(_limbs(got), want)
    assert torch.equal(got, TN.ntt(TN.NTTPlan.make(TL.FR_CTX, K, "cpu"), a))
    assert torch.equal(mesh.gather(sharded_intt(mesh, plan, evals)), a)
    # the shards as a list go in as the whole tensor does
    assert torch.equal(mesh.gather(sharded_ntt(mesh, plan, mesh.scatter(a))), got)


def test_sharded_ntt_preconditions(coeffs):
    a, _ = coeffs
    with pytest.raises(ValueError, match="power of two"):
        ShardedNTTPlan.make(K, 3, "cpu")
    with pytest.raises(ValueError, match="D\\^2 <= N"):
        ShardedNTTPlan.make(K, 16, "cpu")
    with pytest.raises(ValueError, match="devices for"):
        ShardedNTTPlan.make(K, 4, ["cpu"] * 2)
    plan = ShardedNTTPlan.make(K, 4, "cpu")
    with pytest.raises(ValueError, match="plan for"):
        sharded_ntt(Mesh.shared("cpu", 2), plan, a)
    with pytest.raises(ValueError, match="shards for a plan"):
        sharded_intt(Mesh.shared("cpu", 4), plan, Mesh.shared("cpu", 2).scatter(a))
    with pytest.raises(ValueError, match="a shard must be"):
        sharded_ntt(Mesh.shared("cpu", 4), plan, a[:64])


def test_plan_rows_match_jax():
    """The twiddle rows, made on the device by powers, equal the JAX plan's
    per-element Python pow, top rows (ones) included; so do the reversal and
    the local plan's root."""
    from delay_enc_tpu.parallel.ntt import ShardedNTTPlan as JPlan

    ndev = 8
    want = JPlan.make(K, ndev)
    got = ShardedNTTPlan.make(K, ndev, "cpu")
    assert len(got.stage_tw) == len(want.stage_tw) == 3
    for mine, theirs in ((got.stage_tw, want.stage_tw), (got.stage_tw_inv, want.stage_tw_inv)):
        for rows, jrows in zip(mine, theirs):
            assert np.array_equal(_limbs(torch.stack(rows)), np.asarray(jrows))
    assert got.rev_idx == [int(r) for r in np.asarray(want.rev_idx)]
    assert got.local_plan.omega == want.local_plan.omega
    assert _limbs(got.n_inv[0])[0].tolist() == np.asarray(want.n_inv).tolist()


def _carry_heavy():
    """Words that make the carry and borrow chains run long, each against
    each: p - 1, 0, 1, 2^255 - 1 reduced, R mod p, all-ones words."""
    ones = (1 << 256) - 1
    vals = [FR.p - 1, 0, 1, ((1 << 255) - 1) % FR.p, (1 << 256) % FR.p, FR.p - 2,
            ones >> 3, 0xFFFFFFFF << 64, (1 << 224) + 1]
    m = len(vals)
    x = [v for v in vals for _ in range(m)]
    r = [v for _ in range(m) for v in vals]
    return TL.ints_to_words_np(x), TL.ints_to_words_np(r)


@pytest.mark.parametrize("table", ["none", "const", "row"])
@pytest.mark.parametrize("top", [True, False])
def test_shard_butterfly_plain_matches_jax(top, table):
    """The plain butterfly equals the JAX stage's L.add / L.sub and
    L.mont_mul, on carry-heavy operands, in both positions, with a row,
    with one element and with no table."""
    x, r = _carry_heavy()
    n = x.shape[0]
    rng = np.random.default_rng(7)
    tab = {"none": None, "const": _rand_mont(rng, 1), "row": _rand_mont(rng, n)}[table]
    got = PN.shard_butterfly(TL.to_tensor(x, "cpu"), TL.to_tensor(r, "cpu"), top,
                             None if tab is None else TL.to_tensor(tab, "cpu"))
    jx, jr = TL.words_to_limbs_np(x), TL.words_to_limbs_np(r)
    want = JL.add(JL.FR_CTX, jx, jr) if top else JL.sub(JL.FR_CTX, jr, jx)
    if tab is not None:
        want = JL.mont_mul(JL.FR_CTX, want, TL.words_to_limbs_np(tab))
    assert np.array_equal(_limbs(got), np.asarray(want))


def test_shard_butterfly_refusals():
    x = torch.zeros((16, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="two \\(L, 8\\)"):
        PN.shard_butterfly(x, x[:8], True)
    with pytest.raises(ValueError, match="one element or a row"):
        PN.shard_butterfly(x, x, False, x[:4])
    with pytest.raises(ValueError, match="operands on"):
        PN.shard_butterfly(x, x.to("meta"), True)
    with pytest.raises(ValueError, match="field operand"):
        PN.shard_butterfly(x.long(), x, True)


def _host_points(rng, n):
    return [G1.mul(G1_GEN, int(rng.integers(1, 1 << 60))) for _ in range(n)]


@pytest.mark.parametrize("n", [16, 1 << 10])
def test_sharded_msm_matches_host(n):
    """The sharded MSM over 8 shards equals the host's MSM."""
    rng = np.random.default_rng(n)
    pts = _host_points(rng, n)
    scalars = [FR.random(rng) for _ in range(n)]
    want = G1.msm(scalars, pts) if n <= 16 else G1.multi_scalar_mul(scalars, pts)
    mesh = Mesh.shared("cpu", 8)
    p, s = TM.points_to_device(pts, "cpu"), TM.scalars_to_words(scalars, "cpu")
    assert TM.points_from_device(sharded_msm(mesh, p, s)[None]) == [want]


def test_sharded_msm_refusals():
    p = TM.points_to_device([G1_GEN] * 12, "cpu")
    s = TM.scalars_to_words([1] * 12, "cpu")
    with pytest.raises(ValueError, match="not divisible"):
        sharded_msm(Mesh.shared("cpu", 8), p, s)
    with pytest.raises(ValueError, match="even"):
        sharded_msm(Mesh.shared("cpu", 4), p, s)
    with pytest.raises(ValueError, match="12 points and 10 scalars"):
        sharded_msm(Mesh.shared("cpu", 2), p, s[:10])


def test_batch_commit_matches_serial():
    """Commitments of 8 rows over 8 shards, one row a shard, equal the
    port's serial MSM of each row; a batch that does not split raises."""
    rng = np.random.default_rng(3)
    n, batch = 8, 8
    g1 = TM.points_to_device(_host_points(rng, n), "cpu")
    coeffs = torch.stack([TM.scalars_to_words([FR.random(rng) for _ in range(n)], "cpu")
                          for _ in range(batch)])
    got = batch_commit(Mesh.shared("cpu", 8), g1, coeffs)
    want = [TM.points_from_device(TM.msm(g1, row)[None])[0] for row in coeffs]
    assert TM.points_from_device(got) == want
    assert TM.points_from_device(batch_commit(Mesh.shared("cpu", 2), g1, coeffs)) == want
    with pytest.raises(ValueError, match="does not split"):
        batch_commit(Mesh.shared("cpu", 3), g1, coeffs)


def test_mesh_and_exchanges():
    """make_mesh takes devices that exist and refuses to share one quietly;
    the exchanges move blocks as JAX's collectives do."""
    assert make_mesh(1, "cpu").devices == (torch.device("cpu"),)
    with pytest.raises(RuntimeError, match="Mesh.shared"):
        make_mesh(4, "cpu")
    mesh = Mesh.shared("cpu", 4, axis="dp")
    assert mesh.size == 4 and mesh.axis_names == ("dp",)
    assert mesh.distinct == [torch.device("cpu")]
    with pytest.raises(ValueError, match="one shard or more"):
        Mesh.shared("cpu", 0)
    shards = [torch.full((4, 2), i) for i in range(4)]
    perm = PM.ppermute(shards, [(i, i ^ 1) for i in range(4)])
    assert [int(t[0, 0]) for t in perm] == [1, 0, 3, 2]
    gathered = PM.all_gather(shards)
    assert all(g is gathered[0] for g in gathered)  # one device: one stack
    assert torch.equal(gathered[0][:, 0, 0], torch.arange(4))
    blocks = [torch.arange(4 * 3).reshape(4, 3) + 100 * i for i in range(4)]
    out = PM.all_to_all(blocks)
    for j in range(4):
        for i in range(4):
            assert torch.equal(out[j][i], blocks[i][j])
    with pytest.raises(ValueError, match="blocks along axis"):
        PM.all_to_all(blocks[:3])
    with pytest.raises(ValueError, match="do not split"):
        mesh.scatter(torch.zeros(6, 8))


@pytest.mark.parametrize("msm", ["b4", "b16"])
def test_sharded_batch_equals_golden(port, golden, msm):
    """The batch of the two witnesses split over two shards gives the JAX
    package's batch bytes (tests/data/torch_port_batch_k7.npz), in both
    bases."""
    from delay_enc_tpu_torch.plonk import create_proofs_batched

    srs, pk, _, builders = port
    mesh = Mesh.shared("cpu", 2, axis="dp")
    proofs = create_proofs_batched(srs, pk, builders, np.random.default_rng(SEED), msm=msm,
                                   mesh=mesh)
    assert [np.frombuffer(p, np.uint8).tolist() for p in proofs] == \
        [g.tolist() for g in golden["proofs"]]


def test_sharded_batch_refusals(port):
    from delay_enc_tpu_torch.plonk import create_proofs_batched

    srs, pk, _, builders = port
    with pytest.raises(ValueError, match="does not split over 2"):
        create_proofs_batched(srs, pk, builders[:1], mesh=Mesh.shared("cpu", 2, axis="dp"))
    with pytest.raises(ValueError, match="axis is 'shard'"):
        create_proofs_batched(srs, pk, builders, mesh=Mesh.shared("cpu", 2))


def test_key_replica_proves_the_same_bytes(port, golden):
    """A key copied to another device (here a copy on the CPU) keeps its
    views of one stack as views, and proves the golden bytes."""
    from delay_enc_tpu_torch.plonk import create_proofs_batched
    from delay_enc_tpu_torch.plonk.batch_prover import _key_to, _srs_to

    srs, pk, _, builders = port
    pk2, srs2 = _key_to(pk, torch.device("cpu")), _srs_to(srs, torch.device("cpu"))
    assert pk2.raw_stack.data_ptr() != pk.raw_stack.data_ptr()
    first = next(iter(pk2.fixed_raw.values()))
    assert first.untyped_storage().data_ptr() == pk2.raw_stack.untyped_storage().data_ptr()
    proofs = create_proofs_batched(srs2, pk2, builders, np.random.default_rng(SEED),
                                   device="cpu")
    assert [np.frombuffer(p, np.uint8).tolist() for p in proofs] == \
        [g.tolist() for g in golden["proofs"]]


def test_dryrun_fast_on_two_cpu_shards(capsys):
    dryrun_multichip(2, devices=["cpu"] * 2, fast=True)
    assert "dryrun_multichip(2): ok" in capsys.readouterr().out


@pytest.mark.slow
def test_parallel_matches_jax_parallel():
    """sharded_ntt, sharded_intt, sharded_plane_sums and batch_commit equal
    the JAX package's parallel.* on its 8-device CPU mesh."""
    import jax.numpy as jnp

    from delay_enc_tpu.ops import msm as JM
    from delay_enc_tpu.parallel import batch_commit as jbatch_commit
    from delay_enc_tpu.parallel import make_mesh as jmake_mesh
    from delay_enc_tpu.parallel.msm import sharded_plane_sums as jsharded_plane_sums
    from delay_enc_tpu.parallel.ntt import ShardedNTTPlan as JPlan
    from delay_enc_tpu.parallel.ntt import sharded_intt as jsharded_intt
    from delay_enc_tpu.parallel.ntt import sharded_ntt as jsharded_ntt

    jmesh = jmake_mesh(8)
    mesh = Mesh.shared("cpu", 8)
    rng = np.random.default_rng(11)
    a = _rand_mont(rng, 1 << K)
    jplan, plan = JPlan.make(K, 8), ShardedNTTPlan.make(K, 8, mesh.devices)
    jevals = jsharded_ntt(jmesh, jplan, TL.words_to_limbs_np(a))
    evals = sharded_ntt(mesh, plan, TL.to_tensor(a, "cpu"))
    assert np.array_equal(_limbs(mesh.gather(evals)), np.asarray(jevals))
    jback = jsharded_intt(jmesh, jplan, jevals)
    assert np.array_equal(_limbs(mesh.gather(sharded_intt(mesh, plan, evals))),
                          np.asarray(jback))

    n = 16
    pts = _host_points(rng, n)
    scalars = [FR.random(rng) for _ in range(n)]
    jsums = jsharded_plane_sums(jmesh, JM.points_to_device(pts), JM.scalars_to_limbs(scalars))
    sums = sharded_plane_sums(mesh, TM.points_to_device(pts, "cpu"),
                              TM.scalars_to_words(scalars, "cpu"))
    assert TM.points_from_device(sums) == JM.points_from_device(jsums)

    coeff_rows = [[FR.random(rng) for _ in range(8)] for _ in range(8)]
    jout = jbatch_commit(jmesh, JM.points_to_device(pts[:8]),
                         jnp.stack([JM.scalars_to_limbs(r) for r in coeff_rows]))
    out = batch_commit(mesh, TM.points_to_device(pts[:8], "cpu"),
                       torch.stack([TM.scalars_to_words(r, "cpu") for r in coeff_rows]))
    assert TM.points_from_device(out) == JM.points_from_device(jout)
