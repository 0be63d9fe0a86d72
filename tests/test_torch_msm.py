"""Port parity: BN254 G1 complete addition (plain K-d), the plane-sum tree
(plain K-c), pair tables, msm and fixed_base_batch_mul of
delay_enc_tpu_torch.ops against delay_enc_tpu.ops, compared as affine
points (projective coordinates are not unique)."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from delay_enc_tpu.curves.bn254 import G1, G1_GEN
from delay_enc_tpu.fields import FR
from delay_enc_tpu.native.ec import msm_host
from delay_enc_tpu.ops import msm as JM
from delay_enc_tpu.ops import msm_pallas as JMP
from delay_enc_tpu_torch.ops import limbs as TL
from delay_enc_tpu_torch.ops import msm as TM
from delay_enc_tpu_torch.ops import msm_tree as TT


def _host_points(n, seed):
    rng = np.random.default_rng(seed)
    return [G1.mul(G1_GEN, int(rng.integers(1, 1 << 62))) for _ in range(n)]


def _to_jax(t):
    return jnp.asarray(TL.words_to_limbs_np(TL.to_numpy(t)))


def test_complete_add_matches_jax_and_host():
    pts = _host_points(12, 0)
    p, q = pts[:6], pts[6:]
    p += [pts[0], pts[1], None, None, pts[2]]
    q += [pts[0], G1.neg(pts[1]), pts[3], None, None]  # doubling, P + -P, identities
    a, b = TM.points_to_device(p, "cpu"), TM.points_to_device(q, "cpu")
    got = TM.complete_add(a, b)
    want = jax.jit(JM.complete_add)(_to_jax(a), _to_jax(b))
    # identical formulas on identical inputs: even the projective words agree
    assert np.array_equal(TL.words_to_limbs_np(TL.to_numpy(got)), np.asarray(want))
    assert TM.points_from_device(got) == [G1.add(x, y) for x, y in zip(p, q)]


def test_tree_reduce_matches_jax_tree_body():
    """Eight lanes with an identity lane, against msm_pallas._tree_body run
    eagerly (the pattern of tests/test_msm_pallas.py)."""
    rng = np.random.default_rng(12)
    w = 8
    pts = [G1.mul(G1_GEN, int(rng.integers(1, 1 << 48))) for _ in range(w)]
    pts[3] = None
    dev = TM.points_to_device(pts, "cpu")
    got = TT.tree_reduce(dev[None])  # (1, 3, 8)
    x = _to_jax(dev).reshape(1, w, 48).transpose(0, 2, 1).astype(jnp.uint32)[0]
    with jax.disable_jit():
        reduced = JMP._tree_body(x, levels=3)  # (48, 1)
    want = JM.points_from_device(reduced.T.reshape(1, 3, 16))
    assert TM.points_from_device(got) == want
    acc = None
    for pt in pts:
        acc = G1.add(acc, pt)
    assert want == [acc]


def test_tree_reduce_selector_mode_and_odd_width():
    pts = _host_points(10, 3)
    table = TM.pair_tables(TM.points_to_device(pts, "cpu"))  # (16, 5, 3, 8)
    rng = np.random.default_rng(4)
    sel_np = rng.integers(0, 16, (3, 5), dtype=np.uint8)
    got = TM.points_from_device(TT.tree_reduce(table, torch.from_numpy(sel_np)))
    for row, s in zip(got, sel_np):
        acc = None
        for i, o in enumerate(s):
            ce, co = int(o) % 4, int(o) // 4
            acc = G1.add(acc, G1.add(G1.mul(pts[2 * i], ce) if ce else None,
                                     G1.mul(pts[2 * i + 1], co) if co else None))
        assert row == acc


def test_pair_tables_match_jax():
    pts = _host_points(8, 5)
    dev = TM.points_to_device(pts, "cpu")
    got = TM.pair_tables(dev)
    want = np.asarray(JM._jit_pair_tables(_to_jax(dev))).astype(np.uint32)
    assert got.shape == (16, 4, 3, 8)
    assert np.array_equal(TL.words_to_limbs_np(TL.to_numpy(got)), want)


def test_pair_sel_matches_jax():
    rng = np.random.default_rng(6)
    vals = [FR.random(rng) for _ in range(16)] + [FR.p - 1, 0]
    words = TM.scalars_to_words(vals, "cpu")
    got = TM.pair_sel(words[None]).numpy()
    want = np.asarray(JM._jit_pair_sel(jnp.asarray(TL.words_to_limbs_np(TL.to_numpy(words)))[None]))
    assert np.array_equal(got, want)


def test_msm_matches_jax_and_host():
    n = 64
    pts = _host_points(n - 1, 7) + [None]
    rng = np.random.default_rng(8)
    scalars = [FR.random(rng) for _ in range(n)]
    scalars[5] = 0
    dev_pts = TM.points_to_device(pts, "cpu")
    got = TM.points_from_device(TM.msm(dev_pts, TM.scalars_to_words(scalars, "cpu")))[0]
    want = JM.points_from_device(
        JM.msm(_to_jax(dev_pts), JM.scalars_to_limbs(scalars)))[0]
    assert got == want
    assert got == msm_host(scalars, pts, FR.p)


def test_msm_pads_non_power_of_two():
    pts = _host_points(5, 9)
    scalars = [3, 5, 7, 11, 13]
    got = TM.points_from_device(TM.msm(TM.points_to_device(pts, "cpu"),
                                       TM.scalars_to_words(scalars, "cpu")))[0]
    acc = None
    for s, pt in zip(scalars, pts):
        acc = G1.add(acc, G1.mul(pt, s))
    assert got == acc


def test_fixed_base_batch_mul_matches_host():
    rng = np.random.default_rng(10)
    scalars = [FR.random(rng) for _ in range(14)] + [0, 1]
    table = TM.base_table(G1_GEN, "cpu")
    got = TM.points_from_device(TM.fixed_base_batch_mul(table, TM.scalars_to_words(scalars, "cpu")))
    assert got == [G1.mul(G1_GEN, s) for s in scalars]
