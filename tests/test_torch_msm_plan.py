"""Port parity and launch plans of the redesigned MSM kernels: how
`msm_tree.plan` cuts rows into runs, chunks and passes, how many threads
share a scalar in the fixed-base kernel, and the plain versions of the
fixed-base multiplication and of the selector-mode plane sums against the
JAX package (exact, points compared as affine)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from delay_enc_tpu.curves.bn254 import G1, G1_GEN
from delay_enc_tpu.fields import FR
from delay_enc_tpu.ops import msm as JM
from delay_enc_tpu.ops import msm_pallas as JMP
from delay_enc_tpu_torch.ops import limbs as TL
from delay_enc_tpu_torch.ops import msm as TM
from delay_enc_tpu_torch.ops import msm_tree as TT

W16 = 1 << 15  # pair lanes of a k=16 commitment
W11 = 1 << 10  # and of a k=11 one

# (rows, W): the batches of a delay_enc k=16 proof (5, 8, 5, 1, 7 and 3
# columns of 127 planes), keygen's commits, the k=11 path, the shape timed
# on the card, and the corners
SHAPES = [(c * 127, W16) for c in (5, 8, 1, 7, 3, 15, 6, 21)] \
    + [(c * 127, W11) for c in (1, 5, 8, 21)] \
    + [(16, W16), (1, W16), (1, 1), (1, 3), (5, 1), (3, 5), (3, 1007), (3, 8197),
       (65535 + 1, 4), (2, 1 << 24)]


@pytest.mark.parametrize("rows,width", SHAPES, ids=[f"{r}x{w}" for r, w in SHAPES])
def test_plan_covers_every_lane_once_within_the_grid_limits(rows, width):
    passes = TT.plan(rows, width)
    assert 1 <= len(passes) <= 2
    w = width
    for p in passes:
        assert p.width == w
        assert p.threads in (32, 64, 128) and p.run >= 1
        assert 1 <= p.chunks <= 65535 and rows <= 2**31 - 1  # gridDim.y and gridDim.x
        # the chunks tile [0, w) in order, and so do the threads' runs
        bounds = p.chunk_bounds()
        assert bounds[0][0] == 0 and bounds[-1][1] == w
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        assert all(hi - lo <= p.run * p.threads for lo, hi in bounds)
        assert all(lo < hi for lo, hi in bounds)  # no chunk is idle
        total = p.chunks * p.threads
        for g in {0, 1 % total, p.threads - 1, p.threads % total, total - 1}:
            lo, hi = min(w, g * p.run), min(w, (g + 1) * p.run)
            q = g // p.threads
            assert bounds[q][0] <= lo <= hi <= bounds[q][1]
        if total <= 1 << 16:
            runs = [(min(w, g * p.run), min(w, (g + 1) * p.run)) for g in range(total)]
            assert runs[0][0] == 0 and runs[-1][1] == w
            assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
        if not p.fold:
            assert p.run % 16 == 0  # whole 16-byte selector reads
        w = p.out_width
    assert passes[-1].fold and w == 1


def test_plan_fills_the_card_when_rows_are_few():
    """One column (127 rows) and the 16 rows timed on the card must not
    leave most SMs idle: the serial pass has at least one block an SM."""
    for rows in (16, 127):
        first = TT.plan(rows, W16)[0]
        assert not first.fold
        assert rows * first.chunks >= TT.SMS


def test_plan_rejects_empty_input():
    with pytest.raises(ValueError):
        TT.plan(0, 8)
    with pytest.raises(ValueError):
        TT.plan(8, 0)


@pytest.mark.parametrize("n", [1, 1 << 10, 1 << 11, 1 << 16, 1 << 20])
def test_fixed_base_split_divides_a_warp(n):
    s = TM.fixed_base_split(n)
    assert s in (1, 2, 4, 8, 16, 32)
    # splitting stops once the threads fill the card a few times over
    assert s == 1 or n * s <= 4 * TT.SMS * TT.SM_THREADS


def _to_jax(t):
    return jnp.asarray(TL.words_to_limbs_np(TL.to_numpy(t)))


def test_fixed_base_plain_matches_jax():
    rng = np.random.default_rng(21)
    scalars = [0, 1, FR.p - 1, 1 << 200] + [FR.random(rng) for _ in range(4)]
    table = TM.base_table(G1_GEN, "cpu")
    got = TM.fixed_base_batch_mul_plain(table, TM.scalars_to_words(scalars, "cpu"))
    want = jax.jit(JM.fixed_base_batch_mul)(JM.base_table(G1_GEN), JM.scalars_to_limbs(scalars))
    assert TM.points_from_device(got) == JM.points_from_device(want)
    assert TM.points_from_device(got) == [G1.mul(G1_GEN, s) for s in scalars]
    # the wrapper takes the plain version for CPU tensors
    again = TM.fixed_base_batch_mul(table, TM.scalars_to_words(scalars, "cpu"))
    assert torch.equal(again, got)


def test_fixed_base_refuses_wrong_shapes_off_the_cpu():
    table = TM.base_table(G1_GEN, "cpu")
    words = TM.scalars_to_words([1, 2], "cpu")
    with pytest.raises(ValueError):
        TM.fixed_base_batch_mul(table.to("meta"), words)
    with pytest.raises(ValueError):
        TM.fixed_base_batch_mul(table.to("meta"), words.to("meta"))


def test_tree_reduce_selector_mode_matches_jax_tree_body_at_width_16():
    """Sixteen selected lanes, against msm_pallas._tree_body run eagerly on
    the same selected points (the pattern of tests/test_msm_pallas.py)."""
    rng = np.random.default_rng(22)
    w = 16
    pts = [G1.mul(G1_GEN, int(rng.integers(1, 1 << 48))) for _ in range(2 * w)]
    table = TM.pair_tables(TM.points_to_device(pts, "cpu"))  # (16, 16, 3, 8)
    sel_np = rng.integers(0, 16, (1, w), dtype=np.uint8)
    sel_np[0, 2] = 0  # an identity lane
    sel = torch.from_numpy(sel_np)
    got = TM.points_from_device(TT.tree_reduce(table, sel))
    lanes = TT.select_plain(table, sel)[0]  # (16, 3, 8)
    x = _to_jax(lanes).reshape(1, w, 48).transpose(0, 2, 1).astype(jnp.uint32)[0]
    with jax.disable_jit():
        reduced = JMP._tree_body(x, levels=4)  # (48, 1)
    want = JM.points_from_device(reduced.T.reshape(1, 3, 16))
    assert got == want
    acc = None
    for i, o in enumerate(sel_np[0]):
        ce, co = int(o) % 4, int(o) // 4
        acc = G1.add(acc, G1.add(G1.mul(pts[2 * i], ce) if ce else None,
                                 G1.mul(pts[2 * i + 1], co) if co else None))
    assert want == [acc]
