"""Base-16 pair-table MSM: half the additions of the base-4 path.

Counterpart of `delay_enc_tpu/ops/msm16.py`.  The add tree is most of a
commitment's device time, so fewer, bigger digit planes pay:

  base-4  pairs: 127 planes x n/2 additions, 16-option tables (ops/msm.py)
  base-16 pairs:  64 planes x n/2 additions, 256-option tables (here)

For each adjacent pair of points (P_even, P_odd) the table holds the 256
options ce*P_even + co*P_odd, ce, co in 0..15, built once per SRS with
kernel K-d (`msm.complete_add`) in the JAX package's order of additions, so
its words equal the JAX table's.  It takes 16x the base-4 table's memory:
96 B x 256 x n/2, 805 MB at n = 2^16.

Per base-16 digit plane, each pair contributes the option its two digits
select (`pair_sel16`, the selector kernel of `csrc/msm.cu` on a card), and
each row of n/2 selected points is summed by `plane_sums16`
(`msm_tree.tree_reduce` on a 256-option table), which gathers the option
as it loads it.  The 64 plane sums of each commitment come back to the
host for the C fold (sum_p 16^p S_p).

The JAX package's `_jit_tables_to_i8` has no counterpart: its int8 layout
is the operand of the TPU's one-hot MXU product that selects the options;
on the card the selection is the gather in the plane-sum kernel's load,
which reads the table's words as they are.
"""

from __future__ import annotations

import torch

from . import limbs as L
from . import msm as M
from . import msm_tree

DIGIT_BITS = 4
PLANES = 64  # ceil(254 / 4)
OPTS = 256  # (d_even + 16 * d_odd) pair selectors


def pair_tables16(points: torch.Tensor) -> torch.Tensor:
    """(n, 3, 8) projective Montgomery -> (256, n/2, 3, 8) base-16 pair
    tables: option[ce + 16*co] = ce*P_even + co*P_odd.  Fifteen launches of
    K-d on CUDA tensors: the multiples 2..15 of the even and odd points
    together, then the 225 cross sums in one."""
    pe, po = points[0::2], points[1::2]
    m = pe.shape[0]
    both = torch.cat([pe, po])
    mult = [None, both]
    for k in range(2, 16):
        mult.append(M.complete_add(mult[k - 1], both))
    inf = M.identity_proj(points.device).expand(m, 3, L.NW)
    e_opts = [inf] + [t[:m] for t in mult[1:]]
    o_opts = [inf] + [t[m:] for t in mult[1:]]
    cross = M.complete_add(
        torch.cat([e_opts[ce] for co in range(1, 16) for ce in range(1, 16)]),
        torch.cat([o_opts[co] for co in range(1, 16) for _ in range(1, 16)]),
    )
    opts = [None] * OPTS
    for ce in range(16):
        opts[ce] = e_opts[ce]
    for co in range(1, 16):
        opts[16 * co] = o_opts[co]
        for ce in range(1, 16):
            idx = (co - 1) * 15 + (ce - 1)
            opts[ce + 16 * co] = cross[idx * m : (idx + 1) * m]
    return torch.stack(opts)


def pair_sel16(scalar_words: torch.Tensor) -> torch.Tensor:
    """(…, n, 8) canonical words -> (…, 64, n/2) uint8 pair selectors
    (digit16_even + 16 * digit16_odd per plane)."""
    return M.pair_sel(scalar_words, DIGIT_BITS)


def plane_sums_batch16(tables: torch.Tensor, scalar_words: torch.Tensor) -> torch.Tensor:
    """tables from `pair_tables16`; scalar_words (B, n, 8) canonical.
    Returns (B, 64, 3, 8) base-16 plane sums."""
    sel = pair_sel16(scalar_words)  # (B, 64, n/2)
    b = sel.shape[0]
    sums = msm_tree.tree_reduce(tables, sel.reshape(b * PLANES, -1))
    return sums.reshape(b, PLANES, 3, L.NW)


def msm16_with_tables(tables: torch.Tensor, scalar_words: torch.Tensor) -> list:
    """tables from `pair_tables16` (padded power-of-two point count);
    scalar_words (B, n, 8) canonical.  Returns B host affine points."""
    return M.fold_planes_host(plane_sums_batch16(tables, scalar_words), base_bits=DIGIT_BITS)


def msm16(points: torch.Tensor, scalar_words: torch.Tensor) -> list:
    """One-shot form: points (N, 3, 8) projective Montgomery, scalar_words
    (N, 8) canonical; builds the tables inline and returns [affine result]."""
    points, scalar_words = M._pad_pow2(points, scalar_words)
    return msm16_with_tables(pair_tables16(points), scalar_words[None])
