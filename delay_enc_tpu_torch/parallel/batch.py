"""Batch commitments with the instance axis split over a mesh.

Counterpart of `delay_enc_tpu/parallel/batch.py`: the data-parallel axis,
many polynomials (or many proofs' columns) committed at once.  The SRS is
replicated (shared where shards share a device), the (B, n, 8) batch of
coefficient vectors is split into D contiguous groups of instances, one a
shard, and each shard runs the single-device commitment kernels over its
group (pair tables by K-d, `pair_sel`, K-c); each instance's 127 plane
sums come back to the host for the fold.
"""

from __future__ import annotations

import torch

from ..ops import msm as M
from .mesh import Mesh


def _tables(points: torch.Tensor, device) -> torch.Tensor:
    return M.pair_tables(points.to(device))


def batch_plane_sums(mesh: Mesh, g1_powers: torch.Tensor, coeff_batch: torch.Tensor) -> list:
    """g1_powers (n, 3, 8) on any device, replicated; coeff_batch (B, n, 8)
    canonical scalars, B a multiple of the mesh's size.  Returns each
    shard's (B/D, 127, 3, 8) plane sums, on its device."""
    b = coeff_batch.shape[0]
    if b % mesh.size:
        raise ValueError(f"a batch of {b} does not split over {mesh.size} shards")
    if coeff_batch.shape[1] != g1_powers.shape[0] or g1_powers.shape[0] % 2:
        raise ValueError(f"{coeff_batch.shape[1]} coefficients a row against "
                         f"{g1_powers.shape[0]} points (an even count)")
    groups = mesh.scatter(coeff_batch)
    tables: dict = {}
    sums = []
    for i, group in enumerate(groups):
        dev = mesh.devices[i]
        with mesh.on(i):
            if dev not in tables:
                tables[dev] = _tables(g1_powers, dev)
            sums.append(M.plane_sums_batch(tables[dev], group))
    return sums


def batch_commit(mesh: Mesh, g1_powers: torch.Tensor, coeff_batch: torch.Tensor) -> torch.Tensor:
    """The (B, 3, 8) projective Montgomery commitments of the batch, on the
    mesh's first device."""
    sums = batch_plane_sums(mesh, g1_powers, coeff_batch)
    folded = [pt for s in sums for pt in M.fold_planes_host(s, base_bits=2)]
    return M.points_to_device(folded, mesh.devices[0])
