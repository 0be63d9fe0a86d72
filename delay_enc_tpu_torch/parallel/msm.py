"""The MSM with its points and scalars split over a mesh.

Counterpart of `delay_enc_tpu/parallel/msm.py`.  Each shard computes the
127 base-4 plane sums of its block of points and scalars with the
single-device kernels (pair tables by K-d, `pair_sel`, K-c); the shards'
sums are gathered and summed over the shards with a tree of batched
complete additions (K-d): an EC sum is no `psum`.  The 2^b-weighted fold of
the planes runs on the host, as on one device (`ops/msm.py:fold_planes_host`).
"""

from __future__ import annotations

import torch

from ..ops import msm as M
from .mesh import Mesh, all_gather, on


def _local_plane_sums(points: torch.Tensor, scalar_words: torch.Tensor) -> torch.Tensor:
    """(n_loc, 3, 8) x (n_loc, 8) -> the shard's (127, 3, 8) base-4 plane sums."""
    return M.plane_sums_batch(M.pair_tables(points), scalar_words[None])[0]


def _tree_over_devices(gathered: torch.Tensor) -> torch.Tensor:
    """(D, 127, 3, 8) -> (127, 3, 8) with batched complete adds."""
    while gathered.shape[0] > 1:
        half = gathered.shape[0] // 2
        top = M.complete_add(gathered[:half], gathered[half : 2 * half])
        if gathered.shape[0] % 2:
            top = torch.cat([top, gathered[-1:]], dim=0)
        gathered = top
    return gathered[0]


def _split(mesh: Mesh, points: torch.Tensor, scalar_words: torch.Tensor):
    n = points.shape[0]
    if scalar_words.shape[0] != n:
        raise ValueError(f"{n} points and {scalar_words.shape[0]} scalars")
    if n % mesh.size:
        raise ValueError(f"N={n} not divisible by {mesh.size} devices")
    if (n // mesh.size) % 2:
        raise ValueError("shard size must be even for pair tables")
    return mesh.scatter(points), mesh.scatter(scalar_words)


def sharded_plane_sums(mesh: Mesh, points: torch.Tensor,
                       scalar_words: torch.Tensor) -> torch.Tensor:
    """The device part of the sharded MSM: the (127, 3, 8) plane sums of all
    N points, on the mesh's first device."""
    pts, scs = _split(mesh, points, scalar_words)
    sums = []
    for i, (p, s) in enumerate(zip(pts, scs)):
        with mesh.on(i):
            sums.append(_local_plane_sums(p, s))
    gathered = all_gather(sums)[0]
    with on(gathered.device):
        return _tree_over_devices(gathered)


def sharded_msm(mesh: Mesh, points: torch.Tensor, scalar_words: torch.Tensor) -> torch.Tensor:
    """points (N, 3, 8) projective Montgomery, scalar_words (N, 8)
    canonical, N a multiple of the mesh's size with an even shard.  Returns
    the (3, 8) projective Montgomery result on the mesh's first device."""
    sums = sharded_plane_sums(mesh, points, scalar_words)
    (res,) = M.fold_planes_host(sums[None], base_bits=2)
    return M.points_to_device([res], sums.device)[0]
