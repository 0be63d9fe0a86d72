"""MSM plane sums: kernel K-c and its plain version.

Counterpart of `delay_enc_tpu/ops/msm_pallas.py`, renamed because it holds
no Pallas.  It replaces the repo's one Pallas kernel, `msm_pallas._stage`
(the `pl.pallas_call` of complete-add tree levels over (C, 48, W) blocks)
driven by `msm_pallas.tree_reduce`, and the same add tree in
`ops/msm.py:_jit_plane_sums`.

`tree_reduce(x)` sums each row of x (C, W, 3, 8) of projective Fq points
with complete additions, giving (C, 3, 8).  With `sel` (C, W) uint8, x is
the (16, W, 3, 8) base-4 pair table and lane i of row c is
x[sel[c, i], i]: the select is fused into the load.  On CUDA tensors it
launches kernel K-c (`csrc/msm.cu`: a pass of per-chunk sums, then a pass
over the chunk partials); on CPU tensors it runs `tree_reduce_plain`.
The order of additions differs between the two, so compare the results
as affine points.
"""

from __future__ import annotations

import torch

from . import _cuda
from . import limbs as L

K_TREE = _cuda.kernel(
    "plane_sums", "plane_sums",
    "delay_enc_tpu/ops/msm_pallas.py:79 _stage (pallas_call :85), tree_reduce :99",
    "delay_enc_tpu_torch/csrc/msm.cu")

CHUNK = 1024  # lanes per block in the first pass


def select_plain(table: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """(16, W, 3, 8) table, (C, W) selectors -> (C, W, 3, 8) points."""
    lanes = torch.arange(table.shape[1], device=table.device)
    return table[sel.long(), lanes]


def tree_reduce_plain(x: torch.Tensor, sel: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch plane sums: a lane-halving complete-add tree per row,
    the tree of msm_pallas._tree_body."""
    from .msm import complete_add_plain, identity_proj

    if sel is not None:
        x = select_plain(x, sel)
    c, w = x.shape[0], x.shape[1]
    w2 = 1 << max(0, (w - 1).bit_length())
    if w2 != w:
        pad = identity_proj(x.device).expand(c, w2 - w, 3, L.NW)
        x = torch.cat([x, pad], dim=1)
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        x = complete_add_plain(x[:, :h], x[:, h:])
    return x[:, 0]


def tree_reduce(x: torch.Tensor, sel: torch.Tensor | None = None) -> torch.Tensor:
    """(C, W, 3, 8) points, or the (16, W, 3, 8) table with (C, W) uint8
    selectors -> (C, 3, 8) complete-add sums of each row."""
    if x.device.type == "cpu":
        return tree_reduce_plain(x, sel)
    _cuda.require_cuda(x, sel)
    if x.dtype != torch.int32 or x.dim() != 4 or x.shape[2:] != (3, L.NW):
        raise ValueError(f"points must be int32 (…, W, 3, 8), got {x.dtype} {tuple(x.shape)}")
    x = x.contiguous()
    w = x.shape[1]
    if sel is None:
        rows = x.shape[0]
        sel_ptr = None
    else:
        if x.shape[0] != 16 or sel.dtype != torch.uint8 or sel.dim() != 2 \
                or sel.shape[1] != w or sel.device != x.device:
            raise ValueError("selector mode takes a (16, W, 3, 8) table and (C, W) uint8")
        sel = sel.contiguous()
        rows = sel.shape[0]
        sel_ptr = _cuda.ptr(sel)
    if rows == 0:
        return x.new_empty((0, 3, L.NW))
    if rows > 65535:
        raise ValueError("at most 65535 rows per launch")
    chunks = -(-w // CHUNK)
    part = torch.empty((rows, chunks, 3, L.NW), dtype=torch.int32, device=x.device)
    K_TREE(_cuda.ptr(x), sel_ptr, _cuda.ptr(part), rows, w, CHUNK, _cuda.stream())
    if chunks == 1:
        return part[:, 0]
    out = torch.empty((rows, 1, 3, L.NW), dtype=torch.int32, device=x.device)
    K_TREE(_cuda.ptr(part), None, _cuda.ptr(out), rows, chunks, chunks, _cuda.stream())
    return out[:, 0]
