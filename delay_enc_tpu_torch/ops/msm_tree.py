"""MSM plane sums: kernels K-c and plane_sums16, and their plain version.

K-c is the counterpart of `delay_enc_tpu/ops/msm.py:_jit_plane_sums`
(:328), the base-4 select and its XLA add tree.  `plane_sums16` is the
counterpart of `delay_enc_tpu/ops/msm_pallas.py` (renamed here because it
holds no Pallas): the repo's one Pallas kernel, `msm_pallas._stage` (the
`pl.pallas_call` of complete-add tree levels over (C, 48, W) blocks) driven
by `msm_pallas.tree_reduce`, whose only caller is the base-16 MSM
`ops/msm16.py:_jit_plane_sums16`, with the one-hot MXU select before it.

`tree_reduce(x)` sums each row of x (C, W, 3, 8) of projective Fq points
with complete additions, giving (C, 3, 8).  With `sel` (C, W) uint8, x is
a pair table, the (16, W, 3, 8) base-4 one or the (256, W, 3, 8) base-16
one, and lane i of row c is x[sel[c, i], i]: the select is fused into the
load.  On CUDA tensors it launches K-c (16 options, and rows of points) or
`plane_sums16` (256 options) once for each pass that `plan` lays out: as a
rule a pass of serial runs, one partial sum a thread, then a pass that
folds each row's partials.  On CPU tensors it runs `tree_reduce_plain`.
The order of additions differs between the two, so compare the results as
affine points.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import _cuda
from . import limbs as L

K_TREE = _cuda.kernel(
    "plane_sums", "plane_sums",
    "delay_enc_tpu/ops/msm.py:328 _jit_plane_sums (base-4 select and XLA add tree)",
    "delay_enc_tpu_torch/csrc/msm.cu")
K_TREE16 = _cuda.kernel(
    "plane_sums16", "plane_sums16",
    "delay_enc_tpu/ops/msm_pallas.py:79 _stage (pallas_call :85), tree_reduce :99, and the "
    "one-hot select of ops/msm16.py:164 _jit_plane_sums16 (:170-187)",
    "delay_enc_tpu_torch/csrc/msm.cu")
OPTIONS = {16: K_TREE, 256: K_TREE16}  # pair-table options -> kernel

SMS = 132  # streaming multiprocessors of the H100 the plan is laid out for
SM_THREADS = 384  # resident threads an SM: MSM_MIN_BLOCKS x SUM_THREADS of csrc/msm.cu
BLOCK = 128  # threads a block of the serial pass (SUM_THREADS)
FOLD_BLOCKS = (32, 64, 128)  # block sizes the folding pass may take
MAX_CHUNKS = 65535  # CUDA's limit on gridDim.y
MAX_ROWS = 2**31 - 1  # and on gridDim.x


@dataclass(frozen=True)
class Pass:
    """One launch of K-c over rows of `width` points: thread t of chunk q
    sums lanes [g * run, min(width, (g + 1) * run)) with g = q * threads + t.
    A folding pass leaves one point a chunk, a serial one a point a thread."""

    width: int
    run: int
    threads: int
    chunks: int
    fold: bool

    @property
    def out_width(self) -> int:
        return self.chunks if self.fold else self.chunks * self.threads

    def chunk_bounds(self) -> list:
        """[lo, hi) of the lanes each chunk's block sums."""
        size = self.run * self.threads
        return [(min(self.width, q * size), min(self.width, (q + 1) * size))
                for q in range(self.chunks)]

    def cost(self, rows: int) -> int:
        """Additions in sequence, in the time of one wave of resident
        threads: waves of blocks times the additions a thread makes."""
        waves = -(-rows * self.chunks // (SMS * (SM_THREADS // self.threads)))
        # a fold is 5 shuffle levels in a warp, then one level for each doubling of warps
        tail = 5 + (self.threads // 32).bit_length() - 1 if self.fold else 0
        return waves * (self.run + tail)


def _fold_pass(rows: int, width: int) -> Pass:
    """The cheapest single block a row that sums `width` points."""
    options = [Pass(width, -(-width // f), f, 1, True) for f in FOLD_BLOCKS]
    return min(options, key=lambda p: p.cost(rows))


def plan(rows: int, width: int) -> tuple:
    """The passes that sum `rows` rows of `width` points: either one folding
    pass, or a serial pass with runs of a multiple of 16 lanes (so that the
    selectors of a run are whole 16-byte reads) and a folding pass over its
    partial sums, whichever costs less by `Pass.cost`.  Long runs keep the
    folding pass short; short runs fill the card when there are few rows."""
    if rows < 1 or width < 1:
        raise ValueError(f"nothing to sum: {rows} rows of {width} points")
    if rows > MAX_ROWS:
        raise ValueError(f"at most {MAX_ROWS} rows a launch")
    best = (_fold_pass(rows, width),)
    for run in range(16, 513, 16):
        chunks = -(-width // (BLOCK * run))
        if chunks > MAX_CHUNKS or (run > 16 and BLOCK * (run - 16) >= width):
            continue
        first = Pass(width, run, BLOCK, chunks, False)
        both = (first, _fold_pass(rows, first.out_width))
        if sum(p.cost(rows) for p in both) < sum(p.cost(rows) for p in best):
            best = both
    return best


def select_plain(table: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """(16 or 256, W, 3, 8) table, (C, W) selectors -> (C, W, 3, 8) points."""
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
    """(C, W, 3, 8) points, or a (16 or 256, W, 3, 8) pair table with (C, W)
    uint8 selectors -> (C, 3, 8) complete-add sums of each row."""
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
        kern = K_TREE
    else:
        if x.shape[0] not in OPTIONS or sel.dtype != torch.uint8 or sel.dim() != 2 \
                or sel.shape[1] != w or sel.device != x.device:
            raise ValueError("selector mode takes a (16 or 256, W, 3, 8) table and (C, W) uint8")
        kern = OPTIONS[x.shape[0]]
        sel = sel.contiguous()
        rows = sel.shape[0]
        sel_ptr = _cuda.ptr(sel)
    if rows == 0:
        return x.new_empty((0, 3, L.NW))
    if w == 0:
        from .msm import identity_proj

        return identity_proj(x.device).expand(rows, 3, L.NW).contiguous()
    for p in plan(rows, w):
        out = torch.empty((rows, p.out_width, 3, L.NW), dtype=torch.int32, device=x.device)
        kern(_cuda.ptr(x), sel_ptr, _cuda.ptr(out), rows, p.width, p.run, p.threads,
             p.chunks, int(p.fold), _cuda.stream())
        x, sel_ptr = out, None
    return x[:, 0]
