"""The NTT over a mesh of D = 2^m shards, and kernel K12's butterfly.

Counterpart of `delay_enc_tpu/parallel/ntt.py`.  For N = 2^k and shards of
L = N / D elements, block-sharded (shard d holds a[d L : (d + 1) L]):

 * m decimation-in-frequency stages across shards: in stage s, shard d
   exchanges its block with its partner d XOR G/2 (G = D >> s, the group
   size in blocks); the top partner keeps x + recv, the bottom partner
   (recv - x) * w with a twiddle row of its own (`ShardedNTTPlan`);
 * a local NTT of length L (root omega^D, kernel K-b);
 * one all_to_all with the blocks taken in bit-reversed source order, and a
   transpose: local element l of shard b is the evaluation at l D + rev(b),
   and the result comes out block-sharded in natural order.

The inverse undoes the reshuffle, runs the local inverse NTT without its
1/L, then the stages in reverse order as butterflies whose bottom operand
was twiddled before the exchange.  Each twiddle and the 1/N ride on the
launch before them: the first stage's on the local inverse's last store
(`out_scale`), each later one's and 1/N on the previous butterfly's table.
So a stage of either direction is one launch of `shard_butterfly` a shard,
where the JAX package makes three or four limb passes and a select.

A sharded value is a list of D (L, 8) tensors, shard d on
`mesh.devices[d]`; the functions also take one (N, 8) tensor and split it
(`Mesh.scatter`).  Preconditions as in the JAX package: D a power of two,
D^2 <= N.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..fields.bn254 import FR
from ..ops import _cuda
from ..ops import limbs as L
from ..ops.ntt import NTTPlan, powers, stockham
from ..utils.device import resolve
from .mesh import Mesh, all_to_all, on, ppermute

CTX = L.FR_CTX
K_BUTTERFLY = _cuda.kernel(
    "shard_butterfly", "shard_butterfly",
    "delay_enc_tpu/parallel/ntt.py:99 _dif_stages, and the stages of :145 sharded_intt "
    "(:164-182)",
    "delay_enc_tpu_torch/csrc/shard.cu")
TABLE_NONE, TABLE_CONST, TABLE_ROW = 0, 1, 2


def _bit_rev(x: int, bits: int) -> int:
    r = 0
    for i in range(bits):
        r |= ((x >> i) & 1) << (bits - 1 - i)
    return r


# ------------------------------------------------------------- the kernel

def shard_butterfly_plain(x: torch.Tensor, recv: torch.Tensor, top: bool,
                          table: torch.Tensor | None = None) -> torch.Tensor:
    """(top ? x + recv : recv - x) * table in plain PyTorch: the JAX
    package's L.add, L.sub and L.mont_mul of one shard's stage.  table is
    an (L, 8) row, one element, or None."""
    out = L.add_plain(CTX, x, recv) if top else L.sub_plain(CTX, recv, x)
    return out if table is None else L.mont_mul_plain(CTX, out, table.reshape(-1, L.NW))


def shard_butterfly(x: torch.Tensor, recv: torch.Tensor, top: bool,
                    table: torch.Tensor | None = None) -> torch.Tensor:
    """One shard's butterfly of a cross-shard stage: x its own (L, 8)
    block, recv its partner's.  One launch of K12 on CUDA tensors,
    `shard_butterfly_plain` on CPU ones."""
    L._check(x)
    L._check(recv)
    if x.dim() != 2 or recv.shape != x.shape:
        raise ValueError(f"blocks must be two (L, 8) tensors, got {tuple(x.shape)} and "
                         f"{tuple(recv.shape)}")
    mode = TABLE_NONE
    if table is not None:
        L._check(table)
        count = table.numel() // L.NW
        if table.dim() > 2 or count not in (1, x.shape[0]):
            raise ValueError(f"a table is one element or a row of {x.shape[0]}, got "
                             f"{tuple(table.shape)}")
        mode = TABLE_CONST if count == 1 and x.shape[0] != 1 else TABLE_ROW
    tensors = (x, recv) if table is None else (x, recv, table)
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"operands on {[str(t.device) for t in tensors]}")
    if x.device.type == "cpu":
        return shard_butterfly_plain(x, recv, top, table)
    _cuda.require_cuda(*tensors)
    x, recv = x.contiguous(), recv.contiguous()
    table = None if table is None else table.contiguous()
    out = torch.empty_like(x)
    n = x.shape[0]
    if n == 0:
        return out
    if n >= 1 << 32:
        raise ValueError("too many elements for one launch")
    if any(t.data_ptr() % 16 for t in (x, recv, out, *(() if table is None else (table,)))):
        raise ValueError("a block is not 16-byte aligned")
    K_BUTTERFLY(x.data_ptr(), recv.data_ptr(), _cuda.ptr(table), out.data_ptr(), n, int(top),
                mode, _cuda.stream())
    return out


# --------------------------------------------------------------- the plan

@dataclass
class ShardedNTTPlan:
    k: int
    ndev: int
    devices: tuple  # shard d's device
    local_plans: list  # shard d's NTTPlan of length L (root omega^D), one a device
    stage_tw: list  # per stage: D (L, 8) Montgomery twiddle rows, row d on shard d's device
    stage_tw_inv: list  # the same for omega^-1
    rev_idx: list  # bit reversal of the shard indices
    rev_dev: dict  # device -> rev_idx as an index tensor there
    n_inv: list  # shard d's (1, 8) Montgomery 1/N

    @property
    def m(self) -> int:
        return self.ndev.bit_length() - 1

    @property
    def local_plan(self) -> NTTPlan:
        return self.local_plans[0]

    @staticmethod
    def make(k: int, ndev: int, devices="cuda") -> "ShardedNTTPlan":
        """The plan of a 2^k NTT over ndev shards.  `devices` is one device
        for every shard, or ndev devices (a mesh's).  A bottom shard's row
        of stage s holds w^((i0 + l) 2^s) for l < L, with i0 its offset in
        its group: powers of w^(2^s) from w^(i0 2^s), made on its device
        (`ops/ntt.py:powers`); a top shard's row is ones, and is never
        multiplied in."""
        n = 1 << k
        m = ndev.bit_length() - 1
        if ndev < 1 or 1 << m != ndev:
            raise ValueError(f"device count must be a power of two, not {ndev}")
        if ndev * ndev > n:
            raise ValueError(f"need D^2 <= N for the chunked reshuffle: D={ndev}, N={n}")
        if isinstance(devices, (str, torch.device)):
            devices = [devices] * ndev
        devices = tuple(resolve(d) for d in devices)
        if len(devices) != ndev:
            raise ValueError(f"{len(devices)} devices for {ndev} shards")
        l_len = n // ndev
        omega = FR.root_of_unity(k)
        omega_inv = FR.inv(omega)
        rows: dict = {}

        def row(w: int, s: int, d: int) -> torch.Tensor:
            g = ndev >> s
            pos = d % g
            dev = devices[d]
            if pos < g // 2:
                return CTX.one_mont(dev).expand(l_len, L.NW)
            key = (w, s, pos, dev)
            if key not in rows:
                i0 = (pos - g // 2) * l_len
                base = pow(w, 1 << s, FR.p)
                with on(dev):
                    rows[key] = powers(CTX, base, l_len, dev, start=pow(base, i0, FR.p))
            return rows[key]

        distinct = list(dict.fromkeys(devices))
        local = {}
        for dev in distinct:
            with on(dev):
                local[dev] = NTTPlan.make(CTX, k - m, dev, omega=pow(omega, ndev, FR.p))
        rev = [_bit_rev(d, m) for d in range(ndev)]
        n_inv = {dev: L.to_device_mont(CTX, [FR.inv(n)], dev) for dev in distinct}
        return ShardedNTTPlan(
            k=k, ndev=ndev, devices=devices,
            local_plans=[local[dev] for dev in devices],
            stage_tw=[[row(omega, s, d) for d in range(ndev)] for s in range(m)],
            stage_tw_inv=[[row(omega_inv, s, d) for d in range(ndev)] for s in range(m)],
            rev_idx=rev,
            rev_dev={dev: torch.tensor(rev, dtype=torch.long, device=dev) for dev in distinct},
            n_inv=[n_inv[dev] for dev in devices],
        )


# --------------------------------------------------------------- the stages

def _is_top(plan: ShardedNTTPlan, s: int, d: int) -> bool:
    g = plan.ndev >> s
    return d % g < g // 2


def _partners(plan: ShardedNTTPlan, s: int) -> list:
    half = (plan.ndev >> s) // 2
    return [(i, i ^ half) for i in range(plan.ndev)]


def _shards(mesh: Mesh, plan: ShardedNTTPlan, a) -> list:
    if mesh.size != plan.ndev or mesh.devices != plan.devices:
        raise ValueError(f"a plan for {plan.devices} on a mesh of {mesh.devices}")
    shards = mesh.scatter(a) if isinstance(a, torch.Tensor) else list(a)
    if len(shards) != plan.ndev:
        raise ValueError(f"{len(shards)} shards for a plan of {plan.ndev}")
    l_len = (1 << plan.k) // plan.ndev
    for s, dev in zip(shards, mesh.devices):
        L._check(s)
        if s.shape != (l_len, L.NW) or s.device != dev:
            raise ValueError(f"a shard must be ({l_len}, 8) on {dev}, got {tuple(s.shape)} "
                             f"on {s.device}")
    return shards


def _dif_stages(plan: ShardedNTTPlan, shards: list) -> list:
    """The m cross-shard DIF stages: one exchange and one butterfly a shard
    each."""
    for s in range(plan.m):
        recv = ppermute(shards, _partners(plan, s))
        out = []
        for d, (x, r) in enumerate(zip(shards, recv)):
            top = _is_top(plan, s, d)
            with on(x.device):
                out.append(shard_butterfly(x, r, top, None if top else plan.stage_tw[s][d]))
        shards = out
    return shards


def _forward_local(plan: ShardedNTTPlan, shards: list) -> list:
    shards = _dif_stages(plan, shards)
    out = []
    for d, x in enumerate(shards):
        with on(x.device):
            out.append(stockham(CTX, x, plan.local_plans[d].tw))
    # reshuffle: element l of block b is global evaluation l*D + rev(b)
    ndev = plan.ndev
    l_len = out[0].shape[0]
    recv = all_to_all([x.reshape(ndev, l_len // ndev, L.NW) for x in out])
    return [r.index_select(0, plan.rev_dev[r.device]).transpose(0, 1).reshape(l_len, L.NW)
            for r in recv]


def sharded_ntt(mesh: Mesh, plan: ShardedNTTPlan, a) -> list:
    """a: (N, 8) Montgomery coefficients, or their D blocks on the mesh;
    returns the (N, 8) evaluations in natural order as D blocks."""
    return _forward_local(plan, _shards(mesh, plan, a))


def local_ntt_inv_unscaled(plan: NTTPlan, a: torch.Tensor,
                           out_scale: torch.Tensor | None = None) -> torch.Tensor:
    """K-b with the inverse twiddles and no 1/n; `out_scale` (a row or one
    element) is multiplied in as the last pass stores."""
    return stockham(plan.ctx, a, plan.tw_inv, out_scale=out_scale)


def _inv_table(plan: ShardedNTTPlan, s: int, d: int):
    """What shard d multiplies in before inverse stage s: the stage's
    inverse twiddle row where d is a bottom shard of it, nothing where it is
    a top one; after the last stage (s = -1), 1/N."""
    if s < 0:
        return plan.n_inv[d]
    return None if _is_top(plan, s, d) else plan.stage_tw_inv[s][d]


def sharded_intt(mesh: Mesh, plan: ShardedNTTPlan, a) -> list:
    """The inverse of `sharded_ntt`: the reshuffle undone, the local inverse
    NTT unscaled, the stages in reverse order, 1/N; D blocks out."""
    shards = _shards(mesh, plan, a)
    ndev, m = plan.ndev, plan.m
    l_len = shards[0].shape[0]
    # out[t D + r] of block q came from local element t of block rev(r)'s q
    y = [x.reshape(l_len // ndev, ndev, L.NW).transpose(0, 1).index_select(0, plan.rev_dev[x.device])
         for x in shards]
    y = [t.reshape(l_len, L.NW) for t in all_to_all(y)]
    out = []
    for d, x in enumerate(y):
        with on(x.device):
            out.append(local_ntt_inv_unscaled(plan.local_plans[d], x, _inv_table(plan, m - 1, d)))
    y = out
    for s in range(m - 1, -1, -1):
        recv = ppermute(y, _partners(plan, s))
        out = []
        for d, (x, r) in enumerate(zip(y, recv)):
            with on(x.device):
                out.append(shard_butterfly(x, r, _is_top(plan, s, d), _inv_table(plan, s - 1, d)))
        y = out
    return y
