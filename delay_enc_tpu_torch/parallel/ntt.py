"""The NTT over a mesh of D = 2^m shards, and kernel K12.

Counterpart of `delay_enc_tpu/parallel/ntt.py`.  For N = 2^k and shards of
L = N / D elements, block-sharded (shard d holds a[d L : (d + 1) L]):

 * m decimation-in-frequency stages across shards.  At local position l
   they are a D-point network over the blocks' elements x_0[l] ..
   x_{D-1}[l]: in stage s (h = D >> (s + 1)) node d meets d XOR h; the top
   one (bit h of d clear) keeps x_d + x_{d^h}, the bottom one
   (x_{d^h} - x_d) w^((i0 + l) 2^s), i0 = (d mod 2h - h) L;
 * a local NTT of length L (root omega^D, kernel K-b);
 * a reshuffle: local element l of block b is the evaluation at
   l D + rev(b), so out[q][t D + r] = y[rev(r)][q L/D + t] gives the result
   block-sharded in natural order.

The inverse undoes the reshuffle, runs the local inverse NTT without its
1/L, then the stages in reverse order as butterflies whose bottom operand is
twiddled by the inverse row first, and multiplies 1/N in.

On a card a direction is three launches, whatever D (`csrc/shard.cu`):
`shard_stages` runs every stage for every position in registers, reading
the D blocks where they lie (its own memory, or a peer card's through a
peer pointer) and storing only the card's own shards, as one (s, L, 8)
stack; K-b transforms the stack in one call; `shard_reshuffle` gathers the
card's output blocks from all D stacks.  The inverse runs them the other
way round.  The JAX package's ppermute of whole blocks, between limb passes
a stage, and its all_to_all are gone; nothing crosses between cards but
the loads of these two kernels.

A sharded value is a list of D (L, 8) tensors, shard d on
`mesh.devices[d]`; the functions also take one (N, 8) tensor and split it
(`Mesh.scatter`).  Preconditions as in the JAX package: D a power of two,
D^2 <= N; and D <= 16, the kernels' pointer table.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..fields.bn254 import FR
from ..ops import _cuda
from ..ops import limbs as L
from ..ops.ntt import NTTPlan, powers, stockham
from ..utils.device import resolve
from .mesh import Mesh, on

CTX = L.FR_CTX
MAX_SHARDS, MAX_LOG = 16, 4  # csrc/shard_row.cuh shard::MAX_SHARDS, MAX_LOG
SOURCE = "delay_enc_tpu_torch/csrc/shard.cu"
K_STAGES = _cuda.kernel(
    "shard_stages", "shard_stages",
    "delay_enc_tpu/parallel/ntt.py:99 _dif_stages, and the stages of :145 sharded_intt "
    "(:164-182)", SOURCE)
K_RESHUFFLE = _cuda.kernel(
    "shard_reshuffle", "shard_reshuffle",
    "delay_enc_tpu/parallel/ntt.py:117-129 (_forward_local's all_to_all, take and transpose), "
    "and :155-160 of sharded_intt", SOURCE)


class _Args(ctypes.Structure):
    """csrc/shard_row.cuh shard::Args, field for field."""
    _fields_ = [
        ("block", ctypes.c_uint64 * MAX_SHARDS),
        ("rows", ctypes.c_uint64),
        ("scale", ctypes.c_uint64),
        ("out", ctypes.c_uint64),
        ("slot", ctypes.c_int32 * MAX_SHARDS),
        ("shard", ctypes.c_uint32 * MAX_SHARDS),
        ("need", ctypes.c_uint32 * MAX_LOG),
        ("n", ctypes.c_uint32),
        ("log_d", ctypes.c_uint32),
        ("count", ctypes.c_uint32),
        ("log_n", ctypes.c_uint32),
    ]


def _bit_rev(x: int, bits: int) -> int:
    r = 0
    for i in range(bits):
        r |= ((x >> i) & 1) << (bits - 1 - i)
    return r


# ------------------------------------------------------- the network's indices

def row_index(ndev: int, s: int, d: int) -> int | None:
    """The row of a card's (D - 1, L, 8) table that node d multiplies by in
    stage s, None where d is a top node of that stage (csrc/shard_row.cuh
    row_of): the D - 1 distinct rows, stage after stage."""
    h = ndev >> (s + 1)
    if not d & h:
        return None
    return ndev - (ndev >> s) + (d & (h - 1))


def stage_order(m: int, inverse: bool) -> list:
    """The stage of each step of the network."""
    return list(range(m - 1, -1, -1)) if inverse else list(range(m))


def node_masks(ndev: int, shards, inverse: bool) -> list:
    """need[i]: the nodes whose value after step i is read, where the
    outputs are the nodes of `shards`: from the last step back, each step
    reads its nodes and their partners."""
    m = ndev.bit_length() - 1
    need = sum(1 << d for d in shards)
    masks = [0] * m
    for i, s in reversed(list(enumerate(stage_order(m, inverse)))):
        masks[i] = need
        h = ndev >> (s + 1)
        need |= sum(1 << (d ^ h) for d in range(ndev) if need >> d & 1)
    return masks


# ---------------------------------------------------------- the plain versions

def shard_butterfly_plain(x: torch.Tensor, recv: torch.Tensor, top: bool,
                          table: torch.Tensor | None = None) -> torch.Tensor:
    """One shard's butterfly of a cross-shard stage, (top ? x + recv :
    recv - x) * table, in plain PyTorch: the JAX package's L.add, L.sub and
    L.mont_mul of one shard's stage.  table is an (L, 8) row, one element,
    or None."""
    out = L.add_plain(CTX, x, recv) if top else L.sub_plain(CTX, recv, x)
    return out if table is None else L.mont_mul_plain(CTX, out, table.reshape(-1, L.NW))


def shard_stages_plain(blocks: list, rows: torch.Tensor, shards, *, inverse: bool = False,
                       n_inv: torch.Tensor | None = None) -> torch.Tensor:
    """The m stages over all D blocks, composed from `shard_butterfly_plain`
    stage after stage, the outputs of `shards` stacked.  Forward: the
    bottom shard's butterfly takes its row.  Inverse: each butterfly takes
    the inverse row of the stage after it where its shard is a bottom one
    there (and the first stage's rows are multiplied in before), the last
    stage takes 1/N."""
    ndev = len(blocks)
    m = ndev.bit_length() - 1

    def row(s, d):
        r = row_index(ndev, s, d)
        return None if r is None else rows[r]

    v = list(blocks)
    if not inverse:
        for s in range(m):
            h = ndev >> (s + 1)
            v = [shard_butterfly_plain(v[d], v[d ^ h], not d & h, row(s, d)) for d in range(ndev)]
    elif m == 0:
        v = [L.mont_mul_plain(CTX, v[0], n_inv.reshape(-1, L.NW))]
    else:
        v = [x if row(m - 1, d) is None else L.mont_mul_plain(CTX, x, row(m - 1, d))
             for d, x in enumerate(v)]
        for s in range(m - 1, -1, -1):
            h = ndev >> (s + 1)
            v = [shard_butterfly_plain(v[d], v[d ^ h], not d & h,
                                       n_inv if s == 0 else row(s - 1, d))
                 for d in range(ndev)]
    return torch.stack([v[d] for d in shards])


def shard_reshuffle_plain(blocks: list, shards, *, inverse: bool = False) -> torch.Tensor:
    """The reshuffle by torch indexing, the outputs of `shards` stacked.
    Forward: block q of the result takes chunk q of every block, in
    bit-reversed source order, interleaved (out[q][t D + r] =
    y[rev(r)][q L/D + t]).  Inverse: block b takes, from every block q,
    the elements at t D + rev(b), as chunk q."""
    ndev = len(blocks)
    m = ndev.bit_length() - 1
    l_len = blocks[0].shape[0]
    chunk = l_len // ndev
    rev = [_bit_rev(r, m) for r in range(ndev)]
    if not inverse:
        idx = torch.tensor(rev, dtype=torch.long, device=blocks[0].device)
        outs = [torch.stack([b.reshape(ndev, chunk, L.NW)[q] for b in blocks])
                .index_select(0, idx).transpose(0, 1).reshape(l_len, L.NW) for q in shards]
    else:
        outs = [torch.stack([x.reshape(chunk, ndev, L.NW)[:, rev[b]] for x in blocks])
                .reshape(l_len, L.NW) for b in shards]
    return torch.stack(outs)


# ------------------------------------------------------------- the wrappers

_PEERS: set = set()  # (card, peer): the card's kernels may read the peer's memory


def enable_peer_access(devices) -> None:
    """Let every card of `devices` read every other one's memory (once a
    pair a process); raises RuntimeError for a pair without peer access:
    the sharded NTT's kernels read the blocks in place, and there is no
    copy path."""
    cards = [d for d in dict.fromkeys(torch.device(x) for x in devices) if d.type == "cuda"]
    for a in cards:
        for b in cards:
            if a == b or (a.index, b.index) in _PEERS:
                continue
            if not torch.cuda.can_device_access_peer(a, b):
                raise RuntimeError(f"{a} cannot read {b}'s memory (no peer access): the sharded "
                                   f"NTT's kernels read the blocks of every shard in place")
            _cuda.query("shard_enable_peer", a.index, b.index)
            _PEERS.add((a.index, b.index))


def _check_peers(device: torch.device, others) -> None:
    for o in others:
        if o != device and (device.index, o.index) not in _PEERS:
            raise RuntimeError(f"{device} has no peer access to {o}: ShardedNTTPlan.make (or "
                               f"enable_peer_access) turns it on")


def _table(what: str, device, blocks, shards) -> tuple:
    """Checks of both wrappers: D blocks of (L, 8), D a power of two up to
    MAX_SHARDS, L a power of two and at least D, contiguous and 16-byte
    aligned, all on the CPU for a CPU call and all on cards (with peer
    access) for a card's; `shards` distinct indices below D.  Returns
    (device, D, L, shards)."""
    device = torch.device(device)
    ndev = len(blocks)
    if not 1 <= ndev <= MAX_SHARDS or ndev & (ndev - 1):
        raise ValueError(f"{what} takes 1 to {MAX_SHARDS} blocks, a power of two, not {ndev}")
    shape = blocks[0].shape
    l_len = shape[0]
    places = set()
    for b in blocks:
        L._check(b)
        if b.shape != shape:
            l_len = 0
        places.add(b.device)
    if len(shape) != 2 or l_len < ndev or l_len & (l_len - 1):
        raise ValueError(f"{what} takes D (L, 8) blocks, L a power of two and at least D = "
                         f"{ndev}; got {[tuple(b.shape) for b in blocks]}")
    shards = tuple(shards)
    if not shards or len(set(shards)) != len(shards) or min(shards) < 0 or max(shards) >= ndev:
        raise ValueError(f"{what}: shards {shards} are not distinct indices below {ndev}")
    kind = device.type
    if kind not in ("cpu", "cuda") or any(p.type != kind for p in places):
        raise ValueError(f"{what} on {device}: blocks on {sorted(str(p) for p in places)}")
    for b in blocks:
        if not b.is_contiguous():
            raise ValueError(f"{what}: a block is not contiguous")
        if b.data_ptr() % 16:
            raise ValueError(f"{what}: a block is not 16-byte aligned")
    if kind == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        _check_peers(device, places)
    return device, ndev, l_len, shards


_TEMPLATES: dict = {}  # (D, L, shards, direction) -> the fixed fields of an Args, as bytes


def _args(blocks, shards: tuple, out, rows=None, scale=None, inverse=None) -> _Args:
    """A launch's Args: the addresses, over the fields that D, L, the
    shards and the direction fix (the slot map, the node masks of the
    stages' direction, `inverse` None for the reshuffle), made once and
    copied."""
    ndev, n = len(blocks), blocks[0].shape[0]
    key = (ndev, n, shards, inverse)
    fixed = _TEMPLATES.get(key)
    if fixed is None:
        a = _Args()
        a.slot[:] = [-1] * MAX_SHARDS
        for i, d in enumerate(shards):
            a.slot[d] = i
            a.shard[i] = d
        if inverse is not None:
            for i, mask in enumerate(node_masks(ndev, shards, inverse)):
                a.need[i] = mask
        a.n, a.log_d, a.count, a.log_n = n, ndev.bit_length() - 1, len(shards), n.bit_length() - 1
        fixed = _TEMPLATES[key] = bytes(a)
    a = _Args.from_buffer_copy(fixed)
    a.block[:ndev] = [b.data_ptr() for b in blocks]
    a.rows = 0 if rows is None else rows.data_ptr()
    a.scale = 0 if scale is None else scale.data_ptr()
    a.out = out.data_ptr()
    return a


def _others(device, blocks) -> list:
    """The cards other than `device` that hold some of the blocks."""
    return list(dict.fromkeys(b.device for b in blocks if b.device != device))


def _acquire(device, cards) -> None:
    """The card's current stream waits on the cards' current streams: what
    they wrote is there before the card reads it."""
    stream = torch.cuda.current_stream(device)
    for card in cards:
        stream.wait_stream(torch.cuda.current_stream(card))


def _release(device, cards) -> None:
    """The cards' current streams wait on the card's: nothing they write,
    or allocate in memory freed, afterwards meets one of its loads still in
    flight (torch's peer copy waits both ways as well)."""
    if not cards:
        return
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(device))
    for card in cards:
        torch.cuda.current_stream(card).wait_event(done)


def _launch(kernel, device, blocks, args: _Args, inverse: bool, fenced: bool) -> None:
    """One launch on the card's current stream, ordered both ways against
    the current streams of the other cards that hold the blocks it reads,
    unless the caller has ordered them (`fenced`: `_fenced`).  Blocks on
    the card itself need nothing: they were made on its stream."""
    cards = [] if fenced else _others(device, blocks)
    _acquire(device, cards)
    kernel(ctypes.byref(args), int(inverse), _cuda.stream())
    _release(device, cards)


def shard_stages(device, blocks: list, shards, rows: torch.Tensor, *, inverse: bool = False,
                 n_inv: torch.Tensor | None = None, fenced: bool = False) -> torch.Tensor:
    """The m cross-shard stages for the shards `shards` of one device: the
    (len(shards), L, 8) stack of their outputs.  blocks: the D (L, 8)
    blocks, each where it lies; rows: the device's (D - 1, L, 8) forward
    or inverse table; n_inv (inverse): 1/N, one element on the device;
    fenced: the caller orders the cards' streams around the launch.  One
    launch of K12's stages on a card, `shard_stages_plain` on the CPU."""
    device, ndev, l_len, shards = _table("shard_stages", device, blocks, shards)
    L._check(rows)
    if rows.shape != (ndev - 1, l_len, L.NW) or rows.device != device or not rows.is_contiguous():
        raise ValueError(f"rows must be a contiguous ({ndev - 1}, {l_len}, 8) table on {device}, "
                         f"got {tuple(rows.shape)} on {rows.device}")
    if inverse:
        if n_inv is None or n_inv.numel() != L.NW or n_inv.device != device:
            raise ValueError(f"the inverse stages take 1/N, one element on {device}")
        L._check(n_inv)
    if device.type == "cpu":
        return shard_stages_plain(blocks, rows, shards, inverse=inverse, n_inv=n_inv)
    n_inv = n_inv.contiguous() if inverse else None
    if rows.data_ptr() % 16 or (inverse and n_inv.data_ptr() % 16):
        raise ValueError("shard_stages: rows or 1/N not 16-byte aligned")
    with on(device):
        out = torch.empty((len(shards), l_len, L.NW), dtype=torch.int32, device=device)
        _launch(K_STAGES, device, blocks, _args(blocks, shards, out, rows, n_inv, inverse),
                inverse, fenced)
    return out


def shard_reshuffle(device, blocks: list, shards, *, inverse: bool = False,
                    fenced: bool = False) -> torch.Tensor:
    """The reshuffle's output blocks of the shards `shards` of one device,
    as one (len(shards), L, 8) stack, gathered from the D (L, 8) blocks
    wherever they lie (fenced as for `shard_stages`).  One launch of K12's reshuffle on a card,
    `shard_reshuffle_plain` on the CPU."""
    device, ndev, l_len, shards = _table("shard_reshuffle", device, blocks, shards)
    if device.type == "cpu":
        return shard_reshuffle_plain(blocks, shards, inverse=inverse)
    if len(shards) * l_len >= 1 << 32:
        raise ValueError("too many elements for one launch")
    with on(device):
        out = torch.empty((len(shards), l_len, L.NW), dtype=torch.int32, device=device)
        _launch(K_RESHUFFLE, device, blocks, _args(blocks, shards, out), inverse, fenced)
    return out


# --------------------------------------------------------------- the plan

@dataclass
class ShardedNTTPlan:
    k: int
    ndev: int
    devices: tuple  # shard d's device
    groups: list  # (device, the shards it holds), each distinct device once
    local_plans: list  # shard d's NTTPlan of length L (root omega^D), one a device
    rows: list  # shard d's device's (D - 1, L, 8) Montgomery twiddle rows, one a device
    rows_inv: list  # the same for omega^-1
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
        for every shard, or ndev devices (a mesh's).  Every distinct device
        gets the D - 1 distinct twiddle rows of each direction once: stage
        s's bottom rows w^((j L + l) 2^s), j < D >> (s + 1), as powers of
        w^(2^s) from w^(j L 2^s), made on the device
        (`ops/ntt.py:powers`).  Where the devices are several cards, each
        is given peer access to the others (`enable_peer_access`)."""
        n = 1 << k
        m = ndev.bit_length() - 1
        if ndev < 1 or 1 << m != ndev:
            raise ValueError(f"device count must be a power of two, not {ndev}")
        if ndev > MAX_SHARDS:
            raise ValueError(f"the sharded NTT's kernels take at most {MAX_SHARDS} shards, "
                             f"not {ndev}")
        if ndev * ndev > n:
            raise ValueError(f"need D^2 <= N for the chunked reshuffle: D={ndev}, N={n}")
        if isinstance(devices, (str, torch.device)):
            devices = [devices] * ndev
        devices = tuple(resolve(d) for d in devices)
        if len(devices) != ndev:
            raise ValueError(f"{len(devices)} devices for {ndev} shards")
        distinct = list(dict.fromkeys(devices))
        enable_peer_access(distinct)
        l_len = n // ndev
        omega = FR.root_of_unity(k)
        omega_inv = FR.inv(omega)

        def table(w: int, dev) -> torch.Tensor:
            rows = []
            for s in range(m):
                base = pow(w, 1 << s, FR.p)
                for j in range(ndev >> (s + 1)):
                    rows.append(powers(CTX, base, l_len, dev, start=pow(base, j * l_len, FR.p)))
            if not rows:
                return torch.empty((0, l_len, L.NW), dtype=torch.int32, device=dev)
            return torch.stack(rows)

        local, fwd, inv, n_inv = {}, {}, {}, {}
        for dev in distinct:
            with on(dev):
                local[dev] = NTTPlan.make(CTX, k - m, dev, omega=pow(omega, ndev, FR.p))
                fwd[dev], inv[dev] = table(omega, dev), table(omega_inv, dev)
                n_inv[dev] = L.to_device_mont(CTX, [FR.inv(n)], dev)
        return ShardedNTTPlan(
            k=k, ndev=ndev, devices=devices,
            groups=[(dev, tuple(d for d in range(ndev) if devices[d] == dev)) for dev in distinct],
            local_plans=[local[dev] for dev in devices],
            rows=[fwd[dev] for dev in devices],
            rows_inv=[inv[dev] for dev in devices],
            n_inv=[n_inv[dev] for dev in devices],
        )


# ----------------------------------------------------- the sharded transforms

def _shards(mesh: Mesh, plan: ShardedNTTPlan, a) -> list:
    if mesh.size != plan.ndev or mesh.devices != plan.devices:
        raise ValueError(f"a plan for {plan.devices} on a mesh of {mesh.devices}")
    shards = mesh.scatter(a) if isinstance(a, torch.Tensor) else list(a)
    if len(shards) != plan.ndev:
        raise ValueError(f"{len(shards)} shards for a plan of {plan.ndev}")
    l_len = (1 << plan.k) // plan.ndev
    out = []
    for s, dev in zip(shards, mesh.devices):
        L._check(s)
        if s.shape != (l_len, L.NW) or s.device != dev:
            raise ValueError(f"a shard must be ({l_len}, 8) on {dev}, got {tuple(s.shape)} "
                             f"on {s.device}")
        if not s.is_contiguous():
            with on(dev):
                s = s.contiguous()
        out.append(s)
    return out


def _per_device(plan: ShardedNTTPlan, fn) -> dict:
    """{device: fn(device, shards)}, each device's (len(shards), L, 8)
    stack of its shards, made in turn under the device's context."""
    stacks = {}
    for dev, shards in plan.groups:
        with on(dev):
            stacks[dev] = fn(dev, shards)
    return stacks


def _fenced(plan: ShardedNTTPlan, fn) -> dict:
    """`_per_device` for launches that read every device's blocks: each
    card's stream first waits on the others', then every card launches,
    then each card's stream waits on the others' launches.  So the launches
    of one step on several cards run side by side, and neither side of it
    meets the other's memory in use.  fn(device, shards, fenced)."""
    cards = [dev for dev, _ in plan.groups if dev.type == "cuda"]
    cards = cards if len(cards) > 1 else []
    for dev in cards:
        _acquire(dev, [c for c in cards if c != dev])
    stacks = _per_device(plan, lambda dev, sh: fn(dev, sh, bool(cards)))
    for dev in cards:
        _release(dev, [c for c in cards if c != dev])
    return stacks


def _blocks(plan: ShardedNTTPlan, stacks: dict) -> list:
    """The D blocks of a sharded value: views of the devices' stacks."""
    blocks = [None] * plan.ndev
    for dev, shards in plan.groups:
        for i, d in enumerate(shards):
            blocks[d] = stacks[dev][i]
    return blocks


def _local(plan: ShardedNTTPlan, stacks: dict, inverse: bool) -> dict:
    """K-b over each device's stack, one call a device; the inverse without
    its 1/L."""
    def transform(dev, shards):
        p = plan.local_plans[shards[0]]
        return stockham(CTX, stacks[dev], p.tw_inv if inverse else p.tw)

    return _per_device(plan, transform)


def sharded_ntt(mesh: Mesh, plan: ShardedNTTPlan, a) -> list:
    """a: (N, 8) Montgomery coefficients, or their D blocks on the mesh;
    returns the (N, 8) evaluations in natural order as D blocks."""
    x = _shards(mesh, plan, a)
    y = _fenced(plan, lambda dev, sh, f: shard_stages(dev, x, sh, plan.rows[sh[0]], fenced=f))
    y = _blocks(plan, _local(plan, y, inverse=False))
    return _blocks(plan, _fenced(plan, lambda dev, sh, f: shard_reshuffle(dev, y, sh, fenced=f)))


def sharded_intt(mesh: Mesh, plan: ShardedNTTPlan, a) -> list:
    """The inverse of `sharded_ntt`: the reshuffle undone, the local inverse
    NTT unscaled, the stages in reverse order with 1/N; D blocks out."""
    x = _shards(mesh, plan, a)
    y = _fenced(plan, lambda dev, sh, f: shard_reshuffle(dev, x, sh, inverse=True, fenced=f))
    y = _blocks(plan, _local(plan, y, inverse=True))
    return _blocks(plan, _fenced(plan, lambda dev, sh, f: shard_stages(
        dev, y, sh, plan.rows_inv[sh[0]], inverse=True, n_inv=plan.n_inv[sh[0]], fenced=f)))
