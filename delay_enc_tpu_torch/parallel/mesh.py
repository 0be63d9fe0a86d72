"""A one-axis mesh of torch devices, and the exchanges between its shards.

Counterpart of `delay_enc_tpu/parallel/mesh.py`.  The JAX package is
single-controller: one process drives a mesh through `shard_map`, whose
collectives (`ppermute`, `all_gather`, `all_to_all`) ride the chips'
interconnect.  The port is single-controller too: a `Mesh` is an ordered
list of torch devices, one a shard, and a sharded value is a Python list of
tensors, shard i on `mesh.devices[i]`.  The exchanges are copies between
those devices (`Tensor.to(dev, non_blocking=True)`, peer-to-peer over
NVLink on a host with several cards); a copy to the device a tensor is
already on is no copy.  Every shard's launches go to its own device's
current stream (`Mesh.on`).

A mesh may name one device several times (`Mesh.shared`): the one-card
machine and the CPU tests run D shards on one device, every stage of the
algorithms included; only the interconnect is not exercised.  Replicated
inputs (an SRS, a key, pair tables) are then shared, not copied
(`Mesh.replicas`).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from ..utils.device import resolve


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered list of devices, one a shard, along one named axis."""

    devices: tuple
    axis: str = "shard"
    _replicas: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh has one device or more")
        object.__setattr__(self, "devices", tuple(resolve(d) for d in self.devices))

    @staticmethod
    def shared(device, n: int, axis: str = "shard") -> "Mesh":
        """n shards on one device: the one-card machine, and the CPU tests."""
        if n < 1:
            raise ValueError(f"a mesh has one shard or more, not {n}")
        return Mesh((resolve(device),) * n, axis)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def axis_names(self) -> tuple:
        return (self.axis,)

    @property
    def distinct(self) -> list:
        """The mesh's devices, each once, in order."""
        return list(dict.fromkeys(self.devices))

    def on(self, i: int):
        """The context that sends the launches of shard i to its device."""
        return on(self.devices[i])

    def scatter(self, a: torch.Tensor, dim: int = 0) -> list:
        """Split a into `size` equal blocks along dim, block i onto shard
        i's device (a view where it is already there)."""
        if a.shape[dim] % self.size:
            raise ValueError(f"{a.shape[dim]} rows do not split over {self.size} shards")
        return [b.to(d, non_blocking=True) for b, d in zip(a.chunk(self.size, dim), self.devices)]

    def gather(self, shards, dim: int = 0) -> torch.Tensor:
        """The blocks of a sharded value put together on the first device."""
        return torch.cat([s.to(self.devices[0], non_blocking=True) for s in shards], dim)

    def replicas(self, obj, copy) -> list:
        """obj on every shard's device: `copy(obj, device)` once for each
        device other than obj's own (`obj.device`), kept with the mesh for
        the next call; shards on obj's device share obj itself."""
        key = id(obj)
        held = self._replicas.get(key)
        if held is None or held[0] is not obj:
            held = (obj, {obj.device: obj})
            self._replicas[key] = held
        made = held[1]
        for d in self.distinct:
            if d not in made:
                made[d] = copy(obj, d)
        return [made[d] for d in self.devices]


def make_mesh(n_devices: int | None = None, device="cuda", axis: str = "shard") -> Mesh:
    """A mesh of the first n_devices cards (all of them by default); raises
    if there are fewer.  The CPU is one device: a mesh of several shards
    there, or on one card, is asked for by name with `Mesh.shared`."""
    kind = torch.device(device).type
    if kind == "cpu":
        have = [torch.device("cpu")]
    elif kind == "cuda":
        resolve("cuda")  # raises where there is no card
        have = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        raise ValueError(f"unsupported device {device!r}")
    if n_devices is not None:
        if len(have) < n_devices:
            raise RuntimeError(f"need {n_devices} devices, have {len(have)} ({kind}); "
                               f"Mesh.shared({kind!r}, {n_devices}) puts the shards on one")
        have = have[:n_devices]
    return Mesh(tuple(have), axis)


def on(device):
    """The context that makes a card the current device, so that the
    kernels' launches go to its current stream (nothing on the CPU)."""
    device = torch.device(device)
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


# ------------------------------------------------------------- exchanges

def ppermute(shards: list, perm) -> list:
    """out[dst] = shards[src] for every (src, dst) of perm, moved onto shard
    dst's device; a shard that no pair sends to gets None."""
    out = [None] * len(shards)
    for src, dst in perm:
        out[dst] = shards[src].to(shards[dst].device, non_blocking=True)
    return out


def all_gather(shards: list) -> list:
    """Every shard gets the stack of all shards (D, …) on its device; shards
    on one device share one stack."""
    stacks: dict = {}
    for s in shards:
        if s.device not in stacks:
            stacks[s.device] = torch.stack([t.to(s.device, non_blocking=True) for t in shards])
    return [stacks[s.device] for s in shards]


def all_to_all(shards: list, split_axis: int = 0) -> list:
    """Shard i holds D blocks along split_axis; out[j][i] is shard i's block
    j, on shard j's device (JAX's untiled all_to_all, concat_axis 0)."""
    d = len(shards)
    for s in shards:
        if s.shape[split_axis] != d:
            raise ValueError(f"all_to_all over {d} shards needs {d} blocks along axis "
                             f"{split_axis}, got {tuple(s.shape)}")
    return [torch.stack([s.select(split_axis, j).to(shards[j].device, non_blocking=True)
                         for s in shards]) for j in range(d)]
