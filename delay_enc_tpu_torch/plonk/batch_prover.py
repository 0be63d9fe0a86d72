"""create_proofs_batched: B proofs of one circuit and key in one device pipeline.

Counterpart of `delay_enc_tpu/plonk/batch_prover.py`.  The entry only: it
checks the builders and the key, places the instances, and runs the one
proving pipeline, `plonk/prover.py:prove_instances`, which `create_proof`
runs as a batch of one.  Each proof has its own transcript and verifies
alone; each phase runs once over all B instances, with K5, K6 and K7 given a
leading instance axis (up to MAX_INSTANCES instances a launch), as the JAX
package's vmaps do.

`rng` is drawn from in the JAX package's batched order (`plonk/prover.py`).
It differs from a single proof's in one draw: each lookup of each instance
takes a pad for A'_l and another for S'_l, where create_proof shares one.
So a batch of one is a proof of its statement, but not `create_proof`'s
bytes.

Only a fused-quotient key (k < 18 by default) is taken: the JAX package's
batched prover reads the key's extended-coset tables and has no split mode.

With `mesh=` (a `parallel.Mesh` of D devices, B a multiple of D) the
instance axis is split into D contiguous groups, group i on the mesh's
device i, as the JAX package's NamedSharding(P(axis)) splits it: the key,
the SRS and its pair tables are replicated (shared by the groups on one
device), every draw from `rng` is made on the host for all B instances in
the order above, and then each group's transforms, commitments, K5, K6 and
K7 run on its device over its B/D instances.  Each phase launches every
group's device work before it reads any result back, so the devices of a
mesh of several cards work at once.  The proofs are independent, so no
group exchanges anything with another, and the bytes are the unsharded
batch's.

Spans: a batch is the root span `prove_batch`, its phases and their
children named as a single proof's (`plonk/prover.py`).
"""

from __future__ import annotations

import dataclasses

import torch

from ..parallel.mesh import Mesh
from ..utils.device import resolve
from ..utils.timers import GLOBAL_METRICS
from .keygen import ProvingKey, circuit_shape
from .kzg import SRS
from .prover import group, prove_instances


def _check_batch(pk: ProvingKey, builders) -> None:
    if not builders:
        raise ValueError("no builders: a batch proves one or more instances")
    if pk.split:
        raise ValueError("the batched prover takes a fused-quotient key (keygen split=False); "
                         "a split-mode key is proved one instance at a time by create_proof")
    want = pk.shape if pk.shape is not None else circuit_shape(builders[0])
    for i, b in enumerate(builders):
        got = circuit_shape(b)
        if got != want:
            raise ValueError(f"builder {i} has the circuit shape {got}, the key {want}")


def _key_to(pk: ProvingKey, device) -> ProvingKey:
    """A copy of the key's tensors on `device`; tensors that are views of
    one stack in the key stay views of one copied stack."""
    copies: dict = {}

    def move(t):
        if isinstance(t, torch.Tensor):
            base = t if t._base is None else t._base
            if id(base) not in copies:
                copies[id(base)] = (base, base.to(device, copy=True))
            moved = copies[id(base)][1]
            if t._base is None:
                return moved
            return moved.as_strided(t.shape, t.stride(),
                                    moved.storage_offset() + t.storage_offset()
                                    - base.storage_offset())
        if isinstance(t, dict):
            return {k: move(v) for k, v in t.items()}
        if isinstance(t, list):
            return [move(v) for v in t]
        return t

    return dataclasses.replace(pk, **{f.name: move(getattr(pk, f.name))
                                      for f in dataclasses.fields(pk) if f.name != "vk"})


def _srs_to(srs, device):
    return SRS(srs.k, srs.g1_powers.to(device), srs.tau_g2, srs.g2)


def _groups(srs, pk: ProvingKey, b: int, device, msm: str, mesh: Mesh | None,
            axis: str) -> list:
    if mesh is None:
        device = resolve(device)
        if pk.device != device or srs.device != device:
            raise ValueError(f"keys on {pk.device} and SRS on {srs.device}, proofs asked for "
                             f"{device}")
        devices, keys, srss = [device], [pk], [srs]
    else:
        if axis not in mesh.axis_names:
            raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")
        if b % mesh.size:
            raise ValueError(f"a batch of {b} does not split over {mesh.size} shards")
        devices = mesh.devices
        keys, srss = mesh.replicas(pk, _key_to), mesh.replicas(srs, _srs_to)
    per = b // len(devices)
    return [group(i, i * per, (i + 1) * per, dev, key, s, msm)
            for i, (dev, key, s) in enumerate(zip(devices, keys, srss))]


def create_proofs_batched(srs, pk: ProvingKey, builders, rng=None, device="cuda",
                          msm: str = "b4", mesh: Mesh | None = None,
                          axis: str = "dp") -> list[bytes]:
    """Prove every builder in one batched pipeline; returns B proof byte
    strings, each verifiable alone.  Every builder is a witness of the key's
    circuit: the same fixed columns, lookups and copies (the shape is
    checked, `keygen.circuit_shape`).  `msm` picks the commitments' pair
    tables, "b4" or "b16"; both give the same bytes.  `mesh` splits the
    instances over its devices (`axis` must name its axis; B a multiple of
    its size); the key and the SRS may then lie on any device, and
    `device` is not read.  The bytes do not depend on the mesh."""
    if mesh is None:
        device = resolve(device)
    _check_batch(pk, builders)
    groups = _groups(srs, pk, len(builders), device, msm, mesh, axis)
    with GLOBAL_METRICS.span("prove_batch"):
        return prove_instances(pk, builders, rng, lambda: groups, shared_pads=False)
