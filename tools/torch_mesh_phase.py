"""chip_smoke.py's phase 9, the mesh, alone: on a host with 4 cards or more it
runs `make_mesh(4)`, one shard a card, with the kernels reading the other
cards' blocks over NVLink; on one card, 4 shards on that card.

    python3 tools/torch_mesh_phase.py

It builds the kernels and first runs the sharded NTT's overwrite check
(`overwrite_check`).  Then it proves the k=7 test circuit against the JAX
golden (chip_smoke's phase 0, whose SRS and keys the k=7 sharded batch
reuses), then sets up delay_enc k=16 (bench.py's draw, chip_smoke's tau),
keygen, and the unsharded batch of four builds of the statement twice from
default_rng(0) (phase 7's bytes, walls and peak memory), and runs
`chip_smoke.mesh_phase` on them.  It prints the card's name and power limit
and the phase's lines; it exits non-zero on any mismatch.
"""

from __future__ import annotations

import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def overwrite_check(dev, reps: int = 10, stall_cycles: int = 4_000_000) -> str:
    """The sharded NTT and iNTT at k=16 and k=20 over 4 shards (one a card
    where there are 4 cards, else `Mesh.shared` on dev) while the last card
    of the mesh is held back: its stream sleeps `stall_cycles` before each
    of its K12 launches, so the other cards' streams run ahead of its
    reads.  As soon as a call returns, each input block is overwritten in
    place on its own card's stream, then freed, and new blocks of the same
    size (which take the memory the call freed, its inputs' and its
    intermediate stacks') are filled; the results must still equal one
    device's K-b ntt and the column.  A card whose stream did not wait for
    the held-back card's loads would change them."""
    import torch

    from delay_enc_tpu_torch.ops import limbs as L
    from delay_enc_tpu_torch.ops import ntt as N
    from delay_enc_tpu_torch.parallel import (Mesh, ShardedNTTPlan, make_mesh, sharded_intt,
                                              sharded_ntt)
    from delay_enc_tpu_torch.parallel import ntt as PN

    mesh = make_mesh(4) if torch.cuda.device_count() >= 4 else Mesh.shared(dev, 4)
    gen = torch.Generator(device=dev).manual_seed(14)
    last = mesh.devices[-1]

    def held_back(launch):
        def wrapped(device, *args, **kw):
            if torch.device(device) == last:
                with torch.cuda.device(last):
                    torch.cuda._sleep(stall_cycles)
            return launch(device, *args, **kw)
        return wrapped

    def spoil(blocks):
        for b in blocks:
            b.bitwise_not_()
        size = blocks[0].shape
        places = [b.device for b in blocks]
        blocks.clear()
        return [torch.full(size, -1, dtype=torch.int32, device=x) for x in places for _ in "abc"]

    kernels = PN.shard_stages, PN.shard_reshuffle
    PN.shard_stages, PN.shard_reshuffle = map(held_back, kernels)
    try:
        for k in (16, 20):
            column = torch.randint(-2**31, 2**31, (1 << k, 8), generator=gen, device=dev,
                                   dtype=torch.int64).to(torch.int32)
            column[:, 7] &= 0x0FFFFFFF  # below 2^252 < r
            want = N.ntt(N.NTTPlan.make(L.FR_CTX, k, dev), column)
            plan = ShardedNTTPlan.make(k, 4, mesh.devices)
            for _ in range(reps):
                x = [b.clone() for b in mesh.scatter(column)]  # a block may be a view of column
                evals = sharded_ntt(mesh, plan, x)
                junk = spoil(x)
                y = [e.clone() for e in evals]
                back = sharded_intt(mesh, plan, y)
                junk += spoil(y)
                if not torch.equal(mesh.gather(evals), want):
                    raise AssertionError(f"k={k}: the sharded NTT changed with its input "
                                         f"overwritten after the call")
                if not torch.equal(mesh.gather(back), column):
                    raise AssertionError(f"k={k}: the sharded iNTT changed with its input "
                                         f"overwritten after the call")
                del junk
    finally:
        PN.shard_stages, PN.shard_reshuffle = kernels
    return (f"overwrite check: sharded NTT and iNTT at k=16 and k=20 over "
            f"{[str(x) for x in mesh.devices]}, {last} held back {stall_cycles} cycles before "
            f"each K12 launch, inputs overwritten and their memory reused right after each of "
            f"{reps} calls: results equal one device's K-b and the column")


def main() -> int:
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    import chip_smoke as C

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the tool runs on the card")
    card = C.smi("name,power.limit")
    print(card, flush=True)
    from delay_enc_tpu_torch.ops import _cuda
    from delay_enc_tpu_torch.plonk import SRS, create_proofs_batched, keygen
    from delay_enc_tpu_torch.runtime.workloads import build_circuit

    _cuda.build(force=True)
    dev = torch.device("cuda", 0)
    print(overwrite_check(dev), flush=True)
    k7 = C.golden_k7(dev)
    builder = build_circuit("delay_enc", 16)
    srs = SRS.setup(16, tau=0x5EED_0F_DE1A7, device=dev)
    pk, vk = keygen(builder, srs, k=16, device=dev)
    builders = [build_circuit("delay_enc", 16) for _ in range(C.BATCH)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, runs = [], []
    for _ in range(2):
        t0 = time.time()
        runs.append(create_proofs_batched(srs, pk, builders, np.random.default_rng(0),
                                          device=dev))
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
    if runs[0] != runs[1]:
        raise AssertionError("two unsharded batches from one seed differ")
    batch = {"builders": builders, "proofs": runs[0], "walls": walls,
             "peak": torch.cuda.max_memory_allocated()}
    C.mesh_phase(dev, card, srs, pk, vk, k7, batch)
    print("mesh phase: ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
