"""chip_smoke.py's phase 9, the mesh, alone: on a host with 4 cards or more it
runs `make_mesh(4)`, one shard a card, with the copies between the cards
over NVLink; on one card, 4 shards on that card.

    python3 tools/torch_mesh_phase.py

It builds the kernels, proves the k=7 test circuit against the JAX golden
(chip_smoke's phase 0, whose SRS and keys the k=7 sharded batch reuses),
then sets up delay_enc k=16 (bench.py's draw, chip_smoke's tau), keygen,
and the unsharded batch of four builds of the statement twice from
default_rng(0) (phase 7's bytes, walls and peak memory), and runs
`chip_smoke.mesh_phase` on them.  It prints the card's name and power limit
and the phase's lines; it exits non-zero on any mismatch.
"""

from __future__ import annotations

import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
