"""create_proofs_pipelined: single proofs on worker threads, overlapped.

Counterpart of `delay_enc_tpu/plonk/pipeline.py`.  A proof is serial under
Fiat-Shamir, so its host work (transcript, lookup permutation, the plane
folds) cannot overlap its own device work; across instances it can: while
one worker waits on a commitment's fetch or builds columns on the host,
another's kernels run.  Each worker thread proves on a CUDA stream of its
own, kept for its proofs (the caching allocator reuses memory within a
stream), and a proof's phases wait for that stream only (`prover._Spans`),
so the workers do not run in lock step.  Python holds the GIL through the
host phases, so the overlap is what the GIL leaves.

Each instance draws from its own `np.random.default_rng(seed)`, so every
proof equals `create_proof` of its builder with that seed, whatever the
scheduling.  The state the workers share and would otherwise build lazily
(the SRS's pair tables, the domain's NTT plans and the C host library) is
built before they start, and the key's tensors, made on the default
stream, are complete before the first launch; the kernels' build and
bindings are under a lock (`ops/_cuda.py`).
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..native import get_lib
from ..utils.device import resolve, sync_stream
from .prover import create_proof


def _prepare(srs, pk, device, msm: str):
    """Build the shared lazy state on the calling thread."""
    domain = pk.vk.domain
    srs.truncated(domain.k).msm_tables(msm)
    domain.plan(device)
    domain.plan_ext(device)
    get_lib()
    sync_stream(device)


def create_proofs_pipelined(srs, pk, builders, seeds=None, depth: int = 2, on_proof=None,
                            device="cuda", msm: str = "b4") -> list[bytes]:
    """Prove each builder with `depth` proofs in flight; returns the proofs
    in builder order.  seeds: one rng seed an instance (0..B-1 by default);
    on_proof(i, proof) is called as each completes, in order."""
    device = resolve(device)
    if seeds is None:
        seeds = list(range(len(builders)))
    if len(seeds) != len(builders):
        raise ValueError(f"{len(seeds)} seeds for {len(builders)} builders")
    _prepare(srs, pk, device, msm)

    worker = threading.local()

    def one(b, seed):
        prove = lambda: create_proof(srs, pk, b, np.random.default_rng(seed), device=device,
                                     msm=msm)
        if device.type != "cuda":
            return prove()
        if not hasattr(worker, "stream"):
            worker.stream = torch.cuda.Stream(device)
        with torch.cuda.stream(worker.stream):
            return prove()

    proofs = []
    with ThreadPoolExecutor(max_workers=max(1, depth)) as pool:
        futs = [pool.submit(one, b, s) for b, s in zip(builders, seeds)]
        for i, f in enumerate(futs):
            proofs.append(f.result())
            if on_proof is not None:
                on_proof(i, proofs[-1])
    return proofs
