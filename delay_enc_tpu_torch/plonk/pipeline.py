"""create_proofs_pipelined: single proofs on worker threads, overlapped.

Counterpart of `delay_enc_tpu/plonk/pipeline.py`.  A proof is serial under
Fiat-Shamir, so its host work (transcript, lookup permutation, the plane
folds) cannot overlap its own device work; across instances it can: while
one worker waits on a commitment's fetch or builds columns on the host,
another's kernels run.  Each worker thread proves on a CUDA stream of its
own, kept for its proofs (the caching allocator reuses memory within a
stream), and a proof waits for that stream only, where it reads a result
to the host (`ops/limbs.py:to_numpy`), so the workers do not run in lock
step.  Each worker's proof is a root span `prove` of its own, with its own
request id (`utils/timers.py`).  Python holds the GIL through the
host phases, so the overlap is what the GIL leaves.

Each instance draws from its own `np.random.default_rng(seed)`, so every
proof equals `create_proof` of its builder with that seed, whatever the
scheduling.  The state the workers share and would otherwise build lazily
(the SRS's pair tables, the domain's NTT plans, the matmul NTT's plans
with `ntt="mxu"`, and the C host library) is
built before they start, and the key's tensors, made on the default
stream, are complete before the first launch; the kernels' build and
bindings are under a lock (`ops/_cuda.py`).
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..native import get_lib, get_pyints
from ..utils.device import resolve, sync_stream
from .prover import create_proof, transform_plans


def _prepare(srs, pk, device, msm: str, ntt: str = "stockham"):
    """Build the shared lazy state on the calling thread."""
    domain = pk.vk.domain
    srs.truncated(domain.k).msm_tables(msm)
    domain.plan(device)
    domain.plan_ext(device)
    if ntt == "mxu" and not pk.split:
        transform_plans(domain, device, ntt)
    get_lib()
    get_pyints()
    sync_stream(device)


def create_proofs_pipelined(srs, pk, builders, seeds=None, depth: int = 2, on_proof=None,
                            device="cuda", msm: str = "b4",
                            ntt: str = "stockham") -> list[bytes]:
    """Prove each builder with `depth` proofs in flight; returns the proofs
    in builder order.  seeds: one rng seed an instance (0..B-1 by default);
    on_proof(i, proof) is called as each completes, in order.  `msm` and
    `ntt` go to every `create_proof`."""
    device = resolve(device)
    if seeds is None:
        seeds = list(range(len(builders)))
    if len(seeds) != len(builders):
        raise ValueError(f"{len(seeds)} seeds for {len(builders)} builders")
    _prepare(srs, pk, device, msm, ntt)

    worker = threading.local()

    def one(b, seed):
        prove = lambda: create_proof(srs, pk, b, np.random.default_rng(seed), device=device,
                                     msm=msm, ntt=ntt)
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
