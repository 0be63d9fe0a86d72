"""The one generator of requests, driven by a traffic mix's file.

A mix is a closed loop of one client: the next request goes out when the
previous one has returned and the device has finished.  Its file gives

    entry            "create_proof" (one proof a request),
                     "create_proofs_batched" (`batch` proofs in one batched
                     pipeline) or "create_proofs_pipelined" (`batch` proofs,
                     `depth` in flight);
    batch, depth     proofs a request, and the pipeline's depth;
    warmup_requests  requests of set-up, before the window;
    trace_requests   requests under the profiler after the window, in a
                     traced run;
    check_sample     proofs that the reference verifies, drawn from the seed.

Every request proves the configuration's one statement with fresh prover
randomness: request i of phase p draws from np.random.default_rng([p,
seed, i]), so one seed gives the same draws in every run.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

ENTRIES = ("create_proof", "create_proofs_batched", "create_proofs_pipelined")
# the phases' first words of entropy: set-up, window, traced requests,
# the SRS's secret, the sample that is checked
WARMUP, WINDOW, TRACED, SRS_SECRET, CHECK = range(5)


@dataclass(frozen=True)
class Mix:
    entry: str
    batch: int = 1
    depth: int = 1
    warmup_requests: int = 1
    trace_requests: int = 4
    check_sample: int = 12

    @staticmethod
    def from_file(spec: dict) -> "Mix":
        fields = {k: spec[k] for k in ("entry", "batch", "depth", "warmup_requests",
                                       "trace_requests", "check_sample") if k in spec}
        mix = Mix(**fields)
        if mix.entry not in ENTRIES:
            raise ValueError(f"unknown entry {mix.entry!r}: one of {ENTRIES}")
        if mix.entry == "create_proof" and mix.batch != 1:
            raise ValueError("create_proof makes one proof a request")
        if min(mix.batch, mix.depth, mix.warmup_requests, mix.trace_requests,
               mix.check_sample) < 1:
            raise ValueError(f"every count of a mix is at least 1: {spec}")
        return mix


def entropy(seed: int) -> int:
    """The seed as a non-negative integer (numpy's seeds are)."""
    return seed & ((1 << 64) - 1)


def rng(phase: int, seed: int, index: int) -> np.random.Generator:
    return np.random.default_rng([phase, entropy(seed), index])


def requester(mix: Mix, plonk, srs, pk, builder, device):
    """request(rng) -> the list of proofs of one request."""
    builders = [builder] * mix.batch
    if mix.entry == "create_proof":
        return lambda g: [plonk.create_proof(srs, pk, builder, g, device=device)]
    if mix.entry == "create_proofs_batched":
        return lambda g: list(plonk.create_proofs_batched(srs, pk, builders, g, device=device))

    def pipelined(g):
        seeds = [int(s) for s in g.integers(0, 1 << 62, mix.batch)]
        return list(plonk.create_proofs_pipelined(srs, pk, builders, seeds=seeds,
                                                  depth=mix.depth, device=device))

    return pipelined
