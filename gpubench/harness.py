"""One run of one cell: set-up, the measured window, an optional traced
stretch, the check against the reference, and the result's line.

The program under test is delay_enc_tpu_torch; this module imports it only
inside `set_up`, and hands the reference nothing the program made but the
key and the proofs it judges.
"""

from __future__ import annotations

import sys
import time
import traceback
from dataclasses import dataclass, field

import numpy as np

from . import check, devtrace, traffic
from .reference import bn254


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def secret(seed: int) -> int:
    """The SRS's secret tau, drawn from the seed: non-zero, and no 2^28-th
    root of unity, so it lies in no domain of the protocol."""
    ss = np.random.SeedSequence([traffic.SRS_SECRET, traffic.entropy(seed)])
    words = ss.generate_state(16, np.uint32)
    tau = int.from_bytes(words.tobytes(), "little") % bn254.R
    while tau == 0 or pow(tau, 1 << bn254.FR_TWO_ADICITY, bn254.R) == 1:
        tau += 1
    return tau


def statement_of(builder, k: int) -> dict:
    """The statement as plain data, copied out of the circuit's builder."""
    return {"k": k, "rows": builder.rows,
            "fixed": {name: list(col) for name, col in builder.fixed.items()},
            "copies": [tuple(map(tuple, pair)) for pair in builder.copies],
            "lookup_widths": sorted(builder.lookup_widths),
            "instance": list(builder.instance)}


def vk_entries(vk) -> list:
    """The program's verifying key in the reference's entry order."""
    from .reference.plonk import ALL_FIXED

    return ([(f"fixed.{n}", vk.fixed_commitments[n]) for n in ALL_FIXED]
            + [(f"sigma.{c}", p) for c, p in enumerate(vk.sigma_commitments)]
            + [("transcript_repr", vk.transcript_repr)])


@dataclass
class Setup:
    builder: object  # the statement's circuit, as the program built it
    tau: int
    vk: list
    request: object  # rng -> [proof bytes]
    metrics: object  # the program's span registry, or None
    state: list = field(default_factory=list)  # the program's objects, freed before the check


def default_build(config: dict):
    from delay_enc_tpu_torch.runtime.workloads import build_circuit

    return build_circuit(config["workload"], config["k"], seed=config["circuit_seed"],
                         t_bits=config.get("t_bits"))


def set_up(config: dict, mix: traffic.Mix, seed: int, device, build=None) -> Setup:
    """Build the statement, the SRS from the seed's secret, and the key."""
    from delay_enc_tpu_torch import native, plonk

    if device.type == "cuda" and hasattr(native, "require"):
        native.require()  # the host path in C, as deployed
    t = time.time()
    builder = (build or default_build)(config)
    k = config["k"]
    log(f"# statement {config['workload']} k={k}: {builder.rows} rows, "
        f"{time.time() - t:.3f} s")
    tau = secret(seed)
    t = time.time()
    srs = plonk.SRS.setup(k, tau=tau, device=device)
    t_srs = time.time() - t
    t = time.time()
    pk, vk = plonk.keygen(builder, srs, k=k, device=device)
    log(f"# SRS setup {t_srs:.3f} s, keygen {time.time() - t:.3f} s")
    try:
        from delay_enc_tpu_torch.utils.timers import GLOBAL_METRICS as metrics
    except ImportError:
        metrics = None
    return Setup(builder=builder, tau=tau, vk=vk_entries(vk),
                 request=traffic.requester(mix, plonk, srs, pk, builder, device),
                 metrics=metrics, state=[srs, pk, vk, builder])


@dataclass
class Run:
    """What the metric readers read."""
    setup_s: float
    window_s: float = 0.0
    latencies: list = field(default_factory=list)  # seconds a request
    proofs: int = 0  # completed in the window
    batch: int = 1
    spans: dict = field(default_factory=dict)  # the program's span seconds over the window
    trace: devtrace.Trace | None = None


def span_totals(metrics) -> dict:
    snap = getattr(metrics, "snapshot", None)
    return dict(snap()) if snap else {}


def run_cell(cell: dict, config: dict, mix_spec: dict, seed: int, seconds: float, trace: bool,
             metric_entries: list, readers: dict, device, t_start: float,
             build=None) -> dict:
    """One run; returns the result's dict ("checks" last).  t_start is the
    process's start on time.time()."""
    import torch

    mix = traffic.Mix.from_file(mix_spec)
    is_cuda = device.type == "cuda"

    def sync():
        if is_cuda:
            torch.cuda.synchronize(device)

    s = set_up(config, mix, seed, device, build)
    all_proofs, asked, missing = [], 0, 0

    def attempt(phase: int, i: int) -> list:
        nonlocal asked, missing
        asked += mix.batch
        try:
            got = s.request(traffic.rng(phase, seed, i))
            sync()
        except Exception:  # a request that fails is counted, and the run goes on
            log(f"# request {phase}/{i} failed:\n{traceback.format_exc()}")
            got = []
        missing += max(0, mix.batch - len(got))
        all_proofs.extend(got)
        return got

    for i in range(mix.warmup_requests):
        t = time.time()
        attempt(traffic.WARMUP, i)
        log(f"# warm-up request {i}: {time.time() - t:.3f} s")
    run = Run(setup_s=time.time() - t_start, batch=mix.batch)

    before = span_totals(s.metrics)
    t0 = time.perf_counter()
    t_end = t0
    i = 0
    while t_end - t0 < seconds:
        start = time.perf_counter()
        got = attempt(traffic.WINDOW, i)
        t_end = time.perf_counter()
        run.latencies.append(t_end - start)
        run.proofs += len(got)
        i += 1
    run.window_s = t_end - t0
    after = span_totals(s.metrics)
    run.spans = {k: v - before.get(k, 0.0) for k, v in after.items() if v != before.get(k, 0.0)}
    log(f"# window {run.window_s:.3f} s: {i} requests, {run.proofs} proofs; first "
        f"{run.latencies[0]:.4f} s, median {float(np.median(run.latencies)):.4f} s, "
        f"max {max(run.latencies):.4f} s")

    if trace:
        if not is_cuda:
            raise RuntimeError("a traced run needs the card")
        run.trace = devtrace.traced(lambda j: attempt(traffic.TRACED, j), mix.trace_requests,
                                    s.metrics if hasattr(s.metrics, "add") else None, sync)
        log(f"# traced {mix.trace_requests} requests: window {run.trace.window_s:.4f} s, "
            f"busy {run.trace.busy_s():.4f} s")

    peak = torch.cuda.max_memory_allocated(device) if is_cuda else 0
    name = torch.cuda.get_device_name(device) if is_cuda else "cpu"
    statement = statement_of(s.builder, config["k"])
    s.state.clear()
    s.request = s.builder = None
    if is_cuda:
        torch.cuda.empty_cache()

    t = time.time()
    picked = check.sample(len(all_proofs), mix.check_sample,
                          traffic.rng(traffic.CHECK, seed, 0))
    numbers, detail = check.judge(statement, config["statement_blake2b"], s.tau, s.vk,
                                  all_proofs, picked, missing)
    for line in detail[:20]:
        log(f"# {line}")
    log(f"# reference: {len(picked)} of {len(all_proofs)} proofs verified, "
        f"{time.time() - t:.3f} s")

    metrics = {}
    for entry in metric_entries:
        value = readers[entry["name"]].read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    device_info = {"platform": "gpu" if is_cuda else "cpu", "kind": name,
                   "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": check.passed(numbers), "attempted": asked,
              "failed": missing + numbers["rejected"], "metrics": metrics,
              "device": device_info}
    if run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s()
        device_info["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = {n: {"value": v, "limit": check.LIMITS[n]} for n, v in numbers.items()}
    return result
