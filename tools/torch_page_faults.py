"""Host page faults and wall seconds a proving request, for one checkout.

    python3 tools/torch_page_faults.py [--root DIR] [--rows delay_enc:16,delay_enc:16:4,...]
                                       [--requests 6]

A row is `workload:k` (one `create_proof` a request) or `workload:k:B`
(one `create_proofs_batched` over B builds of the statement a request).
For each row: the statement (`runtime/workloads.py:build_circuit`, the
benchmark's `t_bits` at k=18), `SRS.setup`, keygen, one warm-up request,
then `--requests` requests, each closed by `torch.cuda.synchronize()`.
Around each request it reads the process's minor and major page faults
(`resource.getrusage(RUSAGE_SELF)`: every thread of the process; and
`minflt` of `/proc/self/stat` beside it) and the counters `staging grow`,
`staging reuse` and `htod bytes` where the checkout has them.  Before the
rows it times what a fresh host array costs against a warm one: numpy
`empty` then `fill` of the sizes of a proof's stacked columns (12.6, 16.8,
50.3 and 67.1 MB), five times each, against `fill` of one array kept.
`--root` names the checkout whose `delay_enc_tpu_torch` is imported
(default: this one), so that a parent and a change can be read one after
another on one card.  Prints the card's name and power limit, a JSON line
a probed size, then one JSON line a row: the faults and seconds of each
request and their medians.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_BITS = {("delay_enc", 18): 31}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--rows", default="delay_enc:16,delay_enc:16:4,mod_pow:17,delay_enc:18")
    ap.add_argument("--requests", type=int, default=6)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    from delay_enc_tpu_torch import native
    from delay_enc_tpu_torch.ops import _cuda
    from delay_enc_tpu_torch.plonk import SRS, create_proof, create_proofs_batched, keygen
    from delay_enc_tpu_torch.runtime.workloads import build_circuit
    from delay_enc_tpu_torch.utils.timers import GLOBAL_METRICS

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    native.require()
    print(f"card: {card}; root {os.path.abspath(args.root)}", flush=True)
    _cuda.build()
    counters = ("staging grow", "staging reuse", "htod bytes")

    def proc_minflt() -> int:
        with open("/proc/self/stat") as f:
            return int(f.read().rsplit(")", 1)[1].split()[7])

    def read():
        ru = resource.getrusage(resource.RUSAGE_SELF)
        c = GLOBAL_METRICS.counters
        return (ru.ru_minflt, ru.ru_majflt, time.perf_counter(), proc_minflt(),
                *(c.get(n, 0) for n in counters))

    for mb in (12.58, 16.78, 50.33, 67.11):
        words = int(mb * 1e6) // 4
        fresh, warm = [], []
        before = read()
        for _ in range(5):
            t = time.perf_counter()
            a = np.empty(words, dtype=np.uint32)
            a.fill(1)
            fresh.append(time.perf_counter() - t)
            del a
        after = read()
        kept = np.zeros(words, dtype=np.uint32)
        for _ in range(5):
            t = time.perf_counter()
            kept.fill(1)
            warm.append(time.perf_counter() - t)
        del kept
        print(json.dumps({"probe_mb": mb, "fresh_ms": round(1e3 * statistics.median(fresh), 3),
                          "warm_ms": round(1e3 * statistics.median(warm), 3),
                          "minflt_5_fresh": after[0] - before[0],
                          "proc_minflt_5_fresh": after[3] - before[3]}), flush=True)

    for row in args.rows.split(","):
        parts = row.split(":")
        workload, k = parts[0], int(parts[1])
        batch = int(parts[2]) if len(parts) > 2 else 0
        b = build_circuit(workload, k, t_bits=T_BITS.get((workload, k)))
        srs = SRS.setup(k, tau=0x5EED_0F_A17 + k, device=dev)
        pk, _ = keygen(b, srs, k=k, device=dev)
        if batch:
            builds = [b] + [build_circuit(workload, k, t_bits=T_BITS.get((workload, k)))
                            for _ in range(batch - 1)]
            request = lambda rng: create_proofs_batched(srs, pk, builds, rng, device=dev)
        else:
            request = lambda rng: [create_proof(srs, pk, b, rng, device=dev)]
        request(np.random.default_rng([k, 0]))
        torch.cuda.synchronize()
        out = {"row": row, "minflt": [], "majflt": [], "s": [], "proc_minflt": []}
        for name in counters:
            out[name] = []
        for i in range(args.requests):
            before = read()
            request(np.random.default_rng([k, i + 1]))
            torch.cuda.synchronize()
            after = read()
            d = [x - y for x, y in zip(after, before)]
            out["minflt"].append(d[0])
            out["majflt"].append(d[1])
            out["s"].append(round(d[2], 5))
            out["proc_minflt"].append(d[3])
            for name, v in zip(counters, d[4:]):
                out[name].append(v)
        out["minflt_median"] = statistics.median(out["minflt"])
        out["s_median"] = statistics.median(out["s"])
        print(json.dumps(out), flush=True)
        del srs, pk, request
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
