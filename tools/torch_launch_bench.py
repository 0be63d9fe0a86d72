"""Host microseconds per launch of the port's elementwise field kernel (K-a).

    python3 tools/torch_launch_bench.py [--root DIR] [--count 5000]

A loop of small launches ((64, 8) operands, so the card is never the limit)
is timed on the host clock: first the enqueue alone, then with the final
synchronise.  `--root` names the checkout whose `delay_enc_tpu_torch` is
imported (default: the one this file lies in), so that two trees can be
timed one after another on one card; the kernels are built in that tree.
It prints the card's name and power limit and one JSON line for each case.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--count", type=int, default=5000)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from delay_enc_tpu_torch.ops import limbs as L

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; root {os.path.abspath(args.root)}", flush=True)
    ctx = L.FR_CTX
    a = L.to_device_mont(ctx, list(range(1, 65)), dev)
    b = L.to_device_mont(ctx, list(range(101, 165)), dev)
    one = a[:1].clone()
    cases = (
        ("mont_mul, same shape", lambda: L.mont_mul(ctx, a, b)),
        ("add, same shape", lambda: L.add(ctx, a, b)),
        ("mont_mul, (64, 8) by (1, 8)", lambda: L.mont_mul(ctx, a, one)),
        ("mont_mul, (4, 16, 8) by (4, 1, 8)",
         lambda: L.mont_mul(ctx, a.view(4, 16, 8), b.view(4, 16, 8)[:, :1])),
    )
    for name, fn in cases:
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.count):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        print(json.dumps({"case": name, "launches": args.count,
                          "host_us_per_launch": (t1 - t0) / args.count * 1e6,
                          "us_per_launch_with_sync": (t2 - t0) / args.count * 1e6}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
