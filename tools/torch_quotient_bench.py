"""Time the quotient kernel K6 alone on one card, for one checkout.

    python3 tools/torch_quotient_bench.py [--root DIR] [--reps 20]

Times K6 in its fused form (rot 8, dense store) at the delay_enc k=16 and
k=18 extended cosets (2^19 and 2^21 rows), and, where the checkout has it,
its coset form of the split quotient (rot 1, one coset of 2^18 rows stored
at stride 8 into a 2^21 h_ext).  Each case is checked against the plain
version (the composition over K-a), then timed by CUDA events over `--reps`
back-to-back launches and by torch.profiler's device time.  `--root` names
the checkout whose `delay_enc_tpu_torch` is imported (default: the one this
file lies in), so that two trees can be timed in turns on one card; the
kernels are built in that tree.  It prints the card's name and power limit
and one JSON line a case.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from delay_enc_tpu_torch.plonk import kernels as K
    from delay_enc_tpu_torch.plonk.keygen import KEY_ROWS

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    coset_form = "rot" in inspect.signature(K.quotient_h).parameters
    print(f"card: {card}; root {root}; coset form: {coset_form}", flush=True)

    gen = torch.Generator(device=dev).manual_seed(11)
    rng = np.random.default_rng(11)
    consts = K.challenge_words(*(int(v) for v in rng.integers(1, 2**62, 4)),
                               [int(v) for v in rng.integers(1, 2**62, 6)])

    def field(*shape):
        w = torch.randint(-2**31, 2**31, (*shape, 8), generator=gen, device=dev,
                          dtype=torch.int64).to(torch.int32)
        w[..., 7] &= 0x0FFFFFFF  # below 2^252 < p
        return w

    def timings(fn):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
                 for e in prof.key_averages() if "quotient_kernel" in e.key)
        return start.elapsed_time(end) / args.reps, us / 1e3 / args.reps if us else None

    cases = [("fused", 19), ("fused", 21)] + ([("coset", 18)] if coset_form else [])
    for form, k in cases:
        n = 1 << k
        wit, key, x = field(K.WIT_ROWS, n), field(len(KEY_ROWS), n), field(n)
        if form == "fused":
            zh = field(8)
            fn = lambda: K.quotient_h(wit, key, x, zh, consts)
            ok = bool(torch.equal(fn(), K.quotient_h_plain(wit, key, x, zh, consts)))
        else:
            zh, h_ext = field(1), torch.empty((8 * n, 8), dtype=torch.int32, device=dev)
            fn = lambda: K.quotient_h(wit, key, x, zh, consts, rot=1, out=h_ext, out_stride=8,
                                      out_offset=7)
            fn()
            ok = bool(torch.equal(h_ext[7::8], K.quotient_h_plain(wit, key, x, zh, consts, rot=1)))
        ms, device = timings(fn)
        print(json.dumps({"form": form, "rows": n, "agrees": ok, "events_ms": ms,
                          "device_ms": device, "reps": args.reps}), flush=True)
        if not ok:
            raise SystemExit(f"K6's {form} form disagrees with its plain version at {n} rows")
        del wit, key, x
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
