"""Time K7, the openings' two contractions, alone on one card, for one checkout.

    python3 tools/torch_open_bench.py [--root DIR] [--reps 20]

Times `open_stack` at the delay_enc k=16 openings (47, 6 and 4 rows of 2^16
over three points), eval and combine, and, where the checkout has the
batched form (`open_stacks`), four such tables in one launch.  Each case is
checked against the plain version, then timed by CUDA events over `--reps`
back-to-back calls and by torch.profiler's device time (`chip_smoke.py
device_ms`, of the checkout this file lies in).  `--root` names the
checkout whose `delay_enc_tpu_torch` is imported (default: the one this file
lies in), so that two trees can be timed in turns on one card; the kernels
are built in that tree.  It prints the card's name and power limit and one
JSON line a case.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    from delay_enc_tpu_torch.ops import _cuda
    from delay_enc_tpu_torch.plonk import kernels as K

    sys.path.insert(1, HERE)
    from chip_smoke import device_ms, timed

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the tool times the card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    _cuda.build(force=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(7)

    def rand(*shape):
        w = torch.randint(-2**31, 2**31, (*shape, 8), generator=gen, device=dev,
                          dtype=torch.int64).to(torch.int32)
        w[..., 7] &= 0x0FFFFFFF
        return w

    n, counts = 1 << 16, (47, 6, 4)

    def instance():
        return [list(rand(m, n)) for m in counts], list(rand(len(counts), n)), rand(max(counts))

    one = instance()
    cases = [("B=1", lambda kind: K.open_stack(kind, *one),
              lambda kind: K.open_stack_plain(kind, *one))]
    if hasattr(K, "open_stacks"):
        four = [instance() for _ in range(4)]
        batch = tuple(list(x) for x in zip(*four))
        cases.append(("B=4", lambda kind: K.open_stacks(kind, *batch),
                      lambda kind: K.open_stacks_plain(kind, *batch)))
    for label, fn, plain in cases:
        for kind in ("eval", "combine"):
            call = lambda: fn(kind)
            agrees = bool(torch.equal(call(), plain(kind)))
            print(json.dumps({"root": root, "kernel": f"open_{kind}", "case": label,
                              "agrees": agrees, "ms": timed(call, args.reps),
                              "device_ms": device_ms(call, args.reps, f"open_{kind}_kernel"),
                              "reps": args.reps}), flush=True)
            if not agrees:
                raise SystemExit(f"open_{kind} {label} disagrees with its plain version")
    return 0


if __name__ == "__main__":
    sys.exit(main())
