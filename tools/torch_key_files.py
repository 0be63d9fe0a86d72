"""Seconds and bytes of the port's key files at one statement, compressed and not.

    python3 tools/torch_key_files.py [--workload delay_enc] [--k 16] [--dir DIR]

Builds bench.py's statement (`runtime/workloads.py`), sets up an SRS and
runs keygen on the card, then writes the key with `save_pk` both ways (the
JAX package's `savez_compressed` and plain `savez`) and reads each file
back with `load_pk`, which must give the same vk.  `--dir` holds the files
(default: a temporary directory, removed at the end).  It prints the
card's name and power limit and one JSON line for each way.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="delay_enc")
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--dir", default=None)
    args = ap.parse_args()
    import torch

    from delay_enc_tpu_torch.plonk import SRS, keygen
    from delay_enc_tpu_torch.plonk.serialize import load_pk, save_pk
    from delay_enc_tpu_torch.runtime import workloads as W

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    d = args.dir or tempfile.mkdtemp(prefix="keys_")
    try:
        b = W.build_circuit(args.workload, args.k)
        srs = SRS.setup(args.k, device=dev)
        t0 = time.time()
        pk, vk = keygen(b, srs, k=args.k, device=dev)
        torch.cuda.synchronize()
        t_key = time.time() - t0
        for compressed in (False, True):
            path = os.path.join(d, f"keys_{args.workload}_{'z' if compressed else 'plain'}")
            t0 = time.time()
            save_pk(pk, path, compressed=compressed)
            t_save = time.time() - t0
            t0 = time.time()
            back = load_pk(path, device=dev)
            torch.cuda.synchronize()
            t_load = time.time() - t0
            if back.vk.transcript_repr != vk.transcript_repr:
                raise AssertionError("the key read back has another vk")
            del back
            print(json.dumps({"workload": args.workload, "k": args.k, "split": pk.split,
                              "compressed": compressed, "keygen_s": t_key, "save_pk_s": t_save,
                              "load_pk_s": t_load,
                              "pk_bytes": os.path.getsize(path + ".pk.npz")}), flush=True)
            os.remove(path + ".pk.npz")
    finally:
        if args.dir is None:
            shutil.rmtree(d, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
