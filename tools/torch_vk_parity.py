"""Keygen seconds and vk parity with the JAX package at the rows the card proves.

    python3 tools/torch_vk_parity.py [--root DIR] [--rows delay_enc:16,mod_pow:17,delay_enc:18]

For each row: bench.py's statement (`runtime/workloads.py`), `SRS.setup`
with the tau of the chip_smoke.py phase that proves it, keygen in base 4,
the base-16 table, keygen in base 16; each vk is held byte for byte to the
JAX package's by `chip_smoke.vk_parity` of the checkout this file lies in
(the rows of its `VK_GOLDENS`).  `--root` names the checkout whose
`delay_enc_tpu_torch` is imported (default: this one), so that a parent
and a change can be timed one after another on one card; its kernels are
built in that tree.  It prints the card's name and power limit, whether
the host C libraries loaded, chip_smoke's `vk_parity` line for each
keygen and one JSON line a row.  A vk that differs exits non-zero.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# chip_smoke.py's taus: phase 4, 5 and 6
TAU = {("delay_enc", 16): 0x5EED_0F_DE1A7, ("mod_pow", 17): 0x5EED_0F_0D90,
       ("delay_enc", 18): 0x5EED_0F_DE1A7_18}


def load_smoke():
    """chip_smoke.py of this checkout (its vk check and the goldens' list),
    whichever checkout `--root` imports the port from."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--rows", default="delay_enc:16,mod_pow:17,delay_enc:18")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from delay_enc_tpu_torch import native
    from delay_enc_tpu_torch.ops import _cuda
    from delay_enc_tpu_torch.plonk import SRS, keygen
    from delay_enc_tpu_torch.runtime.workloads import build_circuit

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    libs = {"limbops": native.get_lib() is not None, "ecops": native.get_eclib() is not None}
    print(f"card: {card}; root {os.path.abspath(args.root)}; host C libraries loaded: "
          f"{json.dumps(libs)}", flush=True)
    t0 = time.time()
    _cuda.build()
    print(f"build: {time.time() - t0:.1f} s", flush=True)
    smoke = load_smoke()
    for row in args.rows.split(","):
        workload, k = row.split(":")[0], int(row.split(":")[1])
        torch.cuda.empty_cache()
        t0 = time.time()
        b = build_circuit(workload, k)
        t_build = time.time() - t0
        t0 = time.time()
        srs = SRS.setup(k, tau=TAU[(workload, k)], device=dev)
        torch.cuda.synchronize()
        t_srs = time.time() - t0
        out = {"row": row, "rows": b.rows, "build_s": t_build, "srs_s": t_srs}
        for msm in ("b4", "b16"):
            t0 = time.time()
            srs.msm_tables(msm)
            torch.cuda.synchronize()
            out[f"table_{msm}_s"] = time.time() - t0
            t0 = time.time()
            pk, vk = keygen(b, srs, k=k, device=dev, msm=msm)
            torch.cuda.synchronize()
            out[f"keygen_{msm}_s"] = time.time() - t0
            out[f"split_{msm}"] = pk.split
            smoke.vk_parity(row, workload, b, vk, msm, out[f"keygen_{msm}_s"])
            del pk, vk
        del srs
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
