"""The largest rows of bench.py's sweep on one card, in both MSM bases.

    python3 tools/torch_largest_rows.py [--rows delay_enc:17,delay_enc:18,...] [--out FILE]

The rows default to delay_enc at k=17, 18 and 19 and mod_pow at k=18 and
19, bench.py's draws with its T_BITS (`runtime/workloads.py`), nothing cut.
For each row: SRS setup and keygen at k (the split quotient from k=18 on),
with seconds and peak device memory; then in base 4 and in base 16 in turn
two proofs from default_rng(0) (walls, peak device memory, the bytes equal
between them and across the bases; base 16 after its table, whose seconds
and bytes are kept), one more under torch.profiler (chip_smoke's
`profile_proof`: device ms by kernel, the device's idle share), and verify.  It prints the card's name and power
limit, a line for each row, and one JSON line with every row (also written
to FILE with --out).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ROWS = "delay_enc:17,delay_enc:18,delay_enc:19,mod_pow:18,mod_pow:19"


def run_row(dev, workload: str, k: int) -> dict:
    import numpy as np
    import torch

    from chip_smoke import profile_proof
    from delay_enc_tpu_torch.plonk import SRS, create_proof, keygen, verify_proof
    from delay_enc_tpu_torch.plonk.keygen import min_k
    from delay_enc_tpu_torch.runtime.workloads import T_BITS, build_circuit

    torch.cuda.empty_cache()
    t0 = time.time()
    b = build_circuit(workload, k)
    row = {"workload": workload, "k": k, "t_bits": T_BITS.get((workload, k)), "rows": b.rows,
           "min_k": min_k(b), "build_s": round(time.time() - t0, 3)}
    t0 = time.time()
    srs = SRS.setup(k, tau=0x5EED_0F_1A26 + k, device=dev)
    row["srs_s"] = round(time.time() - t0, 3)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    pk, vk = keygen(b, srs, k=k, device=dev)
    torch.cuda.synchronize()
    row.update(keygen_s=round(time.time() - t0, 3), split=pk.split,
               keygen_peak_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3))
    proofs = {}
    for msm in ("b4", "b16"):
        out = {}
        if msm == "b16":
            torch.cuda.synchronize()
            t0 = time.time()
            tab = srs.pair_tables16()
            torch.cuda.synchronize()
            out.update(table_s=round(time.time() - t0, 3), table_bytes=tab.numel() * 4)
            del tab
        torch.cuda.reset_peak_memory_stats()
        walls, got = [], []
        for _ in range(2):
            t0 = time.time()
            got.append(create_proof(srs, pk, b, np.random.default_rng(0), device=dev, msm=msm))
            torch.cuda.synchronize()
            walls.append(round(time.time() - t0, 3))
        if got[0] != got[1]:
            raise AssertionError(f"{workload} k={k} {msm}: proofs from one seed differ")
        proofs[msm] = got[0]
        out.update(walls_s=walls, peak_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3))

        out["profile"] = profile_proof(srs, pk, b, got[0], dev, f"{workload} k={k} {msm}",
                                       msm=msm)
        t0 = time.time()
        out["verifies"] = verify_proof(srs, vk, got[0])
        out["verify_s"] = round(time.time() - t0, 3)
        if not out["verifies"]:
            raise AssertionError(f"{workload} k={k} {msm}: the proof does not verify")
        row[msm] = out
    if proofs["b4"] != proofs["b16"]:
        raise AssertionError(f"{workload} k={k}: the bases' bytes differ")
    row["bases_equal"] = True
    del pk, srs
    torch.cuda.empty_cache()
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", default=ROWS, help="workload:k,... (default %(default)s)")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args()
    import torch

    from chip_smoke import smi
    from delay_enc_tpu_torch.ops import _cuda

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: torch_largest_rows.py runs on the card only")
    dev = torch.device("cuda", 0)
    card = smi("name,power.limit")
    print(f"card: {card}", flush=True)
    _cuda.load_all()
    rows = []
    for spec in args.rows.split(","):
        workload, k = spec.split(":")
        t0 = time.time()
        row = run_row(dev, workload, int(k))
        row["row_s"] = round(time.time() - t0, 1)
        rows.append(row)
        print(f"{workload} k={k}: {json.dumps(row)}", flush=True)
    line = json.dumps({"card": card, "rows": rows})
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
