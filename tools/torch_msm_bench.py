"""Build the port's kernels with optional -D defines, check the MSM kernels
against their plain versions and time them alone at the proof's shapes, with
one large field product, addition and transform beside them, on one card.

    python3 tools/torch_msm_bench.py [--define MSM_MIN_BLOCKS=4 ...] [--rows 127,1016]
        [--rows16 64,512]

It prints the card's name and power limit, the registers and spills ptxas
reports for csrc/msm.cu, and one JSON line for each measurement.  The
defines that the sources know: MSM_MIN_BLOCKS=n (csrc/msm.cu) and
FLD_PORTABLE (csrc/field.cuh: the portable Montgomery bodies on the device).
K-c is timed over the base-4 table (--rows), then plane_sums16 over the
base-16 one (--rows16).
Run it once for each set of defines, all on one card one after another, to
compare variants of the kernels; times from two cards do not compare.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from delay_enc_tpu_torch.ops import _cuda  # noqa: E402
from delay_enc_tpu_torch.ops import msm as M  # noqa: E402
from delay_enc_tpu_torch.ops import msm16 as M16  # noqa: E402
from delay_enc_tpu_torch.ops import msm_tree as MT  # noqa: E402

PLANES = 127
ADD_OPS = 12 * 128 * 2  # integer multiply-adds in one complete addition


def timed(fn, reps: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def affine(pts) -> list:
    return M.points_from_device(pts)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--define", action="append", default=[])
    ap.add_argument("--rows", default="16,127,381,635,1016")
    ap.add_argument("--rows16", default="16,64,320,512")
    ap.add_argument("--width", type=int, default=1 << 15)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; defines {args.define}", flush=True)
    clock_mhz = float(card.split(",")[2].split()[0])
    rate = torch.cuda.get_device_properties(0).multi_processor_count * 64 * clock_mhz * 1e6

    _cuda.NVCC_FLAGS.extend(f"-D{d}" for d in args.define)
    _cuda.build(force=True)
    with open(os.path.join(_cuda.BUILD, "msm.log")) as f:
        for line in f:
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print("  ptxas:", line.strip(), flush=True)

    gen = torch.Generator(device=dev).manual_seed(3)
    w = args.width

    # K-a and K-b share csrc/field.cuh: one large product and one forward
    # transform, both long enough for the card and not the host to set the time
    from delay_enc_tpu_torch.ops import limbs as L
    from delay_enc_tpu_torch.ops import ntt as N
    from delay_enc_tpu_torch.plonk.domain import Domain

    big = torch.randint(-2**31, 2**31, (19, 1 << 19, 8), generator=gen, device=dev,
                        dtype=torch.int64).to(torch.int32)
    big[..., 7] &= 0x0FFFFFFF
    tw = Domain(16).plan_ext(dev).tw
    for name, fn in (("field_mont_mul", lambda: L.mont_mul(L.FR_CTX, big, big)),
                     ("field_add", lambda: L.add(L.FR_CTX, big, big)),
                     ("ntt_fused", lambda: N.stockham(L.FR_CTX, big, tw))):
        print(json.dumps({"kernel": name, "shape": "(19, 2^19) Fr", "ms": timed(fn, 5)}),
              flush=True)
    del big
    scal = torch.randint(0, 2**31, (2 * w, 8), generator=gen, device=dev,
                         dtype=torch.int64).to(torch.int32) & 0x0FFFFFFF
    table_g = M.base_table((1, 2), dev)

    # fixed base: 2^10 scalars against the plain version, then timed at 2 w
    small = scal[:1024].clone()
    small[0] = 0
    small[1] = 0
    small[1, 0] = 1
    got = M.fixed_base_batch_mul(table_g, small)
    want = M.fixed_base_batch_mul_plain(table_g, small)
    ok = affine(got) == affine(want)
    ms = timed(lambda: M.fixed_base_batch_mul(table_g, scal), 3)
    n = scal.shape[0]
    print(json.dumps({"kernel": "g1_fixed_base_mul", "n": n, "split": M.fixed_base_split(n),
                      "agrees": ok, "ms": ms,
                      "bound_ms": n * M.SCALAR_BITS * ADD_OPS / rate * 1e3}), flush=True)
    if not ok:
        return 1

    pts = M.fixed_base_batch_mul(table_g, scal)
    pair = M.pair_tables(pts)
    # K-d at 2^16 pairs, where the host's launch path may set the time, and
    # at 2^20, where the card does
    for reps in (1, 16):
        a, b = pts.repeat(reps, 1, 1), pts.flip(0).repeat(reps, 1, 1)
        n = a.shape[0]
        print(json.dumps({"kernel": "g1_complete_add", "n": n,
                          "ms": timed(lambda: M.complete_add(a, b), 20),
                          "bound_ms": n * ADD_OPS / rate * 1e3}), flush=True)
    del a, b
    rng = np.random.default_rng(5)
    table16 = M16.pair_tables16(pts)
    for table, opts, name, rows_arg in ((pair, 16, "plane_sums", args.rows),
                                        (table16, 256, "plane_sums16", args.rows16)):
        for rows in [int(r) for r in rows_arg.split(",")]:
            sel = torch.randint(0, opts, (rows, w), generator=gen, device=dev,
                                dtype=torch.int64).to(torch.uint8)
            got = MT.tree_reduce(table, sel)
            pick = sorted({0, rows - 1, *rng.integers(0, rows, 6).tolist()})
            want = MT.tree_reduce_plain(table, sel[pick])
            ok = affine(got[pick]) == affine(want)
            ms = timed(lambda: MT.tree_reduce(table, sel), args.reps)
            plan = [(p.run, p.threads, p.chunks, p.fold) for p in MT.plan(rows, w)]
            print(json.dumps({"kernel": name, "rows": rows, "width": w, "plan": plan,
                              "agrees": ok, "rows_compared": len(pick), "ms": ms,
                              "bound_ms": rows * (w - 1) * ADD_OPS / rate * 1e3}), flush=True)
            if not ok:
                return 1
        # a ragged width, one lane and one row
        for rows, width in ((3, 1000 + 13), (5, 1), (1, 4097)):
            sel = torch.randint(0, opts, (rows, width), generator=gen, device=dev,
                                dtype=torch.int64).to(torch.uint8)
            sub = table[:, :width].contiguous()
            ok = affine(MT.tree_reduce(sub, sel)) == affine(MT.tree_reduce_plain(sub, sel))
            print(json.dumps({"kernel": name, "rows": rows, "width": width,
                              "agrees": ok}), flush=True)
            if not ok:
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
