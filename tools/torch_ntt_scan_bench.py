"""Build the port's kernels with optional -D defines, check the multi-stage
NTT (K-b) and the scan kernel against their plain versions, and time them
alone at the proof's shapes on one card.

    python3 tools/torch_ntt_scan_bench.py [--define NTT_PORTABLE ...]
        [--layouts 11:10:512,11:8:512,10:10:256] [--reps 5] [--no-check]

It prints the card's name and power limit, the registers and spills ptxas
reports for csrc/ntt.cu and csrc/scan.cu, and one JSON line for each
measurement.  A layout is TILE_LOG:MAX_STAGES:THREADS of ops/ntt.py; every
layout listed is timed with the one build.  The defines the sources know:
NTT_PORTABLE (csrc/ntt.cu: the portable Montgomery bodies on the device),
NTT_MIN_BLOCKS=n and NTT_MAX_THREADS=n (its launch bounds), FLD_PORTABLE
(csrc/field.cuh, every kernel).  Run it once for each set of defines, all on
one card one after another; times from two cards do not compare.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from delay_enc_tpu_torch.ops import _cuda  # noqa: E402
from delay_enc_tpu_torch.ops import limbs as L  # noqa: E402
from delay_enc_tpu_torch.ops import ntt as N  # noqa: E402
from delay_enc_tpu_torch.ops import poly as P  # noqa: E402
from delay_enc_tpu_torch.plonk.domain import Domain  # noqa: E402

MUL_OPS = 128 * 2  # integer multiply-adds in one Montgomery product
HBM = 3.35e12
CTX = L.FR_CTX


def timed(fn, reps: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--define", action="append", default=[])
    ap.add_argument("--layouts", default=f"{N.TILE_LOG}:{N.MAX_STAGES}:{N.THREADS}")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--no-check", action="store_true")
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
    for name in ("ntt", "scan"):
        with open(os.path.join(_cuda.BUILD, f"{name}.log")) as f:
            for line in f:
                if "Compiling entry" in line or "registers" in line or "spill" in line:
                    print(f"  ptxas {name}:", line.strip(), flush=True)

    gen = torch.Generator(device=dev).manual_seed(4)

    def rand(*shape):
        w = torch.randint(-2**31, 2**31, (*shape, 8), generator=gen, device=dev,
                          dtype=torch.int64).to(torch.int32)
        w[..., 7] &= 0x0FFFFFFF  # below 2^252 < p
        return w

    def same(a, b):
        return bool(torch.equal(a, b))

    d = Domain(16)
    plan, plan_ext = d.plan(dev), d.plan_ext(dev)
    zeta = N.powers(CTX, d.zeta, d.n_ext, dev)
    big = rand(19, 1 << 19)
    col = rand(19, 1 << 16)
    six = rand(6, 1 << 16)
    one = rand(1, 1 << 19)
    shapes = (
        ("(19, 2^19) forward", 19, 19, None,
         lambda: N.stockham(CTX, big, plan_ext.tw),
         lambda: N.stockham_plain(CTX, big, plan_ext.tw)),
        ("(19, 2^16) -> (19, 2^19) coset, table and padding fused", 19, 19, 1 << 16,
         lambda: N.stockham(CTX, col, plan_ext.tw, n=d.n_ext, in_table=zeta),
         lambda: N.stockham_sides_plain(CTX, col, plan_ext.tw, d.n_ext, zeta, None)),
        ("(6, 2^16) inverse with 1/n", 16, 6, None,
         lambda: N.stockham(CTX, six, plan.tw_inv, out_scale=plan.n_inv),
         lambda: N.stockham_sides_plain(CTX, six, plan.tw_inv, d.n, None, plan.n_inv)),
        ("(1, 2^19) inverse with a table", 19, 1, None,
         lambda: N.stockham(CTX, one, plan_ext.tw_inv, out_scale=zeta),
         lambda: N.stockham_sides_plain(CTX, one, plan_ext.tw_inv, d.n_ext, None, zeta)),
    )
    wants = {}
    ok = True
    for layout in args.layouts.split(","):
        N.TILE_LOG, N.MAX_STAGES, N.THREADS = (int(v) for v in layout.split(":"))
        for name, k, batch, n_in, fn, plain in shapes:
            agrees = None
            if not args.no_check:
                if name not in wants:
                    wants[name] = plain()
                agrees = same(fn(), wants[name])
                ok = ok and agrees
            print(json.dumps({
                "kernel": "ntt_fused", "shape": name, "layout": layout,
                "passes": [(p.s, p.c_log, p.nz, p.threads) for p in N.plan(k, n_in)],
                "agrees": agrees, "ms": timed(fn, args.reps),
                "bound_ms": batch * k * (1 << (k - 1)) * MUL_OPS / rate * 1e3}), flush=True)
    del big, col, six, one, wants

    # field_scan: every form at (5, 2^16), the powers of one element, and the
    # ladders of elementwise launches (the plain versions) beside them
    x5 = rand(5, 1 << 16)
    n = 1 << 16
    for op in ("mul", "add"):
        for exclusive in (False, True):
            for reverse in (False, True):
                fn = lambda: P.scan(CTX, x5, op, "block", exclusive=exclusive, reverse=reverse)
                plain = lambda: P.scan_plain(CTX, x5, op, "block", exclusive=exclusive,
                                             reverse=reverse)
                agrees = None if args.no_check else same(fn(), plain())
                ok = ok and agrees is not False
                print(json.dumps({
                    "kernel": "field_scan", "shape": "(5, 2^16)", "op": op,
                    "exclusive": exclusive, "reverse": reverse, "agrees": agrees,
                    "ms": timed(fn, 20), "plain_ms": timed(plain, 3),
                    "bound_ms": max(2 * x5.numel() * 4 / HBM,
                                    5 * (n - 1) * (MUL_OPS if op == "mul" else 0) / rate) * 1e3,
                }), flush=True)
    x = x5[0, 7].contiguous()
    for count in (n, n + 1):
        fn = lambda: P.powers_of(CTX, x, count)
        plain = lambda: P.powers_of_plain(CTX, x, count)
        agrees = None if args.no_check else same(fn(), plain())
        ok = ok and agrees is not False
        print(json.dumps({"kernel": "field_scan", "shape": f"powers, n={count}",
                          "agrees": agrees, "ms": timed(fn, 20), "plain_ms": timed(plain, 3),
                          "bound_ms": (count - 1) * MUL_OPS / rate * 1e3}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
