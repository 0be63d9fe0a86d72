"""Build the port's kernels with optional -D defines, check the multi-stage
NTT (K-b), the scan kernel and K7 (the openings' contractions) against their
plain versions, and time them alone at the proof's shapes on one card.

    python3 tools/torch_ntt_scan_bench.py [--define NTT_PORTABLE ...]
        [--layouts 11:10:512,11:8:512,10:10:256] [--reps 5] [--parts ntt,scan,open]

It prints the card's name and power limit, the registers and spills ptxas
reports for csrc/ntt.cu, csrc/scan.cu and csrc/open.cu, and one JSON line for
each measurement, with whether it agrees with the plain version: "ms" by
CUDA events over back-to-back calls (the wrapper's host path included where
it is the slower), "device_ms" the kernel's own time a call from
torch.profiler.  A layout is TILE_LOG:MAX_STAGES:THREADS of ops/ntt.py;
every layout listed is timed with the one build.  The defines the sources
know: NTT_PORTABLE (csrc/ntt.cu: the portable Montgomery bodies on the
device), NTT_MIN_BLOCKS=n and NTT_MAX_THREADS=n (its launch bounds),
FLD_PORTABLE (csrc/field.cuh, every kernel).  The scan's tiles are the
constants of csrc/scan_tile.cuh.  Run it once for each variant, all on one
card one after another; times from two cards do not compare.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import device_ms  # noqa: E402
from delay_enc_tpu_torch.ops import _cuda  # noqa: E402
from delay_enc_tpu_torch.ops import limbs as L  # noqa: E402
from delay_enc_tpu_torch.ops import ntt as N  # noqa: E402
from delay_enc_tpu_torch.ops import poly as P  # noqa: E402
from delay_enc_tpu_torch.plonk import kernels as K  # noqa: E402
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
    ap.add_argument("--parts", default="ntt,scan,open")
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
    parts = args.parts.split(",")
    for name in ("ntt", "scan", "open"):
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
    ok = True
    if "ntt" in parts:
        ok = ntt_part(args, dev, d, rand, same, rate)
    if "scan" in parts:
        ok = scan_part(rand, same, rate) and ok
    if "open" in parts:
        ok = open_part(dev, rand, same, rate) and ok
    return 0 if ok else 1


def ntt_part(args, dev, d, rand, same, rate) -> bool:
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
    return ok


def scan_part(rand, same, rate) -> bool:
    """field_scan: every form at (5, 2^16), one row of 2^16 and of 2^20, the
    powers of one element, and the plain versions (ladders over K-a) beside
    them."""
    ok = True
    for rows, n in ((5, 1 << 16), (1, 1 << 16), (1, 1 << 20)):
        x = rand(rows, n)
        for op in ("mul", "add"):
            for exclusive in (False, True):
                for reverse in (False, True):
                    fn = lambda: P.scan(CTX, x, op, "block", exclusive=exclusive, reverse=reverse)
                    plain = lambda: P.scan_plain(CTX, x, op, "block", exclusive=exclusive,
                                                 reverse=reverse)
                    agrees = same(fn(), plain())
                    ok = ok and agrees
                    print(json.dumps({
                        "kernel": "field_scan", "shape": f"({rows}, {n})", "op": op,
                        "exclusive": exclusive, "reverse": reverse, "tile": P.kernel_plan(rows, n)[0],
                        "agrees": agrees, "ms": timed(fn, 20),
                        "device_ms": device_ms(fn, 20, "scan_kernel"),
                        "plain_ms": timed(plain, 3),
                        "bound_ms": max(2 * x.numel() * 4 / HBM,
                                        rows * (n - 1) * (MUL_OPS if op == "mul" else 0)
                                        / rate) * 1e3,
                    }), flush=True)
    x = rand(1)[0]
    for count in (1 << 16, (1 << 16) + 1):
        fn = lambda: P.powers_of(CTX, x, count)
        plain = lambda: P.powers_of_plain(CTX, x, count)
        agrees = same(fn(), plain())
        ok = ok and agrees
        print(json.dumps({"kernel": "field_scan", "shape": f"powers, n={count}",
                          "tile": P.kernel_plan(1, count)[0], "agrees": agrees,
                          "ms": timed(fn, 20), "device_ms": device_ms(fn, 20, "scan_kernel"),
                          "plain_ms": timed(plain, 3),
                          "bound_ms": (count - 1) * MUL_OPS / rate * 1e3}), flush=True)
    return ok


def open_part(dev, rand, same, rate) -> bool:
    """K7 at the delay_enc k=16 openings: 47, 6 and 4 rows of 2^16 over
    three points, eval and combine, against open_stack_plain."""
    n = 1 << 16
    counts = (47, 6, 4)
    stacks = [list(rand(m, n)) for m in counts]
    pows = [rand(n) for _ in counts]
    v_pows = rand(max(counts))
    rows = sum(counts)
    ok = True
    for kind, products, symbol in (("eval", rows, "open_eval_kernel"),
                                   ("combine", rows + len(counts), "open_combine_kernel")):
        fn = lambda: K.open_stack(kind, stacks, pows, v_pows)
        plain = lambda: K.open_stack_plain(kind, stacks, pows, v_pows)
        agrees = same(fn(), plain())
        ok = ok and agrees
        nbytes = (rows + len(counts)) * n * 32 + (len(counts) * n * 32 if kind == "combine" else 0)
        print(json.dumps({"kernel": f"open_{kind}", "shape": "(47, 6, 4) rows of 2^16",
                          "agrees": agrees, "ms": timed(fn, 20),
                          "device_ms": device_ms(fn, 20, symbol), "plain_ms": timed(plain, 3),
                          "bound_ms": max(nbytes / HBM, products * n * MUL_OPS / rate) * 1e3}),
              flush=True)
    return ok


if __name__ == "__main__":
    sys.exit(main())
