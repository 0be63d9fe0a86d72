"""Build the matmul NTT's kernels (K11, csrc/ntt_mxu.cu) with optional -D
defines, check them against their plain versions and K-b, and time them
alone at the proof's shapes on one card.

    python3 tools/torch_mxu_bench.py [--root DIR] [--define FLD_PORTABLE ...]
        [--reps 10] [--quick]

It prints the card's name and power limit, what ptxas reports for
csrc/ntt_mxu.cu (registers, spills, warnings, wgmma serialized), the product kernel's
resources as the runtime reports them and its SASS's warpgroup MMA count,
then one JSON line a measurement with whether it agrees: "ms" by CUDA events
over back-to-back calls, "device_ms" the kernel's own time a call from
torch.profiler, "bound_ms" the int8 tensor-core bound at the card's
maximum SM clock.  First a probe: one 64 x 32 by 32 x 8 product of small
integers in the lowest byte plane, whose Montgomery result times 2^256 is
the integer matrix product, so a wrong operand layout shows as a wrong
entry.  --quick stops after the checks at the (6, 2^16) forward.  A
define goes to nvcc for every source (FLD_PORTABLE: csrc/field.cuh's
portable bodies, the product's epilogue among them); run one variant a
call, or several one after another in one call, never across cards.
--root DIR runs the package of another checkout (a parent commit unpacked
with git archive), built in its own build directory, with this checkout's
checks and timing; the two compare inside one call only.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TC_PER_SM_CLK = 4096  # dense int8 tensor-core multiply-adds an SM a clock


def timed(fn, reps: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def probe(dev) -> bool:
    """W (64 x 32) and D (32 x 8) of integers below 16 in byte plane 0:
    out * 2^256 mod p is W . D exactly."""
    rng = np.random.default_rng(7)
    w = rng.integers(0, 16, (X.TILE_M, X.TILE_K))
    d = rng.integers(0, 16, (X.TILE_K, X.TILE_N))
    ww = torch.zeros(X.TILE_M, X.TILE_K, 8, dtype=torch.int32)
    ww[..., 0] = torch.from_numpy(w).to(torch.int32)
    dd = torch.zeros(1, X.TILE_K * X.TILE_N, 8, dtype=torch.int32)
    dd[0, :, 0] = torch.from_numpy(d.reshape(-1)).to(torch.int32)  # (k, j) at 8 k + j
    s = X.StepShape(X.TILE_M, X.TILE_N, X.TILE_K, X.TILE_K * X.TILE_N, X.TILE_N, 1, X.TILE_K)
    wf = X.frag_fixed(ww.to(dev))
    df = X.split(dd.to(dev), s)
    out = X.product(wf, df, None, s, torch.empty((1, X.TILE_M * X.TILE_N, 8),
                                                 dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    got = np.array([v * (1 << 256) % CTX.p for v in L.words_to_ints_np(L.to_numpy(out[0]))],
                   dtype=object).reshape(X.TILE_M, X.TILE_N)
    want = w @ d
    ok = bool((got == want).all())
    print(json.dumps({"probe": "64 x 32 by 32 x 8, plane 0", "agrees": ok}), flush=True)
    if not ok:
        print("want rows 0-3:", want[:4].tolist(), "\ngot rows 0-3: ", got[:4].tolist(),
              "\nwrong (row, col):", np.argwhere(got != want)[:16].tolist(), flush=True)
    return ok


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--define", action="append", default=[])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--root", default=HERE)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    global L, N, X, K, Domain, CTX
    from delay_enc_tpu_torch.ops import _cuda
    from delay_enc_tpu_torch.ops import limbs as L
    from delay_enc_tpu_torch.ops import ntt as N
    from delay_enc_tpu_torch.ops import ntt_mxu as X
    from delay_enc_tpu_torch.plonk import kernels as K
    from delay_enc_tpu_torch.plonk.domain import Domain

    CTX = L.FR_CTX
    max_err, device_ms = smoke.max_err, smoke.device_ms
    print(f"package: {os.path.dirname(X.__file__)}", flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; defines {args.define}", flush=True)
    clock_mhz = float(card.split(",")[2].split()[0])
    tc_rate = torch.cuda.get_device_properties(0).multi_processor_count * TC_PER_SM_CLK \
        * clock_mhz * 1e6

    _cuda.NVCC_FLAGS.extend(f"-D{d}" for d in args.define)
    _cuda.build(force=True)
    with open(os.path.join(_cuda.BUILD, "ntt_mxu.log")) as f:
        for line in f:
            if any(w in line for w in ("Compiling entry", "registers", "spill", "arning",
                                       "Performance Loss")):
                print("  ptxas ntt_mxu:", line.strip(), flush=True)
    attrs = X.product_attrs() if hasattr(X, "product_attrs") else None
    print(json.dumps({"resources": attrs, "sass": smoke.mxu_sass_counts(_cuda.BUILD)}), flush=True)
    ok = probe(dev)

    gen = torch.Generator(device=dev).manual_seed(4)

    def rand(*shape):
        w = torch.randint(-2**31, 2**31, (*shape, 8), generator=gen, device=dev,
                          dtype=torch.int64).to(torch.int32)
        w[..., 7] &= 0x0FFFFFFF  # below 2^252 < p
        return w

    d = Domain(16)
    fwd = d.mxu_plan("fwd", dev)
    x6 = rand(6, d.n)
    s1, s3 = X.steps(fwd, d.n)
    d1 = X.split(x6, s1)
    c = X.product(fwd.w1_frag, d1, fwd.t, s1, torch.empty_like(x6))
    d3 = X.split(c, s3)
    y = X.product(fwd.w2_frag, d3, None, s3, torch.empty_like(x6))
    agrees = (max_err(c, X.product_plain(fwd.w1_frag, d1, fwd.t, s1)) == 0
              and max_err(y, X.product_plain(fwd.w2_frag, d3, None, s3)) == 0)
    ok = ok and agrees
    print(json.dumps({"check": "(6, 2^16) forward, both steps, against product_plain",
                      "agrees": agrees}), flush=True)
    print(json.dumps({"check": "the accumulators' limit", "result": smoke.mxu_limit_check(dev)}),
          flush=True)
    if args.quick:
        return 0 if ok else 1

    def products():
        X.product(fwd.w1_frag, d1, fwd.t, s1, c)
        X.product(fwd.w2_frag, d3, None, s3, y)

    def splits():
        X.split(x6, s1)
        X.split(c, s3)

    tc = sum(smoke.mxu_step_cost(s, 6, t)[0] for s, t in ((s1, True), (s3, False)))
    print(json.dumps({"kernel": "ntt_mxu_product", "shape": "(6, 2^16) forward, both steps",
                      "agrees": agrees, "ms": timed(products, args.reps),
                      "device_ms": device_ms(products, args.reps, "mxu_product_kernel"),
                      "bound_ms": tc / tc_rate * 1e3}), flush=True)
    print(json.dumps({"kernel": "ntt_mxu_split", "shape": "(6, 2^16) forward, both steps",
                      "ms": timed(splits, 20),
                      "device_ms": device_ms(splits, 20, "mxu_split_kernel"),
                      "bound_ms": 2 * 2 * 32 * 6 * d.n / 3.35e12 * 1e3}), flush=True)
    del x6, d1, d3, c, y

    plan_ext = d.plan_ext(dev)
    zeta_powers = N.powers(CTX, d.zeta, d.n, dev)
    coeff = rand(19, d.n)
    k20 = rand(1, 1 << 20)
    plan20 = N.NTTPlan.make(CTX, 20, dev)
    cases = (
        ("(19, 2^16) -> (19, 2^19) coset", d.mxu_plan("ext", dev), coeff,
         lambda: K._ext(coeff, zeta_powers, plan_ext)),
        ("(1, 2^20) forward", Domain(20).mxu_plan("fwd", dev), k20,
         lambda: N.stockham(CTX, k20, plan20.tw)),
    )
    for shape, mp, rows, kb in cases:
        fn = lambda: X.ntt_mxu_stack(mp, rows)
        agrees = max_err(fn(), kb()) == 0
        ok = ok and agrees
        tc = smoke.mxu_transform_cost(mp, rows.shape[0], rows.shape[1])[0]
        print(json.dumps({"kernel": "ntt_mxu_product", "shape": f"whole transform {shape}",
                          "agrees": agrees, "ms": timed(fn, 3),
                          "device_ms": device_ms(fn, 3, "mxu_product_kernel"),
                          "kb_ms": timed(kb, 3), "bound_ms": tc / tc_rate * 1e3}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
