"""Time the sharded NTT of one checkout on one card or four, and check K12's
kernels.

    python3 tools/torch_shard_bench.py [--root DIR] [--cards 1|4] [--kernels]
        [--host-profile] [--reps 20]

For the checkout at --root (default: the one this file lies in) it builds
the kernels, then for k = 16 and k = 20 over D = 4 shards (`Mesh.shared` on
card 0 with --cards 1, `make_mesh(4)` with --cards 4) it checks
`sharded_ntt` and `sharded_intt` against one device's K-b `ntt` and `intt`,
bit for bit, and times them: host ms a call over --reps calls with every
card waited for, beside one device's K-b in the same process; the launches
of one NTT and iNTT pair by kernel; and the device time of one pair by CUDA
function from torch.profiler (the kernels of every card summed).  Only the
API that every checkout since the mesh's port has is used, so a parent
(unpacked with git archive under an ignored directory) and this tree can be
timed in turns in one call.  --kernels (this checkout only) first runs
chip_smoke.py's phase 1 lines of K12: both kernels, forward and inverse,
against their plain versions with their device times and bounds.
--host-profile adds cProfile's 25 costliest functions (own time) over
--reps sharded NTTs and iNTTs at k=16: where the host's path goes.  Prints
the card's name and power limit, what ptxas says of csrc/shard.cu, and one
JSON line a case.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4))
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--host-profile", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    if args.kernels and root != HERE:
        raise SystemExit("--kernels runs this checkout's phase 1 lines only")
    sys.path.insert(0, root)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from delay_enc_tpu_torch.ops import _cuda
    from delay_enc_tpu_torch.ops import limbs as L
    from delay_enc_tpu_torch.ops import ntt as N
    from delay_enc_tpu_torch.parallel import (Mesh, ShardedNTTPlan, make_mesh, sharded_intt,
                                              sharded_ntt)

    sys.path.insert(1, HERE)
    import chip_smoke as C

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the tool times the card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    _cuda.build()  # what is stale; build/shard.log is ptxas's output of the last build
    with open(os.path.join(_cuda.BUILD, "shard.log")) as f:
        print(f"ptxas, csrc/shard.cu of {root}:\n{f.read().strip()}", flush=True)
    dev = torch.device("cuda", 0)
    if args.kernels:
        gen = torch.Generator(device=dev).manual_seed(1)
        rand_field, carry_heavy = C.field_makers(dev, gen)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        clock = float(C.smi("clocks.max.sm").split()[0]) * 1e6
        rep = C.Report(sms * C.INT_PER_SM_CLK * clock, sms * C.TC_INT8_PER_SM_CLK * clock)
        C.phase1_shard(rep, dev, rand_field, carry_heavy)

    d = 4
    mesh = make_mesh(d) if args.cards == 4 else Mesh.shared(dev, d)

    def sync():
        for x in mesh.distinct:
            torch.cuda.synchronize(x)

    def wall_ms(fn) -> float:
        fn()
        sync()
        t0 = time.time()
        for _ in range(args.reps):
            fn()
        sync()
        return (time.time() - t0) * 1e3 / args.reps

    def device_by_function(fn, reps: int = 5) -> dict:
        fn()
        sync()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            sync()
        out = {}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
            name = C.kernel_function(e.key)
            got = out.setdefault(name, [0.0, 0])
            got[0] += us / 1e3 / reps
            got[1] += e.count
        return {k: [round(v[0], 6), v[1]] for k, v in sorted(out.items())}

    gen = torch.Generator(device=dev).manual_seed(9)
    for k in (16, 20):
        n = 1 << k
        w = torch.randint(-2**31, 2**31, (n, 8), generator=gen, device=dev,
                          dtype=torch.int64).to(torch.int32)
        w[:, 7] &= 0x0FFFFFFF
        single = N.NTTPlan.make(L.FR_CTX, k, dev)
        want = N.ntt(single, w)
        plan = ShardedNTTPlan.make(k, d, mesh.devices)
        sync()
        _cuda.reset_launches()
        evals = sharded_ntt(mesh, plan, w)
        back = sharded_intt(mesh, plan, evals)
        sync()
        launches = {name: c for name, c in _cuda.launch_counts().items() if c}
        ntt_ok = bool(torch.equal(mesh.gather(evals), want))
        intt_ok = bool(torch.equal(mesh.gather(back), w))
        pair = lambda: sharded_intt(mesh, plan, sharded_ntt(mesh, plan, w))
        row = {
            "root": root, "k": k, "shards": d, "mesh": [str(x) for x in mesh.devices],
            "ntt_equal": ntt_ok, "intt_equal": intt_ok, "launches_a_pair": launches,
            "host_ms": {
                "sharded ntt": wall_ms(lambda: sharded_ntt(mesh, plan, w)),
                "sharded intt": wall_ms(lambda: sharded_intt(mesh, plan, evals)),
                "single ntt": wall_ms(lambda: N.ntt(single, w)),
                "single intt": wall_ms(lambda: N.intt(single, want)),
            },
            "device_ms_a_pair": device_by_function(pair),
            "single_device_ms_a_pair": device_by_function(lambda: N.intt(single, N.ntt(single, w))),
            "reps": args.reps,
        }
        print(json.dumps(row), flush=True)
        if args.host_profile and k == 16:
            import cProfile
            import io
            import pstats

            prof = cProfile.Profile()
            prof.enable()
            for _ in range(args.reps):
                sharded_intt(mesh, plan, sharded_ntt(mesh, plan, w))
            sync()
            prof.disable()
            text = io.StringIO()
            pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(25)
            print(f"host profile, {args.reps} sharded NTT + iNTT pairs at k={k}:\n"
                  f"{text.getvalue()}", flush=True)
        if not (ntt_ok and intt_ok):
            raise SystemExit(f"the sharded NTT of k={k} differs from one device's K-b")
        del plan, evals, back, single
    return 0


if __name__ == "__main__":
    sys.exit(main())
