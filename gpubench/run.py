"""Run one cell of BENCHMARK.json once and print its result as one JSON line.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for.  Without them, or when the process has loaded JAX or the JAX package
by the time the window has closed, it prints no result and exits with a
code other than 0.  Progress and the check's numbers go to standard error.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, ".gpubench_cache", sub)
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from gpubench import harness, imports, registry

    bench = registry.load_benchmark()
    cell = registry.find_cell(bench, args.workload)
    config = registry.load_config(bench, cell["config"])
    mix = registry.load_traffic(cell["traffic"])
    entries = registry.cell_metrics(bench, cell["name"], bool(args.trace))
    readers = {m["name"]: registry.load_metric(m["name"]) for m in entries}

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        harness.log(f"the cell needs {cell['chips']} CUDA device(s); "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = harness.run_cell(cell, config, mix, args.seed, args.seconds, bool(args.trace),
                              entries, readers, device, T_START)
    loaded = imports.forbidden_loaded()
    if loaded:
        harness.log(f"the process has loaded {', '.join(loaded)}")
        return 3
    absent = [m["name"] for m in entries if m["name"] not in result["metrics"]
              and not args.trace]
    if absent:
        harness.log(f"no reading of {', '.join(absent)}")
        return 4
    for name, c in result["checks"].items():
        harness.log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
