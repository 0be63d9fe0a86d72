"""The control of the check that decides `correct`, run on the card at a
cell's own size.  The benchmark's runs never run it.

    python3 gpubench/control.py --workload <cell> --seeds 11,12,13 [--requests 4]

The configuration states no precision; its guarantee is that a proof is
accepted only for a satisfied statement under the statement's key.  The
control breaks it: the program proves a false witness, the statement's own
with one cell of the advice column e changed on a row whose gate reads it,
under the same key.  For each seed, in one process: the set-up of a run,
`requests` requests of the true witness and as many of the false one, each
judged as a run judges its proofs (every proof checked).  One JSON line a
seed: {"seed", "sound": {number: value}, "control": {number: value}}.
"""

import argparse
import copy
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def false_witness(builder):
    """A copy of the builder whose advice e differs in one constrained cell."""
    bad = copy.copy(builder)
    bad.advice = [list(col) for col in builder.advice]
    row = next(r for r, q in enumerate(builder.fixed["q_e"]) if q)
    bad.advice[4][row] = (bad.advice[4][row] + 1) % builder.field.p
    return bad


def readings(config: dict, mix_spec: dict, seed: int, requests: int, device, build=None) -> dict:
    from delay_enc_tpu_torch import plonk

    from gpubench import check, harness, traffic

    mix = traffic.Mix.from_file(mix_spec)
    s = harness.set_up(config, mix, seed, device, build)
    srs, pk, _, builder = s.state
    statement = harness.statement_of(builder, config["k"])
    out = {"seed": seed}
    for label, witness in (("sound", builder), ("control", false_witness(builder))):
        request = traffic.requester(mix, plonk, srs, pk, witness, device)
        proofs = []
        for i in range(requests):
            proofs += request(traffic.rng(traffic.WINDOW, seed, i))
        missing = requests * mix.batch - len(proofs)
        numbers, detail = check.judge(statement, config["statement_blake2b"], s.tau, s.vk,
                                      proofs, list(range(len(proofs))), missing)
        out[label] = numbers
        for line in detail[:4]:
            harness.log(f"# {label}: {line}")
    s.state.clear()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--requests", type=int, default=4)
    args = ap.parse_args(argv)

    import torch

    from gpubench import registry

    bench = registry.load_benchmark()
    cell = registry.find_cell(bench, args.workload)
    config = registry.load_config(bench, cell["config"])
    mix = registry.load_traffic(cell["traffic"])
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in (int(v) for v in args.seeds.split(",")):
        print(json.dumps(readings(config, mix, seed, args.requests, device)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
