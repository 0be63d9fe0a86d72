"""A cell run end to end at a tiny size on the CPU through the program's
plain path, then with the timed path broken underneath, and the control;
the traced run, which needs the card, skips here."""

import json
import subprocess
import sys
import time

import pytest
import torch

from gpubench import control, harness, registry

from . import tiny

BENCH = registry.load_benchmark()
CPU = torch.device("cpu")
SEED = 2**31 + 77


def entries(cell, trace=False):
    es = registry.cell_metrics(BENCH, cell, trace)
    return es, {m["name"]: registry.load_metric(m["name"]) for m in es}


def run(traffic_name="serial", cell="delay_enc_k16.serial", seconds=0.01, sample=3,
        config=tiny.CONFIG, **kw):
    mix = dict(registry.load_traffic(traffic_name), check_sample=sample)
    es, readers = entries(cell)
    return harness.run_cell(dict(tiny.CELL, traffic=traffic_name), config, mix, SEED,
                            seconds, False, es, readers, CPU, time.time(), build=tiny.build, **kw)


def test_serial_cell_end_to_end():
    res = run()
    assert res["correct"] is True and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert {n: c["value"] for n, c in res["checks"].items()} == {
        "statement": 0, "vk_diff": 0, "rejected": 0, "missing": 0, "repeated": 0}
    assert set(res["metrics"]) == {"proof_s", "setup_s"}  # a p90 needs 100 proofs
    assert res["metrics"]["setup_s"]["value"] > 0
    json.dumps(res)


def test_batch_cell_end_to_end():
    res = run("batch4", "delay_enc_k16.batch4")
    assert res["correct"] is True
    assert res["attempted"] == 8  # a warm-up request and one in the window, 4 proofs each
    assert res["metrics"]["proofs_per_s"]["value"] > 0


def test_pipelined_mix_end_to_end():
    mix = {"entry": "create_proofs_pipelined", "batch": 2, "depth": 2, "check_sample": 4}
    es, readers = entries("delay_enc_k16.batch4")
    res = harness.run_cell(tiny.CELL, tiny.CONFIG, mix, SEED, 0.01, False, es, readers, CPU,
                           time.time(), build=tiny.build)
    assert res["correct"] is True and res["attempted"] == 4


def broken(monkeypatch, name, wrap):
    from delay_enc_tpu_torch import plonk

    inner = getattr(plonk, name)
    monkeypatch.setattr(plonk, name, wrap(inner))


def test_an_altered_answer_fails(monkeypatch):
    def wrap(inner):
        def create_proof(*a, **k):
            p = bytearray(inner(*a, **k))
            p[32 * 30] ^= 1  # an evaluation, where the proof is written
            return bytes(p)
        return create_proof

    broken(monkeypatch, "create_proof", wrap)
    res = run()
    assert res["correct"] is False and res["checks"]["rejected"]["value"] > 0


def test_half_the_batch_left_out_fails(monkeypatch):
    broken(monkeypatch, "create_proofs_batched",
           lambda inner: lambda srs, pk, builders, rng, **k: inner(
               srs, pk, builders[: len(builders) // 2], rng, **k))
    res = run("batch4", "delay_enc_k16.batch4")
    assert res["correct"] is False and res["checks"]["missing"]["value"] == 4


def test_a_request_that_returns_its_state_unchanged_fails(monkeypatch):
    first = {}

    def wrap(inner):
        def create_proof(*a, **k):
            if "p" not in first:
                first["p"] = inner(*a, **k)
            return first["p"]
        return create_proof

    broken(monkeypatch, "create_proof", wrap)
    res = run()
    assert res["correct"] is False and res["checks"]["repeated"]["value"] >= 1


def test_another_statement_fails():
    res = run(config=dict(tiny.CONFIG, statement_blake2b="0" * 32))
    assert res["correct"] is False and res["checks"]["statement"]["value"] == 1


def test_a_wrong_key_fails(monkeypatch):
    def wrap(inner):
        def keygen(*a, **k):
            pk, vk = inner(*a, **k)
            vk.sigma_commitments = list(vk.sigma_commitments[::-1])
            return pk, vk
        return keygen

    broken(monkeypatch, "keygen", wrap)
    res = run()
    assert res["correct"] is False and res["checks"]["vk_diff"]["value"] >= 2


def test_the_control_fails_and_the_program_passes():
    mix = registry.load_traffic("serial")
    got = control.readings(tiny.CONFIG, mix, SEED, 1, CPU, build=tiny.build)
    assert got["sound"] == {"statement": 0, "vk_diff": 0, "rejected": 0, "missing": 0,
                            "repeated": 0}
    assert got["control"]["rejected"] == 1


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "gpubench/run.py", "--workload",
                          "delay_enc_k16.serial", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, cwd=registry.ROOT)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.card
def test_traced_cell_on_the_card(card):
    mix = dict(registry.load_traffic("serial"), check_sample=2, trace_requests=2)
    es, readers = entries("delay_enc_k16.serial", trace=True)
    res = harness.run_cell(tiny.CELL, tiny.CONFIG, mix, SEED, 0.5, True, es, readers, card,
                           time.time(), build=tiny.build)
    assert res["correct"] is True
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert res["breakdown"]["device_ops"]
