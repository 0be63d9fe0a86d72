"""BENCHMARK.json's names find their files, and keep to the contract's
shape: names, units, keys, one metric reader each, every cell with set-up,
another end-to-end metric and a per-layer one."""

import json
import os
import re

import pytest

from gpubench import registry, traffic

BENCH = registry.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"]
    assert BENCH["command"] == ["python3", "gpubench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_each_configuration_loads(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and entry["file"].startswith("gpubench/configs/")
    config = registry.load_config(BENCH, entry["name"])
    assert config["name"] == entry["name"] and config["reduced"] == entry["reduced"] == []
    assert {"workload", "k", "circuit_seed", "rows", "statement_blake2b",
            "guarantees"} <= set(config)
    assert any(c["config"] == entry["name"] for c in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_each_cell_loads(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and cell["chips"] == 1 and len(cell["why"]) <= 200
    registry.load_config(BENCH, cell["config"])
    traffic.Mix.from_file(registry.load_traffic(cell["traffic"]))
    e2e = registry.cell_metrics(BENCH, cell["name"], False)
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert registry.cell_metrics(BENCH, cell["name"], True)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_each_metric_has_its_reader(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(registry.load_metric(metric["name"]).read)
    cells = {c["name"] for c in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in [m["name"] for m in BENCH["end_to_end"]]
        for cell in metric["workloads"]:
            assert metric["moves"] in [m["name"] for m in
                                       registry.cell_metrics(BENCH, cell, False)]


def test_every_file_under_paths_is_named_plainly():
    for dirpath, _, files in os.walk(registry.HERE):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), registry.ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_mix_rejects_what_it_cannot_run():
    with pytest.raises(ValueError):
        traffic.Mix.from_file({"entry": "serve"})
    with pytest.raises(ValueError):
        traffic.Mix.from_file({"entry": "create_proof", "batch": 4})
    assert traffic.Mix.from_file({"entry": "create_proofs_pipelined", "batch": 4,
                                  "depth": 2}).depth == 2


def test_draws_repeat_by_seed():
    big = 2**31 + 12345
    a = traffic.rng(traffic.WINDOW, big, 3).integers(0, 2**62, 4)
    b = traffic.rng(traffic.WINDOW, big, 3).integers(0, 2**62, 4)
    c = traffic.rng(traffic.WINDOW, big, 4).integers(0, 2**62, 4)
    assert (a == b).all() and (a != c).any()
    assert traffic.rng(traffic.WINDOW, -1, 0) is not None
