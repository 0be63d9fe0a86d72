"""Finding a cell's configuration, traffic mix and metrics by name.

Each configuration is `configs/<name>.json`, each traffic mix
`traffic/<name>.json`, and each metric `metrics/<name>.py`, a module with
`read(run)` that returns the metric's value or None where it finds nothing
to read.  BENCHMARK.json, at the root of the checkout, names them.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def load_config(bench: dict, name: str) -> dict:
    for entry in bench["configs"]:
        if entry["name"] == name:
            with open(os.path.join(ROOT, entry["file"])) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def load_traffic(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


def load_metric(name: str):
    """The reader module of one metric, `metrics/<name>.py`."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"gpubench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries a run of the cell reports: its end-to-end ones, or
    with trace its per-layer ones; an entry with `workloads` only where that
    list names the cell."""
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if cell in m.get("workloads", [cell])]
