"""Finds a cell and what belongs to it by name, from the files alone:
BENCHMARK.json at the checkout's root names the cells and metrics; a
configuration is `configs/<config>.json` (the file BENCHMARK.json gives),
a traffic mix `traffic/<traffic>.json`, the family the mix names
`families/<family>.py`, a metric's reader `metrics/<metric>.py`."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list     # metric entries of BENCHMARK.json this cell reports
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict = None) -> Cell:
    bench = benchmark() if bench is None else bench
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    c = next(c for c in bench["configs"] if c["name"] == w["config"])
    return Cell(
        name=name, chips=int(w["chips"]),
        config=load_json(ROOT / c["file"]),
        traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def family(name: str):
    """The module of families/<name>.py: its RUNNER and CONTROL."""
    return importlib.import_module(f"portbench.families.{name}")


def reader(metric: str):
    """The `read(reading)` function of metrics/<metric>.py."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
