"""Finding a cell's pieces by name: the benchmark file, each
configuration and traffic file, the system module a configuration names and the
reader of each metric.  Nothing here knows a particular cell, so a new
configuration, mix or metric is a new file and a new entry."""

from __future__ import annotations

import importlib
import json
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
BENCHMARK = ROOT / "BENCHMARK.json"


def load_benchmark(path: Path = BENCHMARK) -> dict:
    with open(path) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in the benchmark")


def configuration(bench: dict, name: str) -> dict:
    """The configuration file of ``name``, as the benchmark lists it."""
    for c in bench["configs"]:
        if c["name"] == name:
            with open(ROOT / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in the benchmark")


def traffic(name: str) -> dict:
    with open(PKG / "traffic" / f"{name}.json") as f:
        return json.load(f)


def generator(name: str):
    return importlib.import_module(f"tpgbench.generators.{name}")


def system(name: str):
    return importlib.import_module(f"tpgbench.systems.{name}")


def metrics_of(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones without
    the trace, the per-layer ones with it; a metric with ``workloads``
    only in the cells it lists."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader(name: str):
    """The ``read(run)`` of metric ``name``: ``metrics/<stem>.py``, where
    the stem is the name up to its first dot, so that ``codec_ms.burst``
    (the same quantity in the cells of another mix) needs no new reader."""
    stem = name.split(".")[0]
    return importlib.import_module(f"tpgbench.metrics.{stem}").read
