"""Finding a cell's parts by name: BENCHMARK.json's entries, and the files
that belong to one configuration, traffic mix or per-layer metric.

  benchmark/configs/<configuration>.json   sizes and flags, as run
  benchmark/limits/<configuration>.json    the comparison's limits
  benchmark/traffic/<traffic>.json         the mix's parameters
  benchmark/metrics/<metric>.py            a reader: read(ctx) -> float|None

A later change adds a cell, a mix or a metric by adding such files and
entries; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent          # benchmark/
ROOT = HERE.parent                                     # the checkout


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _safe(name: str) -> str:
    if not re.fullmatch(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}", name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{_safe(name)}.json").read_text())


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{_safe(name)}.json").read_text())


def reader(name: str):
    """The read(ctx) function of benchmark/metrics/<name>.py."""
    path = HERE / "metrics" / f"{_safe(name)}.py"
    spec = importlib.util.spec_from_file_location(
        "metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def per_layer_for(bench: dict, workload_name: str) -> list:
    """The per-layer metrics a traced run of this cell reports: those whose
    `workloads` list it (every per-layer entry carries the list)."""
    return [m for m in bench["per_layer"] if workload_name in m["workloads"]]
