"""BENCHMARK.json against the benchmark's contract, and one run's result line."""
import json
import re
import time
from pathlib import Path

import pytest

from conftest import ROOT, tiny_config

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


@pytest.fixture(scope="module")
def bench():
    return json.loads((Path(ROOT) / "BENCHMARK.json").read_text())


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024


def test_configs_and_cells(bench):
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and c["name"] in used
        assert c["file"].startswith("benchmark/") and (Path(ROOT) / c["file"]).is_file()
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert all(NAME.fullmatch(k) for k in c["reduced"])
        data = json.loads((Path(ROOT) / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert (Path(ROOT) / "benchmark" / "limits" / f"{c['name']}.json").is_file()
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (Path(ROOT) / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()


def test_metrics(bench):
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.fullmatch(n) for n in names)
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.fullmatch(m["unit"])
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells
        assert m["better"] in ("lower", "higher") and UNIT.fullmatch(m["unit"])
        assert (Path(ROOT) / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.fixture(scope="module")
def results():
    from cellkit import cells, compare, runner

    bench = cells.benchmark()
    out = {}
    for trace in (0, 1):
        cfg = tiny_config("dtu-wo-brdf")
        per_layer = cells.per_layer_for(bench, "dtu-wo-brdf-train") if trace else []
        run = runner.CellRun(cfg, cells.traffic("post-densify-window"),
                             "dtu-wo-brdf-train", 2 ** 31 + 11, 0.5, bool(trace), "cpu",
                             time.perf_counter(), compare.load_limits("dtu-wo-brdf"),
                             bench["end_to_end"],
                             per_layer, {m["name"]: cells.reader(m["name"])
                                         for m in per_layer})
        out[trace] = run.run()
    return out


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(results, trace):
    out = results[trace]
    line = json.dumps(out)
    assert "\n" not in line and json.loads(line) == out
    keys = list(out)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "compared"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for v in out["compared"].values():
        assert set(v) == {"value", "limit"} and v["value"] <= v["limit"]
    if trace:
        assert set(out["device"]) >= {"busy_s", "window_s"}
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        from cellkit import cells

        assert set(out["metrics"]) == {m["name"] for m in cells.benchmark()["end_to_end"]}
        assert all(m["value"] > 0 for k, m in out["metrics"].items()
                   if k != "peak_mem_gib")
