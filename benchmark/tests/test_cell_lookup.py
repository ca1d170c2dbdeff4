"""Configurations, traffic mixes, limits and metric readers are found by name."""
import pytest

from cellkit import cells, compare


def test_every_cell_resolves():
    bench = cells.benchmark()
    for w in bench["workloads"]:
        assert cells.workload(bench, w["name"]) is w
        cfg = cells.config(w["config"])
        assert cfg["name"] == w["config"]
        assert set(compare.load_limits(w["config"])) == set(compare.NUMBERS)
        tr = cells.traffic(w["traffic"])
        assert tr["name"] == w["traffic"]
        for m in cells.per_layer_for(bench, w["name"]):
            assert callable(cells.reader(m["name"]))


def test_unknown_and_unsafe_names_refused():
    bench = cells.benchmark()
    with pytest.raises(KeyError):
        cells.workload(bench, "no-such-cell")
    for bad in ("../BENCHMARK", "a/b", "", " x"):
        with pytest.raises(ValueError):
            cells.config(bad)


def test_per_layer_selection():
    bench = {"per_layer": [{"name": "x", "moves": "a", "workloads": ["w1", "w2"]},
                           {"name": "y", "moves": "b", "workloads": ["w2"]},
                           {"name": "z", "moves": "a", "workloads": []}]}
    assert [m["name"] for m in cells.per_layer_for(bench, "w1")] == ["x"]
    assert [m["name"] for m in cells.per_layer_for(bench, "w2")] == ["x", "y"]
    with pytest.raises(KeyError):
        cells.per_layer_for({"per_layer": [{"name": "u", "moves": "a"}]}, "w1")
