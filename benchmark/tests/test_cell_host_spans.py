"""The program's span recorder read by the host_* and counter readers
(cellkit/host_spans.py): each reader on a traced run's record from the card,
None without the recorder's log, and a traced run of the tiny geometry
configuration on the CPU, armed as run.py arms it."""
import json
import sys
import time

import pytest

from cellkit import cells
from conftest import HERE, tiny_config

NAMES = ["host_render_ms.train", "host_losses_ms.train", "host_backward_ms.train",
         "host_update_ms.train", "host_pbr_ms.train", "host_unspanned_ms.train",
         "instances_per_step.train", "aligned_slot_use.train"]
HOST = {"host_render_ms.train": "step/render", "host_losses_ms.train": "step/forward",
        "host_backward_ms.train": "step/backward", "host_update_ms.train": "step/update",
        "host_pbr_ms.train": "step/pbr"}


@pytest.fixture(scope="module")
def recorded():
    with open(f"{HERE}/fixtures/spans_brdf.json") as f:
        return json.load(f)


def ctx_of(recorded):
    return {"trace": recorded["record"], "spans": recorded["spans"], "cfg": {}}


def expected(rec, sp):
    """Each reader's number from the record and the two snapshots, written out."""
    a, b = sp["untraced"], sp["traced"]
    u, n = len(a["steps"]), len(b["steps"])
    out = {k: 1e3 * a["spans"][v]["self_s"] / u for k, v in HOST.items()}
    top = sum(a["spans"][k]["total_s"] for k in ("step/forward", "step/backward",
                                                 "step/update", "step/light"))
    assert top == pytest.approx(a["outer_s"])
    out["host_unspanned_ms.train"] = 1e3 * (rec["untraced_step_s"] - top / u)
    c = b["counters"]
    out["instances_per_step.train"] = sum(c["instances"]) / n
    out["aligned_slot_use.train"] = 100 * sum(
        min(k, a) for k, a in zip(c["kept_instances"], c["aligned_slots"])
    ) / sum(c["aligned_slots"])
    return out


@pytest.mark.parametrize("name", NAMES)
def test_reader_values(recorded, name):
    want = expected(recorded["record"], recorded["spans"])[name]
    got = cells.reader(name)(ctx_of(recorded))
    assert got == pytest.approx(want)
    assert got == pytest.approx(recorded["metrics"][name]["value"])


def test_stages_and_unspanned_make_the_wall(recorded):
    c = ctx_of(recorded)
    a = recorded["spans"]["untraced"]
    rest = sum(1e3 * a["spans"][k]["self_s"] / len(a["steps"])
               for k in ("step/light", "step/reduce") if k in a["spans"])
    total = sum(cells.reader(n)(c) for n in NAMES[:6]) + rest
    assert total == pytest.approx(1e3 * recorded["record"]["untraced_step_s"], abs=1e-9)


@pytest.mark.parametrize("name", NAMES)
def test_readers_find_nothing_to_read(recorded, name):
    assert cells.reader(name)({"trace": recorded["record"], "cfg": {}}) is None
    assert cells.reader(name)({"trace": recorded["record"], "spans": None}) is None


def test_slot_use_is_a_share_of_the_slots(recorded):
    c = recorded["spans"]["traced"]["counters"]
    assert len(c["kept_instances"]) == len(c["aligned_slots"]) == len(c["instances"])
    assert all(0 < k <= a for k, a in zip(c["kept_instances"], c["aligned_slots"]))
    assert 0 < cells.reader("aligned_slot_use.train")(ctx_of(recorded)) < 100


def record_window(u, n, order, wall=10.0):
    """The recorder's log of a window run in `order` ("u" an unprofiled
    step, "w" the profiler's warm-up step, "p" a profiled step), after a
    few unprofiled steps of set-up; then host_spans' reading of it."""
    from cellkit import host_spans
    from gs2m_tpu_torch.utils import spans

    spans.reset()
    spans.enable()
    for i, kind in enumerate("uuu" + order):
        spans.set_step(100 + i)
        spans._profiler._is_profiler_enabled = kind == "p"
        try:
            with spans.span("step/forward"):
                with spans.span("step/render"):
                    spans.count("instances", 10)
                    spans.count("kept_instances", 8)
                    spans.count("aligned_slots", 9)
            with spans.span("step/backward"):
                pass
        finally:
            spans._profiler._is_profiler_enabled = False
    real = host_spans._window
    host_spans._window = lambda: (u, n)
    try:
        return host_spans.read({"trace": {"untraced_step_s": wall}})
    finally:
        host_spans._window = real
        spans.disable()
        spans.reset()


@pytest.mark.parametrize("order,reads", [
    ("uuuu" + "w" + "ppp", True),     # traced_window's order
    ("uuuu" + "p" + "ppp", True),     # a warm-up step the profiler records
    ("uuuu" + "w" + "ppp" + "u", False),   # a step after the traced ones
    ("uupu" + "w" + "ppp", False),         # a profiled step among the untraced
    ("w" + "ppp" + "uuuu", False),         # the unprofiled steps come last
    ("uuuu" + "w" + "pp" + "u", False),    # the traced run ends unprofiled
])
def test_window_split_is_checked(order, reads):
    out = record_window(4, 3, order)
    assert (out is not None) == reads
    if reads:
        assert len(out["untraced"]["steps"]) == 4 and out["untraced"]["profiled"] == []
        assert out["traced"]["profiled"] == out["traced"]["steps"]
        assert out["traced"]["counters"]["kept_instances"] == [8.0] * 3


def test_window_split_checked_against_the_wall():
    assert record_window(4, 3, "uuuuwppp", wall=10.0) is not None
    assert record_window(4, 3, "uuuuwppp", wall=1e-9) is None


def test_pbr_reader_silent_without_pbr(recorded):
    sp = json.loads(json.dumps(recorded["spans"]))
    del sp["untraced"]["spans"]["step/pbr"]
    assert cells.reader("host_pbr_ms.train")({"trace": recorded["record"],
                                              "spans": sp}) is None


def test_traced_run_on_the_cpu(monkeypatch):
    from cellkit import compare, runner
    from gs2m_tpu_torch.utils import spans

    monkeypatch.setattr(sys, "argv", ["run.py", "--workload", "dtu-wo-brdf-train",
                                      "--seed", "5", "--seconds", "1", "--trace", "1"])
    bench = cells.benchmark()
    per_layer = [m for m in cells.per_layer_for(bench, "dtu-wo-brdf-train")
                 if m["name"] in NAMES]
    readers = {m["name"]: cells.reader(m["name"]) for m in per_layer}
    assert spans._REC.on
    traffic = cells.traffic("post-densify-window")
    run = runner.CellRun(tiny_config("dtu-wo-brdf"), traffic, "dtu-wo-brdf-train",
                         2 ** 31 + 5, 1.0, True, "cpu", time.perf_counter(),
                         compare.load_limits("dtu-wo-brdf"), bench["end_to_end"],
                         per_layer, readers)
    out = run.run()
    assert not spans._REC.on
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(m) == set(NAMES) - {"host_pbr_ms.train"}
    wall = 1e3 * run.record["untraced_step_s"]
    assert sum(m[n] for n in NAMES[:6] if n in m) == pytest.approx(wall, abs=1e-6)
    assert all(m[n] > 0 for n in NAMES[:4])
    assert 0 < m["aligned_slot_use.train"] <= 100
    assert m["instances_per_step.train"] > 0
