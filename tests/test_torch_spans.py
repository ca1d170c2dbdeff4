"""The step's spans and counters (gs2m_tpu_torch/utils/spans.py), on the CPU.

Off: a span opens no profiler range and logs nothing, and costs less than
a record_function range. Under a profiler session the
trainer's seven stage names are ranges with their nesting (the renders and
the PBR pass inside the forward, the rest at the top), as the benchmark's
trace reduction and apps/train.py::step_stages read them. On: self times
plus children's durations equal durations, counters keep their scalars by
reference, steps under a profiler session are marked, and one train step
logs one span set under its iteration with the counters of its render
packages.
"""
import contextlib
import os
import sys
import time

import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile, record_function

from gs2m_tpu_torch.core.config import ModelConfig as TModel
from gs2m_tpu_torch.core.config import OptimConfig as TOpt
from gs2m_tpu_torch.core.config import PipelineConfig as TPipe
from gs2m_tpu_torch.data.scene import Scene as TScene
from gs2m_tpu_torch.models import render as MR
from gs2m_tpu_torch.pbr import render as PR
from gs2m_tpu_torch.train import trainer as TT
from gs2m_tpu_torch.utils import spans

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPT_KW = dict(multi_view_max_angle=179.0, multi_view_max_dist=100.0,
              nearby_cam_max_angle=179.0, nearby_cam_max_dist=100.0,
              nearby_cam_min_angle=0.0, multi_view_sample_num=200)
TOP = {"step/forward", "step/backward", "step/update", "step/reduce",
       "step/light"}


@pytest.fixture(autouse=True)
def recorder_off():
    spans.disable()
    spans.reset()
    yield
    spans.disable()
    spans.reset()


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from tests.make_synthetic_scene import build
    root = tmp_path_factory.mktemp("spans")
    scene_dir = build(str(root / "scene"), n_views=4, width=40, height=30,
                      n_points=120, surface=True, texture="noise")
    return TScene(TModel(source_path=scene_dir, resolution=1, sh_degree=1),
                  TOpt(**OPT_KW), device="cpu")


def material_trainer(scene, data_parallel=False):
    """A trainer whose first step is a material step (geometry from 0)."""
    opt = TOpt(**OPT_KW, geometry_from_iter=0)
    fns = PR.make_pbr_fns(base_res=8, seed=0, device="cpu")
    return TT.Trainer(TModel(sh_degree=1, material=True), TPipe(chunk=64), opt,
                      scene, seed=1, pbr_fns=fns, data_parallel=data_parallel)


@contextlib.contextmanager
def world_of_one():
    """A one-rank gloo group in this process, so the step has its reduce."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_off_logs_nothing_and_opens_no_range(monkeypatch):
    def no_range(name):
        raise AssertionError(f"a range opened for {name}")

    monkeypatch.setattr(spans, "record_function", no_range)
    x = torch.ones(())
    for name in spans.STAGES.values():
        with spans.span(name):
            spans.count("instances", x)
    snap = spans.snapshot()
    assert snap == {"steps": [], "profiled": [], "lost": 0, "outer_s": 0.0,
                    "spans": {}, "counters": {}}


def test_off_span_costs_less_than_record_function():
    def per_call(ctx, n=20000):
        best = float("inf")
        for _ in range(3):
            t = time.perf_counter()
            for _ in range(n):
                with ctx("step/render"):
                    pass
            best = min(best, (time.perf_counter() - t) / n)
        return best

    assert per_call(spans.span) < per_call(record_function)


def test_profiler_sees_the_seven_stages_nested(scene):
    sys.path.insert(0, os.path.join(ROOT, "benchmark"))
    try:
        from cellkit import trace as TR
    finally:
        sys.path.pop(0)
    from gs2m_tpu_torch.apps.train import step_stages

    with world_of_one():
        tr = material_trainer(scene, data_parallel=True)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            tr.train_step()
    cpu = [e for e in prof.events() if e.name.startswith("step/")]
    assert {e.name for e in cpu} == set(spans.STAGES.values())

    def stage_parent(e):
        p = e.cpu_parent
        while p is not None and not p.name.startswith("step/"):
            p = p.cpu_parent
        return None if p is None else p.name

    for e in cpu:
        want = None if e.name in TOP else "step/forward"
        assert stage_parent(e) == want, e.name
    assert sum(e.name == "step/render" for e in cpu) == 3   # main, nearest, nearby
    rec = TR.compact(prof, 1, 0.01)
    assert set(rec["stage_s"]) == set(TR.STAGES) <= set(spans.STAGES.values())
    assert set(step_stages(prof, 0.0)) == {"render", "pbr", "losses", "backward",
                                           "reduce", "update", "light", "other"}
    # the recorder was off: the profiler's ranges only
    assert spans.snapshot()["spans"] == {}


def test_self_times_plus_children_equal_durations():
    spans.enable()
    spans.set_step(7)
    with spans.span("step/forward"):
        for _ in range(2):
            with spans.span("step/render"):
                time.sleep(0.002)
        with spans.span("step/pbr"):
            time.sleep(0.001)
        time.sleep(0.001)
    with spans.span("step/backward"):
        time.sleep(0.001)
    snap = spans.snapshot()
    s = snap["spans"]
    assert snap["steps"] == [7]
    assert {k: v["n"] for k, v in s.items()} == {
        "step/forward": 1, "step/render": 2, "step/pbr": 1, "step/backward": 1}
    fwd = s["step/forward"]
    assert fwd["self_s"] + s["step/render"]["total_s"] + s["step/pbr"][
        "total_s"] == pytest.approx(fwd["total_s"], abs=1e-9)
    assert fwd["self_s"] >= 0.001 and s["step/render"]["total_s"] >= 0.004
    for name in ("step/render", "step/pbr", "step/backward"):
        assert s[name]["self_s"] == s[name]["total_s"]
    assert snap["outer_s"] == pytest.approx(
        fwd["total_s"] + s["step/backward"]["total_s"], abs=1e-9)
    assert spans.snapshot(steps=[8])["spans"] == {}


def test_count_keeps_scalars_by_reference():
    spans.enable()
    spans.set_step(3)
    a = torch.tensor(5, dtype=torch.int32)
    b = torch.tensor(2.5)
    spans.count("instances", a)
    spans.count("instances", b)
    spans.count("aligned_slots", 64)
    a.fill_(11)          # read at snapshot(), not when counted
    snap = spans.snapshot()
    assert snap["counters"] == {"instances": [11.0, 2.5], "aligned_slots": [64.0]}
    assert snap["steps"] == [3]
    spans.disable()
    spans.count("instances", a)
    assert spans.snapshot()["counters"]["instances"] == [11.0, 2.5]


def test_steps_under_the_profiler_are_marked():
    """With the recorder on, a span under a profiler session is also the
    profiler's range, and its step is listed as profiled."""
    spans.enable()
    spans.set_step(1)
    with spans.span("step/update"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        spans.set_step(2)
        with spans.span("step/update"):
            pass
    spans.set_step(3)
    with spans.span("step/update"):
        pass
    snap = spans.snapshot()
    assert snap["steps"] == [1, 2, 3] and snap["profiled"] == [2]
    assert spans.snapshot(steps=[1, 3])["profiled"] == []
    assert sum(e.name == "step/update" for e in prof.events()) == 1


def test_ring_overwrites_oldest_and_says_so(monkeypatch):
    monkeypatch.setattr(spans, "SPAN_CAPACITY", 4)
    spans.reset()
    spans.enable()
    for i in range(6):
        spans.set_step(i)
        with spans.span("step/update"):
            pass
    snap = spans.snapshot()
    assert snap["lost"] == 2 and snap["steps"] == [2, 3, 4, 5]
    assert snap["spans"]["step/update"]["n"] == 4


def test_train_step_logs_one_span_set_with_its_counters(scene, monkeypatch):
    tr = material_trainer(scene)
    tr.train_step()                        # first step: no recorder
    pkgs, outs = [], []
    derive = MR.derive_render_pkg

    def keep(*a, **kw):
        outs.append(a[0])                  # the render's RasterOut
        pkgs.append(derive(*a, **kw))
        return pkgs[-1]

    monkeypatch.setattr(MR, "derive_render_pkg", keep)
    spans.enable()
    tr.train_step()
    snap = spans.snapshot()
    assert snap["steps"] == [tr.iteration] == [2]
    assert snap == spans.snapshot(steps=[2])
    n = {k: v["n"] for k, v in snap["spans"].items()}
    renders = len(pkgs)
    assert renders in (2, 3)                # main, nearest (+ nearby)
    assert n == {"step/forward": 1, "step/render": renders, "step/pbr": 1,
                 "step/backward": 1, "step/update": 2, "step/light": 1}
    c = snap["counters"]
    cam = scene.train_cameras[0]
    tiles = -(-cam.height // 16) * -(-cam.width // 16)
    assert c == {
        "instances": [float(p["num_instances"]) for p in pkgs],
        "kept_instances": [float(p["num_kept"]) for p in pkgs],
        "aligned_slots": [float(o.aligned_demand) for o in outs],
        "tile_slots_max": c["tile_slots_max"], "tiles": [float(tiles)] * renders}
    assert all(0 < m <= a for m, a in zip(c["tile_slots_max"], c["aligned_slots"]))
    assert all(0 < k <= i for k, i in zip(c["kept_instances"], c["instances"]))
    assert all(k <= a for k, a in zip(c["kept_instances"], c["aligned_slots"]))
    assert snap["profiled"] == []
    s = snap["spans"]
    inner = sum(s[k]["total_s"] for k in ("step/render", "step/pbr"))
    assert s["step/forward"]["self_s"] == pytest.approx(
        s["step/forward"]["total_s"] - inner, abs=1e-9)

