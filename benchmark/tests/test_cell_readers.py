"""The per-layer readers on a small trace record, and the reduction of a
real profiler session to such a record."""
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from cellkit import cells
from cellkit import trace as TR
from cellkit import work as WK
from conftest import HERE


@pytest.fixture(scope="module")
def recorded():
    with open(f"{HERE}/fixtures/trace_geo.json") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def ctx(recorded):
    return {"trace": recorded["record"], "work": recorded["work"], "cfg": {},
            "peaks": WK.PEAKS}


def expected(rec, work):
    """Each reader's number from the record, written out."""
    st, n = rec["stage_s"], rec["steps"]
    k1 = sum(s for name, (_, s) in rec["kernels"].items() if "blend_fwd_kernel" in name)
    k2 = sum(s for name, (_, s) in rec["kernels"].items() if "blend_bwd_kernel" in name)
    return {
        "step_render_ms.train": 1e3 * st["step/render"] / n,
        "step_losses_ms.train": 1e3 * (st["step/forward"] - st["step/render"]
                                       - st["step/pbr"]) / n,
        "step_backward_ms.train": 1e3 * (st["step/backward"] + rec["engine_s"]) / n,
        "step_update_ms.train": 1e3 * st["step/update"] / n,
        "launches_per_step.train": rec["launches"] / n,
        "k1_roofline.train": 100 * work["k1_least_s"] / k1,
        "k2_roofline.train": 100 * work["k2_least_s"] / k2,
        "device_idle_share.train": 100 * (1 - rec["busy_s"] / n / rec["untraced_step_s"]),
        "train_step_mfu": 100 * work["step_ops"] / n / rec["untraced_step_s"] / 67e12,
    }


NAMES = ["step_render_ms.train", "step_losses_ms.train", "step_backward_ms.train",
         "step_update_ms.train", "launches_per_step.train", "k1_roofline.train",
         "k2_roofline.train", "device_idle_share.train", "train_step_mfu"]


@pytest.mark.parametrize("name", NAMES)
def test_reader_values(recorded, ctx, name):
    want = expected(recorded["record"], recorded["work"])[name]
    assert cells.reader(name)(ctx) == pytest.approx(want)
    # and what the traced run itself printed
    assert cells.reader(name)(ctx) == pytest.approx(recorded["metrics"][name]["value"])


def test_pbr_reader_silent_without_pbr(ctx):
    assert cells.reader("step_pbr_ms.train")(ctx) is None


def test_readers_find_nothing_to_read(ctx):
    empty = dict(ctx["trace"], kernels={}, launches=0, busy_s=0.0,
                 stage_s=dict.fromkeys(ctx["trace"]["stage_s"], 0.0), engine_s=0.0)
    c = dict(ctx, trace=empty)
    for name in NAMES:
        if name != "train_step_mfu":
            assert cells.reader(name)(c) is None, name


def test_breakdown_helpers(ctx):
    top = TR.top_ops(ctx["trace"], top=3)
    secs = [s for _, s in top]
    assert len(top) == 3 and secs == sorted(secs, reverse=True)
    n, s = TR.kernel_seconds(ctx["trace"], "blend_bwd_kernel")
    assert n == 20 and s > 0        # 10 steps, two differentiated renders each


def test_compact_of_a_cpu_session():
    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with record_function("step/forward"):
                with record_function("step/render"):
                    y = x @ x
                z = (y * 2).sum()
            with record_function("step/update"):
                x.add_(z * 0)
    rec = TR.compact(prof, 2, 0.01)
    assert rec["steps"] == 2 and rec["launches"] == 0 and rec["busy_s"] == 0
    assert set(rec["stage_s"]) == set(TR.STAGES)
    json.dumps(rec)
