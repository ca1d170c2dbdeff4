"""The Tanks and Temples geometry cell's layout on the CPU: the port's
training steps against the benchmark's plain reference, and the per-render
counters of how uneven the tiles are (gs2m_tpu_torch/utils/spans.py).

The configuration benchmark/configs/tnt-wo-brdf.json cut to a CPU size: a
full ring of 8 views, a trained frame that is not a multiple of the tile
(98x55), a few hundred Gaussians in a slab that encloses the cameras, so
that some lie within 0.2-1 in front of a camera and some behind it.
"""
import copy
import math
import os
import sys
from collections import Counter

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gs2m_tpu_torch.models import render as MR
from gs2m_tpu_torch.ops import rasterize as RZ
from gs2m_tpu_torch.utils import spans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if os.path.join(ROOT, "benchmark") not in sys.path:
    sys.path.insert(0, os.path.join(ROOT, "benchmark"))

from cellkit import cells, compare, program, runner  # noqa: E402
from cellkit import scene as S  # noqa: E402

torch.set_num_threads(1)
SEED = 2 ** 31 + 17
N_COMPARED = cells.traffic("post-densify-window")["compared_steps"]


def tnt_tiny() -> dict:
    cfg = copy.deepcopy(cells.config("tnt-wo-brdf"))
    cfg["scene"].update(views=8, image_width=196, image_height=110, focal_px=117.0,
                        arc_degrees=360.0 * 7 / 8, camera_distance=1.0,
                        camera_height=0.1)
    cfg["state"].update(alive=400, capacity=1024, slab=[1.5, 0.5, 1.5])
    # Neighbours 45 degrees apart on the ring of 8, so the multi-view loss runs.
    cfg["optim"].update(multi_view_sample_num=256, multi_view_max_angle=60)
    cfg["instance_cap"] = 2 ** 15
    return cfg


@pytest.fixture(autouse=True)
def recorder_off():
    spans.disable()
    spans.reset()
    yield
    spans.disable()
    spans.reset()


@pytest.fixture(scope="module")
def inputs():
    cfg = tnt_tiny()
    return cfg, S.make_scene(cfg, SEED, "cpu"), S.make_state(cfg, SEED, "cpu")


def trainer(inputs):
    cfg, scene, state = inputs
    fresh = S.make_state(cfg, SEED, "cpu")       # the program takes its tensors
    return program.build(cfg, scene, fresh, SEED, "cpu")


def test_layout_is_the_unbounded_ring(inputs):
    cfg, scene, state = inputs
    w, h = S.trained_size(cfg)
    assert (w % 16, h % 16) != (0, 0) and (w, h) == (98, 55)
    centers = np.stack([-(R @ T) for R, T in zip(scene.Rs, scene.Ts)])
    angles = np.sort(np.arctan2(centers[:, 0], -centers[:, 2]))
    assert np.allclose(np.diff(angles), 2 * math.pi / 8, atol=1e-6)
    xyz = state.params["xyz"][state.alive].double().numpy()
    assert (np.abs(xyz).max(0) > np.abs(centers).max(0)).all()   # encloses the ring
    near = behind = 0
    for R, T in zip(scene.Rs, scene.Ts):
        z = (xyz @ R + T)[:, 2]          # depth along the camera's view axis
        near += int(np.sum((z > 0.2) & (z < 1.0)))
        behind += int(np.sum(z < 0.0))
    assert near > 0 and behind > 0


def test_three_steps_against_the_reference(inputs):
    cfg, scene, state = inputs
    prog = runner.compared_steps(trainer(inputs), cfg, SEED, "cpu", N_COMPARED)
    _, ref = runner.reference_steps(cfg, scene, state, SEED, N_COMPARED)
    assert any(t["Lgeo"] > 0 for t in ref["terms"])
    nums = compare.numbers(prog, ref)
    correct, rows = compare.judge(nums, compare.load_limits("tnt-wo-brdf"))
    assert correct, rows


def direct_tile_slots(chunk_tile: torch.Tensor, tiles: int, chunk: int) -> int:
    per = np.bincount(chunk_tile.numpy(), minlength=tiles + 1)[:tiles]
    return int(per.max()) * chunk


def test_counters_equal_a_direct_count(inputs, monkeypatch):
    tr = trainer(inputs)
    tr.train_step()
    layouts = []
    binner = RZ.bin_gaussians

    def keep(*a, **kw):
        layouts.append(binner(*a, **kw))
        return layouts[-1]

    monkeypatch.setattr(RZ, "bin_gaussians", keep)
    spans.enable()
    tr.train_step()
    c = spans.snapshot()["counters"]
    tile, chunk = tr.pipe.tile, tr.pipe.chunk
    cam = tr.scene.train_cameras[0]
    tiles = math.ceil(cam.height / tile) * math.ceil(cam.width / tile)
    assert len(layouts) == len(c["tile_slots_max"]) == len(c["tiles"]) == 2
    assert c["tiles"] == [float(tiles)] * 2
    assert c["tile_slots_max"] == [
        float(direct_tile_slots(b.chunk_tile, tiles, chunk)) for b in layouts]
    assert all(0 < m <= a for m, a in zip(c["tile_slots_max"], c["aligned_slots"]))


def test_recorder_off_logs_neither(inputs, monkeypatch):
    tr = trainer(inputs)
    calls = []
    counter = MR.tile_slots_max
    monkeypatch.setattr(MR, "tile_slots_max",
                        lambda *a: calls.append(1) or counter(*a))
    tr.train_step()
    assert calls == [] and spans.snapshot()["counters"] == {}
    spans.enable()
    tr.train_step()
    assert len(calls) == 2 == len(spans.snapshot()["counters"]["tiles"])


class OpCount(TorchDispatchMode):
    """The operators that run, views left out: on a card each of the others
    is a launch."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def derive_ops(out, cam) -> list:
    with OpCount() as m:
        MR.derive_render_pkg(out, cam, torch.zeros(3))
    return m.ops


def test_counter_adds_no_launch_when_off(inputs):
    tr = trainer(inputs)
    cam = tr.scene.train_cameras[0]
    opac, feats, proj = MR.preprocess(tr.gaussians, cam, 3, tile=tr.pipe.tile)
    out = RZ.rasterize_from_projected(proj, opac, feats, torch.zeros(3), cam,
                                      feature_count=5, tile=tr.pipe.tile,
                                      chunk=tr.pipe.chunk,
                                      instance_cap=tr.instance_cap)
    assert out.chunk_tile is not None and out.tiles > 0
    without = out._replace(chunk_tile=None)
    assert derive_ops(out, cam) == derive_ops(without, cam)
    spans.enable()
    on, bare = Counter(derive_ops(out, cam)), Counter(derive_ops(without, cam))
    assert not bare - on and 0 < sum((on - bare).values()) <= 4
