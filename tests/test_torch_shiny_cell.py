"""The Shiny Blender material cell's layout on the CPU: the port's training
steps on a white background against the benchmark's plain reference on
that background, the same steps on black against it, and the PBR pass's
counters of the pixels it shades and keeps (gs2m_tpu_torch/utils/spans.py).

The configuration benchmark/configs/shiny-ball-brdf.json cut to a CPU size:
a ring of 8 views at 96x96 at 30 degrees of elevation, the rig and the
object both halved so that every view keeps a nearest and a nearby view,
a few hundred Gaussians in the central tiles.
"""
import copy
import os
import sys
from collections import Counter

import numpy as np
import pytest
import torch

import gs2m_tpu_torch.models.render as MR
import gs2m_tpu_torch.train.trainer as TT
from gs2m_tpu_torch.utils import spans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if os.path.join(ROOT, "benchmark") not in sys.path:
    sys.path.insert(0, os.path.join(ROOT, "benchmark"))

from cellkit import cells, compare, program, runner  # noqa: E402
from cellkit import scene as S  # noqa: E402
from cellkit.reference.camera import neighbor_tables  # noqa: E402
from test_torch_tnt_cell import OpCount  # noqa: E402

torch.set_num_threads(1)
NAME = "shiny-ball-brdf"
SEED = 2 ** 31 + 23
N_COMPARED = cells.traffic("post-densify-window")["compared_steps"]


def shiny_tiny(white: bool = True) -> dict:
    cfg = copy.deepcopy(cells.config(NAME))
    s = cfg["scene"]
    cfg["scene"].update(views=8, image_width=96, image_height=96,
                        focal_px=s["focal_px"] * 96 / 800, arc_degrees=360.0 * 7 / 8,
                        camera_distance=s["camera_distance"] / 2,
                        camera_height=s["camera_height"] / 2)
    cfg["state"].update(alive=400, capacity=1024,
                        slab=[x / 2 for x in cfg["state"]["slab"]])
    # Views 45 degrees apart on the ring of 8: widen the nearest view's angle.
    cfg["optim"].update(multi_view_sample_num=256, multi_view_max_angle=60)
    cfg["instance_cap"] = 2 ** 15
    cfg["light"]["base_res"] = 64
    cfg["model"]["white_background"] = white
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
    cfg = shiny_tiny()
    return cfg, S.make_scene(cfg, SEED, "cpu"), S.make_state(cfg, SEED, "cpu")


def trainer(cfg, scene):
    fresh = S.make_state(cfg, SEED, "cpu")       # the program takes its tensors
    return program.build(cfg, scene, fresh, SEED, "cpu")


def test_layout_keeps_every_neighbour(inputs):
    cfg, scene, state = inputs
    assert S.trained_size(cfg) == (96, 96) and cfg["model"]["white_background"]
    _, near, _, nearby = neighbor_tables(scene.Rs, scene.Ts, cfg["optim"])
    assert near.any(axis=1).all() and nearby.any(axis=1).all()
    share = float(scene.alpha.mean())
    assert 0.2 < share < 0.55


@pytest.fixture(scope="module")
def reference_readings(inputs):
    cfg, scene, state = inputs
    _, ref = runner.reference_steps(cfg, scene, state, SEED, N_COMPARED)
    return ref


@pytest.mark.parametrize("white", [True, False])
def test_three_steps_against_the_reference_on_white(inputs, reference_readings,
                                                    white):
    """The program on the configured white background matches the
    reference; the same program on black (as the JAX package's trainer
    renders) fails the configuration's limits."""
    cfg, scene, _ = inputs
    prog_cfg = shiny_tiny(white)
    prog = runner.compared_steps(trainer(prog_cfg, scene), prog_cfg, SEED, "cpu",
                                 N_COMPARED)
    assert all(t["Lmat"] > 0 and t["Lgeo"] > 0 for t in reference_readings["terms"])
    nums = compare.numbers(prog, reference_readings)
    correct, rows = compare.judge(nums, compare.load_limits(NAME))
    assert correct == white, rows


@pytest.mark.parametrize("white", [True, False])
def test_every_render_of_the_step_takes_the_configured_background(
        inputs, monkeypatch, white):
    _, scene, _ = inputs
    cfg = shiny_tiny(white)
    tr = trainer(cfg, scene)
    seen = []
    for mod in (TT, MR):          # the step's renders; the nearby view's
        real = mod.render

        def keep(g, cam, bg, *a, _real=real, **kw):
            seen.append(bg.clone())
            return _real(g, cam, bg, *a, **kw)

        monkeypatch.setattr(mod, "render", keep)
    for _ in range(2):
        tr.train_step()
    want = torch.full((3,), float(white))
    assert len(seen) >= 5 and all(torch.equal(b, want) for b in seen)


def test_pbr_counters_equal_a_direct_count(inputs, monkeypatch):
    _, scene, _ = inputs
    tr = trainer(shiny_tiny(), scene)
    masks = []
    real = TT.render

    def keep(*a, **kw):
        pkg = real(*a, **kw)
        if kw.get("sobel_normal"):            # the view's own render
            masks.append(pkg["normal_mask"])
        return pkg

    monkeypatch.setattr(TT, "render", keep)
    spans.enable()
    for _ in range(2):
        tr.train_step()
    c = spans.snapshot()["counters"]
    cam = tr.scene.train_cameras[0]
    assert c["pbr_pixels"] == [float(cam.height * cam.width)] * 2
    assert c["pbr_fg_pixels"] == [float(np.count_nonzero(m.numpy())) for m in masks]
    assert all(0 < f < cam.height * cam.width for f in c["pbr_fg_pixels"])


def test_pbr_counters_log_nothing_and_add_no_launch_when_off(inputs):
    _, scene, _ = inputs
    tr = trainer(shiny_tiny(), scene)
    cam = tr.scene.train_cameras[0]
    gt = tr.scene.gt_images[0]
    with torch.no_grad():
        pkg = MR.render(tr.gaussians, cam, gt.new_ones(3), 3, geometry_stage=True,
                        material_stage=True, instance_cap=tr.instance_cap)

    def ops():
        with torch.no_grad(), OpCount() as m:
            tr.pbr_fns["material_losses"](
                tr.gaussians, cam, pkg, gt, tr.light_state, tr.opt, tr.model_cfg,
                cam, False, tr.scene.gray_images[0], tr.scene.gray_images[0],
                tr.scene.ncc_scale, 3, {}, bg=gt.new_ones(3))
        return Counter(m.ops)

    off = ops()
    assert spans.snapshot()["counters"] == {}
    spans.enable()
    on = ops()
    assert not off - on and sum((on - off).values()) == 1
    assert set(spans.snapshot()["counters"]) == {"pbr_pixels", "pbr_fg_pixels"}
