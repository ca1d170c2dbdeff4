"""The Shiny Blender material configuration (configs/shiny-ball-brdf.json):
its published widths and the preset's flags, its inputs per seed, its
ring's nearest and nearby views, its reference on the configured
background and its control on the card, and the reader of the PBR pass's
share of pixels on the object, on a traced run's record from the card."""
import json

import pytest
import torch

from cellkit import cells, compare, runner
from cellkit import scene as S
from conftest import HERE, tiny_config

NAME = "shiny-ball-brdf"
SEEDS = (0, 7, 2 ** 31 + 5)


def test_published_widths():
    cfg = cells.config(NAME)
    assert S.trained_size(cfg) == (800, 800) == S.ncc_size(cfg)
    s = cfg["scene"]
    assert s["views"] == 100 and s["focal_px"] == pytest.approx(1111.1)
    assert (s["camera_distance"] ** 2 + s["camera_height"] ** 2) ** 0.5 == pytest.approx(
        4.03, abs=0.01)
    m = cfg["model"]
    assert m["sh_degree"] == 3 and m["white_background"] and m["mask_gt"]
    assert m["material"] and not m["metallic"] and not m["gamma"]
    o = cfg["optim"]
    assert (o["reflection_threshold"], o["lambda_smooth"], o["lambda_normal"]) == (
        0.4, 0.1, 8.0)
    assert cfg["light"]["base_res"] == 512 and cfg["reference"] == "step_bg"
    st = cfg["state"]
    assert (st["alive"], st["capacity"]) == (300_000, 2 ** 19)
    assert (cfg["pipeline"]["tile"], cfg["pipeline"]["chunk"]) == (16, 256)
    assert cfg["instance_cap"] % 2 ** 17 == 0
    assert cfg["reduced"] == ["scene", "state"]


def test_deterministic_per_seed_with_the_same_shapes():
    cfg = tiny_config(NAME)
    states = [S.make_state(cfg, s, "cpu") for s in SEEDS]
    scenes = [S.make_scene(cfg, s, "cpu") for s in SEEDS]
    for seed, st, sc in zip(SEEDS, states, scenes):
        again, sc2 = S.make_state(cfg, seed, "cpu"), S.make_scene(cfg, seed, "cpu")
        for k in S.PARAMS:
            assert torch.equal(st.params[k], again.params[k])
            assert st.params[k].shape == states[0].params[k].shape
        for k in ("gt", "gray", "alpha"):
            assert torch.equal(getattr(sc, k), getattr(sc2, k))
            assert getattr(sc, k).shape == getattr(scenes[0], k).shape
        assert torch.equal(st.light, again.light)
        assert st.light.shape == states[0].light.shape
        assert int(st.alive.sum()) == cfg["state"]["alive"]
    assert not torch.equal(states[0].params["xyz"], states[1].params["xyz"])
    assert not torch.equal(scenes[0].alpha, scenes[1].alpha)


def test_every_view_has_a_nearest_and_a_nearby_view():
    from cellkit.reference.camera import neighbor_tables

    cfg = cells.config(NAME)
    small = dict(cfg, scene=dict(cfg["scene"], image_width=32, image_height=32))
    sc = S.make_scene(small, 0, "cpu")
    assert len(sc.Rs) == 100
    _, near_mask, _, nearby_mask = neighbor_tables(sc.Rs, sc.Ts, cfg["optim"])
    assert near_mask.any(axis=1).all() and nearby_mask.any(axis=1).all()


def test_reference_composites_on_the_configured_background():
    """step_bg's colour is the black render plus final_T on white, and its
    depth-normal target the black target plus (1 - alpha) on white."""
    from cellkit.reference import raster as R
    from cellkit.reference import step_bg

    cfg = tiny_config(NAME)
    scene, state = S.make_scene(cfg, 3, "cpu"), S.make_state(cfg, 3, "cpu")
    ref = step_bg.Reference(cfg, scene, state, 3)
    assert torch.equal(ref.bg, torch.ones(3))
    args = (ref.params, ref.alive, ref.cams[0], ref.deg, 9)
    kw = dict(tile=ref.tile, chunk=ref.chunk, sobel=True)
    with torch.no_grad():
        black, white = R.render(*args, **kw), step_bg.render(ref.bg, *args, **kw)
    assert torch.equal(white["render"], black["render"] + black["final_T"][None])
    assert torch.equal(white["sobel_map"],
                       black["sobel_map"] + (1.0 - black["alpha_map"]))
    assert 0 < float(black["final_T"].mean()) < 1


@pytest.mark.cuda
def test_tf32_reference_fails(cuda):
    import readings

    cfg = cells.config(NAME)
    n = cells.traffic("post-densify-window")["compared_steps"]
    failed = []
    for seed in (1, 2, 3):
        scene, state = S.make_scene(cfg, seed, cuda), S.make_state(cfg, seed, cuda)
        _, ref = runner.reference_steps(cfg, scene, state, seed, n)
        with readings.tf32():
            _, low = runner.reference_steps(cfg, scene, state, seed, n)
        ok, _ = compare.judge(compare.numbers(low, ref), compare.load_limits(NAME))
        failed.append(not ok)
        del scene, state
        torch.cuda.empty_cache()
    assert all(failed)


@pytest.fixture(scope="module")
def recorded():
    with open(f"{HERE}/fixtures/spans_shiny.json") as f:
        return json.load(f)


def test_pbr_fg_share_reads_the_record(recorded):
    c = recorded["spans"]["traced"]["counters"]
    want = 100.0 * sum(c["pbr_fg_pixels"]) / sum(c["pbr_pixels"])
    got = cells.reader("pbr_fg_share.train")({"trace": {}, "spans": recorded["spans"]})
    assert got == pytest.approx(want)
    assert got == pytest.approx(recorded["metrics"]["pbr_fg_share.train"]["value"])
    assert 25 <= got <= 50
    assert len(c["pbr_pixels"]) == len(recorded["spans"]["traced"]["steps"])


def test_pbr_fg_share_finds_nothing_to_read(recorded):
    read = cells.reader("pbr_fg_share.train")
    assert read({"trace": {}, "spans": None}) is None
    sp = json.loads(json.dumps(recorded["spans"]))
    del sp["traced"]["counters"]["pbr_fg_pixels"]      # a program without it
    assert read({"trace": {}, "spans": sp}) is None
    sp["traced"]["counters"] = {}                      # a step without the pass
    assert read({"trace": {}, "spans": sp}) is None
