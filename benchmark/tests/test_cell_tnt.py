"""The Tanks and Temples geometry configuration (configs/tnt-wo-brdf.json):
its inputs per seed, its ring's multi-view neighbours, its control on the
card, and the reader of how uneven its tiles are, on a traced run's record
from the card."""
import json

import pytest
import torch

from cellkit import cells, compare, runner
from cellkit import scene as S
from conftest import HERE, tiny_config

NAME = "tnt-wo-brdf"
SEEDS = (0, 7, 2 ** 31 + 5)


def test_published_widths():
    cfg = cells.config(NAME)
    assert S.trained_size(cfg) == (960, 540) and S.ncc_size(cfg) == (1920, 1080)
    assert cfg["scene"]["views"] == 410 and cfg["model"]["sh_degree"] == 3
    st = cfg["state"]
    assert (st["alive"], st["capacity"]) == (2_500_000, 2 ** 22)
    assert (cfg["pipeline"]["tile"], cfg["pipeline"]["chunk"]) == (16, 256)
    o = cfg["optim"]
    assert (o["densify_grad_abs_threshold"], o["opacity_prune_threshold"],
            o["lambda_depth_normal"]) == (0.00015, 0.05, 0.03)
    assert not cfg["model"]["material"] and not cfg["model"]["mask_gt"]
    assert cfg["instance_cap"] % 2 ** 17 == 0


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
        assert int(st.alive.sum()) == cfg["state"]["alive"] and st.light is None
    assert not torch.equal(states[0].params["xyz"], states[1].params["xyz"])


def test_every_view_of_the_ring_has_a_neighbour():
    from cellkit.reference.camera import neighbor_tables

    cfg = cells.config(NAME)
    small = dict(cfg, scene=dict(cfg["scene"], image_width=32, image_height=18))
    sc = S.make_scene(small, 0, "cpu")
    assert len(sc.Rs) == 410
    _, near_mask, _, _ = neighbor_tables(sc.Rs, sc.Ts, cfg["optim"])
    assert near_mask.shape[0] == 410 and near_mask.any(axis=1).all()


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
    with open(f"{HERE}/fixtures/spans_tnt.json") as f:
        return json.load(f)


def test_tile_slot_peak_reads_the_record(recorded):
    c = recorded["spans"]["traced"]["counters"]
    want = sum(c["tile_slots_max"]) / sum(
        a / t for a, t in zip(c["aligned_slots"], c["tiles"]))
    got = cells.reader("tile_slot_peak.train")({"trace": {}, "spans": recorded["spans"]})
    assert got == pytest.approx(want)
    assert got == pytest.approx(recorded["metrics"]["tile_slot_peak.train"]["value"])
    assert got > 1


def test_tile_slot_peak_finds_nothing_to_read(recorded):
    read = cells.reader("tile_slot_peak.train")
    assert read({"trace": {}, "spans": None}) is None
    sp = json.loads(json.dumps(recorded["spans"]))
    del sp["traced"]["counters"]["tile_slots_max"]     # a program without it
    assert read({"trace": {}, "spans": sp}) is None
