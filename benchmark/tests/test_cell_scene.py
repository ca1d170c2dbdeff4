"""The inputs are a function of the seed, with the same shapes for every seed."""
import pytest
import torch

from cellkit import scene as S
from conftest import tiny_config

SEEDS = (0, 7, 2 ** 31 + 5)


@pytest.mark.parametrize("name", ["dtu-wo-brdf", "dtu-brdf"])
def test_deterministic_per_seed(name):
    cfg = tiny_config(name)
    for seed in SEEDS:
        a, b = S.make_state(cfg, seed, "cpu"), S.make_state(cfg, seed, "cpu")
        for k in S.PARAMS:
            assert torch.equal(a.params[k], b.params[k])
        assert (a.light is None) == (cfg["light"] is None)
        if a.light is not None:
            assert torch.equal(a.light, b.light)
        sa, sb = S.make_scene(cfg, seed, "cpu"), S.make_scene(cfg, seed, "cpu")
        for k in ("gt", "gray", "alpha"):
            assert torch.equal(getattr(sa, k), getattr(sb, k))


@pytest.mark.parametrize("name", ["dtu-wo-brdf", "dtu-brdf"])
def test_same_shapes_across_seeds(name):
    cfg = tiny_config(name)
    states = [S.make_state(cfg, s, "cpu") for s in SEEDS]
    scenes = [S.make_scene(cfg, s, "cpu") for s in SEEDS]
    for st in states[1:]:
        assert {k: v.shape for k, v in st.params.items()} == {
            k: v.shape for k, v in states[0].params.items()}
        assert int(st.alive.sum()) == cfg["state"]["alive"]
        assert st.iteration == states[0].iteration
    assert not torch.equal(states[0].params["xyz"], states[1].params["xyz"])
    for sc in scenes[1:]:
        assert sc.gt.shape == scenes[0].gt.shape and sc.extent == scenes[0].extent
        for a, b in zip(sc.Rs + sc.Ts, scenes[0].Rs + scenes[0].Ts):
            assert (a == b).all()      # cameras do not depend on the seed
    w, h = S.trained_size(cfg)
    assert scenes[0].gt.shape[-2:] == (h, w)
    assert scenes[0].gray.shape[-2:] == S.ncc_size(cfg)[::-1]


def test_every_view_has_neighbours():
    from cellkit.reference.camera import neighbor_tables
    from cellkit import cells

    for name in ("dtu-wo-brdf", "dtu-brdf"):
        cfg = cells.config(name)
        small = dict(cfg, scene=dict(cfg["scene"], image_width=32, image_height=24))
        sc = S.make_scene(small, 0, "cpu")
        near, near_mask, nearby, nearby_mask = neighbor_tables(sc.Rs, sc.Ts,
                                                               cfg["optim"])
        assert near_mask.any(axis=1).all()
        if cfg["model"]["material"]:
            assert nearby_mask.any(axis=1).all()
