"""Port vs JAX package: the data-parallel pieces that run in one process
(parallel/dp.py, the scene's subset loading, the statistics' per-view
contribution) and the data-parallel step and trainer in a world of one.

partition_views and host_view_closure equal the JAX package's on
tests/test_parallel.py:252-290's cases; the subset loading equals JAX's
array for array (zero rows outside the subset, gray images at NCC scale
too); the per-view statistics contribution equals the JAX DP step's
formula, and its accumulation the single-view update bit for bit. In a
one-rank gloo group the DP step, which runs the collectives, is bit-equal
to the single-view step, and the DP trainer to the plain trainer.
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from gs2m_tpu.core.config import ModelConfig as JModel
from gs2m_tpu.core.config import OptimConfig as JOpt
from gs2m_tpu.data.scene import Scene as JScene
from gs2m_tpu.parallel import dp as jdp
from gs2m_tpu_torch.core.config import ModelConfig as TModel
from gs2m_tpu_torch.core.config import OptimConfig as TOpt
from gs2m_tpu_torch.core.config import PipelineConfig as TPipe
from gs2m_tpu_torch.data.scene import Scene as TScene
from gs2m_tpu_torch.parallel import dp as tdp
from gs2m_tpu_torch.train import densify as TD
from gs2m_tpu_torch.train import optim as TO
from gs2m_tpu_torch.train import trainer as TT

from tests.test_torch_core import port_gaussians

torch.set_num_threads(1)

OPT_KW = dict(multi_view_max_angle=179.0, multi_view_max_dist=100.0,
              nearby_cam_max_angle=179.0, nearby_cam_max_dist=100.0,
              multi_view_sample_num=300, geometry_from_iter=2,
              densify_from_iter=2, densification_interval=3)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    from tests.make_synthetic_scene import build
    return build(str(tmp_path_factory.mktemp("dp") / "scene"), n_views=6,
                 width=48, height=32, n_points=150)


@contextlib.contextmanager
def world_of_one():
    """A one-rank gloo group in this process (an in-memory store)."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("V,P", [(49, 4), (64, 8), (7, 3), (5, 8)])
def test_partition_views_matches_jax(V, P):
    parts = [tdp.partition_views(V, p, P) for p in range(P)]
    for p, part in enumerate(parts):
        np.testing.assert_array_equal(part, jdp.partition_views(V, p, P))
    allv = np.concatenate(parts)
    assert sorted(allv.tolist()) == list(range(V))
    assert max(map(len, parts)) - min(map(len, parts)) <= 1


@pytest.mark.parametrize("P", [2, 3])
def test_host_view_closure_matches_jax(scene_dir, P):
    kw = dict(OPT_KW, multi_view_max_angle=80.0, nearby_cam_max_angle=80.0)
    ts = TScene(TModel(source_path=scene_dir), TOpt(**kw), load_images=False,
                device="cpu")
    tables = (ts.nearest_table, ts.nearest_mask, ts.nearby_table,
              ts.nearby_mask)
    for p in range(P):
        local = tdp.partition_views(len(ts.train_cameras), p, P)
        got = tdp.host_view_closure(local, *tables)
        np.testing.assert_array_equal(got, jdp.host_view_closure(
            local, *(jnp.asarray(t) for t in tables)))
        assert set(local.tolist()) <= set(got.tolist())


@pytest.mark.parametrize("resolution", [1, 2], ids=["r1", "r2_ncc_scale"])
def test_scene_subset_loading_matches_jax(scene_dir, resolution):
    kw = dict(source_path=scene_dir, resolution=resolution)
    subset = [1, 4]
    js = JScene(JModel(**kw), load_images=False)
    js.training_setup(JOpt(**OPT_KW))
    js.load_train_image_subset(subset)
    ts = TScene(TModel(**kw), load_images=False, device="cpu")
    ts.training_setup(TOpt(**OPT_KW))
    ts.load_train_image_subset(subset)
    assert ts.ncc_scale == js.ncc_scale == 1.0 / resolution
    for name in ("gt_images", "alpha_masks", "gray_images"):
        a, b = getattr(ts, name).numpy(), np.asarray(getattr(js, name))
        np.testing.assert_array_equal(a, b, err_msg=name)
        rest = [v for v in range(a.shape[0]) if v not in subset]
        if name == "alpha_masks":    # the scene has no masks: ones
            assert (a == 1.0).all()
        else:
            assert (a[rest] == 0.0).all() and (a[subset] != 0.0).any(), name
    full = TScene(TModel(**kw), TOpt(**OPT_KW), device="cpu")
    for name in ("gt_images", "gray_images"):
        torch.testing.assert_close(getattr(ts, name)[subset],
                                   getattr(full, name)[subset], rtol=0, atol=0)


def test_stats_contribution_and_its_sum():
    rng = np.random.default_rng(4)
    C, W, H = 64, 48, 32
    views = []
    for _ in range(2):
        sink = rng.normal(size=(C, 2)).astype(np.float32) * 1e-3
        views.append(dict(sink=sink, abs_sink=np.abs(sink) * 1.5,
                          vis=rng.uniform(size=C) > 0.3,
                          radii=rng.integers(0, 30, C).astype(np.int32),
                          obs=rng.integers(0, 3, C).astype(np.int32)))
    contribs = []
    for v in views:
        c = TD.stats_contribution(*(torch.from_numpy(v[k]) for k in (
            "sink", "abs_sink", "vis", "radii", "obs")), W, H)
        # The JAX DP step's per-view terms (gs2m_tpu/parallel/dp.py:126-136).
        scale = jnp.array([0.5 * W, 0.5 * H])
        for got, x in ((c.accum, v["sink"]), (c.accum_abs, v["abs_sink"])):
            want = jnp.linalg.norm(jnp.asarray(x) * scale, axis=-1) * v["vis"]
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-9)
        np.testing.assert_array_equal(c.denom.numpy(), v["vis"].astype(
            np.float32))
        np.testing.assert_array_equal(c.max_radii2d.numpy(), (
            v["radii"] * ((v["obs"] > 0) & v["vis"])).astype(np.float32))
        contribs.append(c)
    # One view: accumulate(contribution) is update_stats, bit for bit.
    stats = TD.DensifyStats(**{k: torch.from_numpy(
        rng.uniform(0, 1, C).astype(np.float32)) for k in (
        "accum", "accum_abs", "denom", "max_radii2d")})
    v = views[0]
    a = TD.update_stats(stats, *(torch.from_numpy(v[k]) for k in (
        "sink", "abs_sink", "vis", "radii", "obs")), W, H)
    b = TD.accumulate_stats(stats, contribs[0])
    for k in ("accum", "accum_abs", "denom", "max_radii2d"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    # Two views: sums and a max of the two contributions.
    both = TD.DensifyStats(
        accum=contribs[0].accum + contribs[1].accum,
        accum_abs=contribs[0].accum_abs + contribs[1].accum_abs,
        denom=contribs[0].denom + contribs[1].denom,
        max_radii2d=torch.maximum(contribs[0].max_radii2d,
                                  contribs[1].max_radii2d))
    two = TD.accumulate_stats(TD.DensifyStats.zeros(C, "cpu"), both)
    assert float(two.denom.max()) <= 2.0
    assert torch.equal(two.max_radii2d, both.max_radii2d)


@pytest.fixture(scope="module")
def scene(scene_dir):
    return TScene(TModel(source_path=scene_dir, resolution=1, sh_degree=1),
                  TOpt(**OPT_KW), device="cpu")


@pytest.mark.parametrize("geometry", [False, True], ids=["warmup", "geometry"])
def test_world_of_one_dp_step_equals_the_step(scene, geometry):
    from tests.test_torch_train import random_gaussians
    g = random_gaussians(7, n=120, capacity=256, sh=1)
    outs = []
    for data_parallel in (False, True):
        tg = port_gaussians(g)
        state = TO.adam_init(tg.params_dict())
        args = (tg, state, TD.DensifyStats.zeros(256, "cpu"), 2, 4, True, 1,
                1, torch.Generator().manual_seed(3))
        if data_parallel:
            with world_of_one():
                step = tdp.make_dp_train_step(
                    TModel(sh_degree=1), TPipe(chunk=64), TOpt(**OPT_KW),
                    scene, 2 ** 13, geometry)
                outs.append(step(*args))
        else:
            outs.append(TT.make_train_step(
                TModel(sh_degree=1), TPipe(chunk=64), TOpt(**OPT_KW), scene,
                2 ** 13, geometry)(*args))
    (ga, sa, ta, ma), (gb, sb, tb, mb) = outs
    for k, v in ga.params_dict().items():
        assert torch.equal(v, gb.params_dict()[k]), k
        assert torch.equal(sa.mu[k], sb.mu[k]) and torch.equal(sa.nu[k],
                                                               sb.nu[k]), k
    for k in ("accum", "accum_abs", "denom", "max_radii2d"):
        assert torch.equal(getattr(ta, k), getattr(tb, k)), k
    for k in ("loss", "Lrgb", "Lgeo", "Lmat", "dropped"):
        assert torch.equal(torch.as_tensor(ma[k]), torch.as_tensor(mb[k])), k
    assert int(mb["mv_active"]) == ma["mv_active"] == int(geometry)


def test_world_of_one_dp_trainer_equals_the_trainer(scene):
    def run(data_parallel):
        tr = TT.Trainer(TModel(sh_degree=1), TPipe(chunk=64), TOpt(**OPT_KW),
                        scene, seed=2, data_parallel=data_parallel)
        for _ in range(6):
            tr.train_step()
        return tr

    a = run(False)
    with world_of_one():
        b = run(True)
        assert (b.rank, b.n_devices) == (0, 1)
    assert a.last_densify_info == b.last_densify_info is not None
    assert a.mv_active_count == b.mv_active_count > 0
    for k, v in a.gaussians.params_dict().items():
        assert torch.equal(v, b.gaussians.params_dict()[k]), k
    assert torch.equal(a.stats.accum, b.stats.accum)
    assert torch.equal(a.last_metrics["loss"], b.last_metrics["loss"])
