"""Port vs JAX package: the training side — Gaussians.create and knn,
the optimizer, densification, the scene's training state, one train step
of each stage, the trim's observe counter, and the train app end to end.

Optimizer and densification states are compared element for element
(allclose rtol 1e-6, atol 1e-6: the split offset's 3-term dot product sums
in another order) on the same inputs, with the JAX package's split
noise injected. One train step: the loss at rtol 1e-5; the gradients (read
back from Adam's first moment, mu = 0.1 g) at the distributional gate of
scripts/check_grads_onchip.py; the updated parameters equal wherever the
gradient is well-conditioned (there Adam's first step is lr * sign(g)).
The geometry step runs with lambda_multi_view = 0: that term's pixel draw
comes from a random stream the two frameworks do not share (its
agreement with the draw injected is tests/test_torch_losses.py's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2m_tpu.core.config import ModelConfig as JModel
from gs2m_tpu.core.config import OptimConfig as JOpt
from gs2m_tpu.core.config import PipelineConfig as JPipe
from gs2m_tpu.core.gaussians import Gaussians as JGaussians
from gs2m_tpu.data.scene import Scene as JScene
from gs2m_tpu.ops.knn import mean_sq_dist_to_3nn as jknn
from gs2m_tpu.train import densify as JD
from gs2m_tpu.train import optim as JO
from gs2m_tpu.train import trainer as JT
from gs2m_tpu_torch.core.config import ModelConfig as TModel
from gs2m_tpu_torch.core.config import OptimConfig as TOpt
from gs2m_tpu_torch.core.config import PipelineConfig as TPipe
from gs2m_tpu_torch.core.gaussians import Gaussians as TGaussians
from gs2m_tpu_torch.data.scene import Scene as TScene
from gs2m_tpu_torch.ops.knn import mean_sq_dist_to_3nn as tknn
from gs2m_tpu_torch.train import densify as TD
from gs2m_tpu_torch.train import optim as TO
from gs2m_tpu_torch.train import trainer as TT
from gs2m_tpu_torch.utils.grad_gate import DEFAULT_TOL, TOLERANCES, grad_gate

from tests.test_torch_core import port_gaussians

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(a, b, name="", rtol=1e-6):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, name
    if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
        np.testing.assert_array_equal(a, b, err_msg=name)
    else:
        np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-6, err_msg=name)


def random_gaussians(seed, n=40, capacity=64, sh=1):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    g = JGaussians.create(pts, cols, sh, capacity,
                          mean_sq_dist=rng.uniform(1e-4, 0.05, n))
    p = {k: np.array(v) for k, v in g.params_dict().items()}
    p["rotation"][:n] += rng.normal(size=(n, 4)).astype(np.float32)
    p["opacity"][:n] = rng.normal(size=(n, 1)).astype(np.float32) * 3
    p["scaling"][:n] += rng.normal(size=(n, 3)).astype(np.float32)
    return g.with_params({k: jnp.asarray(v) for k, v in p.items()})


def random_adam(params, seed, count=3):
    rng = np.random.default_rng(seed)
    mu = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
    nu = {k: rng.uniform(0.1, 1, v.shape).astype(np.float32)
          for k, v in params.items()}
    j = JO.AdamState(mu={k: jnp.asarray(v) for k, v in mu.items()},
                     nu={k: jnp.asarray(v) for k, v in nu.items()},
                     count=jnp.int32(count))
    t = TO.AdamState(mu={k: _t(v) for k, v in mu.items()},
                     nu={k: _t(v) for k, v in nu.items()}, count=count)
    return j, t


def random_stats(C, seed):
    rng = np.random.default_rng(seed)
    a = {"accum": rng.uniform(0, 2e-3, C), "accum_abs": rng.uniform(0, 5e-3, C),
         "denom": rng.integers(0, 3, C), "max_radii2d": rng.uniform(0, 40, C)}
    a = {k: v.astype(np.float32) for k, v in a.items()}
    return (JD.DensifyStats(**{k: jnp.asarray(v) for k, v in a.items()}),
            TD.DensifyStats(**{k: _t(v) for k, v in a.items()}))


def compare_state(jg, tg, jstate, tstate, jstats=None, tstats=None):
    for k, v in jg.params_dict().items():
        _eq(tg.params_dict()[k], v, k)
    _eq(tg.alive, jg.alive, "alive")
    for k in jstate.mu:
        _eq(tstate.mu[k], jstate.mu[k], f"mu/{k}")
        _eq(tstate.nu[k], jstate.nu[k], f"nu/{k}")
    assert tstate.count == int(jstate.count)
    if jstats is not None:
        for f in ("accum", "accum_abs", "denom", "max_radii2d"):
            _eq(getattr(tstats, f), getattr(jstats, f), f)


def test_create_and_knn_match_jax():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(200, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (200, 3)).astype(np.float32)
    np.testing.assert_array_equal(tknn(pts), np.asarray(jknn(pts)))
    np.testing.assert_array_equal(tknn(pts[:3]), np.asarray(jknn(pts[:3])))
    jg = JGaussians.create(pts, cols, 2, capacity=256)
    tg = TGaussians.create(pts, cols, 2, capacity=256, device="cpu")
    for k, v in jg.params_dict().items():
        np.testing.assert_array_equal(tg.params_dict()[k].numpy(),
                                      np.asarray(v), err_msg=k)
    assert torch.equal(tg.alive, _t(jg.alive))
    jp = JD.prune_init_points(jg)
    tp = TD.prune_init_points(tg)
    _eq(tp.alive, jp.alive, "prune_init_points")


def test_adam_and_schedules_match_jax():
    g = random_gaussians(1)
    jp = g.params_dict()
    tp = {k: _t(v) for k, v in jp.items()}
    js, ts = random_adam(jp, 2)
    opt = JOpt()
    jsched = JO.xyz_lr_schedule(opt, 3.7)
    tsched = TO.xyz_lr_schedule(TOpt(), 3.7)
    for it in (1, 2, 3):
        grads = {k: np.random.default_rng(it).normal(size=v.shape).astype(
            np.float32) for k, v in jp.items()}
        assert tsched(it) == float(jsched(jnp.int32(it)))
        jl = JO.group_lrs(opt, 3.7, jsched(jnp.int32(it)))
        tl = TO.group_lrs(TOpt(), 3.7, tsched(it))
        assert set(jl) == set(tl)
        jp, js = JO.adam_update(jp, {k: jnp.asarray(v) for k, v in grads.items()},
                                js, jl)
        TO.adam_update(tp, {k: _t(v) for k, v in grads.items()}, ts, tl)
    for k in jp:
        _eq(tp[k], jp[k], k)
        _eq(ts.mu[k], js.mu[k], f"mu/{k}")
        _eq(ts.nu[k], js.nu[k], f"nu/{k}")
    for step in (0, 10, 1000, 29_999, 40_000):
        np.testing.assert_allclose(
            TO.expon_lr(step, 1e-2, 1e-4, 100, 0.1, 30_000),
            float(JO.expon_lr(jnp.int32(step), 1e-2, 1e-4, 100, 0.1, 30_000)),
            rtol=1e-6)


@pytest.mark.parametrize("case", ["fits", "overflow", "radii"])
def test_densify_and_prune_matches_jax(case):
    capacity = {"fits": 128, "overflow": 48, "radii": 128}[case]
    g = random_gaussians(3, n=40, capacity=capacity)
    C = g.capacity
    js, ts = random_adam(g.params_dict(), 4)
    jst, tst = random_stats(C, 5)
    key = jax.random.PRNGKey(7)
    noise = np.asarray(jax.random.normal(key, (C, 3), jnp.float32))
    kw = dict(grad_threshold=2e-4, grad_abs_threshold=8e-4, min_opacity=0.05,
              extent=4.0, percent_dense=0.05, radii2d_threshold=20.0,
              use_radii_threshold=case == "radii")
    jg2, js2, jst2, jinfo = JD.densify_and_prune(g, js, jst, key, **kw)
    tg2, ts2, tst2, tinfo = TD.densify_and_prune(port_gaussians(g), ts, tst,
                                                 noise=_t(noise), **kw)
    compare_state(jg2, tg2, js2, ts2, jst2, tst2)
    info = {k: int(v) for k, v in tinfo.items()}
    assert info == {k: int(v) for k, v in jinfo.items()}
    assert info["cloned"] > 0 and info["split"] > 0 and info["pruned"] > 0
    if case == "overflow":
        assert info["dropped_children"] > 0


def test_row_surgery_matches_jax():
    g = random_gaussians(6, n=30, capacity=40)
    C = g.capacity
    js, ts = random_adam(g.params_dict(), 8)
    jst, tst = random_stats(C, 9)
    tg = port_gaussians(g)
    for cap in (0.01, 0.8):
        jg2, js2 = JD.reset_opacity(g, js, cap=cap)
        _, ts2 = random_adam(g.params_dict(), 8)
        tg2, ts2 = TD.reset_opacity(tg, ts2, cap=cap)
        compare_state(jg2, tg2, js2, ts2)
    mask = np.random.default_rng(1).uniform(size=C) < 0.3
    jg2, js2, _ = JD.prune_rows(g, js, jst, jnp.asarray(mask))
    tg2, ts2, _ = TD.prune_rows(tg, ts, tst, _t(mask))
    compare_state(jg2, tg2, js2, ts2)
    jg3, js3, jst3 = JD.grow_capacity(jg2, js2, jst, 64)
    tg3, ts3, tst3 = TD.grow_capacity(tg2, ts2, tst, 64)
    compare_state(jg3, tg3, js3, ts3, jst3, tst3)
    rng = np.random.default_rng(2)
    sink = rng.normal(size=(64, 2)).astype(np.float32) * 1e-3
    abs_sink = np.abs(sink) * 2
    vis = rng.uniform(size=64) > 0.3
    radii = rng.integers(0, 30, 64).astype(np.int32)
    obs = rng.integers(0, 3, 64).astype(np.int32)
    ju = JD.update_stats(jst3, sink, abs_sink, vis, radii, obs, 64, 48)
    tu = TD.update_stats(tst3, _t(sink), _t(abs_sink), _t(vis), _t(radii),
                         _t(obs), 64, 48)
    for f in ("accum", "accum_abs", "denom", "max_radii2d"):
        _eq(getattr(tu, f), getattr(ju, f), f)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    from tests.make_synthetic_scene import build
    return build(str(tmp_path_factory.mktemp("train") / "scene"), n_views=5,
                 width=64, height=48, n_points=200)


# Neighbor thresholds widened for the ring of synthetic cameras.
OPT_KW = dict(multi_view_max_angle=179.0, multi_view_max_dist=100.0,
              nearby_cam_max_angle=179.0, nearby_cam_max_dist=100.0,
              multi_view_sample_num=400)


@pytest.fixture(scope="module")
def scenes(scene_dir, tmp_path_factory):
    root = tmp_path_factory.mktemp("models")
    mk = lambda M, sub: M(source_path=scene_dir, model_path=str(root / sub),
                          resolution=1, sh_degree=1, eval=True)
    js = JScene(mk(JModel, "j"), JOpt(**OPT_KW))
    ts = TScene(mk(TModel, "t"), TOpt(**OPT_KW), device="cpu")
    return js, ts


def test_scene_training_side_matches_jax(scenes, scene_dir, tmp_path):
    js, ts = scenes
    for name in ("gt_images", "alpha_masks", "gray_images"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)), name)
    for name in ("nearest_table", "nearest_mask", "nearby_table", "nearby_mask"):
        np.testing.assert_array_equal(getattr(ts, name),
                                      np.asarray(getattr(js, name)), name)
    assert ts.ncc_scale == js.ncc_scale == 1.0
    assert ts.nearest_mask.any()
    for a, b in zip(ts.load_test_images(), js.load_test_images()):
        np.testing.assert_array_equal(a, np.asarray(b))
    # At -r 2 the gray images are read at full resolution (ncc_scale 0.5).
    kw = dict(source_path=scene_dir, resolution=2, eval=True)
    j2 = JScene(JModel(**kw), JOpt(**OPT_KW))
    t2 = TScene(TModel(**kw), TOpt(**OPT_KW), device="cpu")
    assert t2.ncc_scale == j2.ncc_scale == 0.5
    assert tuple(t2.gray_images.shape) == (4, 1, 48, 64)
    np.testing.assert_array_equal(t2.gray_images.numpy(),
                                  np.asarray(j2.gray_images))


@pytest.mark.parametrize("geometry", [False, True], ids=["warmup", "geometry"])
def test_train_step_matches_jax(scenes, geometry):
    js, ts = scenes
    opt_kw = dict(OPT_KW, lambda_multi_view=0.0)
    jopt, topt = JOpt(**opt_kw), TOpt(**opt_kw)
    pts, cols = js.info.points, js.info.colors
    g = JGaussians.create(pts, cols, 1, capacity=256)
    g = g.with_params(dict(g.params_dict(), opacity=g.opacity + 2.0))
    cap, view, it = 2 ** 13, 2, 1
    # Geometry: the JAX package's XLA twin (its Pallas backend fuses the two
    # renders into the pair core); warmup: its Pallas kernels.
    backend = "xla" if geometry else "pallas"
    jstep = JT.make_train_step(JModel(sh_degree=1), JPipe(chunk=64), jopt, js,
                               cap, geometry, False, backend=backend)
    key = jax.random.PRNGKey(11)
    k_nb = jax.random.split(jax.random.fold_in(key, it), 3)[0]
    nearest, has = JT._choose_neighbor(k_nb, js.nearest_table[view],
                                       js.nearest_mask[view], view)
    jst0 = JD.DensifyStats.zeros(256)
    jg2, jstate, jst, _, jm = jstep(
        g, JO.adam_init(g.params_dict()), jst0, js.gt_images, js.alpha_masks,
        js.gray_images, jnp.zeros(1), jnp.int32(view), key, jnp.int32(it), 1)

    tstep = TT.make_train_step(TModel(sh_degree=1), TPipe(chunk=64), topt, ts,
                               cap, geometry)
    tg = port_gaussians(g)
    tstate = TO.adam_init(tg.params_dict())
    tg2, tstate, tst, tm = tstep(tg, tstate, TD.DensifyStats.zeros(256, "cpu"),
                                 view, int(nearest), bool(has), it, 1)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["Lrgb"]), float(jm["Lrgb"]), rtol=1e-5)
    if geometry:
        assert float(tm["Lgeo"]) > 0
        np.testing.assert_allclose(float(tm["Lgeo"]), float(jm["Lgeo"]),
                                   rtol=1e-5)
    assert int(tm["dropped"]) == int(jm["dropped"]) == 0
    p0 = g.params_dict()
    for k, jmu in jstate.mu.items():
        gref = np.asarray(jmu) / 0.1                 # Adam's first moment
        got = tstate.mu[k].numpy() / 0.1
        rep = grad_gate(got, gref, TOLERANCES.get(k, DEFAULT_TOL))
        assert rep["pass"], (k, rep)
        wc = np.abs(gref) >= 1e-2 * np.abs(gref).max()
        d_t = tg2.params_dict()[k].detach().numpy() - np.asarray(p0[k])
        d_j = np.asarray(jg2.params_dict()[k]) - np.asarray(p0[k])
        np.testing.assert_allclose(d_t[wc], d_j[wc], rtol=1e-3, err_msg=k)
    _eq(tst.denom, jst.denom, "denom")
    _eq(tst.max_radii2d, jst.max_radii2d, "max_radii2d")
    rep = grad_gate(tst.accum.numpy(), jst.accum)
    assert rep["pass"], ("accum", rep)
    if not geometry:  # the XLA twin has no AbsGS channel
        rep = grad_gate(tst.accum_abs.numpy(), jst.accum_abs)
        assert rep["pass"], ("accum_abs", rep)


def test_observe_counter_and_trainer_setup_match_jax(scenes):
    js, ts = scenes
    jopt, topt = JOpt(**OPT_KW), TOpt(**OPT_KW)
    jt = JT.Trainer(JModel(sh_degree=1), JPipe(chunk=64), jopt, js)
    tt = TT.Trainer(TModel(sh_degree=1), TPipe(chunk=64), topt, ts)
    assert tt.instance_cap == jt.instance_cap
    for k, v in jt.gaussians.params_dict().items():
        np.testing.assert_array_equal(tt.gaussians.params_dict()[k].numpy(),
                                      np.asarray(v), err_msg=k)
    assert torch.equal(tt.gaussians.alive, _t(jt.gaussians.alive))
    g = jt.gaussians
    g = g.with_params(dict(g.params_dict(), opacity=g.opacity + 2.0))
    jcount = JT.make_observe_counter(js, JPipe(chunk=64), 2 ** 13,
                                     backend="pallas")
    tcount = TT.make_observe_counter(ts, TPipe(chunk=64), 2 ** 13)
    jc, jd = jcount(g, 0)
    tc, td = tcount(port_gaussians(g))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert int(td) == int(jd) == 0 and int(tc.max()) >= 2


def test_train_app_then_render_app(scene_dir, tmp_path):
    """The CLI trains on the CPU through warmup and geometry with one
    densification, writes a snapshot, and the port's render app reads it."""
    from gs2m_tpu_torch.apps import render as render_app
    from gs2m_tpu_torch.apps import train as train_app

    model = tmp_path / "model"
    argv = ["-s", scene_dir, "-m", str(model), "--device", "cpu", "--chunk",
            "64", "--sh_degree", "1", "--eval", "--iterations", "8",
            "--geometry_from_iter", "4", "--densify_from_iter", "2",
            "--densification_interval", "5", "--test_iterations", "8",
            "--save_iterations", "8", "--quiet"]
    for k, v in OPT_KW.items():
        argv += [f"--{k}", str(v)]
    trainer = train_app.main(argv)
    assert trainer.iteration == 8
    assert trainer.last_densify_info is not None
    assert trainer.mv_active_count > 0
    assert np.isfinite(float(trainer.last_metrics["loss"]))
    assert int(trainer.last_metrics["dropped"]) == 0
    assert np.isfinite(trainer.last_eval["psnr"])
    snap = model / "point_cloud" / "iteration_8" / "point_cloud.ply"
    assert snap.exists() and (model / "cfg_args.json").exists()
    stats = render_app.main(["-m", str(model), "--device", "cpu"])["views"]
    assert stats and all(s["finite"] and s["dropped"] == 0 for s in stats)
    assert (model / "test" / "ours_8" / "render").is_dir()


@pytest.fixture(scope="module")
def plain_app_run(scene_dir, tmp_path_factory):
    """The train app without data parallelism: 4 iterations (2 warmup, 2
    geometry with a densification), the reference of the world-of-one
    data-parallel runs."""
    from gs2m_tpu_torch.apps import train as train_app
    return train_app.main(_short_app_argv(
        scene_dir, tmp_path_factory.mktemp("plain") / "model"))


def _short_app_argv(scene_dir, model):
    argv = ["-s", scene_dir, "-m", str(model), "--device", "cpu", "--chunk",
            "64", "--sh_degree", "1", "--iterations", "4",
            "--geometry_from_iter", "2", "--densify_from_iter", "1",
            "--densification_interval", "3", "--test_iterations", "99",
            "--save_iterations", "4", "--quiet"]
    for k, v in OPT_KW.items():
        argv += [f"--{k}", str(v)]
    return argv


# A plain launch (no torchrun environment) is a world of one: the
# data-parallel trainer runs the single-view step bit for bit.
@pytest.mark.parametrize("flags", [["--data_parallel"],
                                   ["--data_parallel", "--distributed"]])
def test_train_app_data_parallel_world_of_one(scene_dir, tmp_path, flags,
                                              plain_app_run):
    from gs2m_tpu_torch.apps import train as train_app
    tr = train_app.main(_short_app_argv(scene_dir, tmp_path / "m") + flags)
    ref = plain_app_run
    assert (tr.n_devices, tr.rank, tr.iteration) == (1, 0, 4)
    assert tr.last_densify_info == ref.last_densify_info is not None
    assert tr.mv_active_count == ref.mv_active_count > 0
    assert torch.equal(tr.last_metrics["loss"], ref.last_metrics["loss"])
    for k, v in ref.gaussians.params_dict().items():
        assert torch.equal(tr.gaussians.params_dict()[k], v), k
    assert torch.equal(tr.stats.accum, ref.stats.accum)
    assert (tmp_path / "m" / "point_cloud" / "iteration_4").is_dir()


def test_train_app_default_device_raises_without_cuda(scene_dir, tmp_path,
                                                      monkeypatch):
    from gs2m_tpu_torch.apps import train as train_app
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_app.main(["-s", scene_dir, "-m", str(tmp_path)])
