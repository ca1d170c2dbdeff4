"""Port vs JAX package: the binning termination cut (`term_cut`) and its
split caps (`expand_cap`).

The layout: the port's bin_gaussians(term_cut=True) against the JAX
package's on the four cases of tests/test_binning_fuzz.py (both bin the
same Projected, carried over). The cut's own contract in the port: every
tile's cut segment is a prefix of its base segment and the blend on the cut
layout equals the blend on the base layout. The render: the scene of
tests/test_pallas.py::test_pair_term_cut_exact through the port's render()
with and without the cut, and against the JAX package's
render_pair(term_cut=True) (Pallas in interpret mode).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2m_tpu.ops.binning import bin_gaussians as jbin
from gs2m_tpu.ops.binning import num_tiles
from gs2m_tpu.ops.projection import project as jproject
from gs2m_tpu_torch.ops.binning import bin_gaussians as tbin
from gs2m_tpu_torch.ops.blend import blend_tiles
from gs2m_tpu_torch.ops.projection import Projected as TProjected
from gs2m_tpu_torch.ops.rasterize import build_features, pack_values
from gs2m_tpu_torch.utils.grad_gate import DEFAULT_TOL, TOLERANCES, grad_gate

from tests.test_golden import make_camera, make_scene
from tests.test_torch_core import camera_pair, port_gaussians

torch.set_num_threads(1)

FIELDS = ("gid", "is_null", "chunk_tile", "tile_nonempty", "num_aligned",
          "dropped", "dropped_expand")


def fuzz_case(seed, n, opaque, cap_slack):
    """tests/test_binning_fuzz.py::test_term_cut_is_prefix_of_base_layout's
    scene and caps: the JAX Projected, its port copy, the opacities and
    (H, W, tile, chunk, base cap, cut cap, expand cap)."""
    rng = np.random.default_rng(seed)
    H, W, tile, chunk = 72, 56, 16, 32
    cam = make_camera(width=W, height=H)
    g = make_scene(rng, n=n, capacity=max(n, 64), random_pose=True)
    if opaque:
        g = dataclasses.replace(
            g, opacity=jnp.full_like(g.opacity, float(np.log(9.0))),
            scaling=jnp.full_like(g.scaling, float(np.log(0.55))))
    opac = jnp.minimum(g.get_opacity[:, 0], 0.99)
    jp = jproject(g, cam, g.max_sh_degree, opacities=opac)
    tp = TProjected(*[torch.from_numpy(np.array(x)) for x in jp])
    T = num_tiles(H, W, tile)[0] * num_tiles(H, W, tile)[1]
    demand = int(np.asarray(jp.tiles_touched).sum())
    IE = max(int(-(-demand // chunk)) * chunk + chunk, 2 * chunk)
    IB = IE + T * chunk
    I = max(int(-(-int(demand * cap_slack) // chunk)) * chunk, 2 * chunk)
    return (g, cam, jp, tp, opac, torch.from_numpy(np.array(opac)),
            (H, W, tile, chunk, IB, I, IE, T))


CASES = [(10, 120, True, 8.0),    # dense opaque: the cut fires
         (11, 120, False, 8.0),   # translucent: cut mostly idle
         (12, 160, True, 1.0),    # tight aligned cap: alignment overflow + cut
         (13, 60, True, 8.0)]     # sparse


@pytest.mark.parametrize("seed,n,opaque,cap_slack", CASES)
def test_term_cut_layout_matches_jax(seed, n, opaque, cap_slack):
    g, cam, jp, tp, jop, top, dims = fuzz_case(seed, n, opaque, cap_slack)
    H, W, tile, chunk, IB, I, IE, T = dims
    jb = jbin(jp, H, W, tile, I, chunk, opacities=jop, term_cut=True,
              expand_cap=IE, with_present=False)
    tb = tbin(tp, H, W, tile, I, chunk, top, with_present=False,
              term_cut=True, expand_cap=IE)
    for name in FIELDS + ("num_instances", "gauss_offset", "gauss_live",
                          "gauss_present"):
        a, b = np.asarray(getattr(jb, name)), getattr(tb, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    if opaque and n >= 120 and cap_slack > 1:
        base = tbin(tp, H, W, tile, IB, chunk, top)
        assert int(tb.num_aligned) < int(base.num_aligned)


@pytest.mark.parametrize("seed,n,opaque,cap_slack", CASES)
def test_num_kept_counts_the_laid_out_instances(seed, n, opaque, cap_slack):
    """`num_kept`, the instances the per-tile cull (and the cut) keep: the
    per-Gaussian counts summed, and the layout's non-null slots where
    nothing drops."""
    g, cam, jp, tp, jop, top, dims = fuzz_case(seed, n, opaque, cap_slack)
    H, W, tile, chunk, IB, I, IE, T = dims
    base = tbin(tp, H, W, tile, IB, chunk, top)
    cut = tbin(tp, H, W, tile, I, chunk, top, with_present=False,
               term_cut=True, expand_cap=IE)
    laid = int((~base.is_null).sum())
    assert int(base.num_kept) == int(base.gauss_present.sum()) == laid
    assert 0 < int(base.num_kept) <= int(base.num_instances)
    laid = int((~cut.is_null).sum())
    if int(cut.dropped) == 0:
        assert int(cut.num_kept) == laid
    else:
        assert int(cut.num_kept) >= laid
    assert int(cut.num_kept) <= int(base.num_kept)
    if opaque and n >= 120 and cap_slack > 1:
        assert int(cut.num_kept) < int(base.num_kept)


@pytest.mark.parametrize("seed,n,opaque,cap_slack", CASES)
def test_term_cut_is_prefix_and_blend_exact(seed, n, opaque, cap_slack):
    """The cut's contract, in the port: each tile's aligned segment is a
    prefix of the base layout's, and the blend (the plain versions of K1
    and, through autograd, K2) on the cut layout equals the blend on the
    base layout, outputs and gradients."""
    g, cam, jp, tp, jop, top, dims = fuzz_case(seed, n, opaque, cap_slack)
    H, W, tile, chunk, IB, I, IE, T = dims
    tc = camera_pair(W, H)[1]
    base = tbin(tp, H, W, tile, IB, chunk, top)
    cut = tbin(tp, H, W, tile, I, chunk, top, with_present=False,
               term_cut=True, expand_cap=IE)
    assert int(base.dropped) == 0
    clipped = int(cut.dropped) > 0
    bct = np.repeat(base.chunk_tile.numpy(), chunk)
    cct = np.repeat(cut.chunk_tile.numpy(), chunk)
    bgid, bnull = base.gid.numpy(), base.is_null.numpy()
    cgid, cnull = cut.gid.numpy(), cut.is_null.numpy()
    for t in range(T):
        bseg = bgid[(bct == t) & ~bnull]
        cseg = cgid[(cct == t) & ~cnull]
        assert len(cseg) <= len(bseg), t
        if not clipped:
            np.testing.assert_array_equal(cseg, bseg[:len(cseg)],
                                          err_msg=f"tile {t}")
    if clipped:
        return
    tg = port_gaussians(g)
    feats = build_features(tg, tc)
    vals = pack_values(tp.colors, feats, 5).detach()
    outs = []
    for b in (base, cut):
        leaves = [x.clone().requires_grad_(True)
                  for x in (vals, tp.means2d, tp.conics, top)]
        o = blend_tiles(*leaves, b, H, W, tile, chunk)
        w = torch.linspace(-1, 1, o.image.numel()).reshape(o.image.shape)
        loss = (o.image * w).sum() + (o.final_T ** 2).sum()
        outs.append((o, torch.autograd.grad(loss, leaves)))
    (o0, g0), (o1, g1) = outs
    assert torch.equal(o1.image, o0.image)
    assert torch.equal(o1.final_T, o0.final_T)
    assert torch.equal(o1.observe, o0.observe)
    for a, b in zip(g1, g0):
        assert torch.equal(a, b)


def pair_scene():
    """tests/test_pallas.py::test_pair_term_cut_exact's scene: 3,000 opaque
    (0.9) splats of scale 0.25 at 64x48, and two cameras, in both
    packages."""
    from gs2m_tpu.core.camera import Camera as JCamera
    from gs2m_tpu.core.gaussians import Gaussians as JGaussians
    from gs2m_tpu_torch.core.camera import Camera as TCamera

    rng = np.random.default_rng(23)
    n = 3000
    pts = np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-0.9, 0.9, n),
                    rng.uniform(-0.6, 0.6, n)], -1).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    g = JGaussians.create(pts, cols, 2, capacity=4096)
    g = dataclasses.replace(
        g, opacity=jnp.full_like(g.opacity, float(np.log(0.9 / 0.1))),
        scaling=jnp.full_like(g.scaling, float(np.log(0.25))))
    h, w = 48, 64
    ja, ta = camera_pair(w, h)
    th = 0.3
    R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                  [-np.sin(th), 0, np.cos(th)]], np.float32)
    kw = dict(fovx=0.9, fovy=0.7, width=w, height=h)
    T = np.array([0.2, 0.0, 4.0])
    return (g, (ja, JCamera.create(R, T, **kw)),
            (ta, TCamera.create(R, T, **kw, device="cpu")))


def cut_kw(term_cut):
    return dict(tile=16, chunk=64,
                instance_cap=2 ** 14 if term_cut else 2 ** 15,
                term_cut=term_cut, expand_cap=2 ** 15 if term_cut else None)


def port_pair(tg, cams, term_cut):
    """The port's geometry-step renders (main with sinks and Sobel normals,
    nearest without) and the JAX test's loss, with its leaf gradients."""
    from gs2m_tpu_torch.models.render import render

    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in tg.params_dict().items()}
    C = tg.capacity
    sink = torch.zeros(C, 2, requires_grad=True)
    abs_sink = torch.zeros(C, 2, requires_grad=True)
    g2 = tg.with_params(leaves)
    kw = cut_kw(term_cut)
    pkg = render(g2, cams[0], torch.zeros(3), 2, geometry_stage=True,
                 sobel_normal=True, m2d_sink=sink, m2d_abs_sink=abs_sink,
                 **kw)
    npkg = render(g2, cams[1], torch.zeros(3), 2, geometry_stage=True, **kw)
    loss = (torch.sum(pkg["render"] ** 2) + torch.sum(pkg["depth_map"] ** 2)
            + 0.3 * torch.sum(npkg["normal_map"] ** 2)
            + 0.7 * torch.sum(npkg["depth_map"]))
    names = list(leaves) + ["sink", "abs_sink"]
    grads = torch.autograd.grad(loss, list(leaves.values()) + [sink, abs_sink])
    return loss.detach(), pkg, npkg, dict(zip(names, grads))


MAPS = ("render", "depth_map", "normal_map", "alpha_map", "final_T")


def arr(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def test_render_term_cut_exact_and_matches_jax_pair():
    from gs2m_tpu.models.render import render_pair

    g, jcams, tcams = pair_scene()
    tg = port_gaussians(g)

    # The cut fires on this scene, in the port's binning.
    from gs2m_tpu_torch.ops.projection import project as tproj
    op = tg.get_opacity[:, 0]
    proj = tproj(tg, tcams[0], 2, op)
    b0 = tbin(proj, 48, 64, 16, 2 ** 15, 64, op)
    b1 = tbin(proj, 48, 64, 16, 2 ** 15, 64, op, with_present=False,
              term_cut=True)
    assert int(b0.dropped) == 0
    assert int(b1.num_aligned) < int(b0.num_aligned) * 0.8
    assert int(b1.num_aligned) <= 2 ** 14

    l0, p0, n0, g0 = port_pair(tg, tcams, False)
    l1, p1, n1, g1 = port_pair(tg, tcams, True)
    assert int(p1["dropped"]) == 0 and int(n1["dropped"]) == 0
    assert int(p1["aligned_demand"]) < int(p0["aligned_demand"])

    # The JAX package's pair render with the cut (Pallas, interpret mode).
    def jloss(params, sink, abs_sink):
        pkg, npkg = render_pair(g.with_params(params), *jcams, jnp.zeros(3),
                                2, geometry_stage=True, sobel_normal=True,
                                m2d_sink=sink, m2d_abs_sink=abs_sink,
                                **cut_kw(True))
        loss = (jnp.sum(pkg["render"] ** 2) + jnp.sum(pkg["depth_map"] ** 2)
                + 0.3 * jnp.sum(npkg["normal_map"] ** 2)
                + 0.7 * jnp.sum(npkg["depth_map"]))
        return loss, (pkg, npkg)

    z = jnp.zeros((g.capacity, 2))
    (lj, (pj, nj)), gj = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(g.params_dict(), z, z)
    gj = dict(gj[0], sink=gj[1], abs_sink=gj[2])

    # Cut against uncut in the port: the JAX test's gates (the cut is exact,
    # and on the CPU the two are in fact bit-equal).
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-6)
    for view, a, b in (("main", p1, p0), ("nbr", n1, n0)):
        for key in MAPS:
            np.testing.assert_allclose(arr(a[key]), arr(b[key]), atol=1e-6,
                                       rtol=1e-5, err_msg=f"{view}:{key}")
        np.testing.assert_array_equal(arr(a["observe"]), arr(b["observe"]))
    for name, got in g1.items():
        ref = g0[name].numpy()
        np.testing.assert_allclose(got.numpy(), ref,
                                   atol=5e-6 * (np.abs(ref).max() + 1e-12),
                                   rtol=1e-5, err_msg=name)

    # The port's cut against JAX's: the port's own gates against the JAX
    # package (tests/test_torch_render.py's maps, test_torch_render_grad's
    # loss and gradient gate); observe counts equal.
    np.testing.assert_allclose(float(l1), float(lj), rtol=1e-5)
    for view, a, b in (("main", p1, pj), ("nbr", n1, nj)):
        for key in MAPS:
            np.testing.assert_allclose(arr(a[key]), arr(b[key]), atol=1e-5,
                                       rtol=1e-4, err_msg=f"{view}:{key}")
        np.testing.assert_array_equal(arr(a["observe"]), arr(b["observe"]))
    for name, got in g1.items():
        rep = grad_gate(got.numpy(), np.asarray(gj[name]),
                        TOLERANCES.get(name, DEFAULT_TOL))
        assert rep["pass"], (name, rep)


# --- the trainer's split caps -------------------------------------------------

TRAIN_OPT = dict(multi_view_max_angle=179.0, multi_view_max_dist=100.0,
                 nearby_cam_max_angle=179.0, nearby_cam_max_dist=100.0,
                 multi_view_sample_num=300)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    from tests.make_synthetic_scene import build
    return build(str(tmp_path_factory.mktemp("cut") / "scene"), n_views=4,
                 width=48, height=32, n_points=150)


def injected_windows(n_iters=600, seed=5):
    """Per-step (dropped, dropped_expand, aligned_demand) for six
    100-iteration windows: a small aligned demand (the cap shrinks), an
    expansion overflow, an aligned overflow, a larger demand (shrinks
    again), a demand near the cap (stays), both overflows at once."""
    rng = np.random.default_rng(seed)
    out = []
    for it in range(1, n_iters + 1):
        w = (it - 1) // 100
        aligned = int(rng.integers(*[(1000, 2000), (1500, 2500), (2000, 3000),
                                     (30_000, 50_000), (55_000, 60_000),
                                     (1000, 2000)][w]))
        dropped = expand = 0
        if it % 100 == 37:
            dropped, expand = [(0, 0), (500, 500), (3000, 0), (0, 0), (0, 0),
                               (2000, 1500)][w]
        out.append((dropped, expand, aligned))
    return out


def test_split_cap_rule_matches_jax(scene_dir, tmp_path):
    """The 100-iteration rule on the same injected windows: the port's
    (instance_cap, expand_cap) after every boundary equal the JAX
    trainer's (its steps and maintenance stubbed out in both)."""
    from gs2m_tpu.core.config import ModelConfig as JModel
    from gs2m_tpu.core.config import OptimConfig as JOpt
    from gs2m_tpu.core.config import PipelineConfig as JPipe
    from gs2m_tpu.data.scene import Scene as JScene
    from gs2m_tpu.train.trainer import Trainer as JTrainer
    from gs2m_tpu_torch.core.config import (ModelConfig, OptimConfig,
                                            PipelineConfig)
    from gs2m_tpu_torch.data.scene import Scene
    from gs2m_tpu_torch.train.trainer import Trainer

    opt_kw = dict(TRAIN_OPT, geometry_from_iter=0, iterations=1000)
    mk = lambda M, sub: M(source_path=scene_dir, model_path=str(tmp_path / sub),
                          resolution=1, sh_degree=1)
    jt = JTrainer(mk(JModel, "j"), JPipe(chunk=64, term_cut=True,
                                         compact_bwd=False),
                  JOpt(**opt_kw), JScene(mk(JModel, "j"), JOpt(**opt_kw)))
    tt = Trainer(mk(ModelConfig, "t"), PipelineConfig(chunk=64, term_cut=True),
                 OptimConfig(**opt_kw),
                 Scene(mk(ModelConfig, "t"), OptimConfig(**opt_kw),
                       device="cpu"))
    assert jt._term_cut and tt._term_cut
    assert (jt.instance_cap, jt.expand_cap) == (tt.instance_cap, tt.expand_cap)
    windows = injected_windows()

    def jstep(gaussians, opt_state, stats, *args):
        d, e, a = windows[jt.iteration - 1]
        return gaussians, opt_state, stats, None, {
            "dropped": jnp.int32(d), "dropped_expand": jnp.int32(e),
            "aligned_demand": jnp.int32(a), "bwd_live": jnp.int32(0),
            "mv_active": jnp.int32(0), "rough_active": jnp.int32(0)}

    def tstep(gaussians, opt_state, stats, *args, **kw):
        d, e, a = windows[tt.iteration - 1]
        i32 = lambda x: torch.tensor(x, dtype=torch.int32)
        return gaussians, opt_state, stats, {
            "loss": torch.zeros(()), "dropped": i32(d),
            "dropped_expand": i32(e), "aligned_demand": i32(a),
            "mv_active": 0, "rough_active": 0}

    jt._get_step = lambda *a: jstep
    tt._get_step = lambda *a: tstep
    jt._maintenance = tt._maintenance = lambda it: None
    seq = []
    for it in range(1, len(windows) + 1):
        jt.train_step()
        tt.train_step()
        if it % 100 == 0:
            seq.append((tt.instance_cap, tt.expand_cap))
            assert (jt.instance_cap, jt.expand_cap) == seq[-1], (it, seq)
    caps = [c for c, _ in seq]
    # Every branch of the rule was taken: shrink, expansion growth, aligned
    # growth, a second shrink, a hold, and both growths at once.
    assert caps[0] < tt.pipe.chunk * 4096 and caps[2] > caps[1] and \
        caps[3] < caps[2] and caps[4] == caps[3] and caps[5] > caps[4]
    assert seq[1][1] > seq[0][1] and seq[5][1] > seq[4][1]


def test_term_cut_off_under_data_parallel(scene_dir, tmp_path, capsys):
    from gs2m_tpu_torch.core.config import (ModelConfig, OptimConfig,
                                            PipelineConfig)
    from gs2m_tpu_torch.data.scene import Scene
    from gs2m_tpu_torch.train.trainer import Trainer

    mc = ModelConfig(source_path=scene_dir, model_path=str(tmp_path / "m"),
                     resolution=1, sh_degree=1)
    opt = OptimConfig(**TRAIN_OPT)
    tr = Trainer(mc, PipelineConfig(chunk=64, term_cut=True), opt,
                 Scene(mc, opt, device="cpu"), data_parallel=True)
    assert not tr._term_cut and tr.expand_cap is None
    assert "term_cut is off under data parallelism" in capsys.readouterr().out


def opaque_checkpoint(scene_dir, root):
    """A checkpoint at iteration 3 (past geometry_from_iter 2) whose
    Gaussians are opaque (0.9) and wide (scale 1), so that the cut fires
    in the next steps."""
    import dataclasses as dc

    from gs2m_tpu_torch.core.config import (ModelConfig, OptimConfig,
                                            PipelineConfig)
    from gs2m_tpu_torch.data.scene import Scene
    from gs2m_tpu_torch.train.trainer import Trainer

    mc = ModelConfig(source_path=scene_dir, model_path=str(root / "m0"),
                     resolution=1, sh_degree=1)
    opt = OptimConfig(**TRAIN_OPT, geometry_from_iter=2)
    tr = Trainer(mc, PipelineConfig(chunk=64), opt,
                 Scene(mc, opt, device="cpu"), seed=3)
    for _ in range(3):
        tr.train_step()
    g = tr.gaussians
    tr.gaussians = dc.replace(
        g, opacity=torch.full_like(g.opacity, float(np.log(0.9 / 0.1))),
        scaling=torch.full_like(g.scaling, float(np.log(1.0))))
    path = str(root / "ckp3.pkl")
    tr.save_checkpoint(path)
    return path


def test_train_app_term_cut_same_loss_fewer_slots(scene_dir, tmp_path):
    """The train app resumed from an opaque state for three geometry steps,
    with and without --term_cut: the same loss (the cut is exact) and a
    smaller aligned demand with the cut."""
    from gs2m_tpu_torch.apps import train as train_app

    ckpt = opaque_checkpoint(scene_dir, tmp_path)
    runs = []
    for flags in ([], ["--term_cut"]):
        argv = ["-s", scene_dir, "-m", str(tmp_path / f"m{len(flags)}"),
                "--device", "cpu", "--chunk", "64", "--sh_degree", "1",
                "--iterations", "6", "--geometry_from_iter", "2",
                "--densify_from_iter", "100", "--test_iterations", "99",
                "--save_iterations", "6", "--quiet",
                "--start_checkpoint", ckpt, *flags]
        for k, v in TRAIN_OPT.items():
            argv += [f"--{k}", str(v)]
        runs.append(train_app.main(argv))
    plain, cut = runs
    assert cut._term_cut and not plain._term_cut
    assert cut.expand_cap == cut.instance_cap == plain.instance_cap
    mp, mc = plain.last_metrics, cut.last_metrics
    np.testing.assert_allclose(float(mc["loss"]), float(mp["loss"]),
                               rtol=1e-6)
    assert int(mc["dropped"]) == 0
    assert 0 < int(mc["aligned_demand"]) < int(mp["aligned_demand"])
