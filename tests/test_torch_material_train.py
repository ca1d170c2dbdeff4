"""Port vs JAX package: the trainer's material stage (train/trainer.py's
third stage, pbr/render.py's make_pbr_fns plug).

One material-stage train step of each package (metallic trained or not):
the loss and Lmat at rtol 1e-5, Lgeo at 1e-4, and every parameter group's
Adam first moment, and the light's, at the distributional gate of
scripts/check_grads_onchip.py; the pixel draws of both packages are made
the same seeded top-k, the scene is textured so that the NCC patches are
well-conditioned, and the roughness term runs at its default
weight and at weight 2. The trainer's material run, and a checkpoint
that carries the light resumes bit-equal on the CPU.
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
from gs2m_tpu.models import losses as JL
from gs2m_tpu.pbr import render as JR
from gs2m_tpu.train import densify as JD
from gs2m_tpu.train import optim as JO
from gs2m_tpu.train import trainer as JT
from gs2m_tpu_torch.core.config import ModelConfig as TModel
from gs2m_tpu_torch.core.config import OptimConfig as TOpt
from gs2m_tpu_torch.core.config import PipelineConfig as TPipe
from gs2m_tpu_torch.data.scene import Scene as TScene
from gs2m_tpu_torch.models import losses as TL
from gs2m_tpu_torch.pbr import render as TR
from gs2m_tpu_torch.train import densify as TD
from gs2m_tpu_torch.train import optim as TO
from gs2m_tpu_torch.train import trainer as TT
from gs2m_tpu_torch.utils.grad_gate import DEFAULT_TOL, TOLERANCES, grad_gate

from tests.test_torch_core import port_gaussians

torch.set_num_threads(1)

OPT_KW = dict(multi_view_max_angle=179.0, multi_view_max_dist=100.0,
              nearby_cam_max_angle=179.0, nearby_cam_max_dist=100.0,
              nearby_cam_min_angle=0.0, multi_view_sample_num=400)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    from tests.make_synthetic_scene import build
    root = tmp_path_factory.mktemp("material")
    # A sphere with per-point random colors: its texture is the same in
    # every view, so the multi-view and roughness NCC patches are
    # well-conditioned and agree where the views do (flat colors make the
    # NCC's float32 variance a cancellation whose sign is noise).
    scene_dir = build(str(root / "scene"), n_views=5, width=64, height=48,
                      n_points=200, surface=True, texture="noise")
    mk = lambda M, sub: M(source_path=scene_dir, model_path=str(root / sub),
                          resolution=1, sh_degree=1, eval=True)
    js = JScene(mk(JModel, "j"), JOpt(**OPT_KW))
    ts = TScene(mk(TModel, "t"), TOpt(**OPT_KW), device="cpu")
    return js, ts


def _fixed_draws(monkeypatch, n_pixels):
    """Both packages' pixel draws become the same seeded top-k: distinct
    scores, the invalid ones below every valid one."""
    u = np.random.default_rng(99).permutation(n_pixels).astype(np.float32)
    u = (u + 1.0) / (n_pixels + 1.0)

    def jdraw(key, valid, k):
        _, idx = jax.lax.top_k(jnp.where(valid, u, -u), k)
        return idx, valid[idx]

    def tdraw(generator, valid, k):
        s = torch.from_numpy(u).to(valid.device)
        return torch.topk(torch.where(valid, s, -s), k).indices

    monkeypatch.setattr(JL, "_sample_valid_indices", jdraw)
    monkeypatch.setattr(TL, "sample_valid_indices", tdraw)


@pytest.mark.parametrize("metallic,lambda_rough", [
    (False, TOpt.lambda_rough), (True, TOpt.lambda_rough), (False, 2.0)],
    ids=["derived", "trained", "derived-rough2"])
def test_material_train_step_matches_jax(scenes, metallic, lambda_rough,
                                         monkeypatch):
    js, ts = scenes
    _fixed_draws(monkeypatch, 64 * 48)
    # The default roughness weight (1e-4) leaves the roughness term a small
    # share of the roughness gradient; weight 2 makes it the larger share,
    # so a wrong nearby view, gray image or pixel draw shows in the moments.
    # (At weight 1 this negative term nearly cancels the rest of Lmat, -0.04
    # of parts near 0.35, and float32 summation order alone moves it 1e-5.)
    opt_kw = dict(OPT_KW, lambda_smooth=0.5, lambda_normal=0.5,
                  reflection_threshold=0.2, lambda_rough=lambda_rough)
    jopt, topt = JOpt(**opt_kw), TOpt(**opt_kw)
    g = JGaussians.create(js.info.points, js.info.colors, 1, capacity=256)
    # Random rotations and material latents: fresh Gaussians' identity
    # rotations blend normals with exact-zero channels (normal_mask empty,
    # no PBR term), and equal albedos make the albedo TV an L1 of ulp-sized
    # differences whose sign is noise in either package.
    rng = np.random.default_rng(12)
    n = int(np.asarray(g.alive).sum())
    p = {k: np.array(v) for k, v in g.params_dict().items()}
    p["opacity"] = p["opacity"] + 2.0
    for k, s in (("rotation", 0.5), ("albedo", 1.0), ("roughness", 1.0),
                 ("metallic", 1.0)):
        p[k][:n] += s * rng.normal(size=p[k][:n].shape).astype(np.float32)
    g = g.with_params({k: jnp.asarray(v) for k, v in p.items()})
    cap, view, it = 2 ** 13, 2, 1
    jmodel = JModel(sh_degree=1, material=True, metallic=metallic)
    jfns = JR.make_pbr_fns(base_res=16)
    light0 = np.asarray(jfns["init_light"]())
    jstep = JT.make_train_step(jmodel, JPipe(chunk=64), jopt, js, cap, True,
                               True, backend="xla", pbr_fns=jfns)
    key = jax.random.PRNGKey(11)
    k_nb, _, k_rough = jax.random.split(jax.random.fold_in(key, it), 3)
    nearest, has = JT._choose_neighbor(k_nb, js.nearest_table[view],
                                       js.nearest_mask[view], view)
    nearby, has_nb = JT._choose_neighbor(jax.random.split(k_rough)[0],
                                         js.nearby_table[view],
                                         js.nearby_mask[view], 0)
    assert bool(has) and bool(has_nb)
    jg2, jstate, jst, jlg, jm = jstep(
        g, JO.adam_init(g.params_dict()), JD.DensifyStats.zeros(256),
        js.gt_images, js.alpha_masks, js.gray_images, jnp.asarray(light0),
        jnp.int32(view), key, jnp.int32(it), 1)
    jlight, jlstate = jfns["light_update"](jnp.asarray(light0), jlg,
                                           JO.adam_init(jnp.asarray(light0)),
                                           jopt.opacity_lr)

    tfns = TR.make_pbr_fns(base_res=16, light=light0, device="cpu")
    tstep = TT.make_train_step(TModel(sh_degree=1, material=True,
                                      metallic=metallic), TPipe(chunk=64),
                               topt, ts, cap, True, True, tfns)
    tg = port_gaussians(g)
    tstate = TO.adam_init(tg.params_dict())
    tlight = tfns["init_light"]()
    tlstate = tfns["init_light_opt"](tlight)
    tg2, tstate, tst, tm = tstep(
        tg, tstate, TD.DensifyStats.zeros(256, "cpu"), view, int(nearest),
        True, it, 1, light=tlight, light_opt_state=tlstate,
        nearby_idx=int(nearby), has_nearby=True)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["Lmat"]), float(jm["Lmat"]), rtol=1e-5)
    # Lgeo holds the multi-view NCC term, held at 1e-4 as in
    # tests/test_torch_losses.py (its patch variances are cancellations).
    np.testing.assert_allclose(float(tm["Lgeo"]), float(jm["Lgeo"]), rtol=1e-4)
    assert float(tm["Lmat"]) != 0 and tm["rough_active"] == 1
    assert int(tm["dropped"]) == int(jm["dropped"]) == 0
    for k, jmu in jstate.mu.items():
        if k == "metallic" and not metallic:
            assert not np.any(np.asarray(jmu)) and not tstate.mu[k].any()
            continue
        rep = grad_gate(tstate.mu[k].numpy() / 0.1, np.asarray(jmu) / 0.1,
                        TOLERANCES.get(k, DEFAULT_TOL))
        assert rep["pass"], (k, rep)
    rep = grad_gate(tlstate.mu["light"].numpy() / 0.1,
                    np.asarray(jlstate.mu) / 0.1)
    assert rep["pass"], ("light", rep)
    assert tlstate.count == int(jlstate.count) == 1
    # Adam's first step moves each texel by lr * sign(g) where g is
    # well-conditioned, then the clamp to >= 0.
    gl = np.asarray(jlg)
    wc = np.abs(gl) >= 1e-2 * np.abs(gl).max()
    np.testing.assert_allclose(tlight.numpy()[wc], np.asarray(jlight)[wc],
                               rtol=1e-5, atol=1e-7)
    assert float(tlight.min()) >= 0.0


def _material_trainer(ts, iterations=6, geometry_from=2, seed=0):
    opt = TOpt(**OPT_KW, iterations=iterations, geometry_from_iter=geometry_from)
    fns = TR.make_pbr_fns(base_res=16, seed=seed, device="cpu")
    return TT.Trainer(TModel(sh_degree=1, material=True), TPipe(chunk=64), opt,
                      ts, seed=seed, pbr_fns=fns)


def test_trainer_material_stage(scenes):
    _, ts = scenes
    tr = _material_trainer(ts)
    assert tr.material_from_iter == 2
    light0 = tr.light_state.clone()
    lmats = []
    for _ in range(5):
        m = tr.train_step()
        lmats.append(float(m["Lmat"]))
        assert np.isfinite(float(m["loss"]))
    assert lmats[:2] == [0.0, 0.0] and all(v > 0 for v in lmats[2:])
    assert tr.rough_active_count == 3 and tr.mv_active_count == 3
    assert not torch.equal(tr.light_state, light0)
    assert float(tr.light_state.min()) >= 0.0
    assert tr.light_opt_state.count == 3


def test_material_checkpoint_resumes_bit_equal(scenes, tmp_path):
    _, ts = scenes
    a = _material_trainer(ts)
    for _ in range(3):
        a.train_step()
    ckpt = str(tmp_path / "ckp3.pkl")
    a.save_checkpoint(ckpt)
    for _ in range(2):
        a.train_step()
    b = _material_trainer(ts, seed=1)
    b.load_checkpoint(ckpt)
    assert b.iteration == 3 and b.rough_active_count == 1
    for _ in range(2):
        b.train_step()
    assert torch.equal(a.last_metrics["loss"], b.last_metrics["loss"])
    for k, v in a.gaussians.params_dict().items():
        assert torch.equal(v, b.gaussians.params_dict()[k]), k
        assert torch.equal(a.opt_state.mu[k], b.opt_state.mu[k]), k
    assert torch.equal(a.light_state, b.light_state)
    assert torch.equal(a.light_opt_state.mu["light"], b.light_opt_state.mu["light"])
    assert torch.equal(a.light_opt_state.nu["light"], b.light_opt_state.nu["light"])
    assert a.rough_active_count == b.rough_active_count == 3
