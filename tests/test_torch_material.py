"""Port vs JAX package: the material stage's losses (pbr/render.py's
material_losses, models/losses.py::roughness_loss and its NCC pieces).

`roughness_loss` and `material_losses` on the same seeded maps, with the
nearby view and the pixel sample injected (the two frameworks' random
streams differ): values at rtol 1e-5 (1e-4 for the roughness term), the
gradients into the light and the maps at rtol 1e-4. The trainer's third
stage is tests/test_torch_material_train.py's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2m_tpu.core.config import ModelConfig as JModel
from gs2m_tpu.core.config import OptimConfig as JOpt
from gs2m_tpu.models import losses as JL
from gs2m_tpu.pbr import render as JR
from gs2m_tpu_torch.core.config import ModelConfig as TModel
from gs2m_tpu_torch.core.config import OptimConfig as TOpt
from gs2m_tpu_torch.models import losses as TL
from gs2m_tpu_torch.pbr import render as TR

from tests.test_torch_core import camera_pair
from tests.test_torch_losses import _plane_pkgs

torch.set_num_threads(1)


def _t(x, grad=False):
    return torch.from_numpy(np.array(x, np.float32)).requires_grad_(grad)


def _close(a, b, tol, name=""):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol * np.abs(b).max() + 1e-30,
                               err_msg=name)


def _maps(rng, cam, H, W, tilt=0.0):
    """_plane_pkgs plus the material maps of a render package."""
    pkg = _plane_pkgs(rng, cam, H, W, tilt)
    pkg["roughness_map"] = rng.uniform(0.02, 0.95, (1, H, W)).astype(np.float32)
    pkg["metallic_map"] = rng.uniform(0, 1, (1, H, W)).astype(np.float32)
    pkg["albedo_map"] = rng.uniform(-0.1, 1.1, (3, H, W)).astype(np.float32)
    pkg["alpha_map"] = rng.uniform(0, 1, (1, H, W)).astype(np.float32)
    nm = np.ones((1, H, W), bool)
    nm[:, :3] = False          # empty rows: exact zeros in the PBR image
    pkg["normal_mask"] = nm
    return pkg


def _setup(H=24, W=32):
    rng = np.random.default_rng(4)
    th = 0.05
    R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                  [-np.sin(th), 0, np.cos(th)]])
    jc, tc = camera_pair(W, H)
    jn, tn = camera_pair(W, H, R=R, T=np.array([0.2, 0.05, 4.0]))
    pkg = _maps(rng, jc, H, W)
    npkg = _maps(rng, jn, H, W, tilt=0.1)
    gray_ref = rng.uniform(0, 1, (1, H, W)).astype(np.float32)
    gray_nea = rng.uniform(0, 1, (1, H, W)).astype(np.float32)
    return rng, (jc, tc, jn, tn), pkg, npkg, gray_ref, gray_nea


def _jax_rough_draw(cfg, jc, jn, pkg, npkg, key, k):
    """The JAX package's roughness-term pixel draw, from its pieces."""
    pts = JL.points_from_depth(jc, jnp.asarray(pkg["depth_map"]))
    pin = jn.world_to_cam(pts)
    mz, _, valid, _ = JL.sample_depth_normal(
        pin, jn, jnp.asarray(npkg["depth_map"]), jnp.asarray(npkg["normal_map"]))
    valid = valid & (pin[:, 2] - mz <= cfg.mv_occlusion_threshold)
    idx, _ = JL._sample_valid_indices(key, valid, k)
    return np.array(idx), int(jnp.sum(valid))


@pytest.mark.parametrize("threshold", [0.2, 1.0])
def test_roughness_loss_matches_with_injected_draw(threshold):
    _, (jc, tc, jn, tn), pkg, npkg, gray_ref, gray_nea = _setup()
    cfg = JOpt(multi_view_sample_num=200, reflection_threshold=threshold)
    key = jax.random.PRNGKey(5)
    idx, n_valid = _jax_rough_draw(cfg, jc, jn, pkg, npkg, key, 200)
    assert n_valid > 200

    def jf(rough):
        return JL.roughness_loss(cfg, jc, jn, {**pkg, "roughness_map": rough},
                                 npkg, gray_ref, gray_nea, key, 1.0)

    jv, jg = jax.value_and_grad(jf)(jnp.asarray(pkg["roughness_map"]))
    tp = {k: _t(v, k == "roughness_map") for k, v in pkg.items()}
    tv = TL.roughness_loss(TOpt(multi_view_sample_num=200,
                                reflection_threshold=threshold),
                           tc, tn, tp, {k: _t(v) for k, v in npkg.items()},
                           _t(gray_ref), _t(gray_nea), 1.0,
                           indices=torch.from_numpy(idx))
    assert float(tv.detach()) != 0.0
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-4)
    (tg,) = torch.autograd.grad(tv, [tp["roughness_map"]])
    _close(tg.numpy(), jg, 1e-4)


def test_ncc_std_mask_and_patch_gradient_match_jax():
    rng = np.random.default_rng(8)
    ref = rng.uniform(0, 1, (20, 49)).astype(np.float32)
    ref[:3] = 0.5 + 1e-4 * ref[:3]          # flat patches: std below 0.01
    nea = rng.uniform(0, 1, (20, 49)).astype(np.float32)
    for std_mask in (False, True):
        jn, jm = JL._ncc(jnp.asarray(ref), jnp.asarray(nea), std_mask=std_mask)
        tn, tm = TL._ncc(_t(ref), _t(nea), std_mask=std_mask)
        # A flat patch's NCC is a cancellation (its variance ~1e-9): the
        # values are held on the others, the masks on all.
        np.testing.assert_allclose(tn.numpy()[3:], np.asarray(jn)[3:],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(TL._patch_gradient(_t(ref), 7).numpy(),
                               np.asarray(JL._patch_gradient(jnp.asarray(ref), 7)),
                               rtol=1e-5, atol=1e-6)


MAT_KEYS = ("albedo_map", "roughness_map", "metallic_map", "normal_map")


@pytest.mark.parametrize("metallic", [False, True], ids=["derived", "trained"])
def test_material_losses_match_jax(metallic, monkeypatch):
    """material_losses' PBR, smoothness, normal-TV and roughness terms, the
    nearby render replaced by a fixed package in both packages."""
    rng, (jc, tc, jn, tn), pkg, npkg, gray_ref, gray_nea = _setup()
    H, W = 24, 32
    gt = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    light = rng.uniform(0.1, 1.0, (6, 16, 16, 3)).astype(np.float32)
    opt_kw = dict(multi_view_sample_num=200, reflection_threshold=0.2,
                  lambda_smooth=0.5, lambda_normal=0.5, lambda_rough=0.3)
    cfg_j, cfg_t = JOpt(**opt_kw), TOpt(**opt_kw)
    mcfg_j = JModel(material=True, metallic=metallic)
    mcfg_t = TModel(material=True, metallic=metallic)
    key = jax.random.PRNGKey(2)
    k_nb, k_r = jax.random.split(key)
    idx, _ = _jax_rough_draw(cfg_j, jc, jn, pkg, npkg, k_r, 200)

    import gs2m_tpu.models.render as jrender
    import gs2m_tpu.train.trainer as jtrainer
    monkeypatch.setattr(jrender, "render",
                        lambda *a, **k: {k2: jnp.asarray(v) for k2, v in npkg.items()})
    monkeypatch.setattr(jtrainer, "_choose_neighbor",
                        lambda *a: (jnp.int32(1), jnp.bool_(True)))
    jfns = JR.make_pbr_fns(base_res=16)
    cams = type("Stack", (), {})()

    def jf(lgt, maps):
        monkeypatch.setattr(JR, "index_camera", lambda *_: jn)
        return jfns["material_losses"](
            None, jc, {**pkg, **maps}, jnp.asarray(gt), lgt, cfg_j, mcfg_j,
            jnp.zeros(4, jnp.int32), jnp.ones(4, bool), jnp.asarray(gray_ref),
            jnp.stack([jnp.asarray(gray_ref), jnp.asarray(gray_nea)]), cams,
            key, 1.0, 0, {})[0]

    jmaps = {k: jnp.asarray(pkg[k]) for k in MAT_KEYS}
    jv, (jgl, jgm) = jax.value_and_grad(jf, (0, 1))(jnp.asarray(light), jmaps)

    import gs2m_tpu_torch.models.render as trender
    monkeypatch.setattr(trender, "render",
                        lambda *a, **k: {k2: _t(v) for k2, v in npkg.items()})
    tfns = TR.make_pbr_fns(base_res=16, light=light, device="cpu")
    tl = tfns["init_light"]().requires_grad_(True)
    np.testing.assert_array_equal(tl.detach().numpy(), light)
    tpkg = {k: (torch.from_numpy(v) if v.dtype == bool else _t(v, k in MAT_KEYS))
            for k, v in pkg.items()}
    tv, aux = tfns["material_losses"](
        None, tc, tpkg, _t(gt), tl, cfg_t, mcfg_t, tn, True, _t(gray_ref),
        _t(gray_nea), 1.0, 0, {}, indices=torch.from_numpy(idx))
    assert aux["rough_active"]
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    leaves = [tl] + [tpkg[k] for k in MAT_KEYS]
    grads = torch.autograd.grad(tv, leaves, allow_unused=True)
    for name, g, r in zip(("light",) + MAT_KEYS, grads,
                          [jgl] + [jgm[k] for k in MAT_KEYS]):
        g = np.zeros(np.shape(r), np.float32) if g is None else g.numpy()
        _close(g, r, 1e-4, name)
