"""Port vs JAX package: the training losses and their ops (ops/ssim.py,
ops/grid_sample.py, models/losses.py).

Seeded numpy inputs go through both packages. Values and gradients of
fused_ssim, grid sampling, depth_normal_loss and plane_loss at allclose
1e-5; multi_view_loss value and gradients at 1e-4 with the JAX package's
pixel draw injected (its random stream cannot be reproduced in torch).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2m_tpu.core import sh as jsh
from gs2m_tpu.core.config import OptimConfig as JOpt
from gs2m_tpu.models import losses as JL
from gs2m_tpu.ops import grid_sample as jgs
from gs2m_tpu.ops import ssim as jssim
from gs2m_tpu_torch.core import sh as tsh
from gs2m_tpu_torch.models import losses as TL
from gs2m_tpu_torch.ops import grid_sample as tgs
from gs2m_tpu_torch.ops import ssim as tssim

from tests.test_torch_core import camera_pair

torch.set_num_threads(1)


def _t(x, grad=False):
    return torch.from_numpy(np.array(x, np.float32)).requires_grad_(grad)


def _close(a, b, tol, name=""):
    a, b = np.asarray(a), np.asarray(b)
    scale = np.abs(b).max()
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol * scale + 1e-30,
                               err_msg=name)


def test_fused_ssim_value_and_grad():
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (1, 3, 40, 52)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    jv, jg = jax.value_and_grad(lambda x: jssim.fused_ssim(x, b))(a)
    x = _t(a, True)
    tv = tssim.fused_ssim(x, _t(b))
    (tg,) = torch.autograd.grad(tv, [x])
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    _close(tg.numpy(), jg, 1e-5)
    # The reference form differentiates both images and agrees in value.
    np.testing.assert_allclose(float(tssim.ssim_reference(_t(a), _t(b))),
                               float(jssim.ssim_reference(a, b)), rtol=1e-5)


def test_grid_sample_value_and_grads():
    rng = np.random.default_rng(1)
    img = rng.normal(size=(4, 20, 30)).astype(np.float32)
    grid = rng.uniform(-1.15, 1.15, (7, 9, 2)).astype(np.float32)

    def jf(i, g):
        return jgs.grid_sample_bilinear(i, g, "border")

    w = rng.normal(size=(7, 9, 4)).astype(np.float32)
    jv = jf(img, grid)
    jgi, jgg = jax.grad(lambda i, g: jnp.sum(jf(i, g) * w), (0, 1))(img, grid)
    ti, tg = _t(img, True), _t(grid, True)
    tv = tgs.grid_sample_bilinear(ti, tg)
    gi, gg = torch.autograd.grad((tv * _t(w)).sum(), [ti, tg])
    _close(tv.detach().numpy(), jv, 1e-5, "value")
    _close(gi.numpy(), jgi, 1e-5, "d img")
    _close(gg.numpy(), jgg, 1e-5, "d grid")
    # Pixel-coordinate sampling.
    pix = rng.uniform(-2, 33, (50, 2)).astype(np.float32)
    _close(tgs.sample_pixels(_t(img), _t(pix)).numpy(),
           jgs.sample_pixels(img, pix, "border"), 1e-5, "pixels")


def test_photometric_geometric_losses():
    rng = np.random.default_rng(2)
    H, W = 24, 36
    pred = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    gt = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    nmap = rng.normal(size=(3, H, W)).astype(np.float32)
    smap = rng.normal(size=(3, H, W)).astype(np.float32)
    vis = rng.uniform(size=50) > 0.4
    scal = rng.uniform(0.01, 0.5, (50, 3)).astype(np.float32)
    iso = np.repeat(scal[:, :1], 3, axis=1)          # tied axes
    nmap0, smap0 = nmap.copy(), smap.copy()          # exact-zero channels,
    nmap0[1:] = 0.0                                  # as of axis-aligned
    smap0[:, [0, -1]] = 0.0                          # normals and the sobel
    smap0[1:, :, [0, -1]] = 0.0                      # map's border
    clipped = np.round(rng.uniform(-0.5, 1.5, (3, H, W)), 1).astype(np.float32)
    alpha = rng.uniform(0, 1, (1, H, W)).astype(np.float32)
    mask = (rng.uniform(size=(1, H, W)) > 0.5).astype(np.float32)

    cases = {
        "rgb_loss": (lambda m, x, y: m.rgb_loss(x, y, 0.2), (pred, gt)),
        "l1": (lambda m, x, y: m.l1_loss(x, y), (pred, gt)),
        "bce": (lambda m, x, y: m.binary_cross_entropy(x, y), (alpha, mask)),
        "depth_normal": (lambda m, x, y: m.depth_normal_loss(
            x, y, gt if m is JL else torch.from_numpy(gt)), (nmap, smap)),
        "depth_normal_ties": (lambda m, x, y: m.depth_normal_loss(
            x, y, gt if m is JL else torch.from_numpy(gt)), (nmap0, smap0)),
        "tv": (lambda m, x, y: m.tv_loss(y, x), (pred, gt)),
        "plane": (lambda m, x, y: m.plane_loss(
            y if m is JL else torch.from_numpy(vis), x), (scal, vis)),
        # Ties split the gradient as jnp.min / jnp.clip / jnp.maximum do.
        "plane_isotropic": (lambda m, x, y: m.plane_loss(
            y if m is JL else torch.from_numpy(vis), x), (iso, vis)),
        "clip": (lambda m, x, y: ((jnp.clip(x, 0.0, 1.0) if m is JL
                                   else m.clip(x, 0.0, 1.0)) * y).sum(),
                 (clipped, gt)),
        "sh_to_rgb": (lambda m, x, y: (
            jsh.sh_to_rgb(0, x, y) if m is JL
            else tsh.sh_to_rgb(0, x, y)).sum(),
            ((np.float32(-0.5) / np.float32(jsh.C0)
              + np.zeros((8, 1, 3), np.float32)),
             np.tile(np.float32([[0, 0, 1]]), (8, 1)))),
    }
    for name, (f, (x, y)) in cases.items():
        jv, jg = jax.value_and_grad(lambda a: f(JL, a, y))(x)
        tx = _t(x, True)
        ty = torch.from_numpy(np.array(y))
        tv = f(TL, tx, ty)
        (tg,) = torch.autograd.grad(tv, [tx])
        np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5,
                                   err_msg=name)
        _close(tg.numpy(), jg, 1e-5, name)


def _plane_pkgs(rng, cam, H, W, tilt=0.0):
    """Render-package maps of a slightly bumpy plane at depth ~4 seen by the
    JAX camera `cam`: depth, distance, world and camera normals (tilted by
    ~`tilt` rad), as numpy."""
    yy, xx = np.meshgrid(np.linspace(-1, 1, H), np.linspace(-1, 1, W),
                         indexing="ij")
    depth = (4.0 + 0.05 * np.sin(3 * xx) * np.cos(2 * yy)
             + 0.002 * rng.normal(size=(H, W))).astype(np.float32)[None]
    n = np.stack([0.05 * np.sin(2 * xx) + tilt, 0.05 * np.cos(3 * yy),
                  -np.ones_like(xx)], 0)
    n = (n / np.linalg.norm(n, axis=0, keepdims=True)).astype(np.float32)
    wv = np.asarray(cam.world_view)[:3, :3]
    local = (n.reshape(3, -1).T @ wv).T.reshape(3, H, W).astype(np.float32)
    return {"depth_map": depth, "normal_map": n, "local_normal_map": local,
            "distance_map": (depth * 0.98).astype(np.float32),
            "roughness_map": np.full((1, H, W), 0.5, np.float32)}


DIFF_KEYS = ("depth_map", "normal_map", "local_normal_map", "distance_map")


def test_multi_view_loss_matches_with_injected_draw():
    rng = np.random.default_rng(4)
    H, W = 48, 64
    th = 0.05
    R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                  [-np.sin(th), 0, np.cos(th)]])
    jc, tc = camera_pair(W, H)
    jn, tn = camera_pair(W, H, R=R, T=np.array([0.2, 0.05, 4.0]))
    pkg = _plane_pkgs(rng, jc, H, W)
    # Normals ~6 degrees apart: cos(angle) stays off arccos's clamp at
    # 1 - 1e-6, where one ulp would switch a pixel's gradient on or off.
    npkg = _plane_pkgs(rng, jn, H, W, tilt=0.1)
    gray_ref = rng.uniform(0, 1, (1, H, W)).astype(np.float32)
    gray_nea = rng.uniform(0, 1, (1, H, W)).astype(np.float32)
    cfg = JOpt(multi_view_sample_num=300)
    key = jax.random.PRNGKey(3)

    def jloss(p, q):
        return JL.multi_view_loss(cfg, jc, jn, {**pkg, **p}, {**npkg, **q},
                                  gray_ref, gray_nea, key, False, 1.0)

    jp = {k: jnp.asarray(pkg[k]) for k in DIFF_KEYS}
    jq = {k: jnp.asarray(npkg[k]) for k in DIFF_KEYS}
    jout = jloss(jp, jq)
    jg = jax.grad(lambda p, q: jloss(p, q).loss, (0, 1))(jp, jq)

    # The JAX package's own draw, recomputed from its pieces.
    pts = JL.points_from_depth(jc, jnp.asarray(pkg["depth_map"]))
    pin = jn.world_to_cam(pts)
    mz, _, valid, _ = JL.sample_depth_normal(pin, jn, jnp.asarray(npkg["depth_map"]),
                                             jnp.asarray(npkg["normal_map"]))
    valid = valid & (pin[:, 2] - mz <= cfg.mv_occlusion_threshold)
    rp = JL.reproject_points(jn, jc, pin, mz)
    ix, iy = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32), indexing="xy")
    noise = jnp.sqrt(jnp.sum((rp - np.stack([ix, iy], -1).reshape(-1, 2)) ** 2,
                             -1) + 1e-12)
    idx, _ = JL._sample_valid_indices(key, valid & (noise < 1.0), 300)
    assert int(jnp.sum(valid & (noise < 1.0))) > 300  # a real draw

    tp = {k: _t(pkg[k], k in DIFF_KEYS) for k in pkg}
    tq = {k: _t(npkg[k], k in DIFF_KEYS) for k in npkg}
    tout = TL.multi_view_loss(cfg, tc, tn, tp, tq, _t(gray_ref), _t(gray_nea),
                              False, 1.0, indices=torch.from_numpy(
                                  np.array(idx)))
    for name in ("loss", "geo_loss", "ncc_loss"):
        np.testing.assert_allclose(float(getattr(tout, name).detach()),
                                   float(getattr(jout, name)), rtol=1e-4,
                                   err_msg=name)
    assert float(tout.ncc_loss.detach()) > 0 < float(tout.geo_loss.detach())
    leaves = [tp[k] for k in DIFF_KEYS] + [tq[k] for k in DIFF_KEYS]
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(
        leaves, torch.autograd.grad(tout.loss, leaves, allow_unused=True))]
    refs = [jg[0][k] for k in DIFF_KEYS] + [jg[1][k] for k in DIFF_KEYS]
    for name, g, r in zip([f"ref/{k}" for k in DIFF_KEYS]
                          + [f"nearest/{k}" for k in DIFF_KEYS], grads, refs):
        _close(g.numpy(), r, 1e-4, name)

    # Without injected indices the draw comes from a torch.Generator.
    gen = torch.Generator().manual_seed(0)
    out = TL.multi_view_loss(cfg, tc, tn, tp, tq, _t(gray_ref), _t(gray_nea),
                             False, 1.0, generator=gen)
    assert torch.isfinite(out.loss)


def test_ref_patches_fast_path_equals_bilinear():
    """The integer-tap fast path of the NCC reference patches reads what
    border-clamped bilinear sampling reads (up to the normalization's
    rounding), and exactly what the JAX package's fast path reads."""
    rng = np.random.default_rng(5)
    gray = _t(rng.uniform(0, 1, (1, 12, 16)))
    pix = torch.from_numpy(np.stack([rng.integers(0, 16, 40),
                                     rng.integers(0, 12, 40)], -1)
                           .astype(np.float32))
    fast = TL._ref_patches(gray, pix, 3, 1.0)
    offs = TL._patch_offsets(3, "cpu")
    slow = tgs.sample_pixels(gray, pix[:, None, :] + offs[None])[..., 0]
    torch.testing.assert_close(fast, slow, atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(
        fast.numpy(), np.asarray(JL._ref_patches(np.asarray(gray), np.asarray(pix),
                                                 3, 1.0)))
