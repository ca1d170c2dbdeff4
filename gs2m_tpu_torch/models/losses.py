"""Training losses: photometric, geometric (PGSR-style multi-view), TV.

Port of gs2m_tpu/models/losses.py for the three stages. All losses are
functions of rendered map dicts; the trainer renders the neighbor view and
passes both packages in. The multi-view NCC term and the material stage's
roughness-from-reflection term draw a FIXED number of pixels among the
valid ones (top-k over random scores); the draw comes from a
torch.Generator, or tests pass the JAX package's indices in (`indices`),
since the two frameworks' random streams differ.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from gs2m_tpu_torch.ops.grid_sample import sample_pixels
from gs2m_tpu_torch.ops.ssim import fused_ssim


def _safe_norm(x, dim=-1, eps=1e-12, keepdim=False):
    """sqrt(sum(x^2) + eps): a finite gradient at x == 0."""
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim) + eps)


def _safe_div_z(z, threshold=1e-4):
    """Clamp a divisor away from 0 (sign-preserving). Rows with tiny |z| are
    masked invalid by the callers; this keeps their gradient finite."""
    return torch.where(torch.abs(z) < threshold,
                       torch.where(z < 0, -threshold, threshold), z)


# --- basic photometric ---------------------------------------------------------

# Ties keep the JAX package's subgradients. They are not rare: fresh
# Gaussians have identity rotations, so blended normals have exact-zero
# channels, as do the sobel map's border and empty pixels.

def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip's gradient: half of it at a tie with a bound (an empty
    pixel's 0 color), where torch.clamp passes all of it."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


def abs_(x: torch.Tensor) -> torch.Tensor:
    """jnp.abs's gradient: +1 at 0, where torch.abs gives 0."""
    return torch.where(x >= 0, x, -x)


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean(abs_(pred - gt))


def rgb_loss(pred: torch.Tensor, gt: torch.Tensor,
             lambda_ssim: float) -> torch.Tensor:
    """(1-l)*L1 + l*(1-SSIM) on (3, H, W) images."""
    ls = 1.0 - fused_ssim(pred[None], gt[None])
    return (1.0 - lambda_ssim) * l1_loss(pred, gt) + lambda_ssim * ls


def binary_cross_entropy_map(pred: torch.Tensor,
                             target: torch.Tensor) -> torch.Tensor:
    """Per-pixel BCE (the band-sharded objective sums a masked slice)."""
    p = torch.clamp(pred, 1e-7, 1.0 - 1e-7)
    return -(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p))


def binary_cross_entropy(pred: torch.Tensor,
                         target: torch.Tensor) -> torch.Tensor:
    return torch.mean(binary_cross_entropy_map(pred, target))


# --- flattening prior -------------------------------------------------------------

def plane_loss(visibility: torch.Tensor, scaling: torch.Tensor) -> torch.Tensor:
    """Mean min-scale of visible Gaussians -> drives them flat.
    visibility: (C,) bool; scaling: (C, 3) activated scales. amin splits the
    gradient evenly among tied axes (isotropic Gaussians), as jnp.min does;
    min(dim).values would send it all to one axis."""
    min_scale = torch.amin(scaling, dim=-1)
    w = visibility.to(scaling.dtype)
    return torch.sum(min_scale * w) / torch.clamp_min(torch.sum(w), 1.0)


# --- depth-normal consistency --------------------------------------------------------

def _img_grad_weight(img: torch.Tensor) -> torch.Tensor:
    """(3, H, W) -> (H, W) normalized image-gradient magnitude, zero border."""
    _, hd, wd = img.shape
    bottom = img[..., 2:hd, 1:wd - 1]
    top = img[..., 0:hd - 2, 1:wd - 1]
    right = img[..., 1:hd - 1, 2:wd]
    left = img[..., 1:hd - 1, 0:wd - 2]
    gx = torch.mean(torch.abs(right - left), dim=0)
    gy = torch.mean(torch.abs(top - bottom), dim=0)
    g = torch.maximum(gx, gy)
    g = (g - g.min()) / (g.max() - g.min() + 1e-12)
    return F.pad(g, (1, 1, 1, 1))


def depth_normal_loss(normal_map: torch.Tensor, sobel_map: torch.Tensor,
                      gt_image: torch.Tensor) -> torch.Tensor:
    """Image-gradient-weighted |normal-from-depth − blended normal|."""
    with torch.no_grad():
        weights = torch.clamp(1.0 - _img_grad_weight(gt_image), 0.0, 1.0) ** 2
    return torch.mean(weights * torch.sum(abs_(sobel_map - normal_map), dim=0))


# --- edge-aware TV -------------------------------------------------------------------

def tv_loss(gt_image: torch.Tensor, pred: torch.Tensor, norm1: bool = True,
            weight_map: torch.Tensor | None = None) -> torch.Tensor:
    rgb_h = torch.exp(-torch.mean(torch.abs(gt_image[:, 1:, :]
                                            - gt_image[:, :-1, :]), 0,
                                  keepdim=True))
    rgb_w = torch.exp(-torch.mean(torch.abs(gt_image[:, :, 1:]
                                            - gt_image[:, :, :-1]), 0,
                                  keepdim=True))
    dh = pred[:, 1:, :] - pred[:, :-1, :]
    dw = pred[:, :, 1:] - pred[:, :, :-1]
    loss_h = (abs_(dh) if norm1 else dh ** 2) * rgb_h
    loss_w = (abs_(dw) if norm1 else dw ** 2) * rgb_w
    if weight_map is not None:
        loss_h = loss_h * (weight_map[:, 1:, :] + weight_map[:, :-1, :]) / 2.0
        loss_w = loss_w * (weight_map[:, :, 1:] + weight_map[:, :, :-1]) / 2.0
    return torch.mean(loss_h) + torch.mean(loss_w)


# --- multi-view machinery --------------------------------------------------------------

def points_from_depth(cam, depth_map: torch.Tensor) -> torch.Tensor:
    """Back-project (1, H, W) depth to (H*W, 3) world points."""
    pts_cam = cam.get_rays() * depth_map[0][..., None]
    return cam.cam_to_world(pts_cam.reshape(-1, 3))


def sample_depth_normal(cam_points: torch.Tensor, cam, depth_map: torch.Tensor,
                        normal_map: torch.Tensor):
    """Project (N,3) neighbor-camera-space points and bilinearly sample the
    neighbor's depth and normal maps. Returns (map_z, map_n, valid, proj)."""
    W, H = cam.width, cam.height
    z = _safe_div_z(cam_points[:, 2])
    proj = torch.stack([cam_points[:, 0] * cam.fx / z + cam.cx,
                        cam_points[:, 1] * cam.fy / z + cam.cy], dim=-1)
    z = cam_points[:, 2]
    valid = ((proj[:, 0] > 0) & (proj[:, 0] < W) & (proj[:, 1] > 0)
             & (proj[:, 1] < H) & (z > 0.1))
    zn = sample_pixels(torch.cat([depth_map, normal_map], 0), proj)
    map_z = zn[:, 0]
    map_n = zn[:, 1:4]
    map_n = map_n / _safe_norm(map_n, keepdim=True, eps=1e-12)
    return map_z, map_n, valid, proj


def reproject_points(from_cam, to_cam, points: torch.Tensor,
                     sampled_depth: torch.Tensor) -> torch.Tensor:
    """(N,3) from_cam view points + sampled depth -> pixel coords in to_cam."""
    pts = points / _safe_div_z(points[:, 2:3]) * sampled_depth[:, None]
    p = to_cam.world_to_cam(from_cam.cam_to_world(pts))
    pz = _safe_div_z(p[:, 2])
    return torch.stack([p[:, 0] * to_cam.fx / pz + to_cam.cx,
                        p[:, 1] * to_cam.fy / pz + to_cam.cy], dim=-1)


def _patch_offsets(half: int, device) -> torch.Tensor:
    o = torch.arange(-half, half + 1, dtype=torch.float32, device=device)
    dx, dy = torch.meshgrid(o, o, indexing="xy")
    return torch.stack([dx.reshape(-1), dy.reshape(-1)], dim=-1)  # (P, 2) (x, y)


def _ref_patches(gray: torch.Tensor, pix: torch.Tensor, half: int,
                 ncc_scale: float) -> torch.Tensor:
    """Reference-side NCC patches: sample_pixels(gray, pix/ncc_scale +
    offsets)[..., 0], (k, P) for P = (2*half+1)^2 taps. When 1/ncc_scale is
    an integer (the standard protocol) every tap lands on an exact pixel,
    where border-clamped bilinear sampling is a plain read: the taps are
    read from P edge-padded shifted copies of the image instead."""
    inv = 1.0 / ncc_scale
    if abs(inv - round(inv)) > 1e-9:
        offsets = _patch_offsets(half, pix.device)
        return sample_pixels(gray, pix[:, None, :] / ncc_scale
                             + offsets[None, :, :])[..., 0]
    inv = int(round(inv))
    Hs, Ws = gray.shape[-2:]
    padded = F.pad(gray[None], (half, half, half, half), mode="replicate")[0, 0]
    offs = range(-half, half + 1)
    stack = torch.stack([padded[half + dy: half + dy + Hs,
                                half + dx: half + dx + Ws].reshape(-1)
                         for dy in offs for dx in offs], 0)    # (P, Hs*Ws)
    base = ((pix[:, 1] * inv).to(torch.int32) * Ws
            + (pix[:, 0] * inv).to(torch.int32)).long()
    return stack[:, base].T                                    # (k, P)


def _patch_warp(Hmat: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Apply per-point homographies (N,3,3) to patch pixel coords (N,P,2)."""
    homo = torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)  # (N, P, 3)
    out = torch.einsum("nik,npk->npi", Hmat, homo)
    return out[..., :2] / _safe_div_z(out[..., 2:], 1e-6)


def _ncc(ref: torch.Tensor, nea: torch.Tensor, std_mask: bool = False):
    """Patch NCC. ref/nea: (N, P) -> (ncc, ncc < 0.9), or with `std_mask`
    (ncc, std(ref) < 0.01): the flat reference patches."""
    tps = ref.shape[1]
    ref_sum = torch.sum(ref, dim=1)
    nea_sum = torch.sum(nea, dim=1)
    ref2_sum = torch.sum(ref * ref, dim=1)
    nea2_sum = torch.sum(nea * nea, dim=1)
    rn_sum = torch.sum(ref * nea, dim=1)
    ref_avg = ref_sum / tps
    nea_avg = nea_sum / tps
    cross = rn_sum - nea_avg * ref_sum
    ref_var = ref2_sum - ref_avg * ref_sum
    nea_var = nea2_sum - nea_avg * nea_sum
    cc = cross * cross / (ref_var * nea_var + 1e-8)
    ncc = torch.clamp(1.0 - cc, 0.0, 2.0)
    if std_mask:
        return ncc, torch.sqrt(torch.clamp_min(ref_var, 0.0)) < 0.01
    return ncc, ncc < 0.9


@functools.cache
def _sobel_x(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The (1, 1, 3, 3) Sobel x kernel on `device`, copied there once (a
    copy per call would wait for the card)."""
    return torch.tensor([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]],
                        dtype=dtype).reshape(1, 1, 3, 3).to(device)


def _patch_gradient(patch: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Sobel magnitude over (N, P) patches."""
    n = patch.shape[0]
    x = patch.reshape(n, 1, patch_size, patch_size)
    sx = _sobel_x(patch.device, patch.dtype)
    gx = F.conv2d(x, sx, padding=1)
    gy = F.conv2d(x, sx.transpose(-1, -2), padding=1)
    return torch.sqrt(gx ** 2 + gy ** 2 + 1e-6).reshape(n, -1)


def sample_valid_indices(generator: torch.Generator | None,
                         valid_flat: torch.Tensor, k: int) -> torch.Tensor:
    """k indices drawn without replacement among the valid ones (top-k of
    uniform scores, -1 for invalid entries; invalid picks only when fewer
    than k are valid)."""
    u = torch.rand(valid_flat.shape, generator=generator,
                   device=valid_flat.device)
    return torch.topk(torch.where(valid_flat, u, -1.0), k).indices


class MultiViewOut(NamedTuple):
    loss: torch.Tensor
    geo_loss: torch.Tensor
    ncc_loss: torch.Tensor


def _masked_mean(x, m):
    mf = m.to(x.dtype)
    return torch.sum(x * mf) / torch.clamp_min(torch.sum(mf), 1.0)


def multi_view_loss(cfg, cam, nearest_cam, render_pkg: dict, nearest_pkg: dict,
                    gray_ref: torch.Tensor, gray_nea: torch.Tensor,
                    material_stage: bool, ncc_scale: float = 1.0,
                    generator: torch.Generator | None = None,
                    indices: torch.Tensor | None = None) -> MultiViewOut:
    """PGSR multi-view geometric + photometric consistency. Gradients flow
    into both renders' depth/normal maps; the pixel subsample is drawn from
    `generator` without gradient, or given as `indices` (k,)."""
    H, W = cam.height, cam.width
    dev = render_pkg["depth_map"].device
    iy, ix = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    pixels = torch.stack([ix, iy], -1)  # (H, W, 2)

    pts = points_from_depth(cam, render_pkg["depth_map"])
    pts_in_nearest = nearest_cam.world_to_cam(pts)
    map_z, map_n, valid, _ = sample_depth_normal(
        pts_in_nearest, nearest_cam, nearest_pkg["depth_map"],
        nearest_pkg["normal_map"])
    valid = valid & (pts_in_nearest[:, 2] - map_z <= cfg.mv_occlusion_threshold)

    re_proj = reproject_points(nearest_cam, cam, pts_in_nearest, map_z)
    pixel_noise = _safe_norm(re_proj - pixels.reshape(-1, 2), dim=-1)

    # Sampling the own normal map at the identity pixel grid is the map.
    normals = render_pkg["normal_map"].reshape(3, -1).T
    normals = normals / _safe_norm(normals, keepdim=True, eps=1e-12)
    cos_sim = torch.sum(normals * map_n, dim=1)
    angle_err = torch.acos(torch.clamp(cos_sim, -1 + 1e-6, 1 - 1e-6))
    angle_thresh = cfg.mv_angle_threshold * math.pi / 180.0
    angle_valid = valid & (angle_err < angle_thresh)
    angle_noise = cfg.mv_angle_factor * angle_err

    pixel_valid = valid & (pixel_noise < 1.0)
    noise = pixel_noise.detach()
    geo_w = torch.where(pixel_valid,
                        torch.exp(-noise * cfg.mv_geo_weight_decay), 0.0)
    geo_loss = (_masked_mean(geo_w * pixel_noise, pixel_valid)
                + _masked_mean(geo_w * angle_noise, angle_valid))

    # --- NCC patch term ---------------------------------------------------------
    k = min(cfg.multi_view_sample_num, H * W)
    idx = (sample_valid_indices(generator, pixel_valid, k) if indices is None
           else indices.to(dev).long())
    pick_valid = pixel_valid[idx]
    ncc_weights = torch.where(pick_valid, torch.exp(-noise)[idx], 0.0)
    if material_stage:
        rough = torch.clamp(render_pkg["roughness_map"][0].detach().reshape(-1),
                            0, 1) ** 2.0
        ncc_weights = ncc_weights * rough[idx]

    pix = pixels.reshape(-1, 2)[idx]
    half = cfg.multi_view_patch_size
    patch_pix = pix[:, None, :] / ncc_scale + _patch_offsets(half, dev)[None]
    ref_gray = _ref_patches(gray_ref, pix, half, ncc_scale)     # (k, P)

    # Homography ref -> nearest per pixel from the rendered plane:
    # H = K_n (R - t n^T / d) K_ref^-1.
    rn_R = nearest_cam.world_view[:3, :3].T @ cam.world_view[:3, :3]
    rn_t = -rn_R @ cam.world_view[3, :3] + nearest_cam.world_view[3, :3]
    local_n = render_pkg["local_normal_map"].permute(1, 2, 0).reshape(-1, 3)[idx]
    local_d = render_pkg["distance_map"][0].reshape(-1)[idx]
    H_rn = rn_R[None] - (rn_t[None, :, None] @ local_n[:, None, :]) / \
        _safe_div_z(local_d[:, None, None], 1e-6)
    H_rn = (nearest_cam.get_K(ncc_scale)[None] @ H_rn
            @ cam.get_inv_K(ncc_scale)[None])
    nea_gray = sample_pixels(gray_nea, _patch_warp(H_rn, patch_pix))[..., 0]

    ncc, ncc_mask = _ncc(ref_gray, nea_gray)
    ncc_loss = _masked_mean(ncc * ncc_weights, ncc_mask & pick_valid)

    total = (cfg.multi_view_geo_weight * geo_loss
             + cfg.multi_view_ncc_weight * ncc_loss)
    return MultiViewOut(loss=total, geo_loss=geo_loss, ncc_loss=ncc_loss)


def _nearby_homography(cam, nearby_cam, render_pkg: dict, idx: torch.Tensor,
                       ncc_scale: float) -> torch.Tensor:
    """Per-pixel homographies ref -> nearby from the rendered plane at the
    sampled pixels: H = K_n (R - t n^T / d) K_ref^-1, (k, 3, 3)."""
    rn_R = nearby_cam.world_view[:3, :3].T @ cam.world_view[:3, :3]
    rn_t = -rn_R @ cam.world_view[3, :3] + nearby_cam.world_view[3, :3]
    local_n = render_pkg["local_normal_map"].permute(1, 2, 0).reshape(-1, 3)[idx]
    local_d = render_pkg["distance_map"][0].reshape(-1)[idx]
    H_rn = rn_R[None] - (rn_t[None, :, None] @ local_n[:, None, :]) / \
        _safe_div_z(local_d[:, None, None], 1e-6)
    return (nearby_cam.get_K(ncc_scale)[None] @ H_rn
            @ cam.get_inv_K(ncc_scale)[None])


def roughness_loss(cfg, cam, nearby_cam, render_pkg: dict, nearby_pkg: dict,
                   gray_ref: torch.Tensor, gray_nea: torch.Tensor,
                   ncc_scale: float = 1.0,
                   generator: torch.Generator | None = None,
                   indices: torch.Tensor | None = None) -> torch.Tensor:
    """Roughness-from-reflection supervision: the NCC error against a nearby
    view (all without gradient) pushes the sampled roughness up where the
    views disagree photometrically and down where they agree: the mean over
    the masked pixels of tanh(8 (ncc - threshold)) * roughness. The pixel
    sample comes from `generator`, or is given as `indices` (k,)."""
    H, W = cam.height, cam.width
    dev = render_pkg["depth_map"].device
    with torch.no_grad():
        iy, ix = torch.meshgrid(
            torch.arange(H, dtype=torch.float32, device=dev),
            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
        pixels = torch.stack([ix, iy], -1)

        pts = points_from_depth(cam, render_pkg["depth_map"])
        pts_in_nearby = nearby_cam.world_to_cam(pts)
        map_z, _, valid, _ = sample_depth_normal(
            pts_in_nearby, nearby_cam, nearby_pkg["depth_map"],
            nearby_pkg["normal_map"])
        valid = valid & (pts_in_nearby[:, 2] - map_z
                         <= cfg.mv_occlusion_threshold)

        k = min(cfg.multi_view_sample_num, H * W)
        idx = (sample_valid_indices(generator, valid, k) if indices is None
               else indices.to(dev).long())
        pick_valid = valid[idx]

        pix = pixels.reshape(-1, 2)[idx]
        half = cfg.multi_view_patch_size
        patch_pix = pix[:, None, :] / ncc_scale + _patch_offsets(half, dev)[None]
        ref_gray = _ref_patches(gray_ref, pix, half, ncc_scale)
        H_rn = _nearby_homography(cam, nearby_cam, render_pkg, idx, ncc_scale)
        nea_gray = sample_pixels(gray_nea, _patch_warp(H_rn, patch_pix))[..., 0]

        patch_size = 2 * half + 1
        ncc_grad, _ = _ncc(_patch_gradient(ref_gray, patch_size),
                           _patch_gradient(nea_gray, patch_size))
        ncc_gray, std_mask = _ncc(ref_gray, nea_gray, std_mask=True)
        ncc_error = torch.where(std_mask, ncc_grad, ncc_gray)
        ncc_error = torch.tanh(8.0 * (ncc_error - cfg.reflection_threshold))

    # Sampling the roughness map at the identity grid is the pixel itself.
    rough_vals = render_pkg["roughness_map"][0].reshape(-1)[idx]
    rv = rough_vals.detach()
    increase = (ncc_error < 0.0) & (rv <= 0.8)
    decrease = (ncc_error > 0.0) & (rv > 0.08)
    mf = ((increase | decrease) & pick_valid).to(rough_vals.dtype)
    return (torch.sum(ncc_error * rough_vals * mf)
            / torch.clamp_min(torch.sum(mf), 1.0))
