"""The reference's training losses, in plain PyTorch.

A frozen copy of GS-2M's staged losses as the port computes them: L1 +
SSIM (11x11 Gaussian window), the flattening prior, the alpha BCE, the
image-gradient-weighted depth-normal term, PGSR's multi-view geometric and
NCC terms (a fixed number of pixels drawn by top-k over uniform scores),
and the material stage's TV and roughness-from-reflection terms. Clips and
absolute values keep the subgradients at ties that the published
implementation's framework gives (half at a clip bound, +1 at |0|).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, x.new_full((), lo)), x.new_full((), hi))


def abs_(x):
    return torch.where(x >= 0, x, -x)


def _safe_norm(x, dim=-1, eps=1e-12, keepdim=False):
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim) + eps)


def _safe_div_z(z, threshold=1e-4):
    return torch.where(torch.abs(z) < threshold,
                       torch.where(z < 0, -threshold, threshold), z)


# --- photometric --------------------------------------------------------------------

def _window(device):
    xs = np.arange(11) - 5
    g = np.exp(-(xs ** 2) / (2.0 * 1.5 ** 2))
    return torch.from_numpy((g / g.sum()).astype(np.float32)).to(device)


def _blur(x):
    w = _window(x.device)
    b, c, h, wd = x.shape
    y = F.conv2d(x.reshape(b * c, 1, h, wd), w.reshape(1, 1, 11, 1), padding=(5, 0))
    return F.conv2d(y, w.reshape(1, 1, 1, 11), padding=(0, 5)).reshape(b, c, h, wd)


def ssim(img1, img2):
    """Mean SSIM; the gradient reaches img1 only."""
    img2 = img2.detach()
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    mu1, mu2 = _blur(img1), _blur(img2)
    s1 = _blur(img1 * img1) - mu1 * mu1
    s2 = _blur(img2 * img2) - mu2 * mu2
    s12 = _blur(img1 * img2) - mu1 * mu2
    m = ((2.0 * mu1 * mu2 + C1) * (2.0 * s12 + C2)) / (
        (mu1 * mu1 + mu2 * mu2 + C1) * (s1 + s2 + C2))
    return torch.mean(m)


def rgb_loss(pred, gt, lambda_ssim):
    ls = 1.0 - ssim(pred[None], gt[None])
    return (1.0 - lambda_ssim) * torch.mean(abs_(pred - gt)) + lambda_ssim * ls


def bce(pred, target):
    p = torch.clamp(pred, 1e-7, 1.0 - 1e-7)
    return torch.mean(-(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p)))


def plane_loss(visibility, scaling):
    w = visibility.to(scaling.dtype)
    return torch.sum(torch.amin(scaling, -1) * w) / torch.clamp_min(w.sum(), 1.0)


def _img_grad_weight(img):
    _, hd, wd = img.shape
    gx = torch.mean(torch.abs(img[..., 1:hd - 1, 2:wd] - img[..., 1:hd - 1, 0:wd - 2]), 0)
    gy = torch.mean(torch.abs(img[..., 0:hd - 2, 1:wd - 1] - img[..., 2:hd, 1:wd - 1]), 0)
    g = torch.maximum(gx, gy)
    g = (g - g.min()) / (g.max() - g.min() + 1e-12)
    return F.pad(g, (1, 1, 1, 1))


def depth_normal_loss(normal_map, sobel_map, gt):
    with torch.no_grad():
        w = torch.clamp(1.0 - _img_grad_weight(gt), 0.0, 1.0) ** 2
    return torch.mean(w * torch.sum(abs_(sobel_map - normal_map), 0))


def tv_loss(gt, pred, norm1=True, weight_map=None):
    rgb_h = torch.exp(-torch.mean(torch.abs(gt[:, 1:, :] - gt[:, :-1, :]), 0, keepdim=True))
    rgb_w = torch.exp(-torch.mean(torch.abs(gt[:, :, 1:] - gt[:, :, :-1]), 0, keepdim=True))
    dh = pred[:, 1:, :] - pred[:, :-1, :]
    dw = pred[:, :, 1:] - pred[:, :, :-1]
    lh = (abs_(dh) if norm1 else dh ** 2) * rgb_h
    lw = (abs_(dw) if norm1 else dw ** 2) * rgb_w
    if weight_map is not None:
        lh = lh * (weight_map[:, 1:, :] + weight_map[:, :-1, :]) / 2.0
        lw = lw * (weight_map[:, :, 1:] + weight_map[:, :, :-1]) / 2.0
    return torch.mean(lh) + torch.mean(lw)


# --- bilinear sampling ------------------------------------------------------------------

def sample_pixels(img, pix):
    """(C, H, W) at pixel coordinates (..., 2), bilinear, border clamp
    (align_corners normalisation, as the published loss samples)."""
    C, H, W = img.shape
    gx = 2.0 * pix[..., 0] / (W - 1) - 1.0
    gy = 2.0 * pix[..., 1] / (H - 1) - 1.0
    gx = clip((gx + 1.0) * 0.5 * (W - 1), 0.0, W - 1)
    gy = clip((gy + 1.0) * 0.5 * (H - 1), 0.0, H - 1)
    x0, y0 = torch.floor(gx), torch.floor(gy)
    wx, wy = (gx - x0)[..., None], (gy - y0)[..., None]
    x0i = torch.clamp(x0, 0, W - 1).long()
    x1i = torch.clamp(x0 + 1, 0, W - 1).long()
    y0i = torch.clamp(y0, 0, H - 1).long()
    y1i = torch.clamp(y0 + 1, 0, H - 1).long()
    flat = img.reshape(C, H * W).T
    tap = lambda yi, xi: flat[(yi * W + xi).reshape(-1)].reshape(*yi.shape, C)
    top = tap(y0i, x0i) * (1 - wx) + tap(y0i, x1i) * wx
    bot = tap(y1i, x0i) * (1 - wx) + tap(y1i, x1i) * wx
    return top * (1 - wy) + bot * wy


# --- multi-view ------------------------------------------------------------------------

def points_from_depth(cam, depth_map):
    return cam.cam_to_world((cam.get_rays() * depth_map[0][..., None]).reshape(-1, 3))


def sample_depth_normal(pts, cam, depth_map, normal_map):
    W, H = cam.width, cam.height
    z = _safe_div_z(pts[:, 2])
    proj = torch.stack([pts[:, 0] * cam.fx / z + cam.cx,
                        pts[:, 1] * cam.fy / z + cam.cy], -1)
    z = pts[:, 2]
    valid = ((proj[:, 0] > 0) & (proj[:, 0] < W) & (proj[:, 1] > 0)
             & (proj[:, 1] < H) & (z > 0.1))
    zn = sample_pixels(torch.cat([depth_map, normal_map], 0), proj)
    map_n = zn[:, 1:4]
    return zn[:, 0], map_n / _safe_norm(map_n, keepdim=True), valid


def reproject_points(from_cam, to_cam, pts, depth):
    pts = pts / _safe_div_z(pts[:, 2:3]) * depth[:, None]
    p = to_cam.world_to_cam(from_cam.cam_to_world(pts))
    pz = _safe_div_z(p[:, 2])
    return torch.stack([p[:, 0] * to_cam.fx / pz + to_cam.cx,
                        p[:, 1] * to_cam.fy / pz + to_cam.cy], -1)


def _offsets(half, device):
    o = torch.arange(-half, half + 1, dtype=torch.float32, device=device)
    dx, dy = torch.meshgrid(o, o, indexing="xy")
    return torch.stack([dx.reshape(-1), dy.reshape(-1)], -1)


def _ref_patches(gray, pix, half, ncc_scale):
    """(k, P) reference patches at pix / ncc_scale + offsets. With an integer
    1 / ncc_scale every tap is an exact pixel: a border-clamped read."""
    inv = 1.0 / ncc_scale
    if abs(inv - round(inv)) > 1e-9:
        return sample_pixels(gray, pix[:, None, :] / ncc_scale
                             + _offsets(half, pix.device)[None])[..., 0]
    inv = int(round(inv))
    Hs, Ws = gray.shape[-2:]
    bx = (pix[:, 0] * inv).to(torch.int32).long()
    by = (pix[:, 1] * inv).to(torch.int32).long()
    o = torch.arange(-half, half + 1, device=pix.device)
    yy = torch.clamp(by[:, None, None] + o[None, :, None], 0, Hs - 1)
    xx = torch.clamp(bx[:, None, None] + o[None, None, :], 0, Ws - 1)
    return gray[0][yy, xx].reshape(pix.shape[0], -1)


def _patch_warp(Hm, uv):
    homo = torch.cat([uv, torch.ones_like(uv[..., :1])], -1)
    out = torch.einsum("nik,npk->npi", Hm, homo)
    return out[..., :2] / _safe_div_z(out[..., 2:], 1e-6)


def _ncc(ref, nea, std_mask=False):
    tps = ref.shape[1]
    ref_sum, nea_sum = ref.sum(1), nea.sum(1)
    cross = (ref * nea).sum(1) - nea_sum / tps * ref_sum
    ref_var = (ref * ref).sum(1) - ref_sum / tps * ref_sum
    nea_var = (nea * nea).sum(1) - nea_sum / tps * nea_sum
    ncc = torch.clamp(1.0 - cross * cross / (ref_var * nea_var + 1e-8), 0.0, 2.0)
    if std_mask:
        return ncc, torch.sqrt(torch.clamp_min(ref_var, 0.0)) < 0.01
    return ncc, ncc < 0.9


def sample_valid_indices(generator, valid, k):
    u = torch.rand(valid.shape, generator=generator, device=valid.device)
    return torch.topk(torch.where(valid, u, -1.0), k).indices


def _masked_mean(x, m):
    mf = m.to(x.dtype)
    return torch.sum(x * mf) / torch.clamp_min(mf.sum(), 1.0)


def _homography(cam, other, pkg, idx, ncc_scale):
    R = other.world_view[:3, :3].T @ cam.world_view[:3, :3]
    t = -R @ cam.world_view[3, :3] + other.world_view[3, :3]
    n = pkg["local_normal_map"].permute(1, 2, 0).reshape(-1, 3)[idx]
    d = pkg["distance_map"][0].reshape(-1)[idx]
    Hm = R[None] - (t[None, :, None] @ n[:, None, :]) / _safe_div_z(d[:, None, None], 1e-6)
    return other.get_K(ncc_scale)[None] @ Hm @ cam.get_inv_K(ncc_scale)[None]


def _pixel_grid(H, W, dev):
    iy, ix = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    return torch.stack([ix, iy], -1).reshape(-1, 2)


def multi_view_loss(o, cam, ncam, pkg, npkg, gray_ref, gray_nea, material,
                    ncc_scale, generator):
    H, W = cam.height, cam.width
    pixels = _pixel_grid(H, W, pkg["depth_map"].device)
    pts_n = ncam.world_to_cam(points_from_depth(cam, pkg["depth_map"]))
    map_z, map_n, valid = sample_depth_normal(pts_n, ncam, npkg["depth_map"],
                                              npkg["normal_map"])
    valid = valid & (pts_n[:, 2] - map_z <= o["mv_occlusion_threshold"])
    pixel_noise = _safe_norm(reproject_points(ncam, cam, pts_n, map_z) - pixels)
    normals = pkg["normal_map"].reshape(3, -1).T
    normals = normals / _safe_norm(normals, keepdim=True)
    angle_err = torch.acos(torch.clamp(torch.sum(normals * map_n, 1),
                                       -1 + 1e-6, 1 - 1e-6))
    angle_valid = valid & (angle_err < o["mv_angle_threshold"] * math.pi / 180.0)
    pixel_valid = valid & (pixel_noise < 1.0)
    noise = pixel_noise.detach()
    geo_w = torch.where(pixel_valid, torch.exp(-noise * o["mv_geo_weight_decay"]), 0.0)
    angle_noise = o["mv_angle_factor"] * angle_err
    geo = (_masked_mean(geo_w * pixel_noise, pixel_valid)
           + _masked_mean(geo_w * angle_noise, angle_valid))

    k = min(o["multi_view_sample_num"], H * W)
    idx = sample_valid_indices(generator, pixel_valid, k)
    pick = pixel_valid[idx]
    wts = torch.where(pick, torch.exp(-noise)[idx], 0.0)
    if material:
        rough = torch.clamp(pkg["roughness_map"][0].detach().reshape(-1), 0, 1) ** 2.0
        wts = wts * rough[idx]
    pix = pixels[idx]
    half = o["multi_view_patch_size"]
    patch_pix = pix[:, None, :] / ncc_scale + _offsets(half, pix.device)[None]
    ref = _ref_patches(gray_ref, pix, half, ncc_scale)
    Hm = _homography(cam, ncam, pkg, idx, ncc_scale)
    nea = sample_pixels(gray_nea, _patch_warp(Hm, patch_pix))[..., 0]
    ncc, mask = _ncc(ref, nea)
    ncc_loss = _masked_mean(ncc * wts, mask & pick)
    return o["multi_view_geo_weight"] * geo + o["multi_view_ncc_weight"] * ncc_loss


def _patch_gradient(patch, size):
    n = patch.shape[0]
    x = patch.reshape(n, 1, size, size)
    sx = torch.tensor([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=patch.dtype,
                      device=patch.device).reshape(1, 1, 3, 3)
    gx = F.conv2d(x, sx, padding=1)
    gy = F.conv2d(x, sx.transpose(-1, -2), padding=1)
    return torch.sqrt(gx ** 2 + gy ** 2 + 1e-6).reshape(n, -1)


def roughness_loss(o, cam, ncam, pkg, npkg, gray_ref, gray_nea, ncc_scale,
                   generator):
    H, W = cam.height, cam.width
    with torch.no_grad():
        pixels = _pixel_grid(H, W, pkg["depth_map"].device)
        pts_n = ncam.world_to_cam(points_from_depth(cam, pkg["depth_map"]))
        map_z, _, valid = sample_depth_normal(pts_n, ncam, npkg["depth_map"],
                                              npkg["normal_map"])
        valid = valid & (pts_n[:, 2] - map_z <= o["mv_occlusion_threshold"])
        k = min(o["multi_view_sample_num"], H * W)
        idx = sample_valid_indices(generator, valid, k)
        pick = valid[idx]
        pix = pixels[idx]
        half = o["multi_view_patch_size"]
        patch_pix = pix[:, None, :] / ncc_scale + _offsets(half, pix.device)[None]
        ref = _ref_patches(gray_ref, pix, half, ncc_scale)
        nea = sample_pixels(gray_nea, _patch_warp(
            _homography(cam, ncam, pkg, idx, ncc_scale), patch_pix))[..., 0]
        size = 2 * half + 1
        ncc_grad, _ = _ncc(_patch_gradient(ref, size), _patch_gradient(nea, size))
        ncc_gray, flat = _ncc(ref, nea, std_mask=True)
        err = torch.tanh(8.0 * (torch.where(flat, ncc_grad, ncc_gray)
                                - o["reflection_threshold"]))
    rough = pkg["roughness_map"][0].reshape(-1)[idx]
    rv = rough.detach()
    mf = ((((err < 0.0) & (rv <= 0.8)) | ((err > 0.0) & (rv > 0.08)))
          & pick).to(rough.dtype)
    return torch.sum(err * rough * mf) / torch.clamp_min(mf.sum(), 1.0)
