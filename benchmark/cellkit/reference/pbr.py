"""The reference's material stage: the learned cubemap light, its split-sum
prefilter, deferred PBR shading and GS-2M's material losses, in plain
PyTorch.

A frozen copy of the published split-sum model as the port evaluates it:
mips by 2x2 average pooling down to 16 texels, a cosine-weighted diffuse
prefilter and GGX-weighted specular prefilters as dense weight matrices
(built here in numpy), seamless bilinear cube lookups through a one-texel
cross-face border, a Karis BRDF look-up table by Hammersley quadrature,
and the material stage's PBR photometric, smoothness, normal-TV and
roughness-from-reflection terms. Everything the program derives (the
weight matrices, the look-up table, the pad indices) is derived again here.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import losses as L

LIGHT_MIN_RES = 16
MIN_ROUGHNESS = 0.04
MAX_ROUGHNESS = 0.5
PREFILTER_MAX_RES = 32


def _faces(gx, gy):
    one = np.ones_like(gx)
    return np.stack([np.stack([one, -gy, -gx], -1), np.stack([-one, -gy, gx], -1),
                     np.stack([gx, one, gy], -1), np.stack([gx, -one, -gy], -1),
                     np.stack([gx, -gy, one], -1), np.stack([-gx, -gy, -one], -1)], 0)


def cube_dirs(res):
    f = (np.arange(res) + 0.5) / res * 2.0 - 1.0
    gx, gy = np.meshgrid(f, f, indexing="xy")
    d = _faces(gx, gy)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def texel_solid_angle(res):
    b = np.arange(res + 1) / res * 2.0 - 1.0
    bx, by = np.meshgrid(b, b, indexing="xy")
    s = np.arctan2(bx * by, np.sqrt(bx * bx + by * by + 1.0))
    return (s[1:, 1:] - s[:-1, 1:] - s[1:, :-1] + s[:-1, :-1]).astype(np.float32)


def _face_uv(x, y, z, xp):
    """Dominant-axis face and (u, v) in [0, 1]; xp is numpy or torch."""
    ax, ay, az = xp.abs(x), xp.abs(y), xp.abs(z)
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    face = xp.where(is_x, xp.where(x > 0, 0, 1),
                    xp.where(is_y, xp.where(y > 0, 2, 3), xp.where(z > 0, 4, 5)))
    ma = xp.where(is_x, ax, xp.where(is_y, ay, az)) + 1e-12
    fxs = [-z / ma, z / ma, x / ma, x / ma, x / ma, -x / ma]
    fys = [-y / ma, -y / ma, z / ma, -z / ma, -y / ma, -y / ma]
    fx, fy = fxs[5], fys[5]
    for k in range(4, -1, -1):
        fx = xp.where(face == k, fxs[k], fx)
        fy = xp.where(face == k, fys[k], fy)
    return face, (fx + 1.0) * 0.5, (fy + 1.0) * 0.5


@functools.lru_cache(maxsize=None)
def _pad_index(res):
    """Flat source texel of every texel of the one-texel padded cube."""
    g = (np.arange(-1, res + 1) + 0.5) / res * 2.0 - 1.0
    fx, fy = np.meshgrid(g, g, indexing="xy")
    d = _faces(fx, fy)
    face, u, v = _face_uv(d[..., 0], d[..., 1], d[..., 2], np)
    col = np.clip(np.floor(u.astype(np.float32) * res), 0, res - 1)
    row = np.clip(np.floor(v.astype(np.float32) * res), 0, res - 1)
    return ((face.astype(np.int64) * res + row.astype(np.int64)) * res
            + col.astype(np.int64))


def pad_cube(cube):
    _, R, _, C = cube.shape
    idx = torch.from_numpy(_pad_index(R)).to(cube.device)
    padded = cube.reshape(-1, C)[idx.reshape(-1)].reshape(6, R + 2, R + 2, C)
    # The interior is the cube itself, passed through.
    inner = torch.zeros(6, R + 2, R + 2, 1, dtype=torch.bool, device=cube.device)
    inner[:, 1:-1, 1:-1] = True
    full = torch.nn.functional.pad(cube, (0, 0, 1, 1, 1, 1))
    return torch.where(inner, full, padded)


def _taps(face, u, v, R):
    gu, gv = u * R + 0.5, v * R + 0.5
    u0, v0 = torch.floor(gu), torch.floor(gv)
    wu, wv = (gu - u0)[..., None], (gv - v0)[..., None]
    Rp, hi = R + 2, R + 1
    u0i, u1i = torch.clamp(u0, 0, hi).long(), torch.clamp(u0 + 1, 0, hi).long()
    v0i, v1i = torch.clamp(v0, 0, hi).long(), torch.clamp(v0 + 1, 0, hi).long()
    base = face * Rp
    return [(base + v0i) * Rp + u0i, (base + v0i) * Rp + u1i,
            (base + v1i) * Rp + u0i, (base + v1i) * Rp + u1i], wu, wv


def _lookup_taps(cube, face, u, v):
    R, C = cube.shape[1], cube.shape[3]
    flat = pad_cube(cube).reshape(-1, C)
    idx, wu, wv = _taps(face, u, v, R)
    t = [flat[i.reshape(-1)].reshape(*i.shape, C) for i in idx]
    return (t[0] * (1 - wu) + t[1] * wu) * (1 - wv) + (t[2] * (1 - wu) + t[3] * wu) * wv


def cube_lookup(cube, dirs):
    face, u, v = _face_uv(dirs[..., 0], dirs[..., 1], dirs[..., 2], torch)
    return _lookup_taps(cube, face.long(), u, v)


def upsample_cube(cube, res):
    face, u, v = _face_uv(*np.moveaxis(cube_dirs(res), -1, 0), np)
    dev = cube.device
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return _lookup_taps(cube, t(face.astype(np.int64)), t(u.astype(np.float32)),
                        t(v.astype(np.float32)))


def _ndf_ggx(a2, c):
    c = np.clip(c, 0.0, 1.0)
    d = (c * a2 - c) * c + 1.0
    return a2 / (d * d * np.pi)


@functools.lru_cache(maxsize=None)
def ndf_cutoff(roughness, cutoff=0.99):
    ct = np.cos(np.linspace(0, np.pi / 2.0, 1_000_000))
    D = np.cumsum(_ndf_ggx(roughness ** 4, ct))
    return float(ct[int(np.argmax(D >= D[-1] * cutoff))])


@functools.lru_cache(maxsize=None)
def _weights(kind, res, roughness):
    d = cube_dirs(res).reshape(-1, 3)
    area = np.tile(texel_solid_angle(res)[None], (6, 1, 1)).reshape(-1)
    cos = d @ d.T
    if kind == "diffuse":
        return (np.clip(cos, 0.0, 0.999) * area[None, :] / np.pi).astype(np.float32)
    vnr_h = np.sqrt(np.clip((1.0 + cos) / 2.0, 0.0, 1.0))
    w = np.clip(cos, 0.0, None) * _ndf_ggx(roughness ** 4, vnr_h) * area[None, :] / 4.0
    w = np.where(cos >= ndf_cutoff(roughness), w, 0.0)
    return (w / np.maximum(w.sum(axis=1, keepdims=True), 1e-12)).astype(np.float32)


def _prefilter_res(base_res, roughness):
    theta = float(np.arccos(np.clip(ndf_cutoff(roughness), -1, 1)))
    if theta < 1.5 * (2.0 / base_res):
        return 0
    need = int(2 ** np.ceil(np.log2(max(4.0 / max(theta, 1e-6), LIGHT_MIN_RES))))
    return min(need, PREFILTER_MAX_RES, base_res)


def _ramp(n):
    """The mip levels' roughness: MIN to MAX, the last level 1.0."""
    return [(i / (n - 2)) * (MAX_ROUGHNESS - MIN_ROUGHNESS) + MIN_ROUGHNESS
            for i in range(n - 1)] + [1.0]


def mip_plan(base_res):
    """(diffuse prefilter resolution, the specular prefilter resolution of
    each mip level that is prefiltered): the dense matmuls build_mips runs."""
    n, res = 1, base_res
    while res > LIGHT_MIN_RES:
        res //= 2
        n += 1
    spec = [_prefilter_res(base_res >> i, r) for i, r in enumerate(_ramp(n))]
    return LIGHT_MIN_RES, [s for s in spec if s]


def _pool(c):
    six, R, _, C = c.shape
    return c.reshape(six, R // 2, 2, R // 2, 2, C).mean(dim=(2, 4))


def build_mips(base):
    mips = [base]
    while mips[-1].shape[1] > LIGHT_MIN_RES:
        mips.append(_pool(mips[-1]))
    ramp = _ramp(len(mips))
    dev = base.device
    S = mips[-1].shape[1]
    Wd = torch.from_numpy(_weights("diffuse", S, 0.0)).to(dev)
    diffuse = (Wd @ mips[-1].reshape(-1, 3)).reshape(6, S, S, 3)
    specular = []
    for mip, r in zip(mips, ramp):
        R = mip.shape[1]
        s_i = _prefilter_res(R, r)
        if s_i == 0:
            specular.append(mip)
            continue
        src = mip
        while src.shape[1] > s_i:
            src = _pool(src)
        s = src.shape[1]
        Ws = torch.from_numpy(_weights("specular", s, float(r))).to(dev)
        out = (Ws @ src.reshape(-1, 3)).reshape(6, s, s, 3)
        specular.append(upsample_cube(out, R) if R != s else out)
    return diffuse, specular


def _hammersley(n):
    i = np.arange(n)
    b = i.astype(np.uint32)
    b = (b << np.uint32(16)) | (b >> np.uint32(16))
    for m, sh in ((0x55555555, 1), (0x33333333, 2), (0x0F0F0F0F, 4), (0x00FF00FF, 8)):
        b = ((b & np.uint32(m)) << np.uint32(sh)) | ((b & np.uint32(~m & 0xFFFFFFFF))
                                                     >> np.uint32(sh))
    return np.stack([i / n, b.astype(np.float64) * 2.3283064365386963e-10], -1)


@functools.lru_cache(maxsize=1)
def brdf_lut(res=256, n=512):
    """(res, res, 2) split-sum (A, B) over (NoV, roughness), Karis 2013."""
    xi = _hammersley(n)
    c = (np.arange(res) + 0.5) / res
    NoV, R = np.meshgrid(c, c, indexing="ij")
    V = np.stack([np.sqrt(1 - NoV ** 2), np.zeros_like(NoV), NoV], -1)
    a = R ** 2
    A, B = np.zeros((res, res)), np.zeros((res, res))
    k = (R ** 2) / 2.0
    g1v = NoV / (NoV * (1 - k) + k)
    for u1, u2 in xi:
        phi = 2 * np.pi * u1
        cos_t = np.sqrt((1 - u2) / (1 + (a ** 2 - 1) * u2))
        sin_t = np.sqrt(np.maximum(1 - cos_t ** 2, 0))
        Hh = np.stack([sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t], -1)
        VdotH = np.sum(V * Hh, -1)
        Lv = 2 * VdotH[..., None] * Hh - V
        NoL = np.clip(Lv[..., 2], 0, 1)
        NoH = np.clip(Hh[..., 2], 0, 1)
        VoH = np.clip(VdotH, 0, 1)
        G = g1v * (NoL / (NoL * (1 - k) + k + 1e-12))
        Gv = np.where(NoL > 0, G * VoH / (NoH * NoV + 1e-12), 0.0)
        Fc = (1 - VoH) ** 5
        A += (1 - Fc) * Gv
        B += Fc * Gv
    return (np.stack([A, B], -1) / n).astype(np.float32)


def sample_lut(lut, uv):
    R = lut.shape[0]
    g = uv * R - 0.5
    g0 = torch.floor(g)
    w = g - g0
    i0, i1 = torch.clamp(g0[..., 0], 0, R - 1).long(), torch.clamp(g0[..., 0] + 1, 0, R - 1).long()
    j0, j1 = torch.clamp(g0[..., 1], 0, R - 1).long(), torch.clamp(g0[..., 1] + 1, 0, R - 1).long()
    wu, wv = w[..., 0:1], w[..., 1:2]
    top = lut[i0, j0] * (1 - wv) + lut[i0, j1] * wv
    bot = lut[i1, j0] * (1 - wv) + lut[i1, j1] * wv
    return top * (1 - wu) + bot * wu


def shade(diffuse, specular, normals, view_dirs, albedo, roughness, metallic, lut):
    """Split-sum shading of (H, W, C) maps, clipped to [0, 1]."""
    ref = 2.0 * torch.maximum(torch.sum(normals * view_dirs, -1, keepdim=True),
                              normals.new_zeros(())) * normals - view_dirs
    diffuse_light = cube_lookup(diffuse, normals)
    occ = torch.ones_like(diffuse_light[..., :1])
    irr = torch.zeros_like(diffuse_light[..., :1])
    diffuse_rgb = (diffuse_light * occ + (1 - occ) * irr) * albedo
    NoV = L.clip(torch.sum(normals * view_dirs, -1, keepdim=True), 1e-4, 1.0)
    fg = sample_lut(lut, torch.cat([NoV, roughness], -1))
    n = len(specular)
    lo = (L.clip(roughness, MIN_ROUGHNESS, MAX_ROUGHNESS) - MIN_ROUGHNESS) / (
        MAX_ROUGHNESS - MIN_ROUGHNESS) * (n - 2)
    hi = (L.clip(roughness, MAX_ROUGHNESS, 1.0) - MAX_ROUGHNESS) / (
        1.0 - MAX_ROUGHNESS) + n - 2
    mip = torch.where(roughness < MAX_ROUGHNESS, lo, hi)
    samples = torch.stack([cube_lookup(s, ref) for s in specular], 0)
    m = L.clip(mip[..., 0], 0.0, n - 1)
    lo_i = torch.floor(m).long()
    hi_i = torch.clamp_max(lo_i + 1, n - 1)
    wm = (m - lo_i)[..., None]
    levels = torch.arange(n, device=m.device).reshape(n, *([1] * lo_i.dim()))
    s_lo = torch.sum(torch.where((levels == lo_i)[..., None], samples, 0.0), 0)
    s_hi = torch.sum(torch.where((levels == hi_i)[..., None], samples, 0.0), 0)
    spec = s_lo * (1 - wm) + s_hi * wm
    F0 = (1.0 - metallic) * 0.04 + albedo * metallic
    return L.clip(diffuse_rgb + spec * (F0 * fg[..., 0:1] + fg[..., 1:2]), 0.0, 1.0)


def view_dirs_world(cam):
    H, W = cam.height, cam.width
    dev = cam.device
    y, x = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev),
                          indexing="ij")
    rays = torch.stack([(x.reshape(-1) - cam.cx + 0.5) / cam.fx,
                        (y.reshape(-1) - cam.cy + 0.5) / cam.fy,
                        torch.ones(H * W, device=dev)], -1)
    rays = rays / (torch.linalg.norm(rays, dim=-1, keepdim=True) + 1e-12)
    vd = -(rays @ cam.world_view[:3, :3].T)
    vd = vd / (torch.linalg.norm(vd, dim=-1, keepdim=True) + 1e-12)
    return vd.reshape(H, W, 3)


def material_loss(o, cam, pkg, gt, light, ncam, has_nearby, gray_ref, gray_nea,
                  ncc_scale, render_nearby, generator, lut):
    """GS-2M's material-stage loss of one view (metallic from alpha and
    roughness, no gamma)."""
    diffuse, specular = build_mips(light)
    nm = pkg["normal_map"].detach()
    nrm = torch.linalg.norm(nm, dim=0, keepdim=True)
    nm = torch.where(nrm > 0, nm / (nrm + 1e-12), nm)
    albedo = L.clip(pkg["albedo_map"], 0.0, 1.0)
    rough_raw = pkg["roughness_map"]
    metallic = (pkg["alpha_map"].detach() * L.clip(1.0 - rough_raw, 0.0, 1.0)).detach()
    rough = (rough_raw * (1.0 - 0.04) + 0.04).detach()
    hwc = lambda x: x.permute(1, 2, 0)
    rgb = shade(diffuse, specular, hwc(nm), view_dirs_world(cam), hwc(albedo),
                hwc(rough), hwc(metallic), lut)
    rgb = L.clip(rgb.permute(2, 0, 1), 0.0, 1.0)
    rgb = torch.where(pkg["normal_mask"], rgb, 0.0)
    Lpbr = L.rgb_loss(rgb, gt, o["lambda_ssim"])
    Lsm = (o["lambda_smooth"] * L.tv_loss(gt, pkg["roughness_map"], norm1=False)
           + 0.01 * L.tv_loss(gt, pkg["albedo_map"]))
    wn = (1.0 - pkg["roughness_map"]).detach()
    wn = L.clip(0.5 * torch.tanh(8.0 * (wn - 0.5)) + 0.5, 0.0, 1.0)
    Ltv = o["lambda_normal"] * L.tv_loss(gt, pkg["normal_map"], weight_map=wn)
    Lr = gt.new_zeros(())
    if has_nearby:
        with torch.no_grad():
            npkg = render_nearby(ncam)
        Lr = L.roughness_loss(o, cam, ncam, pkg, npkg, gray_ref, gray_nea,
                              ncc_scale, generator)
    return Lpbr + Lsm + Ltv + o["lambda_rough"] * Lr
