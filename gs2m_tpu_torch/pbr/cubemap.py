"""Cubemap environment light: lookup, mip chain, diffuse/GGX prefilter.

Port of gs2m_tpu/pbr/cubemap.py. The prefilters are the JAX package's
precomputed weight matrices, built by the same numpy code (so bit-equal)
once per (resolution, roughness) and kept on the device per device
(`_device_weights`); each filter is one torch.matmul with TF32 off (the
package pins it), differentiable in the light through autograd. The
lookups gather bilinear taps through `ops/gather.py`, so the light's
gradient, a scatter of every pixel's taps into six levels, is summed by a
sort-based segment sum, the same bits on every run; static direction
grids (upsampling, lat-long export, the pad ring) keep their sorted
index tables on the device.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from gs2m_tpu_torch.ops.gather import gather_rows, plan

LIGHT_MIN_RES = 16
MIN_ROUGHNESS = 0.04
MAX_ROUGHNESS = 0.5
PREFILTER_MAX_RES = 32  # dense-integral cap (6*32^2 = 6144 texels)


class CubemapConfig:
    base_res: int = 512


# --- direction <-> face/uv maps --------------------------------------------------

def cube_dirs(res: int) -> np.ndarray:
    """(6, res, res, 3) unit direction of each texel center."""
    fx = (np.arange(res) + 0.5) / res * 2.0 - 1.0
    gx, gy = np.meshgrid(fx, fx, indexing="xy")  # gx varies along x (cols)
    one = np.ones_like(gx)
    faces = [
        np.stack([one, -gy, -gx], -1),
        np.stack([-one, -gy, gx], -1),
        np.stack([gx, one, gy], -1),
        np.stack([gx, -one, -gy], -1),
        np.stack([gx, -gy, one], -1),
        np.stack([-gx, -gy, -one], -1),
    ]
    d = np.stack(faces, 0)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def texel_solid_angle(res: int) -> np.ndarray:
    """(res, res) exact solid angle of each texel via the corner formula
    sigma(x, y) = atan2(x*y, sqrt(x^2 + y^2 + 1)); the texels of the six
    faces cover 4*pi."""
    b = np.arange(res + 1) / res * 2.0 - 1.0  # texel borders in [-1, 1]
    bx, by = np.meshgrid(b, b, indexing="xy")
    sigma = np.arctan2(bx * by, np.sqrt(bx * bx + by * by + 1.0))
    area = (sigma[1:, 1:] - sigma[:-1, 1:] - sigma[1:, :-1] + sigma[:-1, :-1])
    return area.astype(np.float32)  # (y, x)


def dir_to_face_uv(dirs: torch.Tensor):
    """(..., 3) directions -> (face int64, u, v in [0, 1]) inverting
    cube_dirs: the dominant axis and its sign pick the face."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    ax, ay, az = torch.abs(x), torch.abs(y), torch.abs(z)
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    face = torch.where(is_x, torch.where(x > 0, 0, 1),
                       torch.where(is_y, torch.where(y > 0, 2, 3),
                                   torch.where(z > 0, 4, 5)))
    ma = torch.where(is_x, ax, torch.where(is_y, ay, az)) + 1e-12
    # Per-face (fx, fy) such that cube_dirs(face, fx, fy) == dir:
    #   0: (+1, -fy, -fx)   1: (-1, -fy, +fx)
    #   2: (fx, +1,  fy)    3: (fx, -1, -fy)
    #   4: (fx, -fy, +1)    5: (-fx, -fy, -1)
    fxs = torch.stack([-z / ma, z / ma, x / ma, x / ma, x / ma, -x / ma])
    fys = torch.stack([-y / ma, -y / ma, z / ma, -z / ma, -y / ma, -y / ma])
    sel = face[None].long()
    fx = torch.gather(fxs, 0, sel)[0]
    fy = torch.gather(fys, 0, sel)[0]
    return face.long(), (fx + 1.0) * 0.5, (fy + 1.0) * 0.5


def _dir_to_face_uv_np(d: np.ndarray):
    """Host-side dir_to_face_uv (the same dominant-axis rules), for static
    direction grids."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = np.abs(x), np.abs(y), np.abs(z)
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    face = np.where(is_x, np.where(x > 0, 0, 1),
                    np.where(is_y, np.where(y > 0, 2, 3),
                             np.where(z > 0, 4, 5)))
    ma = np.where(is_x, ax, np.where(is_y, ay, az)) + 1e-12
    sel = [face == k for k in range(6)]
    fx = np.select(sel, [-z / ma, z / ma, x / ma, x / ma, x / ma, -x / ma])
    fy = np.select(sel, [-y / ma, -y / ma, z / ma, -z / ma, -y / ma, -y / ma])
    return face.astype(np.int32), ((fx + 1.0) * 0.5).astype(np.float32), \
        ((fy + 1.0) * 0.5).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _pad_gather_indices(res: int):
    """(face, row, col) int32 numpy arrays, each (6, res+2, res+2), mapping
    every texel of the 1-texel-padded cube onto the nearest texel of the
    unpadded cube: interior texels map to themselves, the border ring across
    the seam onto the adjacent face's edge texels (pad corners pick one of
    the three meeting faces). The face's (fx, fy) grid is extrapolated one
    texel beyond [-1, 1] and inverted with dir_to_face_uv's rules."""
    g = (np.arange(-1, res + 1) + 0.5) / res * 2.0 - 1.0  # padded texel centers
    fx, fy = np.meshgrid(g, g, indexing="xy")  # fx varies along cols
    one = np.ones_like(fx)
    faces = [
        np.stack([one, -fy, -fx], -1),
        np.stack([-one, -fy, fx], -1),
        np.stack([fx, one, fy], -1),
        np.stack([fx, -one, -fy], -1),
        np.stack([fx, -fy, one], -1),
        np.stack([-fx, -fy, -one], -1),
    ]
    d = np.stack(faces, 0)  # (6, res+2, res+2, 3), unnormalized
    face, u, v = _dir_to_face_uv_np(d)  # dominant-axis rules, scale-invariant
    col = np.clip(np.floor(u * res), 0, res - 1).astype(np.int32)
    row = np.clip(np.floor(v * res), 0, res - 1).astype(np.int32)
    return face, row, col


@functools.cache
def _pad_plans(res: int, device: torch.device):
    """The pad ring's flat source indices into the (6*res*res) texels, as
    sorted gather plans on `device`: (top, bottom, left, right)."""
    F, Rw, Cw = _pad_gather_indices(res)
    flat = (F.astype(np.int64) * res + Rw) * res + Cw
    n = 6 * res * res
    parts = (flat[:, 0, :], flat[:, -1, :], flat[:, 1:-1, 0], flat[:, 1:-1, -1])
    return tuple(plan(torch.from_numpy(np.ascontiguousarray(p)).to(device), n)
                 for p in parts)


def pad_cube(cubemap: torch.Tensor) -> torch.Tensor:
    """(6, R, R, C) -> (6, R+2, R+2, C) with a 1-texel cross-face border:
    bilinear taps that cross a face edge land on the neighbor face's edge
    texels instead of clamping. Only the ring is gathered; the interior is
    concatenated through."""
    _, res, _, C = cubemap.shape
    top, bot, left, right = (gather_rows(cubemap.reshape(-1, C), p)
                             for p in _pad_plans(res, cubemap.device))
    mid = torch.cat([left[:, :, None], cubemap, right[:, :, None]], dim=2)
    return torch.cat([top[:, None], mid, bot[:, None]], dim=1)


def _tap_index(face, u, v, R: int, seamless: bool):
    """Flat indices (4, ...) of the bilinear taps into the (padded when
    seamless) cube and their weights wu, wv (..., 1)."""
    if seamless:
        off, hi, Rp = 0.5, R + 1, R + 2  # +1 texel pad shifts the grid by one
    else:
        off, hi, Rp = -0.5, R - 1, R
    # Texel centers at (i + 0.5) / R.
    gu = u * R + off
    gv = v * R + off
    u0 = torch.floor(gu)
    v0 = torch.floor(gv)
    wu = (gu - u0)[..., None]
    wv = (gv - v0)[..., None]
    u0i = torch.clamp(u0, 0, hi).long()
    u1i = torch.clamp(u0 + 1, 0, hi).long()
    v0i = torch.clamp(v0, 0, hi).long()
    v1i = torch.clamp(v0 + 1, 0, hi).long()
    base = face * Rp
    idx = torch.stack([(base + v0i) * Rp + u0i, (base + v0i) * Rp + u1i,
                       (base + v1i) * Rp + u0i, (base + v1i) * Rp + u1i])
    return idx, wu, wv


def _blend_taps(c, wu, wv):
    top = c[0] * (1 - wu) + c[1] * wu
    bot = c[2] * (1 - wu) + c[3] * wu
    return top * (1 - wv) + bot * wv


def _bilinear_cube(cubemap: torch.Tensor, face, u, v,
                   seamless: bool) -> torch.Tensor:
    R, C = cubemap.shape[1], cubemap.shape[3]
    if seamless:
        cubemap = pad_cube(cubemap)
    idx, wu, wv = _tap_index(face, u, v, R, seamless)
    return _blend_taps(gather_rows(cubemap.reshape(-1, C), idx), wu, wv)


def cube_lookup(cubemap: torch.Tensor, dirs: torch.Tensor,
                seamless: bool = True) -> torch.Tensor:
    """Differentiable bilinear cubemap lookup. cubemap (6, R, R, C); dirs
    (..., 3) (need not be normalized). Returns (..., C). seamless=True blends
    across face edges through pad_cube; False clamps to the owning face."""
    face, u, v = dir_to_face_uv(dirs)
    return _bilinear_cube(cubemap, face, u, v, seamless)


@functools.lru_cache(maxsize=None)
def _texel_face_uv(res: int):
    """face/u/v of the res-grid texel-center directions."""
    return _dir_to_face_uv_np(cube_dirs(res))


@functools.cache
def _static_taps(kind: str, res: int, key: tuple, device: torch.device):
    """A static direction grid's seamless taps into a padded cube of
    resolution `res`: the gather plan and the weights, on `device`.
    kind "cube": the texel centers of a (6, key[0], key[0]) cube; "latlong":
    an equirectangular (h, w) = key grid."""
    face, u, v = (_texel_face_uv(key[0]) if kind == "cube"
                  else _latlong_face_uv(*key))
    t = lambda a: torch.from_numpy(a).to(device)
    idx, wu, wv = _tap_index(t(face).long(), t(u), t(v), res, True)
    return plan(idx, 6 * (res + 2) ** 2), wu, wv


def _static_lookup(cubemap: torch.Tensor, kind: str, key: tuple):
    R, C = cubemap.shape[1], cubemap.shape[3]
    p, wu, wv = _static_taps(kind, R, key, cubemap.device)
    return _blend_taps(gather_rows(pad_cube(cubemap).reshape(-1, C), p),
                       wu, wv)


def upsample_cube(cubemap: torch.Tensor, res: int) -> torch.Tensor:
    """Bilinear upsample of a (6, S, S, C) cubemap to (6, res, res, C) by
    direction lookup (cube-aware, smooth across the prefiltered field)."""
    return _static_lookup(cubemap, "cube", (res,))


# --- prefilter weight matrices (host-side, cached) -------------------------------

def _ndf_ggx(alpha_sqr: np.ndarray, cos_theta: np.ndarray) -> np.ndarray:
    c = np.clip(cos_theta, 0.0, 1.0)
    d = (c * alpha_sqr - c) * c + 1.0
    return alpha_sqr / (d * d * np.pi)


@functools.lru_cache(maxsize=None)
def ndf_cutoff_angle(roughness: float, cutoff: float = 0.99) -> float:
    """cos(theta) containing `cutoff` of the GGX lobe's energy."""
    n = 1_000_000
    costheta = np.cos(np.linspace(0, np.pi / 2.0, n))
    D = np.cumsum(_ndf_ggx(roughness ** 4, costheta))
    idx = int(np.argmax(D >= D[-1] * cutoff))
    return float(costheta[idx])


@functools.lru_cache(maxsize=None)
def _diffuse_weights(res: int) -> np.ndarray:
    """(6R^2, 6R^2) cosine-hemisphere weights."""
    d = cube_dirs(res).reshape(-1, 3)
    area = np.tile(texel_solid_angle(res)[None], (6, 1, 1)).reshape(-1)
    cos = np.clip(d @ d.T, 0.0, 0.999)
    return (cos * area[None, :] / np.pi).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _specular_weights(res: int, roughness: float, cutoff: float = 0.99):
    """Normalized (6R^2, 6R^2) GGX split-sum weights."""
    d = cube_dirs(res).reshape(-1, 3)
    area = np.tile(texel_solid_angle(res)[None], (6, 1, 1)).reshape(-1)
    cos_cut = ndf_cutoff_angle(roughness, cutoff)
    alpha_sqr = roughness ** 4
    cos = d @ d.T  # dot(VNR_i, L_j)
    # H = normalize(L + VNR); VNR.H = sqrt((1 + cos)/2).
    vnr_dot_h = np.sqrt(np.clip((1.0 + cos) / 2.0, 0.0, 1.0))
    w = np.clip(cos, 0.0, None) * _ndf_ggx(alpha_sqr, vnr_dot_h) * area[None, :] / 4.0
    w = np.where(cos >= cos_cut, w, 0.0)
    w = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
    return w.astype(np.float32)


@functools.cache
def _device_weights(kind: str, res: int, roughness: float, cutoff: float,
                    device: torch.device) -> torch.Tensor:
    """A weight matrix on `device`, built and copied once per process."""
    w = (_diffuse_weights(res) if kind == "diffuse"
         else _specular_weights(res, roughness, cutoff))
    return torch.from_numpy(w).to(device)


def _prefilter_res(base_res: int, roughness: float) -> int:
    """Smallest cube resolution resolving the lobe (>= ~2 texels per 99%
    radius), capped at PREFILTER_MAX_RES; 0 means identity (sub-texel lobe)."""
    theta = float(np.arccos(np.clip(ndf_cutoff_angle(roughness), -1, 1)))
    texel = 2.0 / base_res  # angular texel size at face center
    if theta < 1.5 * texel:
        return 0
    need = int(2 ** np.ceil(np.log2(max(4.0 / max(theta, 1e-6), LIGHT_MIN_RES))))
    return min(min(need, PREFILTER_MAX_RES), base_res)


# --- the light -------------------------------------------------------------------

def init_cubemap(generator: torch.Generator | None, base_res: int = 512,
                 scale: float = 0.5, bias: float = 0.25,
                 device=None) -> torch.Tensor:
    """Learnable base environment: uniform in [bias, bias + scale), drawn
    from `generator` (the JAX package draws from its PRNG key, a stream
    torch cannot reproduce)."""
    return torch.rand(6, base_res, base_res, 3, generator=generator,
                      device=device) * scale + bias


def num_levels(base_res: int) -> int:
    n = 1
    while base_res > LIGHT_MIN_RES:
        base_res //= 2
        n += 1
    return n


def level_roughness(n_levels: int) -> list[float]:
    """The mip roughness ramp: levels 0..n-2 ramp MIN->MAX, the final level
    is roughness 1.0."""
    if n_levels <= 2:  # tiny test cubemaps; the reference always has 6 levels
        return [MIN_ROUGHNESS] * (n_levels - 1) + [1.0]
    ramp = [(i / (n_levels - 2)) * (MAX_ROUGHNESS - MIN_ROUGHNESS)
            + MIN_ROUGHNESS for i in range(n_levels - 1)]
    return ramp + [1.0]


def _avg_pool_cube(c: torch.Tensor) -> torch.Tensor:
    """2x2 average pool per face, NHWC."""
    six, R, _, C = c.shape
    return c.reshape(six, R // 2, 2, R // 2, 2, C).mean(dim=(2, 4))


def build_mips(base: torch.Tensor, cutoff: float = 0.99):
    """-> (diffuse (6,16,16,3), [specular levels at mip resolutions]).
    Differentiable in `base`."""
    mips = [base]
    while mips[-1].shape[1] > LIGHT_MIN_RES:
        mips.append(_avg_pool_cube(mips[-1]))
    n = len(mips)
    dev = base.device

    coarse = mips[-1]
    S = coarse.shape[1]
    Wd = _device_weights("diffuse", S, 0.0, cutoff, dev)
    diffuse = (Wd @ coarse.reshape(-1, 3)).reshape(6, S, S, 3)

    specular = []
    for mip, r in zip(mips, level_roughness(n)):
        R = mip.shape[1]
        S_i = _prefilter_res(R, r)
        if S_i == 0:
            specular.append(mip)
            continue
        src = mip
        while src.shape[1] > S_i:
            src = _avg_pool_cube(src)
        s = src.shape[1]
        Ws = _device_weights("specular", s, float(r), cutoff, dev)
        out = (Ws @ src.reshape(-1, 3)).reshape(6, s, s, 3)
        specular.append(upsample_cube(out, R) if R != s else out)
    return diffuse, specular


@functools.lru_cache(maxsize=None)
def _latlong_face_uv(h: int, w: int):
    gy = np.linspace(0.0 + 1.0 / h, 1.0 - 1.0 / h, h)
    gx = np.linspace(-1.0 + 1.0 / w, 1.0 - 1.0 / w, w)
    gy, gx = np.meshgrid(gy, gx, indexing="ij")
    sint, cost = np.sin(gy * np.pi), np.cos(gy * np.pi)
    sinp, cosp = np.sin(gx * np.pi), np.cos(gx * np.pi)
    refl = np.stack([sint * sinp, cost, -sint * cosp], -1)
    return _dir_to_face_uv_np(refl)


def cubemap_to_latlong(base: torch.Tensor, res=(512, 1024)) -> torch.Tensor:
    """Equirectangular export (h, w, C)."""
    return _static_lookup(base, "latlong", tuple(res))
