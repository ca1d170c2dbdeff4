"""Split-sum PBR shading, BRDF LUT, tonemap/sRGB helpers.

Port of gs2m_tpu/pbr/shade.py: diffuse = irradiance(n) * albedo; specular
= prefiltered(reflect, mip(r)) * (F0 * LUT.x + LUT.y) with F0 = 0.04 (1 -
m) + albedo * m; ACES filmic and sRGB curves. The split-sum BRDF LUT is
computed at first use by the JAX package's numpy quadrature (copied, so the
table is bit-equal), not shipped. Clips keep jnp.clip's half gradient at a
tie (`models.losses.clip`): background pixels sit exactly on the bounds.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from gs2m_tpu_torch.models.losses import clip
from gs2m_tpu_torch.pbr import cubemap as cm

F32_EPS = float(np.finfo(np.float32).eps)


# --- tonemapping / transfer curves --------------------------------------------------

def aces_film(rgb: torch.Tensor) -> torch.Tensor:
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    out = (rgb * (a * rgb + b)) / (rgb * (c * rgb + d) + e)
    return clip(out, 0.0, 1.0)


def linear_to_srgb(linear: torch.Tensor) -> torch.Tensor:
    srgb0 = 323.0 / 25.0 * linear
    srgb1 = (211.0 * torch.maximum(linear, linear.new_full((), F32_EPS))
             ** (5.0 / 12.0) - 11.0) / 200.0
    return torch.where(linear <= 0.0031308, srgb0, srgb1)


def srgb_to_linear(srgb: torch.Tensor) -> torch.Tensor:
    srgb = clip(srgb, 0.0, 1.0)
    return torch.where(srgb <= 0.04045, srgb / 12.92,
                       ((srgb + 0.055) / 1.055) ** 2.4)


def saturate_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return clip(torch.sum(a * b, dim=-1, keepdim=True), 1e-4, 1.0)


# --- split-sum BRDF LUT (computed, not shipped) ----------------------------------

def _hammersley(n: int) -> np.ndarray:
    i = np.arange(n)
    bits = i.astype(np.uint32)
    bits = (bits << np.uint32(16)) | (bits >> np.uint32(16))
    bits = ((bits & np.uint32(0x55555555)) << np.uint32(1)) | \
           ((bits & np.uint32(0xAAAAAAAA)) >> np.uint32(1))
    bits = ((bits & np.uint32(0x33333333)) << np.uint32(2)) | \
           ((bits & np.uint32(0xCCCCCCCC)) >> np.uint32(2))
    bits = ((bits & np.uint32(0x0F0F0F0F)) << np.uint32(4)) | \
           ((bits & np.uint32(0xF0F0F0F0)) >> np.uint32(4))
    bits = ((bits & np.uint32(0x00FF00FF)) << np.uint32(8)) | \
           ((bits & np.uint32(0xFF00FF00)) >> np.uint32(8))
    return np.stack([i / n, bits.astype(np.float64) * 2.3283064365386963e-10], -1)


@functools.lru_cache(maxsize=2)
def compute_brdf_lut(res: int = 256, n_samples: int = 512) -> np.ndarray:
    """(res, res, 2) split-sum (A, B) over (NoV, roughness), Karis 2013."""
    xi = _hammersley(n_samples)  # (S, 2)
    nov = (np.arange(res) + 0.5) / res
    rough = (np.arange(res) + 0.5) / res
    NoV, R = np.meshgrid(nov, rough, indexing="ij")  # (res, res) u = NoV, v = r
    V = np.stack([np.sqrt(1 - NoV ** 2), np.zeros_like(NoV), NoV], -1)  # (res,res,3)
    a = (R ** 2)[..., None]  # GGX alpha = roughness^2

    A = np.zeros((res, res))
    B = np.zeros((res, res))
    for s in range(n_samples):
        u1, u2 = xi[s]
        phi = 2 * np.pi * u1
        cos_t = np.sqrt((1 - u2) / (1 + (a[..., 0] ** 2 - 1) * u2))
        sin_t = np.sqrt(np.maximum(1 - cos_t ** 2, 0))
        H = np.stack([sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t], -1)
        VdotH = np.sum(V * H, -1)
        L = 2 * VdotH[..., None] * H - V
        NoL = np.clip(L[..., 2], 0, 1)
        NoH = np.clip(H[..., 2], 0, 1)
        VoH = np.clip(VdotH, 0, 1)
        mask = NoL > 0
        k = (R ** 2) / 2.0  # Karis IBL k = alpha / 2
        g1v = NoV / (NoV * (1 - k) + k)
        g1l = NoL / (NoL * (1 - k) + k + 1e-12)
        G = g1v * g1l
        G_vis = np.where(mask, G * VoH / (NoH * NoV + 1e-12), 0.0)
        Fc = (1 - VoH) ** 5
        A += (1 - Fc) * G_vis
        B += Fc * G_vis
    lut = np.stack([A, B], -1) / n_samples
    return lut.astype(np.float32)


@functools.cache
def get_brdf_lut(device=None) -> torch.Tensor:
    """(256, 256, 2) LUT indexed by (NoV, roughness), on `device`."""
    from gs2m_tpu_torch import resolve_device
    return torch.from_numpy(compute_brdf_lut()).to(resolve_device(device))


def sample_lut(lut: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear clamp-mode 2D texture lookup. lut (R, R, C); uv (..., 2) in
    [0, 1]. The LUT is a constant: its taps need no gradient."""
    R, _, C = lut.shape
    g = uv * R - 0.5
    g0 = torch.floor(g)
    w = g - g0
    i0 = torch.clamp(g0[..., 0], 0, R - 1).long()
    i1 = torch.clamp(g0[..., 0] + 1, 0, R - 1).long()
    j0 = torch.clamp(g0[..., 1], 0, R - 1).long()
    j1 = torch.clamp(g0[..., 1] + 1, 0, R - 1).long()
    wu = w[..., 0:1]
    wv = w[..., 1:2]
    top = lut[i0, j0] * (1 - wv) + lut[i0, j1] * wv
    bot = lut[i1, j0] * (1 - wv) + lut[i1, j1] * wv
    return top * (1 - wu) + bot * wu


# --- mip selection + shading --------------------------------------------------------

def get_mip(roughness: torch.Tensor, n_levels: int) -> torch.Tensor:
    """Continuous mip level from roughness."""
    lo = (clip(roughness, cm.MIN_ROUGHNESS, cm.MAX_ROUGHNESS)
          - cm.MIN_ROUGHNESS) / (cm.MAX_ROUGHNESS - cm.MIN_ROUGHNESS) \
        * (n_levels - 2)
    hi = (clip(roughness, cm.MAX_ROUGHNESS, 1.0) - cm.MAX_ROUGHNESS) \
        / (1.0 - cm.MAX_ROUGHNESS) + n_levels - 2
    return torch.where(roughness < cm.MAX_ROUGHNESS, lo, hi)


def sample_specular(specular: list, dirs: torch.Tensor,
                    mip: torch.Tensor) -> torch.Tensor:
    """Trilinear lookup across the prefiltered levels: every level is looked
    up, then the two around `mip` are blended. dirs (..., 3); mip (..., 1).
    The level pick is a one-hot sum (no scatter in its backward)."""
    L = len(specular)
    samples = torch.stack([cm.cube_lookup(s, dirs) for s in specular], 0)
    m = clip(mip[..., 0], 0.0, L - 1)
    lo = torch.floor(m).long()
    hi = torch.clamp_max(lo + 1, L - 1)
    w = (m - lo)[..., None]
    levels = torch.arange(L, device=dirs.device).reshape(L, *([1] * lo.dim()))
    s_lo = torch.sum(torch.where((levels == lo)[..., None], samples, 0.0), 0)
    s_hi = torch.sum(torch.where((levels == hi)[..., None], samples, 0.0), 0)
    return s_lo * (1 - w) + s_hi * w


def pbr_shading(diffuse_map, specular_levels, normals, view_dirs, albedo,
                roughness, brdf_lut, metallic=None, tone: bool = False,
                gamma: bool = False, occlusion=None, irradiance=None) -> dict:
    """Split-sum shading. All image args (H, W, C)."""
    ref_dirs = (2.0 * torch.maximum(
        torch.sum(normals * view_dirs, -1, keepdim=True),
        normals.new_zeros(())) * normals - view_dirs)

    diffuse_light = cm.cube_lookup(diffuse_map, normals)
    if occlusion is not None:
        diffuse_light = diffuse_light * occlusion + (1 - occlusion) * irradiance
    diffuse_rgb = diffuse_light * albedo

    NoV = saturate_dot(normals, view_dirs)
    fg = sample_lut(brdf_lut, torch.cat([NoV, roughness], -1))

    mip = get_mip(roughness, len(specular_levels))
    spec = sample_specular(specular_levels, ref_dirs, mip)

    if metallic is None:
        F0 = torch.ones_like(albedo) * 0.04
    else:
        F0 = (1.0 - metallic) * 0.04 + albedo * metallic
    reflectance = F0 * fg[..., 0:1] + fg[..., 1:2]
    specular_rgb = spec * reflectance

    render_rgb = diffuse_rgb + specular_rgb
    render_rgb = aces_film(render_rgb) if tone else clip(render_rgb, 0.0, 1.0)
    if gamma:
        render_rgb = linear_to_srgb(render_rgb)

    return {"render_rgb": render_rgb, "diffuse_rgb": diffuse_rgb,
            "specular_rgb": specular_rgb, "diffuse_light": diffuse_light}
