"""Point-light BSDF op library + HDR image losses.

Port of gs2m_tpu/pbr/bsdf.py: Lambert/Frostbite diffuse, Fresnel-Schlick,
GGX NDF/lambda/correlated-Smith masking, the full point-light `bsdf_pbr`
with the kd/ks metallic split, shading-normal preparation (two-sided
bending, tangent-space perturbation), point/vector transforms, and the
SMAPE/RelMSE/MSE/L1 image losses with the log-sRGB tonemapper. Not on the
training path (only the cubemap prefilters are); plain differentiable
torch. Clips keep jnp.clip's half gradient at a tie.
"""
from __future__ import annotations

import math

import torch

from gs2m_tpu_torch.models.losses import abs_, clip

NORMAL_THRESHOLD = 0.1
SPECULAR_EPSILON = 1e-4


def _clip_lo(x: torch.Tensor, lo: float) -> torch.Tensor:
    return torch.maximum(x, x.new_full((), lo))


def dot(x, y):
    return torch.sum(x * y, dim=-1, keepdim=True)


def reflect(x, n):
    return 2.0 * dot(x, n) * n - x


def safe_normalize(x):
    return x / _clip_lo(torch.linalg.norm(x, dim=-1, keepdim=True), 1e-12)


# --- shading-normal preparation ---------------------------------------------------

def bend_normal(view_vec, smooth_nrm, geom_nrm, two_sided_shading: bool):
    if two_sided_shading:
        front = dot(geom_nrm, view_vec) > 0
        smooth_nrm = torch.where(front, smooth_nrm, -smooth_nrm)
        geom_nrm = torch.where(front, geom_nrm, -geom_nrm)
    t = clip(dot(view_vec, smooth_nrm) / NORMAL_THRESHOLD, 0.0, 1.0)
    return geom_nrm + (smooth_nrm - geom_nrm) * t


def perturb_normal(perturbed_nrm, smooth_nrm, smooth_tng, opengl: bool):
    bitang = safe_normalize(torch.cross(smooth_tng, smooth_nrm, dim=-1))
    sign = -1.0 if opengl else 1.0
    shading = (smooth_tng * perturbed_nrm[..., 0:1]
               + sign * bitang * perturbed_nrm[..., 1:2]
               + smooth_nrm * _clip_lo(perturbed_nrm[..., 2:3], 0.0))
    return safe_normalize(shading)


def prepare_shading_normal(pos, view_pos, perturbed_nrm, smooth_nrm,
                           smooth_tng, geom_nrm, two_sided_shading: bool,
                           opengl: bool):
    smooth_nrm = safe_normalize(smooth_nrm)
    smooth_tng = safe_normalize(smooth_tng)
    view_vec = safe_normalize(view_pos - pos)
    shading = perturb_normal(perturbed_nrm, smooth_nrm, smooth_tng, opengl)
    return bend_normal(view_vec, shading, geom_nrm, two_sided_shading)


# --- diffuse terms ------------------------------------------------------------------

def bsdf_lambert(nrm, wi):
    return _clip_lo(dot(nrm, wi), 0.0) / math.pi


def bsdf_fresnel_shlick(f0, f90, cos_theta):
    c = clip(cos_theta, SPECULAR_EPSILON, 1.0 - SPECULAR_EPSILON)
    return f0 + (f90 - f0) * (1.0 - c) ** 5.0


def bsdf_frostbite(nrm, wi, wo, linear_roughness):
    wi_n = dot(wi, nrm)
    wo_n = dot(wo, nrm)
    h = safe_normalize(wo + wi)
    wi_h = dot(wi, h)
    energy_bias = 0.5 * linear_roughness
    energy_factor = 1.0 - (0.51 / 1.51) * linear_roughness
    f90 = energy_bias + 2.0 * wi_h * wi_h * linear_roughness
    res = (bsdf_fresnel_shlick(1.0, f90, wi_n)
           * bsdf_fresnel_shlick(1.0, f90, wo_n) * energy_factor)
    return torch.where((wi_n > 0.0) & (wo_n > 0.0), res, 0.0)


def bsdf_phong(nrm, wo, wi, N):
    dp_r = clip(dot(reflect(wo, nrm), wi), 0.0, 1.0)
    dp_l = clip(dot(nrm, wi), 0.0, 1.0)
    return (dp_r ** N) * dp_l * (N + 2) / (2 * math.pi)


# --- GGX specular -------------------------------------------------------------------

def bsdf_ndf_ggx(alpha_sqr, cos_theta):
    c = clip(cos_theta, SPECULAR_EPSILON, 1.0 - SPECULAR_EPSILON)
    d = (c * alpha_sqr - c) * c + 1.0
    return alpha_sqr / (d * d * math.pi)


def bsdf_lambda_ggx(alpha_sqr, cos_theta):
    c = clip(cos_theta, SPECULAR_EPSILON, 1.0 - SPECULAR_EPSILON)
    c2 = c * c
    tan2 = (1.0 - c2) / c2
    return 0.5 * (torch.sqrt(1.0 + alpha_sqr * tan2) - 1.0)


def bsdf_masking_smith_ggx_correlated(alpha_sqr, cos_i, cos_o):
    return 1.0 / (1.0 + bsdf_lambda_ggx(alpha_sqr, cos_i)
                  + bsdf_lambda_ggx(alpha_sqr, cos_o))


def bsdf_pbr_specular(col, nrm, wo, wi, alpha, min_roughness: float = 0.08):
    a = clip(alpha, min_roughness * min_roughness, 1.0)
    alpha_sqr = a * a
    h = safe_normalize(wo + wi)
    wo_n = dot(wo, nrm)
    wi_n = dot(wi, nrm)
    wo_h = dot(wo, h)
    n_h = dot(nrm, h)
    D = bsdf_ndf_ggx(alpha_sqr, n_h)
    G = bsdf_masking_smith_ggx_correlated(alpha_sqr, wo_n, wi_n)
    F = bsdf_fresnel_shlick(col, 1.0, wo_h)
    w = F * D * G * 0.25 / _clip_lo(wo_n, SPECULAR_EPSILON)
    front = (wo_n > SPECULAR_EPSILON) & (wi_n > SPECULAR_EPSILON)
    return torch.where(front, w, 0.0)


def bsdf_pbr(kd, arm, pos, nrm, view_pos, light_pos,
             min_roughness: float = 0.08, bsdf: int = 0):
    """Full point-light PBR: arm = (spec_str, rough, metal); bsdf 0 =
    Lambert diffuse, 1 = Frostbite."""
    wo = safe_normalize(view_pos - pos)
    wi = safe_normalize(light_pos - pos)
    spec_str = arm[..., 0:1]
    roughness = arm[..., 1:2]
    metallic = arm[..., 2:3]
    ks = (0.04 * (1.0 - metallic) + kd * metallic) * (1.0 - spec_str)
    kd = kd * (1.0 - metallic)
    if bsdf == 0:
        diffuse = kd * bsdf_lambert(nrm, wi)
    else:
        diffuse = kd * bsdf_frostbite(nrm, wi, wo, roughness)
    specular = bsdf_pbr_specular(ks, nrm, wo, wi, roughness * roughness,
                                 min_roughness=min_roughness)
    return diffuse + specular


# --- point/vector transforms ----------------------------------------------------------

def xfm_points(points, matrix):
    """(..., N, 3) points through a (4, 4) row-vector matrix -> (..., N, 4)."""
    ones = torch.ones_like(points[..., :1])
    return torch.cat([points, ones], -1) @ torch.swapaxes(matrix, -1, -2)


def xfm_vectors(vectors, matrix):
    return vectors @ torch.swapaxes(matrix[..., :3, :3], -1, -2)


# --- HDR image losses -------------------------------------------------------------------

def _tonemap_srgb(f):
    return torch.where(f > 0.0031308,
                       _clip_lo(f, 0.0031308) ** (1.0 / 2.4) * 1.055 - 0.055,
                       12.92 * f)


def smape(img, target, eps: float = 0.01):
    return torch.mean(abs_(img - target)
                      / (abs_(img) + abs_(target) + eps))


def relmse(img, target, eps: float = 0.1):
    return torch.mean((img - target) ** 2 / (img * img + target * target + eps))


def image_loss(img, target, loss: str = "l1", tonemapper: str = "none"):
    if tonemapper == "log_srgb":
        img = _tonemap_srgb(torch.log(clip(img, 0.0, 65535.0) + 1.0))
        target = _tonemap_srgb(torch.log(clip(target, 0.0, 65535.0) + 1.0))
    if loss == "mse":
        return torch.mean((img - target) ** 2)
    if loss == "smape":
        return smape(img, target)
    if loss == "relmse":
        return relmse(img, target)
    return torch.mean(abs_(img - target))
