"""Per-Gaussian preprocess: cull, project, 2D covariance, conic, tile rect.

Port of gs2m_tpu/ops/projection.py with every numerical detail kept:

* near cull at view-space z <= 0.2, with a safe homogeneous w (`w_safe`)
  and a clamped tz for the culled rows
* EWA 2D covariance with the 1.3*tanfov frustum clamp, no +0.3 dilation
* det <= 0 cull (razor-thin splats round to an indefinite conic)
* radius = ceil(3 * sqrt(max eigenvalue)) from the max(0.1, mid^2-det)
  guarded discriminant
* ndc2Pix(v, S) = ((v+1)*S - 1)/2, tile rect floor((p - r)/T) ..
  floor((p + r + T - 1)/T) clamped to the grid
* the opacity-aware rect: tiles_touched and the emitted rect use the
  alpha >= 1/255 radius (capped at 3 sigma); radii and `valid` keep the
  3-sigma definition

One vectorized pass over the padded (C,) tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gs2m_tpu_torch.core import sh as shlib
from gs2m_tpu_torch.core.camera import Camera
from gs2m_tpu_torch.core.gaussians import Gaussians


class Projected(NamedTuple):
    """Per-Gaussian screen-space quantities (all shape (C, ...))."""
    means2d: torch.Tensor        # (C, 2) pixel coordinates
    depths: torch.Tensor         # (C,) view-space z
    conics: torch.Tensor         # (C, 3) inverse 2D covariance (a, b, c)
    colors: torch.Tensor         # (C, 3) SH-evaluated RGB
    radii: torch.Tensor          # (C,) int32 screen radius, 0 = culled
    rect_min: torch.Tensor       # (C, 2) int32 tile rect (x, y), inclusive
    rect_max: torch.Tensor       # (C, 2) int32 tile rect, exclusive
    tiles_touched: torch.Tensor  # (C,) int32
    valid: torch.Tensor          # (C,) bool


def compute_cov2d(xyz: torch.Tensor, cov3d: torch.Tensor,
                  camera: Camera) -> torch.Tensor:
    """EWA projection of world covariance to screen:
    cov2d = J @ Rw2c @ Sigma @ Rw2c^T @ J^T with the frustum-clamped
    Jacobian. Returns (C, 3): (cov_xx, cov_xy, cov_yy). Rows behind the near
    plane get tz = 1 (they are culled downstream)."""
    wv = camera.world_view
    t = xyz @ wv[:3, :3] + wv[3, :3]
    limx = 1.3 * camera.tanfovx
    limy = 1.3 * camera.tanfovy
    tz = torch.where(t[:, 2] > 0.2, t[:, 2], 1.0)
    tx = torch.clamp(t[:, 0] / tz, -limx, limx) * tz
    ty = torch.clamp(t[:, 1] / tz, -limy, limy) * tz

    fx, fy = camera.fx, camera.fy
    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    R = wv[:3, :3].T  # true w2c rotation
    s = cov3d  # (C,6): xx xy xz yy yz zz

    def quad(u, v):
        """u^T Sigma v for constant 3-vectors u, v (rows of R)."""
        return (s[:, 0] * (u[0] * v[0]) + s[:, 3] * (u[1] * v[1])
                + s[:, 5] * (u[2] * v[2])
                + s[:, 1] * (u[0] * v[1] + u[1] * v[0])
                + s[:, 2] * (u[0] * v[2] + u[2] * v[0])
                + s[:, 4] * (u[1] * v[2] + u[2] * v[1]))

    r0, r1, r2 = R[0], R[1], R[2]
    M00, M01, M02 = quad(r0, r0), quad(r0, r1), quad(r0, r2)
    M11, M12, M22 = quad(r1, r1), quad(r1, r2), quad(r2, r2)

    j00 = fx * inv_z
    j02 = -fx * tx * inv_z2
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z2
    cxx = j00 * j00 * M00 + 2 * j00 * j02 * M02 + j02 * j02 * M22
    cxy = j00 * j11 * M01 + j00 * j12 * M02 + j02 * j11 * M12 + j02 * j12 * M22
    cyy = j11 * j11 * M11 + 2 * j11 * j12 * M12 + j12 * j12 * M22
    return torch.stack([cxx, cxy, cyy], dim=-1)


def _tile_index(v: torch.Tensor, tile: int, hi: int) -> torch.Tensor:
    """f32 -> int32 with truncation toward zero, then clamped to [0, hi]."""
    return torch.clamp((v / tile).to(torch.int32), 0, hi)


def crop_projected(proj: Projected, y0: int, local_height: int,
                   tile: int) -> Projected:
    """Shift a Projected into the window rows [y0, y0 + local_height), y0 a
    multiple of `tile` (band-sharded rendering, parallel/sp.py): screen y
    moves by -y0, the tile rect is re-clamped to the local grid and
    Gaussians whose rect misses the window are invalidated. Binning and the
    blend then run unchanged at the local height; for y0 a multiple of the
    tile the shift is exact in float32, so each band's pixels see the
    full-frame render's numbers."""
    y0_t = y0 // tile
    local_gy = (local_height + tile - 1) // tile
    means2d = torch.stack([proj.means2d[:, 0], proj.means2d[:, 1] - y0], -1)
    rmin_y = torch.clamp(proj.rect_min[:, 1] - y0_t, 0, local_gy)
    rmax_y = torch.clamp(proj.rect_max[:, 1] - y0_t, 0, local_gy)
    area = (proj.rect_max[:, 0] - proj.rect_min[:, 0]) * (rmax_y - rmin_y)
    valid = proj.valid & (area > 0)
    return proj._replace(
        means2d=torch.where(valid[:, None], means2d, -1e4),
        rect_min=torch.stack([proj.rect_min[:, 0], rmin_y], -1),
        rect_max=torch.stack([proj.rect_max[:, 0], rmax_y], -1),
        tiles_touched=torch.where(valid, area, 0).to(torch.int32),
        valid=valid)


def project(gaussians: Gaussians, camera: Camera, active_sh_degree: int,
            opacities: torch.Tensor, tile: int = 16,
            with_colors: bool = True) -> Projected:
    """Vectorized preprocess over the padded capacity. `opacities` (C,)
    tightens the tile rect to the alpha >= 1/255 ellipse (see module note);
    it is index-valued there and carries no gradient. with_colors=False
    skips the SH evaluation (colors are zeros): observe counting depends on
    geometry and opacity alone. Differentiable in xyz, scaling, rotation and
    the SH features through autograd; the guards above keep the culled
    rows' gradients finite."""
    xyz = gaussians.xyz
    W, H = camera.width, camera.height
    grid_x = (W + tile - 1) // tile
    grid_y = (H + tile - 1) // tile
    wv = camera.world_view

    # View/clip transforms (row-vector convention).
    p_view = xyz @ wv[:3, :3] + wv[3, :3]
    p_hom = torch.cat([xyz, torch.ones_like(xyz[:, :1])], dim=-1) @ camera.full_proj
    in_front = p_view[:, 2] > 0.2
    w_safe = torch.where(in_front, p_hom[:, 3], 1.0)
    p_w = 1.0 / (w_safe + 1e-7)
    p_proj = p_hom[:, :3] * p_w[:, None]

    cov = compute_cov2d(xyz, gaussians.get_covariance(), camera)
    det = cov[:, 0] * cov[:, 2] - cov[:, 1] * cov[:, 1]
    det_ok = det > 0.0
    det_inv = 1.0 / torch.where(det_ok, det, 1.0)
    conic = torch.stack([cov[:, 2] * det_inv, -cov[:, 1] * det_inv,
                         cov[:, 0] * det_inv], -1)

    mid = 0.5 * (cov[:, 0] + cov[:, 2])
    disc = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    lambda1 = mid + disc
    sigma_max = torch.sqrt(torch.maximum(lambda1, mid - disc))
    radius = torch.ceil(3.0 * sigma_max)

    # Opacity-aware rect: q = 2*ln(255*op) bounds the Mahalanobis form at the
    # last alpha >= 1/255 pixel; +1e-3 keeps it conservative under f32, +1 px
    # covers the rect formula's one-pixel under-coverage.
    q = 2.0 * torch.log(torch.clamp_min(opacities.detach(), 1e-12) * 255.0)
    r_op = torch.sqrt((torch.clamp_min(q, 0.0) + 1e-3)
                      * torch.clamp_min(lambda1, 0.0))
    rect_radius = torch.minimum(radius, torch.ceil(r_op) + 1.0)

    px = ((p_proj[:, 0] + 1.0) * W - 1.0) * 0.5
    py = ((p_proj[:, 1] + 1.0) * H - 1.0) * 0.5
    means2d = torch.stack([px, py], dim=-1)

    rect_min_x = _tile_index(px - rect_radius, tile, grid_x)
    rect_min_y = _tile_index(py - rect_radius, tile, grid_y)
    rect_max_x = _tile_index(px + rect_radius + tile - 1, tile, grid_x)
    rect_max_y = _tile_index(py + rect_radius + tile - 1, tile, grid_y)
    area = (rect_max_x - rect_min_x) * (rect_max_y - rect_min_y)

    # Visibility keeps the 3-sigma rect semantics.
    area3_x = (_tile_index(px + radius + tile - 1, tile, grid_x)
               - _tile_index(px - radius, tile, grid_x))
    area3_y = (_tile_index(py + radius + tile - 1, tile, grid_y)
               - _tile_index(py - radius, tile, grid_y))

    valid = in_front & det_ok & (area3_x * area3_y > 0) & gaussians.alive
    radii = torch.where(valid, radius, 0.0).to(torch.int32)
    tiles_touched = torch.where(valid, area, 0).to(torch.int32)

    if with_colors:
        # SH -> RGB with view dirs from the unclamped positions.
        dirs = xyz - camera.cam_center[None, :]
        dirs = dirs / torch.sqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True)
                                 + 1e-20)
        colors = shlib.sh_to_rgb(active_sh_degree, gaussians.get_features,
                                 dirs)
    else:
        colors = xyz.new_zeros(xyz.shape[0], 3)

    # Culled slots get safe values so no inf/NaN reaches the blend.
    v = valid[:, None]
    means2d = torch.where(v, means2d, -1e4)
    # (1, 0, 1), built on the device: a host tensor would be copied per view.
    safe = (torch.arange(3, device=conic.device) != 1).to(conic.dtype)
    conic = torch.where(v, conic, safe)
    depths = torch.where(valid, p_view[:, 2], camera.zfar)

    return Projected(
        means2d=means2d,
        depths=depths,
        conics=conic,
        colors=colors,
        radii=radii,
        rect_min=torch.stack([rect_min_x, rect_min_y], -1),
        rect_max=torch.stack([rect_max_x, rect_max_y], -1),
        tiles_touched=tiles_touched,
        valid=valid,
    )
