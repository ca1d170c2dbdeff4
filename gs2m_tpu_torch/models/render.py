"""Scene renderer: feature packing -> tiled rasterization -> derived maps.

Port of gs2m_tpu/models/render.py's single-view forward. Produces the same
output surface:

  render (3,H,W) | alpha_map (1,H,W) | distance_map (1,H,W) | depth_map (1,H,W)
  normal_map (3,H,W world) | local_normal_map (3,H,W camera) |
  albedo_map (3,H,W) | roughness_map (1,H,W) | metallic_map (1,H,W) |
  normal_mask (1,H,W) | radii (C,) | visibility_filter (C,) | observe (C,) |
  sobel_map (3,H,W, optional) | final_T (H,W) | dropped () |
  dropped_expand () | aligned_demand () (the binning's expansion-cap
  overflow and aligned slots in use, which the trainer sizes its caps from)
  | num_instances () | num_kept () (port only: the binned instance count
  and the instances the per-tile cull keeps, for reports; with the span
  recorder on, the deepest tile's slots are counted too)

feature_count staging: 1 (RGB warmup) / 5 (+distance+normal, geometry) /
9 (+albedo+roughness, material) / +1 when blending metallic.

Differentiable in the Gaussians' parameters through torch autograd (the
per-Gaussian preprocess is one kernel pair and the blend's backward is
kernel K2 on CUDA tensors). Densification statistics
flow through the `m2d_sink` / `m2d_abs_sink` zero tensors, whose gradients
the trainer reads. `count_observed` is the trim's observe-only pass.
`term_cut` / `expand_cap` bin with the termination cut (ops/binning.py), as
the JAX package's render_pair does for the geometry step's renders.
"""
from __future__ import annotations

import torch

from gs2m_tpu_torch.core.camera import Camera
from gs2m_tpu_torch.core.gaussians import Gaussians
from gs2m_tpu_torch.ops.binning import tile_slots_max
from gs2m_tpu_torch.ops.normals import normal_from_depth_image
from gs2m_tpu_torch.ops.preprocess import preprocess
from gs2m_tpu_torch.ops.rasterize import (RasterOut, observe_from_projected,
                                          rasterize_from_projected)
from gs2m_tpu_torch.utils import spans


def feature_count_for(geometry_stage: bool, material_stage: bool,
                      blend_metallic: bool) -> int:
    fc = 9 if material_stage else 5 if geometry_stage else 1
    return fc + (1 if blend_metallic else 0)


def render(
    gaussians: Gaussians,
    camera: Camera,
    bg: torch.Tensor,
    active_sh_degree: int,
    geometry_stage: bool = False,
    material_stage: bool = False,
    sobel_normal: bool = False,
    blend_metallic: bool = False,
    z_depth: bool = False,
    tile: int = 16,
    chunk: int = 256,
    instance_cap: int = 2 ** 18,
    m2d_sink: torch.Tensor | None = None,
    m2d_abs_sink: torch.Tensor | None = None,
    term_cut: bool = False,
    expand_cap: int | None = None,
) -> dict:
    feature_count = feature_count_for(geometry_stage, material_stage,
                                      blend_metallic)
    opacities, features, proj = preprocess(gaussians, camera,
                                           active_sh_degree, tile=tile,
                                           z_depth=z_depth)
    out = rasterize_from_projected(
        proj, opacities, features, bg, camera, feature_count=feature_count,
        tile=tile, chunk=chunk, instance_cap=instance_cap,
        m2d_sink=m2d_sink, m2d_abs_sink=m2d_abs_sink, term_cut=term_cut,
        expand_cap=expand_cap)
    return derive_render_pkg(out, camera, bg, z_depth=z_depth,
                             sobel_normal=sobel_normal)


def count_observed(gaussians: Gaussians, camera: Camera, tile: int = 16,
                   chunk: int = 256, instance_cap: int = 2 ** 18,
                   term_cut: bool = False, expand_cap: int | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-Gaussian observe counts for this view and the binning overflow
    scalar — what the multi-view trim consumes — at a fraction of render()'s
    cost: a color-free projection and the geometry-only blend sweep (K3).
    Counts equal render(...)["observe"]."""
    with torch.no_grad():
        opac, _, proj = preprocess(gaussians, camera, 0, tile=tile,
                                   with_colors=False)
        return observe_from_projected(proj, opac, camera, tile=tile,
                                      chunk=chunk, instance_cap=instance_cap,
                                      term_cut=term_cut,
                                      expand_cap=expand_cap)


def derive_render_pkg(out: RasterOut, camera: Camera, bg: torch.Tensor,
                      z_depth: bool = False,
                      sobel_normal: bool = False) -> dict:
    """Raster surface -> the 13-map render dict."""
    H, W = camera.height, camera.width
    buffer = out.buffer
    normal_map = buffer[2:5]
    normal_mask = torch.all(normal_map.detach() != 0.0, dim=0, keepdim=True)

    # World -> camera normals.
    n_flat = normal_map.permute(1, 2, 0).reshape(-1, 3)
    local_n = n_flat @ camera.world_view[:3, :3]
    local_normal_map = local_n.reshape(H, W, 3).permute(2, 0, 1)

    # Plane depth = distance / -(n_cam . ray).
    distance_map = buffer[1:2]
    if z_depth:
        depth_map = distance_map
    else:
        rays = camera.get_rays().reshape(-1, 3)
        denoms = torch.sum(local_n * rays, dim=-1).reshape(1, H, W)
        depth_map = distance_map / -(denoms + 1e-8)

    pkg = {
        "render": out.color,
        "radii": out.radii,
        "visibility_filter": out.radii > 0,
        "observe": out.observe,
        "alpha_map": buffer[0:1],
        "distance_map": distance_map,
        "depth_map": depth_map,
        "normal_map": normal_map,
        "albedo_map": buffer[5:8],
        "roughness_map": buffer[8:9],
        "metallic_map": buffer[9:10],
        "normal_mask": normal_mask,
        "local_normal_map": local_normal_map,
        "final_T": out.final_T,
        "dropped": out.dropped,
        "dropped_expand": out.dropped_expand,
        "aligned_demand": out.aligned_demand,
        "num_instances": out.num_instances,
        "num_kept": out.num_kept,
    }
    # Per render, for the span recorder (nothing while it is off): the
    # (tile, Gaussian) pairs the binning expands, those the per-tile cull
    # keeps, and the chunk-aligned slots K1/K2 walk; and, computed only
    # while it is on (a few launches), the slots of the deepest tile and
    # the frame's tile count.
    spans.count("instances", out.num_instances)
    spans.count("kept_instances", out.num_kept)
    spans.count("aligned_slots", out.aligned_demand)
    if spans.recording() and out.chunk_tile is not None:
        spans.count("tile_slots_max",
                    tile_slots_max(out.chunk_tile, out.tiles, out.chunk))
        spans.count("tiles", out.tiles)
    if sobel_normal:
        pkg["sobel_map"] = render_normal_from_depth_map(
            camera, depth_map[0], bg, pkg["alpha_map"][0])
    return pkg


def render_normal_from_depth_map(camera: Camera, depth: torch.Tensor,
                                 bg: torch.Tensor,
                                 alpha: torch.Tensor) -> torch.Tensor:
    """World-space normals from the rendered depth, alpha-composited over
    the background."""
    c2w = torch.linalg.inv_ex(camera.world_view.T).inverse  # no host sync
    n = normal_from_depth_image(depth, camera.get_K(), c2w)  # (H, W, 3)
    n = n * alpha[..., None] + bg[None, None, :] * (1.0 - alpha[..., None])
    return n.permute(2, 0, 1)
