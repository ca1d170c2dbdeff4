"""Rasterizer API, single view forward: project -> bin -> blend.

Port of gs2m_tpu/ops/rasterize.py's forward surface. Outputs are color
(3,H,W) composited over the background, the 10-channel feature buffer
(10,H,W) [alpha, plane distance, world normal x3, albedo x3, roughness,
metallic], final T, radii, observe counts, the binning overflow
`dropped` (with its expansion-cap part `dropped_expand`), the instance count
`num_instances`, the aligned slots in use `aligned_demand` and the
instances the per-tile cull keeps `num_kept`;
`feature_count` (1/5/9/10) selects how many feature channels blend. The
blend runs kernel K1 on CUDA tensors (ops/blend.py). `term_cut` bins with
the termination cut (ops/binning.py), with the expansion side at
`expand_cap`: outputs and gradients are those of the uncut layout.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gs2m_tpu_torch.core.camera import Camera
from gs2m_tpu_torch.core.gaussians import Gaussians
from gs2m_tpu_torch.ops.binning import bin_gaussians
from gs2m_tpu_torch.ops.blend import blend_tiles, observe_tiles
from gs2m_tpu_torch.ops.projection import Projected


class RasterOut(NamedTuple):
    color: torch.Tensor     # (3, H, W) background-composited
    buffer: torch.Tensor    # (10, H, W)
    final_T: torch.Tensor   # (H, W)
    radii: torch.Tensor     # (C,) int32
    observe: torch.Tensor   # (C,) int32
    dropped: torch.Tensor   # () int32 — binning overflow diagnostic
    num_instances: torch.Tensor  # () int32 — (tile, Gaussian) pairs binned
    dropped_expand: torch.Tensor  # () int32 — the expansion-cap part of dropped
    aligned_demand: torch.Tensor  # () int32 — aligned slots in use
    num_kept: torch.Tensor  # () int32 — instances kept by the per-tile cull
    # The layout's tile per chunk (T = the dummy tile), its tile count and
    # its chunk size, for the span recorder's per-tile counter; None where
    # a render has no one layout (the band-sharded renders).
    chunk_tile: torch.Tensor | None = None
    tiles: int = 0
    chunk: int = 0


def value_width(feature_count: int) -> int:
    """Blend-value channel count: 3 RGB + feature_count, rounded up to 8 or
    16. Channels beyond feature_count are exactly zero, so widths never
    change outputs."""
    return 8 if feature_count + 3 <= 8 else 16


def pack_values(colors: torch.Tensor, features: torch.Tensor,
                feature_count: int) -> torch.Tensor:
    """(C,3) colors + (C,10) features -> (C,V) value rows; channels beyond
    feature_count are zeroed."""
    C = colors.shape[0]
    nf = value_width(feature_count) - 3
    mask = (torch.arange(nf, device=features.device) < feature_count).to(
        features.dtype)
    feats = features[:, :nf] if nf <= 10 else torch.cat(
        [features, features.new_zeros(C, nf - 10)], dim=-1)
    return torch.cat([colors, feats * mask[None, :]], dim=-1)


def build_features(gaussians: Gaussians, camera: Camera,
                   z_depth: bool = False,
                   normals: torch.Tensor | None = None) -> torch.Tensor:
    """The 10-channel per-Gaussian feature matrix: [1, plane distance
    |n.x_cam| (or z-depth), world normal x3, albedo x3, roughness, metallic]."""
    C = gaussians.capacity
    if normals is None:
        normals = gaussians.get_normals(camera.cam_center)
    wv = camera.world_view
    cam_n = normals @ wv[:3, :3]
    cam_p = gaussians.xyz @ wv[:3, :3] + wv[3, :3]
    if z_depth:
        dist = cam_p[:, 2]
    else:
        dist = torch.abs(torch.sum(cam_n * cam_p, dim=-1))
    return torch.cat([
        gaussians.xyz.new_ones(C, 1),
        dist[:, None],
        normals,
        gaussians.get_albedo,
        gaussians.get_roughness,
        gaussians.get_metallic,
    ], dim=-1)


def rasterize_from_projected(
    proj: Projected,
    opacities: torch.Tensor,       # (C,)
    features: torch.Tensor,        # (C, 10)
    bg: torch.Tensor,              # (3,)
    camera: Camera,
    feature_count: int = 10,
    tile: int = 16,
    chunk: int = 256,
    instance_cap: int = 2 ** 17,
    m2d_sink: torch.Tensor | None = None,
    m2d_abs_sink: torch.Tensor | None = None,
    term_cut: bool = False,
    expand_cap: int | None = None,
) -> RasterOut:
    H, W = camera.height, camera.width
    with torch.no_grad():  # an integer layout: nothing to differentiate
        binning = bin_gaussians(proj, H, W, tile, instance_cap, chunk,
                                opacities=opacities,
                                with_present=not term_cut, term_cut=term_cut,
                                expand_cap=expand_cap)
    values = pack_values(proj.colors, features, feature_count)
    means2d = proj.means2d if m2d_sink is None else proj.means2d + m2d_sink
    out = blend_tiles(values, means2d, proj.conics, opacities, binning,
                      H, W, tile, chunk, m2d_abs_sink=m2d_abs_sink)

    image = out.image[:, :H, :W]
    final_T = out.final_T[:H, :W]
    color = image[0:3] + final_T[None] * bg[:, None, None]
    buffer = image[3:13]
    if buffer.shape[0] < 10:
        buffer = torch.cat([buffer, image.new_zeros(10 - buffer.shape[0], H, W)])
    return RasterOut(color=color, buffer=buffer, final_T=final_T,
                     radii=proj.radii, observe=out.observe,
                     dropped=binning.dropped,
                     num_instances=binning.num_instances,
                     dropped_expand=binning.dropped_expand,
                     aligned_demand=binning.num_aligned,
                     num_kept=binning.num_kept,
                     chunk_tile=binning.chunk_tile,
                     tiles=binning.tile_nonempty.shape[0], chunk=chunk)


def observe_from_projected(
    proj: Projected,
    opacities: torch.Tensor,       # (C,)
    camera: Camera,
    tile: int = 16,
    chunk: int = 256,
    instance_cap: int = 2 ** 17,
    term_cut: bool = False,
    expand_cap: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-Gaussian observe counts (C,) int32 and the binning `dropped`
    scalar, without blending any values: the multi-view trim consumes only
    visibility bits, which depend on geometry and opacity alone. Counts
    equal rasterize_from_projected(...).observe, with or without the cut.
    Nothing reduces per Gaussian here, so the binning skips its survivor
    counts."""
    H, W = camera.height, camera.width
    with torch.no_grad():
        binning = bin_gaussians(proj, H, W, tile, instance_cap, chunk,
                                opacities=opacities, with_present=False,
                                term_cut=term_cut, expand_cap=expand_cap)
        observe = observe_tiles(proj.means2d, proj.conics, opacities, binning,
                                H, W, tile, chunk)
    return observe, binning.dropped
