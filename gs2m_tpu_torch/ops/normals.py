"""Normals from depth maps via back-projection + central-difference cross products.

Port of gs2m_tpu/ops/normals.py: back-project the depth image through K^-1
into camera (optionally world) space, take the cross product of the
horizontal and vertical central differences, normalize, zero the 1-px
border. `row0` offsets the pixel rows: a depth band of a larger frame
(band-sharded rendering, parallel/sp.py) back-projects with its global
rows.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def depth_to_points(depth: torch.Tensor, K: torch.Tensor,
                    c2w: torch.Tensor | None = None,
                    row0: int = 0) -> torch.Tensor:
    """(H, W) depth -> (H, W, 3) camera-space (or world if c2w given) points
    on the integer pixel grid 0..W-1 / row0..row0+H-1."""
    H, W = depth.shape
    y, x = torch.meshgrid(
        row0 + torch.arange(H, dtype=depth.dtype, device=depth.device),
        torch.arange(W, dtype=depth.dtype, device=depth.device), indexing="ij")
    pix = torch.stack([x * depth, y * depth, depth], dim=-1)
    # inv_ex: no singularity check, which would wait for the card.
    pts_cam = pix @ torch.linalg.inv_ex(K).inverse.T
    if c2w is None:
        return pts_cam
    return pts_cam @ c2w[:3, :3].T + c2w[:3, 3]


def points_to_normals(pts: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) point image -> (H, W, 3) unit normals, zero on the 1-px
    border: cross(right - left, top - bottom)."""
    H, W, _ = pts.shape
    bottom = pts[2:H, 1:W - 1]
    top = pts[0:H - 2, 1:W - 1]
    right = pts[1:H - 1, 2:W]
    left = pts[1:H - 1, 0:W - 2]
    n = torch.linalg.cross(right - left, top - bottom, dim=-1)
    n = n / torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True) + 1e-20)
    return F.pad(n, (0, 0, 1, 1, 1, 1))


def normal_from_depth_image(depth: torch.Tensor, K: torch.Tensor,
                            c2w: torch.Tensor | None = None,
                            row0: int = 0) -> torch.Tensor:
    """(H, W) depth -> (H, W, 3) normals in world space (camera space if
    c2w is None). With `row0` (a depth band) the 1-px zero border lands on
    the band's edges; banded callers zero the true image border
    themselves."""
    return points_to_normals(depth_to_points(depth, K, c2w, row0=row0))
