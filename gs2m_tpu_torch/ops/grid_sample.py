"""Bilinear grid sampling for the multi-view losses.

Port of gs2m_tpu/ops/grid_sample.py's surface: sampling a (C, H, W) image
at normalized coordinates in [-1, 1] (x, y), bilinear with
align_corners=True and border padding (the mode the multi-view loss uses),
differentiable in both the image and the grid.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_bilinear(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Sample `img` (C, H, W) at normalized coords `grid` (..., 2) in
    [-1, 1] (x, y), align_corners=True. Returns (..., C)."""
    C = img.shape[0]
    lead = grid.shape[:-1]
    out = F.grid_sample(img[None], grid.reshape(1, -1, 1, 2), mode="bilinear",
                        padding_mode="border", align_corners=True)
    return out[0, :, :, 0].T.reshape(*lead, C)


def sample_pixels(img: torch.Tensor, pix: torch.Tensor) -> torch.Tensor:
    """Sample (C, H, W) image at pixel coordinates pix (..., 2) = (x, y),
    align_corners=True normalization: x_norm = 2x/(W-1) - 1."""
    _, H, W = img.shape
    gx = 2.0 * pix[..., 0] / (W - 1) - 1.0
    gy = 2.0 * pix[..., 1] / (H - 1) - 1.0
    return grid_sample_bilinear(img, torch.stack([gx, gy], -1))
