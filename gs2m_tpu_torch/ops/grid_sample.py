"""Bilinear grid sampling for the multi-view losses.

Port of gs2m_tpu/ops/grid_sample.py: sampling a (C, H, W) image at
normalized coordinates in [-1, 1] (x, y), bilinear with align_corners=True
and border padding (the mode the multi-view loss uses), differentiable in
both the image and the grid. Written as the JAX package writes its core:
coordinates clipped to the border (jnp.clip's half gradient at a tie),
four corner taps gathered, and an image gradient summed per pixel by a
sort-based segment sum (`ops/gather.py`), never by float atomics:
F.grid_sample's CUDA backward accumulates with atomicAdd, so two runs of
the same step differed in the last bits.
"""
from __future__ import annotations

import torch

from gs2m_tpu_torch.ops.gather import gather_rows


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip's gradient (half at a tie with a bound)."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


def bilinear_at(img: torch.Tensor, gx: torch.Tensor,
                gy: torch.Tensor) -> torch.Tensor:
    """img (C, H, W) at pixel coordinates gx, gy (...) already inside
    [0, W-1] x [0, H-1] -> (..., C)."""
    C, H, W = img.shape
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx = (gx - x0)[..., None]
    wy = (gy - y0)[..., None]
    x0i = torch.clamp(x0, 0, W - 1).long()
    x1i = torch.clamp(x0 + 1, 0, W - 1).long()
    y0i = torch.clamp(y0, 0, H - 1).long()
    y1i = torch.clamp(y0 + 1, 0, H - 1).long()
    idx = torch.stack([y0i * W + x0i, y0i * W + x1i,
                       y1i * W + x0i, y1i * W + x1i])
    v = gather_rows(img.reshape(C, H * W).T, idx)            # (4, ..., C)
    top = v[0] * (1 - wx) + v[1] * wx
    bot = v[2] * (1 - wx) + v[3] * wx
    return top * (1 - wy) + bot * wy


def grid_sample_bilinear(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Sample `img` (C, H, W) at normalized coords `grid` (..., 2) in
    [-1, 1] (x, y), align_corners=True, border padding. Returns (..., C)."""
    _, H, W = img.shape
    gx = _clip((grid[..., 0] + 1.0) * 0.5 * (W - 1), 0.0, W - 1)
    gy = _clip((grid[..., 1] + 1.0) * 0.5 * (H - 1), 0.0, H - 1)
    return bilinear_at(img, gx, gy)


def sample_pixels(img: torch.Tensor, pix: torch.Tensor) -> torch.Tensor:
    """Sample (C, H, W) image at pixel coordinates pix (..., 2) = (x, y),
    align_corners=True normalization: x_norm = 2x/(W-1) - 1."""
    _, H, W = img.shape
    gx = 2.0 * pix[..., 0] / (W - 1) - 1.0
    gy = 2.0 * pix[..., 1] / (H - 1) - 1.0
    return grid_sample_bilinear(img, torch.stack([gx, gy], -1))
