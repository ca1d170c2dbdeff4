"""Differentiable SSIM: 11x11 Gaussian window (sigma 1.5), C1 = 0.01^2,
C2 = 0.03^2, "same" zero padding, mean over the map.

Port of gs2m_tpu/ops/ssim.py. The separable blur is two F.conv2d passes in
true float32 (the package pins TF32 off: a TF32 blur makes
blur(x^2) - mu^2 go negative past C2 and SSIM leaves [-1, 1]). The
gradient reaches img1 only, as in the JAX package's fused-ssim train mode:
img2 is the ground truth and is detached. Plain autograd stands in for
the JAX package's stored-partials custom backward (the same derivative).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

C1 = 0.01 ** 2
C2 = 0.03 ** 2


def _gaussian_window(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    xs = np.arange(window_size) - window_size // 2
    g = np.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


@functools.cache
def _window(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The window on `device`, copied there once (a copy per call would
    wait for the card)."""
    return torch.from_numpy(_gaussian_window()).to(device, dtype)


def _blur(x: torch.Tensor) -> torch.Tensor:
    """Separable 11x11 Gaussian blur, 'same' zero padding. x: (B, C, H, W)."""
    w = _window(x.device, x.dtype)
    b, c, h, wd = x.shape
    y = F.conv2d(x.reshape(b * c, 1, h, wd), w.reshape(1, 1, 11, 1),
                 padding=(5, 0))
    y = F.conv2d(y, w.reshape(1, 1, 1, 11), padding=(0, 5))
    return y.reshape(b, c, h, wd)


def ssim_map(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) per-pixel SSIM map."""
    mu1 = _blur(img1)
    mu2 = _blur(img2)
    sigma1_sq = _blur(img1 * img1) - mu1 * mu1
    sigma2_sq = _blur(img2 * img2) - mu2 * mu2
    sigma12 = _blur(img1 * img2) - mu1 * mu2
    A = 2.0 * mu1 * mu2 + C1
    B = 2.0 * sigma12 + C2
    C = mu1 * mu1 + mu2 * mu2 + C1
    D = sigma1_sq + sigma2_sq + C2
    return (A * B) / (C * D)


def fused_ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Mean SSIM over a (B, C, H, W) batch; grads to img1 only."""
    return torch.mean(ssim_map(img1, img2.detach()))


def ssim_reference(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Plain SSIM mean, differentiable in both images."""
    return torch.mean(ssim_map(img1, img2))
