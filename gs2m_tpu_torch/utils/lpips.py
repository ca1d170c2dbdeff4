"""LPIPS perceptual metric (VGG16 backbone), in PyTorch.

Port of gs2m_tpu/utils/lpips.py: ImageNet-normalized input, VGG16
features at the five pre-pool ReLU stages, channel-unit-normalized
activations (+1e-10), the learned 1x1 linear heads `lin{i}` (or, without
them, the plain channel mean), the spatial mean, summed over the stages.
The convolutions are torch's own (LPIPS has no custom kernel), in float32
with TF32 off (gs2m_tpu_torch/__init__.py pins that for the package).

Weight gating: the repo ships no pretrained weights and nothing is
downloaded, so LPIPS is computed only when a weights file is supplied: a
pickle or npz of torchvision-layout VGG16 conv weights
(`features.N.weight/bias`) plus the LPIPS linear heads
(`lin{i}.model.1.weight`), as scripts/convert_lpips.py writes it.
`lpips(..., weights_path=...)` or the GS2M_LPIPS_WEIGHTS variable names
it; without one `lpips` raises FileNotFoundError and the metrics app
reports LPIPS as null.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch
import torch.nn.functional as F

# torchvision VGG16 `features` conv indices per stage (pre-pool ReLU blocks).
_VGG16_STAGES = [[0, 2], [5, 7], [10, 12, 14], [17, 19, 21], [24, 26, 28]]

_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# Weights on a device, by (path, modification time, device): the metrics
# app scores one image pair per call.
_CACHE: dict = {}


def load_weights(path: str) -> dict:
    """npz or pickle -> {name: numpy array}."""
    if path.endswith(".npz"):
        return dict(np.load(path))
    with open(path, "rb") as f:
        return {k: np.asarray(v) for k, v in pickle.load(f).items()}


def weights_file(weights_path: str | None = None) -> str:
    """The weights file to use (`weights_path`, else GS2M_LPIPS_WEIGHTS);
    raises FileNotFoundError when there is none."""
    weights_path = weights_path or os.environ.get("GS2M_LPIPS_WEIGHTS", "")
    if not weights_path or not os.path.exists(weights_path):
        raise FileNotFoundError(
            "LPIPS requires pretrained VGG16 + linear-head weights; none are "
            "bundled with the repo. Export them once (torchvision vgg16 "
            "features.* + lpips lin heads) to a pickle/npz and pass "
            "weights_path= or set GS2M_LPIPS_WEIGHTS.")
    return weights_path


def _device_weights(path: str, device: torch.device) -> dict:
    key = (path, os.path.getmtime(path), str(device))
    if key not in _CACHE:
        _CACHE.clear()
        _CACHE[key] = {k: torch.from_numpy(np.asarray(v, np.float32)).to(device)
                       for k, v in load_weights(path).items()
                       if k.startswith(("features.", "lin"))}
    return _CACHE[key]


def _vgg_stages(x: torch.Tensor, weights: dict) -> list:
    feats = []
    for i, stage in enumerate(_VGG16_STAGES):
        for idx in stage:
            x = F.relu(F.conv2d(x, weights[f"features.{idx}.weight"],
                                weights[f"features.{idx}.bias"], padding=1))
        feats.append(x)
        if i < len(_VGG16_STAGES) - 1:  # 2x2 max pool between stages
            x = F.max_pool2d(x, 2)
    return feats


def lpips(img1, img2, weights_path: str | None = None,
          device=None) -> torch.Tensor:
    """img1/img2 (3, H, W) or (N, 3, H, W) in [0, 1], numpy or torch.
    Returns the mean LPIPS over the batch as a 0-d float32 tensor on
    `device` (None: the CUDA card; raises without one)."""
    from gs2m_tpu_torch import resolve_device

    path = weights_file(weights_path)
    device = resolve_device(device)
    weights = _device_weights(path, device)
    mean = torch.from_numpy(_IMAGENET_MEAN).to(device).reshape(1, 3, 1, 1)
    std = torch.from_numpy(_IMAGENET_STD).to(device).reshape(1, 3, 1, 1)

    def prep(x):
        x = torch.as_tensor(x).to(device=device, dtype=torch.float32)
        if x.ndim == 3:
            x = x[None]
        return (x - mean) / std

    with torch.no_grad():
        f1 = _vgg_stages(prep(img1), weights)
        f2 = _vgg_stages(prep(img2), weights)
        total = 0.0
        for i, (a, b) in enumerate(zip(f1, f2)):
            a = a / torch.sqrt(torch.sum(a * a, dim=1, keepdim=True) + 1e-10)
            b = b / torch.sqrt(torch.sum(b * b, dim=1, keepdim=True) + 1e-10)
            d = (a - b) ** 2
            key = f"lin{i}.model.1.weight"
            if key in weights:
                d = torch.sum(d * weights[key].reshape(1, -1, 1, 1), dim=1,
                              keepdim=True)
            else:  # uncalibrated fallback: the plain channel mean
                d = torch.mean(d, dim=1, keepdim=True)
            total = total + torch.mean(d, dim=(1, 2, 3))
        return torch.mean(total)
