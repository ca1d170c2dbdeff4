"""Scene state, camera side: dataset sniffing, cameras, cameras_extent.

Port of the part of gs2m_tpu/data/scene.py that the render app uses:
`Scene(..., load_images=False)` reads the dataset, writes the model
directory's cameras.json and input.ply, and builds one Camera per view on
the scene's device. The GT image stacks, the neighbor tables and
`training_setup` arrive with the training slice.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import numpy as np

from gs2m_tpu_torch import resolve_device
from gs2m_tpu_torch.core.camera import Camera
from gs2m_tpu_torch.core.config import ModelConfig
from gs2m_tpu_torch.data.readers import (SceneInfo, detect_and_read_scene,
                                         focal2fov, pick_resolution)


def camera_to_json(idx: int, info) -> dict:
    w2c = np.eye(4)
    w2c[:3, :3] = info.R.T
    w2c[:3, 3] = info.T
    c2w = np.linalg.inv(w2c)
    return {
        "id": idx,
        "img_name": info.image_name,
        "width": info.width,
        "height": info.height,
        "position": c2w[:3, 3].tolist(),
        "rotation": [r.tolist() for r in c2w[:3, :3]],
        "fx": info.fx,
        "fy": info.fy,
    }


class Scene:
    """Loads a dataset's cameras onto `device` (None: the CUDA card, raising
    without one)."""

    def __init__(self, model_cfg: ModelConfig, resolution_scale: float = 1.0,
                 shuffle: bool = True, load_images: bool = False,
                 scene_info: SceneInfo | None = None, device=None):
        if load_images:
            raise NotImplementedError(
                "GT image stacks are not ported yet: ROADMAP.md Queue A, "
                "'Training slice'; pass load_images=False")
        self.model_cfg = model_cfg
        self.device = resolve_device(device)
        info = scene_info or detect_and_read_scene(
            model_cfg.source_path, model_cfg.images, model_cfg.masks,
            model_cfg.depths, model_cfg.eval)
        self.info = info
        self.cameras_extent = info.radius

        if shuffle:
            rng = np.random.default_rng(0)
            rng.shuffle(info.train_cameras)
            rng.shuffle(info.test_cameras)

        if model_cfg.model_path:
            os.makedirs(model_cfg.model_path, exist_ok=True)
            cams_json = [camera_to_json(i, c) for i, c in
                         enumerate(info.test_cameras + info.train_cameras)]
            with open(os.path.join(model_cfg.model_path, "cameras.json"), "w") as f:
                json.dump(cams_json, f)
            if info.ply_path and os.path.exists(info.ply_path):
                shutil.copyfile(info.ply_path,
                                os.path.join(model_cfg.model_path, "input.ply"))

        self.resolution_scale = resolution_scale
        self.train_camera_infos = info.train_cameras
        self.test_camera_infos = info.test_cameras
        self.train_cameras = [self._make_camera(c) for c in info.train_cameras]
        self.test_cameras = [self._make_camera(c) for c in info.test_cameras]

    def _make_camera(self, ci) -> Camera:
        w, h = pick_resolution(ci.width, ci.height, self.model_cfg.resolution,
                               self.resolution_scale)
        return Camera.create(ci.R, ci.T, fovx=focal2fov(ci.fx, ci.width),
                             fovy=focal2fov(ci.fy, ci.height), width=w, height=h,
                             device=self.device)


def search_max_iteration(point_cloud_dir: str) -> int:
    """Largest saved iteration_* folder."""
    subs = [p.name for p in Path(point_cloud_dir).iterdir() if p.is_dir()]
    iters = [int(s.split("_")[-1]) for s in subs if s.startswith("iteration_")]
    if not iters:
        raise FileNotFoundError(f"no iteration_* under {point_cloud_dir}")
    return max(iters)
