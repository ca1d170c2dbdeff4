"""Scene state: dataset sniffing, cameras, GT pixel stacks, neighbor graph.

Port of gs2m_tpu/data/scene.py: reads the dataset, writes the model
directory's cameras.json and input.ply, builds one Camera per view on the
scene's device, and (load_images=True) the (V, C, H, W) GT, alpha and
luma-at-NCC-scale stacks there. `training_setup` builds the per-view
nearest (multi-view loss) and nearby (roughness loss) neighbor tables.
`load_train_image_subset` (data-parallel ranks that draw from their own
view partition, parallel/dp.py) reads only a subset of the views from
disk; the other rows of the stacks are zeros (alpha ones).
The cameras stay a Python list and the neighbor tables stay numpy on the
host: the trainer picks a view and its neighbor on the host, so nothing is
indexed on the device by a device value.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import numpy as np

import torch

from gs2m_tpu_torch import resolve_device
from gs2m_tpu_torch.core.camera import Camera
from gs2m_tpu_torch.core.config import ModelConfig, OptimConfig
from gs2m_tpu_torch.data.readers import (SceneInfo, detect_and_read_scene,
                                         focal2fov, load_view_arrays,
                                         pick_resolution)


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


def build_neighbor_tables(cam_infos, opt: OptimConfig):
    """Per-view nearest (multi-view loss) and nearby (roughness loss) index
    tables: two (V, K) int32 arrays padded with the view's own index, and
    (V, K) bool validity masks."""
    V = len(cam_infos)
    centers = np.stack([-(c.R @ c.T) for c in cam_infos], 0)
    # Optical axis = 3rd column of the (transposed-w2c) rotation.
    rays = np.stack([c.R[:, 2] for c in cam_infos], 0)
    rays = rays / (np.linalg.norm(rays, axis=-1, keepdims=True) + 1e-12)
    dists = np.linalg.norm(centers[:, None] - centers[None], axis=-1)
    cosang = np.clip((rays[:, None] * rays[None]).sum(-1), -1.0, 1.0)
    angles = np.arccos(cosang) * 180.0 / 3.14159

    def make_table(k, select):
        table = np.tile(np.arange(V, dtype=np.int32)[:, None], (1, k))
        mask = np.zeros((V, k), bool)
        for i in range(V):
            order = np.lexsort((angles[i], dists[i]))
            chosen = select(order, angles[i][order], dists[i][order])
            m = min(len(chosen), k)
            table[i, :m] = chosen[:m]
            mask[i, :m] = True
        return table, mask

    def nearest_select(order, a, d):
        keep = ((a <= opt.multi_view_max_angle) & (d > opt.multi_view_min_dist)
                & (d < opt.multi_view_max_dist))
        return order[keep][:opt.multi_view_num]

    def nearby_select(order, a, d):
        keep = ((a <= opt.nearby_cam_max_angle) & (a >= opt.nearby_cam_min_angle)
                & (d >= opt.nearby_cam_min_dist) & (d <= opt.nearby_cam_max_dist))
        idx = order[keep]
        n = min(opt.nearby_cam_num, len(idx))
        if n == 0:
            return idx[:0]
        pos = np.round(np.linspace(0, len(idx) - 1, n)).astype(int)
        return idx[pos]

    nearest, nearest_mask = make_table(opt.multi_view_num, nearest_select)
    nearby, nearby_mask = make_table(opt.nearby_cam_num, nearby_select)
    return nearest, nearest_mask, nearby, nearby_mask


class Scene:
    """Loads a dataset onto `device` (None: the CUDA card, raising without
    one); with `opt`, also sets up the training-time state."""

    def __init__(self, model_cfg: ModelConfig, opt: OptimConfig | None = None,
                 resolution_scale: float = 1.0, shuffle: bool = True,
                 load_images: bool = True, scene_info: SceneInfo | None = None,
                 device=None):
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

        self.gt_images = None
        self.alpha_masks = None
        self.gray_images = None
        self.ncc_scale = 1.0
        self.loaded_views = None   # the views read from disk; None: all
        self._test_images = None
        if load_images and self.train_cameras:
            self._load_train_images()
        if opt is not None and self.train_cameras:
            self.training_setup(opt)

    def _make_camera(self, ci) -> Camera:
        w, h = pick_resolution(ci.width, ci.height, self.model_cfg.resolution,
                               self.resolution_scale)
        return Camera.create(ci.R, ci.T, fovx=focal2fov(ci.fx, ci.width),
                             fovy=focal2fov(ci.fy, ci.height), width=w, height=h,
                             device=self.device)

    def _view_rgb(self, ci, size) -> np.ndarray:
        rgb, alpha = load_view_arrays(ci, size, self.model_cfg.mask_gt)
        if self.model_cfg.white_background and alpha is not None:
            rgb = rgb * alpha + (1.0 - alpha)
        return rgb, alpha

    def _keep(self, i: int) -> bool:
        return self.loaded_views is None or i in self.loaded_views

    def _load_train_images(self):
        """Fill the (V, 3, H, W) GT and (V, 1, H, W) alpha stacks; rows of
        views outside `loaded_views` are zeros (alpha ones), unread."""
        rgbs, alphas = [], []
        for i, (ci, cam) in enumerate(zip(self.train_camera_infos,
                                          self.train_cameras)):
            if not self._keep(i):
                rgbs.append(np.zeros((3, cam.height, cam.width), np.float32))
                alphas.append(np.ones((1, cam.height, cam.width), np.float32))
                continue
            rgb, alpha = self._view_rgb(ci, (cam.width, cam.height))
            rgbs.append(rgb)
            alphas.append(alpha if alpha is not None else np.ones_like(rgb[:1]))
        self.gt_images = torch.from_numpy(np.stack(rgbs, 0)).to(self.device)
        self.alpha_masks = torch.from_numpy(np.stack(alphas, 0)).to(self.device)

    def load_train_image_subset(self, subset):
        """Read the GT (and, at NCC scale, gray) images of the train views in
        `subset` only, after training_setup built the neighbor tables
        (parallel/dp.py::host_view_closure gives a rank's subset)."""
        self.loaded_views = frozenset(int(v) for v in subset)
        self._load_train_images()
        self._populate_gray_images()

    def load_test_images(self) -> list:
        """GT images of the held-out split as host numpy, loaded at first
        use (the evaluation touches them a handful of times per run)."""
        if self._test_images is None:
            self._test_images = [
                self._view_rgb(ci, (cam.width, cam.height))[0]
                for ci, cam in zip(self.test_camera_infos, self.test_cameras)]
        return self._test_images

    def training_setup(self, opt: OptimConfig):
        (self.nearest_table, self.nearest_mask,
         self.nearby_table, self.nearby_mask) = build_neighbor_tables(
            self.train_camera_infos, opt)
        if opt.multi_view_ncc_scale > 0:
            self.ncc_scale = opt.multi_view_ncc_scale
        elif self.model_cfg.resolution in (1, 2, 4, 8):
            self.ncc_scale = 1.0 / self.model_cfg.resolution
        else:
            self.ncc_scale = 1.0
        if self.gt_images is not None:
            self._populate_gray_images()

    def _populate_gray_images(self):
        """Per-view luma (V, 1, H', W') at NCC scale."""
        if self.ncc_scale == 1.0:
            rgb = self.gt_images
        else:
            rgbs = []
            for i, (ci, cam) in enumerate(zip(self.train_camera_infos,
                                              self.train_cameras)):
                size = (int(cam.width / self.ncc_scale),
                        int(cam.height / self.ncc_scale))
                rgbs.append(self._view_rgb(ci, size)[0] if self._keep(i)
                            else np.zeros((3, size[1], size[0]), np.float32))
            rgb = torch.from_numpy(np.stack(rgbs, 0)).to(self.device)
        self.gray_images = (rgb[:, 0:1] * 0.299 + rgb[:, 1:2] * 0.587
                            + rgb[:, 2:3] * 0.114)

    def save_dir(self, iteration: int) -> str:
        d = os.path.join(self.model_cfg.model_path, "point_cloud",
                         f"iteration_{iteration}")
        os.makedirs(d, exist_ok=True)
        return d


def search_max_iteration(point_cloud_dir: str) -> int:
    """Largest saved iteration_* folder."""
    subs = [p.name for p in Path(point_cloud_dir).iterdir() if p.is_dir()]
    iters = [int(s.split("_")[-1]) for s in subs if s.startswith("iteration_")]
    if not iters:
        raise FileNotFoundError(f"no iteration_* under {point_cloud_dir}")
    return max(iters)
