"""Pinhole camera of the reference: GL-style z in [0, 1], row-vector matrices.

A frozen plain-PyTorch copy of the port's camera conventions (the
benchmark's yardstick may not change with the program): `world_view` is
the world-to-camera matrix stored transposed, so p_cam = [p, 1] @
world_view; `full_proj` = world_view @ projection. The matrices are built
in numpy in float64 and rounded to float32 once, so the reference sees the
same camera numbers as a program that follows the published conventions.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def pick_resolution(orig_w: int, orig_h: int, resolution: int) -> tuple[int, int]:
    """The -r flag: 1/2/4/8 divide the source size."""
    if resolution not in (1, 2, 4, 8):
        raise ValueError(f"the reference supports -r 1/2/4/8, not {resolution}")
    return round(orig_w / resolution), round(orig_h / resolution)


def _w2c(R: np.ndarray, T: np.ndarray) -> np.ndarray:
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = T
    Rt[3, 3] = 1.0
    return Rt.astype(np.float32)


def _projection(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    tan_y, tan_x = math.tan(fovy / 2.0), math.tan(fovx / 2.0)
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / (tan_x * znear)
    P[1, 1] = znear / (tan_y * znear)
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


@dataclasses.dataclass(frozen=True)
class Cam:
    world_view: torch.Tensor
    full_proj: torch.Tensor
    cam_center: torch.Tensor
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    tanfovx: torch.Tensor
    tanfovy: torch.Tensor
    width: int
    height: int
    zfar: float = 100.0

    @staticmethod
    def create(R, T, fovx, fovy, width, height, device, znear=0.01, zfar=100.0):
        w2c = _w2c(np.asarray(R), np.asarray(T))
        world_view = w2c.T
        full_proj = world_view @ _projection(znear, zfar, fovx, fovy).T
        c2w = np.linalg.inv(w2c)

        def f32(x):
            return torch.tensor(np.asarray(x, np.float32), device=device)

        return Cam(world_view=f32(world_view), full_proj=f32(full_proj),
                   cam_center=f32(c2w[:3, 3]), fx=f32(fov2focal(fovx, width)),
                   fy=f32(fov2focal(fovy, height)), cx=f32(0.5 * width),
                   cy=f32(0.5 * height), tanfovx=f32(math.tan(fovx * 0.5)),
                   tanfovy=f32(math.tan(fovy * 0.5)), width=int(width),
                   height=int(height), zfar=float(zfar))

    @property
    def device(self):
        return self.world_view.device

    def get_rays(self) -> torch.Tensor:
        """(H, W, 3) camera-space directions through the pixel grid."""
        v, u = torch.meshgrid(
            torch.arange(self.height, dtype=torch.float32, device=self.device),
            torch.arange(self.width, dtype=torch.float32, device=self.device),
            indexing="ij")
        rx = (u - self.cx) / self.fx
        ry = (v - self.cy) / self.fy
        return torch.stack([rx, ry, torch.ones_like(rx)], dim=-1)

    def get_K(self, scale: float = 1.0) -> torch.Tensor:
        z = torch.zeros((), device=self.device)
        o = torch.ones((), device=self.device)
        return torch.stack([torch.stack([self.fx / scale, z, self.cx / scale]),
                            torch.stack([z, self.fy / scale, self.cy / scale]),
                            torch.stack([z, z, o])])

    def get_inv_K(self, scale: float = 1.0) -> torch.Tensor:
        z = torch.zeros((), device=self.device)
        o = torch.ones((), device=self.device)
        return torch.stack([
            torch.stack([scale / self.fx, z, -self.cx / self.fx]),
            torch.stack([z, scale / self.fy, -self.cy / self.fy]),
            torch.stack([z, z, o])])

    def world_to_cam(self, pts: torch.Tensor) -> torch.Tensor:
        return pts @ self.world_view[:3, :3] + self.world_view[3, :3]

    def cam_to_world(self, pts: torch.Tensor) -> torch.Tensor:
        return (pts - self.world_view[3, :3]) @ self.world_view[:3, :3].T


def neighbor_tables(Rs, Ts, opt: dict):
    """Per-view nearest (multi-view loss) and nearby (roughness loss) tables:
    candidates ordered by camera distance then angle, (V, K) int32 padded
    with the view itself, and (V, K) bool masks (GS-2M's selection rules)."""
    V = len(Rs)
    centers = np.stack([-(R @ T) for R, T in zip(Rs, Ts)], 0)
    rays = np.stack([R[:, 2] for R in Rs], 0)
    rays = rays / (np.linalg.norm(rays, axis=-1, keepdims=True) + 1e-12)
    dists = np.linalg.norm(centers[:, None] - centers[None], axis=-1)
    cosang = np.clip((rays[:, None] * rays[None]).sum(-1), -1.0, 1.0)
    angles = np.arccos(cosang) * 180.0 / 3.14159

    def make(k, select):
        table = np.tile(np.arange(V, dtype=np.int32)[:, None], (1, k))
        mask = np.zeros((V, k), bool)
        for i in range(V):
            order = np.lexsort((angles[i], dists[i]))
            chosen = select(order, angles[i][order], dists[i][order])
            m = min(len(chosen), k)
            table[i, :m] = chosen[:m]
            mask[i, :m] = True
        return table, mask

    def nearest(order, a, d):
        keep = ((a <= opt["multi_view_max_angle"])
                & (d > opt["multi_view_min_dist"])
                & (d < opt["multi_view_max_dist"]))
        return order[keep][:opt["multi_view_num"]]

    def nearby(order, a, d):
        keep = ((a <= opt["nearby_cam_max_angle"])
                & (a >= opt["nearby_cam_min_angle"])
                & (d >= opt["nearby_cam_min_dist"])
                & (d <= opt["nearby_cam_max_dist"]))
        idx = order[keep]
        n = min(opt["nearby_cam_num"], len(idx))
        if n == 0:
            return idx[:0]
        return idx[np.round(np.linspace(0, len(idx) - 1, n)).astype(int)]

    return make(opt["multi_view_num"], nearest) + make(opt["nearby_cam_num"],
                                                      nearby)
