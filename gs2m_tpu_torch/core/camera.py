"""Camera model: pinhole projection, GL-style z in [0,1], row-vector matrices.

Port of gs2m_tpu/core/camera.py with the same conventions:

* `world_view` is the world-to-camera matrix stored TRANSPOSED so points
  transform as row vectors: ``p_cam = [p, 1] @ world_view``.
* `full_proj` = world_view @ projection (both transposed), so
  ``p_clip = [p, 1] @ full_proj``.
* The projection matrix maps z in [znear, zfar] to [0, 1].

The matrices are built in numpy with the same float64 -> float32 steps as
the JAX package, so both packages see bit-identical cameras. The scalar
intrinsics are 0-d float32 tensors: arithmetic with them rounds in float32,
as JAX's float32 scalars do.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from gs2m_tpu_torch import resolve_device


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def world_to_view_matrix(R: np.ndarray, T: np.ndarray, translate=None,
                         scale: float = 1.0) -> np.ndarray:
    """w2c 4x4 (NOT transposed). R is the transposed w2c rotation (= c2w
    rotation), T the w2c translation — the COLMAP-loader convention."""
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = T
    Rt[3, 3] = 1.0
    if translate is not None or scale != 1.0:
        translate = np.zeros(3) if translate is None else np.asarray(translate)
        C2W = np.linalg.inv(Rt)
        C2W[:3, 3] = (C2W[:3, 3] + translate) * scale
        Rt = np.linalg.inv(C2W)
    return Rt.astype(np.float32)


def projection_matrix(znear: float, zfar: float, fovx: float,
                      fovy: float) -> np.ndarray:
    """GL-style perspective with z in [0, 1]."""
    tan_y = math.tan(fovy / 2.0)
    tan_x = math.tan(fovx / 2.0)
    top = tan_y * znear
    right = tan_x * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


@dataclasses.dataclass(frozen=True)
class Camera:
    """A single view: float32 tensors on one device; width/height ints."""

    world_view: torch.Tensor   # (4, 4) transposed w2c: p_cam = [p,1] @ world_view
    full_proj: torch.Tensor    # (4, 4) transposed w2c @ proj
    cam_center: torch.Tensor   # (3,)
    fx: torch.Tensor           # () focal in pixels
    fy: torch.Tensor
    cx: torch.Tensor           # () principal point (W/2, H/2)
    cy: torch.Tensor
    tanfovx: torch.Tensor
    tanfovy: torch.Tensor
    width: int
    height: int
    znear: float = 0.01
    zfar: float = 100.0

    @staticmethod
    def create(R: np.ndarray, T: np.ndarray, fovx: float, fovy: float,
               width: int, height: int, znear: float = 0.01,
               zfar: float = 100.0, trans=None, scale: float = 1.0,
               device=None) -> "Camera":
        """`device` None means the CUDA card (raises without one)."""
        device = resolve_device(device)
        w2c = world_to_view_matrix(np.asarray(R), np.asarray(T), trans, scale)
        world_view = w2c.T
        proj = projection_matrix(znear, zfar, fovx, fovy).T
        full_proj = world_view @ proj
        c2w = np.linalg.inv(w2c)

        def f32(x):
            return torch.tensor(np.asarray(x, np.float32), device=device)

        return Camera(
            world_view=f32(world_view),
            full_proj=f32(full_proj),
            cam_center=f32(c2w[:3, 3]),
            fx=f32(fov2focal(fovx, width)),
            fy=f32(fov2focal(fovy, height)),
            cx=f32(0.5 * width),
            cy=f32(0.5 * height),
            tanfovx=f32(math.tan(fovx * 0.5)),
            tanfovy=f32(math.tan(fovy * 0.5)),
            width=int(width),
            height=int(height),
            znear=float(znear),
            zfar=float(zfar),
        )

    @property
    def device(self) -> torch.device:
        return self.world_view.device

    def get_rays(self, scale: float = 1.0) -> torch.Tensor:
        """(H', W', 3) camera-space ray directions through pixel centers."""
        h, w = int(self.height / scale), int(self.width / scale)
        v, u = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=self.device),
            torch.arange(w, dtype=torch.float32, device=self.device),
            indexing="ij")
        rx = (scale * u - self.cx / scale) / self.fx
        ry = (scale * v - self.cy / scale) / self.fy
        return torch.stack([rx, ry, torch.ones_like(rx)], dim=-1)

    def get_K(self, scale: float = 1.0) -> torch.Tensor:
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        one = torch.ones((), dtype=torch.float32, device=self.device)
        return torch.stack([
            torch.stack([self.fx / scale, zero, self.cx / scale]),
            torch.stack([zero, self.fy / scale, self.cy / scale]),
            torch.stack([zero, zero, one])])

    def get_inv_K(self, scale: float = 1.0) -> torch.Tensor:
        """The JAX package's (approximate) inverse K, term for term."""
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        one = torch.ones((), dtype=torch.float32, device=self.device)
        return torch.stack([
            torch.stack([scale / self.fx, zero, -self.cx / self.fx]),
            torch.stack([zero, scale / self.fy, -self.cy / self.fy]),
            torch.stack([zero, zero, one])])

    def world_to_cam(self, pts: torch.Tensor) -> torch.Tensor:
        """(N,3) world points -> camera space."""
        return pts @ self.world_view[:3, :3] + self.world_view[3, :3]

    def cam_to_world(self, pts: torch.Tensor) -> torch.Tensor:
        return (pts - self.world_view[3, :3]) @ self.world_view[:3, :3].T
