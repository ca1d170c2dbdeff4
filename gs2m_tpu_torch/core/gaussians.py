"""Gaussian point-cloud state: fixed-capacity padded tensors with alive mask.

Port of gs2m_tpu/core/gaussians.py. Every tensor keeps the fixed capacity C
with a boolean `alive` mask, so rows line up one for one with the JAX
package's in tests; padded rows carry opacity logit -12, log-scale -10 and
the identity rotation, as there.

Raw (pre-activation) parameters:
  xyz (C,3) | features_dc (C,1,3) | features_rest (C,K-1,3) | scaling (C,3 log)
  rotation (C,4 quat) | opacity (C,1 logit) | albedo (C,3 logit)
  roughness (C,1 logit) | metallic (C,1 logit)
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gs2m_tpu_torch import resolve_device
from gs2m_tpu_torch.core import sh as shlib


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1.0 - x))


def quat_to_rotmat_elems(q: torch.Tensor) -> tuple:
    """(…,4) normalized quaternion (r,x,y,z) -> the 9 rotation-matrix entries
    as a row-major tuple of (…,) tensors (the JAX package's element layout)."""
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return (1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
            2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
            2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y))


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(…,4) normalized quaternion (r,x,y,z) -> (…,3,3) rotation matrix."""
    e = quat_to_rotmat_elems(q)
    return torch.stack([torch.stack(e[0:3], -1), torch.stack(e[3:6], -1),
                        torch.stack(e[6:9], -1)], dim=-2)


@dataclasses.dataclass(frozen=True)
class Gaussians:
    xyz: torch.Tensor            # (C, 3)
    features_dc: torch.Tensor    # (C, 1, 3)
    features_rest: torch.Tensor  # (C, K-1, 3)
    scaling: torch.Tensor        # (C, 3) log-scales
    rotation: torch.Tensor       # (C, 4) unnormalized quaternion
    opacity: torch.Tensor        # (C, 1) logit
    albedo: torch.Tensor         # (C, 3) logit
    roughness: torch.Tensor      # (C, 1) logit
    metallic: torch.Tensor       # (C, 1) logit
    alive: torch.Tensor          # (C,) bool — padded slots are False
    max_sh_degree: int

    # --- activations ---------------------------------------------------------

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    @property
    def num_alive(self) -> int:
        return int(self.alive.sum())

    @property
    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.scaling)

    @property
    def get_rotation(self) -> torch.Tensor:
        q = self.rotation
        return q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + 1e-20)

    @property
    def get_opacity(self) -> torch.Tensor:
        # Dead slots get opacity exactly 0 so they never rasterize.
        return torch.sigmoid(self.opacity) * self.alive[:, None]

    @property
    def get_albedo(self) -> torch.Tensor:
        return torch.sigmoid(self.albedo)

    @property
    def get_roughness(self) -> torch.Tensor:
        return torch.sigmoid(self.roughness)

    @property
    def get_metallic(self) -> torch.Tensor:
        return torch.sigmoid(self.metallic)

    @property
    def get_features(self) -> torch.Tensor:
        """(C, K, 3) concatenated SH coefficients."""
        return torch.cat([self.features_dc, self.features_rest], dim=1)

    def get_covariance(self, scaling_modifier: float = 1.0) -> torch.Tensor:
        """(C, 6) upper-triangular world covariance Sigma = R S S^T R^T, as
        sigma_ij = sum_k s_k^2 R_ik R_jk (xx xy xz yy yz zz)."""
        e = quat_to_rotmat_elems(self.get_rotation)
        s = self.get_scaling * scaling_modifier
        s0, s1, s2 = s[:, 0] ** 2, s[:, 1] ** 2, s[:, 2] ** 2

        def sig(i, j):
            return (s0 * e[3 * i] * e[3 * j] + s1 * e[3 * i + 1] * e[3 * j + 1]
                    + s2 * e[3 * i + 2] * e[3 * j + 2])

        return torch.stack([sig(0, 0), sig(0, 1), sig(0, 2),
                            sig(1, 1), sig(1, 2), sig(2, 2)], dim=-1)

    def get_normals(self, cam_center: torch.Tensor) -> torch.Tensor:
        """(C, 3) world normals: the rotation column of the shortest axis
        (first minimum on ties), flipped toward the camera."""
        scales = self.get_scaling
        e = quat_to_rotmat_elems(self.get_rotation)
        s0, s1, s2 = scales[:, 0], scales[:, 1], scales[:, 2]
        m0 = (s0 <= s1) & (s0 <= s2)
        m1 = ~m0 & (s1 <= s2)

        def col(i):
            return torch.where(m0, e[3 * i],
                               torch.where(m1, e[3 * i + 1], e[3 * i + 2]))

        normals = torch.stack([col(0), col(1), col(2)], dim=-1)
        view_dirs = cam_center[None, :] - self.xyz
        flip = torch.sum(normals * view_dirs, dim=-1, keepdim=True) < 0.0
        normals = torch.where(flip, -normals, normals)
        return normals / torch.sqrt(torch.sum(normals * normals, dim=-1,
                                              keepdim=True) + 1e-20)

    # --- construction ----------------------------------------------------------

    @staticmethod
    def create(points: np.ndarray, colors: np.ndarray, max_sh_degree: int,
               capacity: int, mean_sq_dist: np.ndarray | None = None,
               device=None) -> "Gaussians":
        """Initialize from an SfM/random point cloud: SH DC from RGB,
        log-scales from sqrt(mean 3-NN squared distance), identity
        rotations, opacity 0.1, material logits 1; padded to `capacity`,
        on `device` (None: the CUDA card, raising without one)."""
        n = points.shape[0]
        if capacity < n:
            raise ValueError(f"capacity {capacity} < number of points {n}")
        K = shlib.num_sh_coeffs(max_sh_degree)
        if mean_sq_dist is None:
            from gs2m_tpu_torch.ops.knn import mean_sq_dist_to_3nn
            mean_sq_dist = mean_sq_dist_to_3nn(np.asarray(points, np.float32))
        dist2 = np.maximum(np.asarray(mean_sq_dist, np.float32), 1e-7)
        scales = np.repeat(np.log(np.sqrt(dist2))[:, None], 3, axis=1)
        dc = shlib.rgb_to_sh_dc(np.asarray(colors, np.float32))[:, None, :]
        op = float(inverse_sigmoid(torch.tensor(0.1, dtype=torch.float32)))

        def pad(a, fill=0.0):
            out = np.full((capacity,) + a.shape[1:], fill, np.float32)
            out[:n] = a
            return out

        rot = np.zeros((capacity, 4), np.float32)
        rot[:, 0] = 1.0
        alive = np.zeros((capacity,), bool)
        alive[:n] = True
        params = {
            "xyz": pad(np.asarray(points, np.float32)), "f_dc": pad(dc),
            "f_rest": pad(np.zeros((n, K - 1, 3), np.float32)),
            "scaling": pad(scales, fill=-10.0), "rotation": rot,
            "opacity": pad(np.full((n, 1), op, np.float32), fill=-12.0),
            "albedo": pad(np.ones((n, 3), np.float32)),
            "roughness": pad(np.ones((n, 1), np.float32)),
            "metallic": pad(np.ones((n, 1), np.float32)),
        }
        return Gaussians.from_numpy(params, alive, max_sh_degree, device)

    @staticmethod
    def from_numpy(params: dict, alive: np.ndarray, max_sh_degree: int,
                   device=None) -> "Gaussians":
        """Carry-over from the JAX package: `params` holds its params_dict()
        keys as numpy arrays (np.asarray of each leaf), `alive` its mask.
        `device` None means the CUDA card (raises without one)."""
        device = resolve_device(device)

        def t(a):
            return torch.tensor(np.asarray(a, np.float32), device=device)

        return Gaussians(
            xyz=t(params["xyz"]), features_dc=t(params["f_dc"]),
            features_rest=t(params["f_rest"]), scaling=t(params["scaling"]),
            rotation=t(params["rotation"]), opacity=t(params["opacity"]),
            albedo=t(params["albedo"]), roughness=t(params["roughness"]),
            metallic=t(params["metallic"]),
            alive=torch.tensor(np.asarray(alive, bool), device=device),
            max_sh_degree=max_sh_degree)

    @staticmethod
    def from_raw(raw: dict, max_sh_degree: int, capacity: int | None = None,
                 device=None) -> "Gaussians":
        """Build from raw (pre-activation) numpy arrays, e.g. a loaded PLY
        snapshot (data/ply.py load_gaussian_ply), padded to `capacity`, on
        `device` (None: the CUDA card, raising without one)."""
        n = raw["xyz"].shape[0]
        cap = capacity or n
        if cap < n:
            raise ValueError(f"capacity {cap} < {n}")

        def pad(a, fill=0.0):
            out = np.full((cap,) + a.shape[1:], fill, np.float32)
            out[:n] = a
            return out

        rot = np.zeros((cap, 4), np.float32)
        rot[:, 0] = 1.0
        rot[:n] = raw["rotation"]
        alive = np.zeros((cap,), bool)
        alive[:n] = True
        params = {
            "xyz": pad(raw["xyz"]), "f_dc": pad(raw["f_dc"]),
            "f_rest": pad(raw["f_rest"]), "scaling": pad(raw["scaling"], -10.0),
            "rotation": rot, "opacity": pad(raw["opacity"], -12.0),
            "albedo": pad(raw["albedo"]), "roughness": pad(raw["roughness"]),
            "metallic": pad(raw["metallic"]),
        }
        return Gaussians.from_numpy(params, alive, max_sh_degree, device)

    def params_dict(self) -> dict:
        """The optimizable leaves, keyed like the JAX package's param groups."""
        return {
            "xyz": self.xyz,
            "f_dc": self.features_dc,
            "f_rest": self.features_rest,
            "opacity": self.opacity,
            "scaling": self.scaling,
            "rotation": self.rotation,
            "albedo": self.albedo,
            "roughness": self.roughness,
            "metallic": self.metallic,
        }

    def with_params(self, params: dict) -> "Gaussians":
        return dataclasses.replace(
            self, xyz=params["xyz"], features_dc=params["f_dc"],
            features_rest=params["f_rest"], opacity=params["opacity"],
            scaling=params["scaling"], rotation=params["rotation"],
            albedo=params["albedo"], roughness=params["roughness"],
            metallic=params["metallic"])
