"""The cells' inputs, made on the device from the run's seed.

A DTU-like capture stands in for a scan: the configuration's number of
views on a horizontal arc around the origin, all looking at it, at the
source image size; smooth noise as ground truth (drawn on a coarse grid
and upsampled, so that NCC patches see structure); masks thresholded from
the same kind of noise. The state after densification is drawn from the
seed: Gaussians in a slab, flattened, at a fixed count in a fixed
capacity, with Adam's first moments at zero and its second moments at the
configuration's per-group level, and, with the material stage, the light
and its Adam state. Every seed gives the same shapes; only values differ.
The cameras do not depend on the seed at all.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

SH_C0 = 0.28209479177387814
PARAMS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation", "albedo",
          "roughness", "metallic")


def arc_camera(theta: float, dist: float, height: float):
    """(R, T) looking at the origin from (dist sin t, height, -dist cos t):
    R the camera-to-world rotation (COLMAP's y-down camera), T the
    world-to-camera translation."""
    eye = np.array([dist * np.sin(theta), height, -dist * np.cos(theta)])
    forward = -eye / np.linalg.norm(eye)
    right = np.cross(np.array([0.0, -1.0, 0.0]), forward)
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(forward, right), forward], axis=1)
    return R, -R.T @ eye


@dataclasses.dataclass
class Scene:
    Rs: list
    Ts: list
    fx: float
    fy: float
    width: int            # source image size
    height: int
    extent: float         # 1.1 x the largest camera distance from their mean
    gt: torch.Tensor      # (V, 3, h, w) at the trained resolution
    gray: torch.Tensor    # (V, 1, h', w') luma at the NCC scale
    alpha: torch.Tensor   # (V, 1, h, w) masks (ones without mask_gt)


@dataclasses.dataclass
class State:
    params: dict          # name -> (C, ...) raw parameters
    alive: torch.Tensor   # (C,) bool
    nu0: dict             # name -> () second-moment level
    iteration: int
    light: torch.Tensor | None
    light_nu0: torch.Tensor | None


def trained_size(cfg: dict) -> tuple[int, int]:
    s = cfg["scene"]
    r = cfg["model"]["resolution"]
    return round(s["image_width"] / r), round(s["image_height"] / r)


def ncc_size(cfg: dict) -> tuple[int, int]:
    """The luma images' size: the trained size over the NCC scale (1/r)."""
    w, h = trained_size(cfg)
    r = cfg["model"]["resolution"]
    return int(w * r), int(h * r)


def _smooth_noise(gen, n, c, h, w, cell, device):
    coarse = torch.rand(n, c, -(-h // cell) + 1, -(-w // cell) + 1,
                        generator=gen, device=device)
    up = F.interpolate(coarse, scale_factor=cell, mode="bilinear",
                       align_corners=False)
    return up[:, :, :h, :w].contiguous()


def make_scene(cfg: dict, seed: int, device) -> Scene:
    s = cfg["scene"]
    V = s["views"]
    half = math.radians(s["arc_degrees"]) / 2.0
    cams = [arc_camera(-half + 2 * half * i / max(V - 1, 1), s["camera_distance"],
                       s["camera_height"]) for i in range(V)]
    Rs, Ts = [c[0] for c in cams], [c[1] for c in cams]
    centers = np.stack([-(R @ T) for R, T in cams], 0)
    extent = float(np.linalg.norm(centers - centers.mean(0), axis=-1).max() * 1.1)

    gen = torch.Generator(device=device).manual_seed(seed + 2 ** 40)
    w, h = trained_size(cfg)
    W, H = ncc_size(cfg)
    full = _smooth_noise(gen, V, 3, H, W, s["gt_cell_px"], device)
    gray = full[:, 0:1] * 0.299 + full[:, 1:2] * 0.587 + full[:, 2:3] * 0.114
    gt = F.adaptive_avg_pool2d(full, (h, w)) if (H, W) != (h, w) else full
    del full
    if cfg["model"]["mask_gt"]:
        alpha = (_smooth_noise(gen, V, 1, h, w, s["gt_cell_px"] * 4, device)
                 > s["mask_threshold"]).float()
    else:
        alpha = torch.ones(V, 1, h, w, device=device)
    return Scene(Rs=Rs, Ts=Ts, fx=s["focal_px"], fy=s["focal_px"],
                 width=s["image_width"], height=s["image_height"], extent=extent,
                 gt=gt, gray=gray, alpha=alpha)


def make_state(cfg: dict, seed: int, device) -> State:
    st = cfg["state"]
    C, N = st["capacity"], st["alive"]
    K = (cfg["model"]["sh_degree"] + 1) ** 2
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(N, 9, generator=gen, device=device)
    n = torch.randn(N, 3 + 4 + 3 * (K - 1) + 5, generator=gen, device=device)
    slab = torch.tensor(st["slab"], device=device)
    lo, hi = st["opacity_logit"]
    alive_p = {
        "xyz": (u[:, 0:3] * 2.0 - 1.0) * slab,
        "f_dc": ((u[:, 3:6] * 0.8 + 0.1 - 0.5) / SH_C0)[:, None, :],
        "f_rest": (n[:, 7:7 + 3 * (K - 1)] * st["f_rest_std"]).reshape(N, K - 1, 3),
        "opacity": (lo + (hi - lo) * u[:, 6:7]),
        "scaling": math.log(st["scale"]) + st["scale_log_std"] * n[:, 0:3]
        + torch.tensor([0.0, 0.0, math.log(st["flatness"])], device=device),
        "rotation": n[:, 3:7],
        "albedo": n[:, 7 + 3 * (K - 1):10 + 3 * (K - 1)] * st["material_logit_std"],
        "roughness": n[:, 10 + 3 * (K - 1):11 + 3 * (K - 1)] * st["material_logit_std"],
        "metallic": n[:, 11 + 3 * (K - 1):12 + 3 * (K - 1)] * st["material_logit_std"],
    }
    fill = {"scaling": -10.0, "opacity": -12.0}
    params = {}
    for k in PARAMS:
        v = alive_p[k]
        full = torch.full((C,) + tuple(v.shape[1:]), fill.get(k, 0.0), device=device)
        full[:N] = v
        params[k] = full
    params["rotation"][N:, 0] = 1.0
    alive = torch.zeros(C, dtype=torch.bool, device=device)
    alive[:N] = True
    nu0 = {k: torch.tensor(float(st["adam_nu0"][k]), device=device) for k in PARAMS}
    light = light_nu0 = None
    if cfg.get("light"):
        r = cfg["light"]["base_res"]
        light = torch.rand(6, r, r, 3, generator=gen, device=device) * 0.5 + 0.25
        light_nu0 = torch.tensor(float(cfg["light"]["adam_nu0"]), device=device)
    return State(params=params, alive=alive, nu0=nu0, iteration=st["iteration"],
                 light=light, light_nu0=light_nu0)
