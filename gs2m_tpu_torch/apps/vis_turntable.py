"""Turntable visualization: orbit renders of a trained model -> animated WebP.

Port of scripts/vis_turntable.py, rendered by the port's renderer (K1 on
the card). Two modes:

* Gaussian model: render / normal / depth / albedo map orbits (default).
* Extracted mesh (`--mesh tsdf_post.ply`): one flat surfel splat per face
  (tangent axes sized by the face area, the normal axis collapsed,
  `mesh_to_surfels`), headlight-Lambert shaded per frame on the device, so
  a dense TSDF mesh renders as a diffuse surface through the same
  rasterizer.

The instance caps are the script's and are never regrown (2**21 in the
mesh mode, 2**20 in the model mode): each frame's binning overflow
(`dropped`) is printed. Frames are written with PIL's animated WebP writer
(80 ms per frame, looping); a Pillow without WebP raises. Runs on the card
unless --device cpu.

Usage: python -m gs2m_tpu_torch.apps.vis_turntable -m <model_dir> \\
           [--map render] [--mesh <mesh.ply>] [--frames 60] [--size 512] \\
           [--out turntable.webp] [--device cuda|cpu]
"""
from __future__ import annotations

import os
import sys
import time
from argparse import ArgumentParser

import numpy as np
import torch

from gs2m_tpu_torch.apps.quality_gate import ring_camera

MESH_INSTANCE_CAP = 2 ** 21
MODEL_INSTANCE_CAP = 2 ** 20
MESH_BASE_COLOR = np.array([0.82, 0.8, 0.78], np.float32)  # Principled-ish gray


def _rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """(N, 3, 3) rotation matrices -> (N, 4) quaternions (r, x, y, z):
    the trace formula, and the largest-diagonal formula on rows whose trace
    is not positive (the script's per-row fallback, vectorized with the
    same operations in the same order, so bit-equal)."""
    m = R
    t = np.trace(m, axis1=1, axis2=2)
    q = np.zeros((len(m), 4), np.float64)
    s = np.sqrt(np.maximum(t + 1.0, 1e-12)) * 2
    q[:, 0] = 0.25 * s
    q[:, 1] = (m[:, 2, 1] - m[:, 1, 2]) / s
    q[:, 2] = (m[:, 0, 2] - m[:, 2, 0]) / s
    q[:, 3] = (m[:, 1, 0] - m[:, 0, 1]) / s
    bad = t <= 0
    k = np.argmax(np.diagonal(m, axis1=1, axis2=2), axis=1)
    for axis in range(3):
        rows = np.nonzero(bad & (k == axis))[0]
        M = m[rows]
        i, j, l = axis, (axis + 1) % 3, (axis + 2) % 3
        o1, o2 = sorted((j, l))   # the script subtracts in index order
        s_ = np.sqrt(np.maximum(1.0 + M[:, i, i] - M[:, o1, o1]
                                - M[:, o2, o2], 1e-12)) * 2
        w = (M[:, l, j] - M[:, j, l]) / s_
        a = 0.25 * s_
        b = (M[:, i, j] + M[:, j, i]) / s_
        c = (M[:, i, l] + M[:, l, i]) / s_
        q[rows, 0] = w
        q[rows, 1 + i] = a
        q[rows, 1 + j] = b
        q[rows, 1 + l] = c
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def mesh_to_surfels(mesh_ply: str):
    """Triangles -> flat surfel splats: (centers, quats, log_scales, normals),
    one thin Gaussian per face."""
    from gs2m_tpu_torch.data.ply import fetch_mesh

    verts, faces, _ = fetch_mesh(mesh_ply)
    v = verts[faces].astype(np.float64)          # (F, 3, 3)
    centers = v.mean(1)
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    n = np.cross(e1, e2)
    area = 0.5 * np.linalg.norm(n, axis=1)
    n = n / (np.linalg.norm(n, axis=1, keepdims=True) + 1e-12)
    t1 = e1 / (np.linalg.norm(e1, axis=1, keepdims=True) + 1e-12)
    t2 = np.cross(n, t1)
    R = np.stack([t1, t2, n], axis=-1)           # columns = splat axes
    quats = _rotmat_to_quat(R)
    s = np.sqrt(np.maximum(area, 1e-12))         # tangent sigma ~ face size
    log_scales = np.log(np.stack([s * 0.9, s * 0.9, s * 1e-3], -1) + 1e-12)
    return (centers.astype(np.float32), quats,
            log_scales.astype(np.float32), n.astype(np.float32))


def orbit_distance(points: np.ndarray, distance: float) -> tuple:
    """-> (orbit center, orbit radius): the points' centroid and, unless
    `distance` > 0, 3x the 90th percentile of their spread."""
    center = points.mean(0)
    spread = np.linalg.norm(points - center, axis=1)
    dist = distance if distance > 0 else float(np.quantile(spread, 0.9) * 3)
    return center, dist


def orbit_camera(i: int, frames: int, center: np.ndarray, dist: float,
                 elevation: float, size: int, device):
    """Frame i's camera on the ring around `center` (fov 0.8, square)."""
    from gs2m_tpu_torch.core.camera import Camera

    R, T = ring_camera(2 * np.pi * i / frames, dist=dist,
                       height=elevation * dist)
    T = T - (R.T @ center)
    return Camera.create(R, T, fovx=0.8, fovy=0.8, width=size, height=size,
                         device=device)


def surfel_gaussians(centers, quats, log_scales, device):
    """The surfels as Gaussians of SH degree 0 at opacity 0.97."""
    import dataclasses

    from gs2m_tpu_torch.core.gaussians import Gaussians, inverse_sigmoid

    F = len(centers)
    # mean_sq_dist is a placeholder: the scales are replaced just below, so
    # the k-NN spacing Gaussians.create would compute is never used.
    g = Gaussians.create(centers, np.full((F, 3), 0.8, np.float32),
                         max_sh_degree=0, capacity=F,
                         mean_sq_dist=np.ones(F, np.float32), device=device)
    dev = g.device
    return dataclasses.replace(
        g, rotation=torch.as_tensor(quats, device=dev),
        scaling=torch.as_tensor(log_scales, device=dev),
        opacity=torch.full((F, 1), float(inverse_sigmoid(
            torch.tensor(0.97, dtype=torch.float32))), device=dev))


def mesh_frame(g, centers: torch.Tensor, normals: torch.Tensor, cam):
    """One headlight-Lambert frame of the surfels (`centers`, `normals`:
    (F, 3) float32 on g's device, shaded there) -> (HxWx3 image in [0, 1],
    dropped)."""
    import dataclasses

    from gs2m_tpu_torch.core.sh import C0
    from gs2m_tpu_torch.models.render import render

    view = cam.cam_center[None] - centers
    view = view / (torch.linalg.norm(view, dim=1, keepdim=True) + 1e-12)
    lam = (normals * view).sum(1, keepdim=True).abs()
    base = torch.as_tensor(MESH_BASE_COLOR, device=centers.device)
    col = (base[None] * (0.25 + 0.75 * lam)).clamp(0, 1)
    gf = dataclasses.replace(g, features_dc=((col - 0.5) / C0)[:, None, :])
    with torch.no_grad():
        pkg = render(gf, cam, torch.ones(3, device=g.device), 0, chunk=256,
                     instance_cap=MESH_INSTANCE_CAP)
    img = np.clip(pkg["render"].permute(1, 2, 0).cpu().numpy(), 0, 1)
    return img, int(pkg["dropped"])


def model_frame(g, cam, map_name: str, sh_degree: int):
    """One frame of a map of the Gaussian model -> (HxWx3 image in [0, 1],
    dropped)."""
    from gs2m_tpu_torch.models.render import render

    with torch.no_grad():
        pkg = render(g, cam, torch.zeros(3, device=g.device), sh_degree,
                     geometry_stage=map_name in ("normal", "depth"),
                     material_stage=map_name == "albedo", chunk=256,
                     instance_cap=MODEL_INSTANCE_CAP)
    if map_name == "render":
        img = np.clip(pkg["render"].permute(1, 2, 0).cpu().numpy(), 0, 1)
    elif map_name == "normal":
        img = np.clip(pkg["normal_map"].permute(1, 2, 0).cpu().numpy()
                      * 0.5 + 0.5, 0, 1)
    elif map_name == "albedo":
        img = np.clip(pkg["albedo_map"].permute(1, 2, 0).cpu().numpy(), 0, 1)
    else:
        d = pkg["depth_map"][0].cpu().numpy()
        lo, hi = np.percentile(d, 1), np.percentile(d, 99)
        img = np.repeat(((np.clip(d, lo, hi) - lo)
                         / (hi - lo + 1e-8))[..., None], 3, -1)
    return img, int(pkg["dropped"])


def write_webp(path: str, frames: list):
    """An animated WebP, 80 ms per frame, looping."""
    from PIL import Image, features

    if not features.check("webp"):
        raise RuntimeError("this Pillow was built without WebP support: the "
                           "turntable cannot be written as .webp")
    ims = [Image.fromarray(f) for f in frames]
    ims[0].save(path, save_all=True, append_images=ims[1:], duration=80,
                loop=0)


def main(argv=None) -> dict:
    """-> {"out", "frames", "ms_per_frame" (each frame's render and readback,
    host clock after a device sync), "dropped" (per frame), "gaussians"}."""
    from gs2m_tpu_torch import resolve_device

    p = ArgumentParser()
    p.add_argument("--model_path", "-m", required=True)
    p.add_argument("--iteration", type=int, default=-1)
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--elevation", type=float, default=0.35)
    p.add_argument("--distance", type=float, default=-1.0)
    p.add_argument("--map", default="render",
                   choices=["render", "normal", "depth", "albedo"])
    p.add_argument("--mesh", default="",
                   help="render this mesh PLY as diffuse-shaded surfels "
                        "instead of the Gaussian model")
    p.add_argument("--out", default="")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--sh_degree", type=int, default=3)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    if args.mesh:
        centers, quats, log_scales, normals = mesh_to_surfels(args.mesh)
        g = surfel_gaussians(centers, quats, log_scales, device)
        center, dist = orbit_distance(centers, args.distance)
        centers_d = torch.as_tensor(centers, device=device)
        normals_d = torch.as_tensor(normals, device=device)

        def frame(cam):
            return mesh_frame(g, centers_d, normals_d, cam)
        label = "mesh frame"
        out = args.out or os.path.join(
            os.path.dirname(args.mesh) or ".", "turntable_mesh.webp")
    else:
        from gs2m_tpu_torch.core.gaussians import Gaussians
        from gs2m_tpu_torch.data.ply import load_gaussian_ply
        from gs2m_tpu_torch.data.scene import search_max_iteration

        iteration = args.iteration
        if iteration == -1:
            iteration = search_max_iteration(
                os.path.join(args.model_path, "point_cloud"))
        ply = os.path.join(args.model_path, "point_cloud",
                           f"iteration_{iteration}", "point_cloud.ply")
        raw = load_gaussian_ply(ply)
        g = Gaussians.from_raw(raw, args.sh_degree, device=device)
        center, dist = orbit_distance(np.asarray(raw["xyz"]), args.distance)

        def frame(cam):
            return model_frame(g, cam, args.map, args.sh_degree)
        label = "frame"
        out = args.out or os.path.join(
            args.model_path, f"turntable_{args.map}_{iteration}.webp")

    frames, dropped, ms = [], [], []
    for i in range(args.frames):
        cam = orbit_camera(i, args.frames, center, dist, args.elevation,
                           args.size, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        img, drop = frame(cam)
        ms.append((time.perf_counter() - t0) * 1e3)
        frames.append((img * 255).astype(np.uint8))
        dropped.append(drop)
        print(f"\r[>] {label} {i + 1}/{args.frames} dropped {drop}", end="",
              flush=True)
    print()
    print(f"[>] dropped per frame: {dropped} (instance cap "
          f"{MESH_INSTANCE_CAP if args.mesh else MODEL_INSTANCE_CAP}, never "
          f"regrown); {g.capacity} Gaussians; median {np.median(ms):.2f} "
          f"ms/frame")
    write_webp(out, frames)
    print(f"[>] Wrote {out}")
    return {"out": out, "frames": args.frames, "ms_per_frame": ms,
            "dropped": dropped, "gaussians": g.capacity}


if __name__ == "__main__":
    main(sys.argv[1:])
