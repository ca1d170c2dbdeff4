"""Quality gate: train -> render -> TSDF mesh -> chamfer + PSNR/SSIM on a
synthetic scene with analytic geometry, entirely through the port.

Port of scripts/run_quality_gate.py, run in process (the train, render and
metrics apps' `main`) and without the TPU retry wrapper:

  1. build the scene as COLMAP files, its GT images rendered by the port
     (`build_scene`): a noise- or smooth-textured sphere, or with --scene
     composite a sphere and a box on a finite ground plane (sharp edges, a
     large planar region, contact lines, occlusion)
  2. train with --eval, held-out PSNR at the test iterations and a
     checkpoint at each (apps.train)
  3. render + TSDF-fuse + mesh the train split (apps.render --extract_mesh)
  4. PSNR/SSIM on both splits (apps.metrics); the chamfer of the train
     split's cleaned mesh against the ANALYTIC surface (the unit sphere, or
     the composite's exact unsigned distance)
  5. write quality_gate.json with the JAX gate's keys

--skip_train reuses an existing model directory (render, mesh and score
only); --chunk overrides the train stage's blend chunk.

--production --smoke is the JAX package's CPU smoke schedule: 120x90, 8
views, 1,500 points, 600 iterations, checkpoints at 200/400/600, a mesh at
voxel 0.03 / trunc 0.12 (reference: test PSNR 27.73, chamfer 0.069,
BASELINE.md). --production alone is the full protocol: 800x600, 49 views,
40,000 points, 30k iterations (reference: QUALITY_GATE_r05.json). The
scenes' pieces (`ring_camera`, `make_sphere_data`, `COMPOSITE` and
the composite's sampler, distance and colors) are numpy copies of
tests/make_synthetic_scene.py's, `composite_chamfer` is
scripts/run_quality_gate.py's; the chamfers sample the mesh with
apps/eval_dtu.py's `sample_mesh_surface`.

Usage: python -m gs2m_tpu_torch.apps.quality_gate --out <dir> \\
           [--production [--smoke]] [--scene sphere|composite] \\
           [--skip_train] [--chunk N] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from gs2m_tpu_torch.apps.eval_dtu import sample_mesh_surface


def ring_camera(theta: float, dist: float = 4.0, height: float = 0.8):
    """c2w looking at the origin from a ring; returns (R_transposed_w2c, T_w2c)."""
    eye = np.array([dist * np.sin(theta), height, -dist * np.cos(theta)])
    forward = -eye / np.linalg.norm(eye)           # +z view axis toward origin
    up = np.array([0.0, -1.0, 0.0])                 # COLMAP y-down
    right = np.cross(up, forward)
    right /= np.linalg.norm(right)
    true_up = np.cross(forward, right)
    R_c2w = np.stack([right, true_up, forward], axis=1)  # columns
    w2c_R = R_c2w.T
    T = -w2c_R @ eye
    return R_c2w, T


def make_sphere_data(n_points: int = 4000, radius: float = 1.0, seed: int = 0,
                     texture: str = "smooth"):
    """Points ON a sphere surface; texture="noise" mixes per-point random
    color into the smooth normal coding, so the optimizer has to densify."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n_points, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pts = (v * radius).astype(np.float32)
    if texture == "noise":
        cols = (0.3 + 0.3 * v
                + 0.4 * rng.uniform(0, 1, (n_points, 3))).astype(np.float32)
        cols = np.clip(cols, 0.0, 1.0)
    else:
        cols = (0.5 + 0.45 * v).astype(np.float32)  # smooth normal coding
    return pts, cols


# --- the composite scene: a sphere and a box resting on a finite ground
# plane (COLMAP y-down: world-up is -y; the ground is y = ground_y,
# |x|, |z| <= ground_half). One source for the scene and the chamfer.
COMPOSITE = {
    "ground_y": 0.5, "ground_half": 1.6,
    "sphere_c": np.array([-0.55, 0.0, 0.1]), "sphere_r": 0.5,
    "box_c": np.array([0.6, 0.1, -0.1]), "box_h": np.array([0.35, 0.4, 0.3]),
    # visible-surface exclusions (regions no ring camera can see)
    "contact_eps": 0.04,
}


def composite_surface_distance(pts: np.ndarray) -> np.ndarray:
    """Exact unsigned distance from (N, 3) points to the composite surface
    (min over primitives; the finite plane's distance includes its edges)."""
    c = COMPOSITE
    d_sph = np.abs(np.linalg.norm(pts - c["sphere_c"], axis=1) - c["sphere_r"])
    q = np.abs(pts - c["box_c"]) - c["box_h"]
    outside = np.linalg.norm(np.maximum(q, 0.0), axis=1)
    inside = np.minimum(np.max(q, axis=1), 0.0)
    d_box = np.abs(outside + inside)
    dy = np.abs(pts[:, 1] - c["ground_y"])
    dx = np.maximum(np.abs(pts[:, 0]) - c["ground_half"], 0.0)
    dz = np.maximum(np.abs(pts[:, 2]) - c["ground_half"], 0.0)
    d_pln = np.sqrt(dy * dy + dx * dx + dz * dz)
    return np.minimum(np.minimum(d_sph, d_box), d_pln)


def _plane_footprint_free(p: np.ndarray) -> np.ndarray:
    """Mask of plane points NOT under the sphere or the box (invisible)."""
    c = COMPOSITE
    in_sph = (np.linalg.norm(p[:, [0, 2]] - c["sphere_c"][[0, 2]], axis=1)
              < c["sphere_r"] + c["contact_eps"])
    in_box = (np.all(np.abs(p[:, [0, 2]] - c["box_c"][[0, 2]])
                     < c["box_h"][[0, 2]] + c["contact_eps"], axis=1))
    return ~(in_sph | in_box)


def sample_composite_surface(n_points: int, seed: int = 0) -> np.ndarray:
    """Area-weighted samples of the VISIBLE composite surface: the sphere
    minus its contact cap, the box minus its bottom face, the plane minus
    the objects' footprints (the scene's splat centers and the chamfer's
    surface->mesh coverage term)."""
    c = COMPOSITE
    rng = np.random.default_rng(seed)
    r, h, E = c["sphere_r"], c["box_h"], c["ground_half"]
    area_sph = 4 * np.pi * r * r
    # box faces: +-x (hy*hz), +-z (hx*hy), top only in y (hx*hz)
    fa = np.array([h[1] * h[2], h[1] * h[2], h[0] * h[1], h[0] * h[1],
                   h[0] * h[2]]) * 4.0
    area_box = fa.sum()
    area_pln = (2 * E) ** 2 - np.pi * r ** 2 - 4 * h[0] * h[2]
    w = np.array([area_sph, area_box, area_pln])
    n_sph, n_box = (np.floor(n_points * w[:2] / w.sum())).astype(int)
    n_pln = n_points - n_sph - n_box

    out = []
    need = n_sph  # the sphere minus the cap touching the plane
    while need > 0:
        v = rng.normal(size=(2 * need + 16, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        p = c["sphere_c"] + r * v
        p = p[p[:, 1] < c["ground_y"] - c["contact_eps"]][:need]
        out.append(p)
        need -= len(p)
    # Box faces (not the bottom face, flush with the ground).
    face = rng.choice(5, size=n_box, p=fa / fa.sum())
    u = rng.uniform(-1, 1, (n_box, 2))
    bp = np.zeros((n_box, 3))
    for f, (ax, sgn) in enumerate([(0, 1), (0, -1), (2, 1), (2, -1), (1, -1)]):
        m = face == f
        oth = [a for a in range(3) if a != ax]
        bp[m, ax] = sgn * h[ax]
        bp[m, oth[0]] = u[m, 0] * h[oth[0]]
        bp[m, oth[1]] = u[m, 1] * h[oth[1]]
    out.append(c["box_c"] + bp)
    need = n_pln  # the plane minus the objects' footprints
    while need > 0:
        p = np.column_stack([rng.uniform(-E, E, 2 * need + 16),
                             np.full(2 * need + 16, c["ground_y"]),
                             rng.uniform(-E, E, 2 * need + 16)])
        p = p[_plane_footprint_free(p)][:need]
        out.append(p)
        need -= len(p)
    return np.concatenate(out).astype(np.float32)


def make_composite_data(n_points: int = 40_000, seed: int = 0):
    """Composite splat centers and noise-textured colors: a base tone per
    primitive plus per-point noise."""
    c = COMPOSITE
    pts = sample_composite_surface(n_points, seed)
    rng = np.random.default_rng(seed + 7)
    on_sph = (np.abs(np.linalg.norm(pts - c["sphere_c"], axis=1)
                     - c["sphere_r"]) < 1e-4)
    on_pln = np.abs(pts[:, 1] - c["ground_y"]) < 1e-4
    base = np.where(on_sph[:, None], np.array([[0.75, 0.40, 0.30]]),
                    np.where(on_pln[:, None], np.array([[0.45, 0.50, 0.40]]),
                             np.array([[0.30, 0.50, 0.75]])))
    cols = np.clip(0.75 * base + 0.35 * rng.uniform(0, 1, (len(pts), 3)),
                   0.0, 1.0).astype(np.float32)
    return pts, cols


def composite_point_scale(n_points: int) -> float:
    """Splat scale ~ the inter-point spacing, sqrt(visible area / n) with a
    visible area of ~14.7 (sphere 3.1 + box 2.5 + plane 9.1)."""
    return round((14.7 / n_points) ** 0.5, 3)


def build_scene(out_dir: str, n_views: int = 10, width: int = 64,
                height: int = 48, n_points: int = 300, seed: int = 0,
                opacity_boost: float = 6.0, point_scale: float | None = None,
                texture: str = "smooth", instance_cap: int = 2 ** 15,
                sfm_fraction: float = 0.5, scene: str = "sphere",
                device=None) -> str:
    """tests/make_synthetic_scene.build's sphere or composite scene through
    the port: a ring of views of the Gaussian splats (for the composite,
    radius 3.4 at two interleaved heights, so the box sides, the ground and
    the occlusion boundaries all get views), GT rendered with feature count
    1, chunk 64 and opacity x boost capped at 0.99, the instance cap
    doubled until nothing drops; a noisy subset of the points as the SfM
    cloud."""
    from PIL import Image

    from gs2m_tpu_torch.core.camera import Camera
    from gs2m_tpu_torch.core.gaussians import Gaussians
    from gs2m_tpu_torch.data import colmap as cm
    from gs2m_tpu_torch.ops.projection import project
    from gs2m_tpu_torch.ops.rasterize import (build_features,
                                              rasterize_from_projected)

    if scene == "composite":
        pts, cols = make_composite_data(n_points, seed=seed)

        def ring(i):
            return ring_camera(2 * np.pi * i / n_views, dist=3.4,
                               height=(-1.6 if i % 2 else -0.9))
    else:
        pts, cols = make_sphere_data(n_points, seed=seed, texture=texture)

        def ring(i):
            return ring_camera(2 * np.pi * i / n_views)
    msd = (np.full(pts.shape[0], point_scale ** 2, np.float32)
           if point_scale is not None else None)
    g = Gaussians.create(pts, cols, max_sh_degree=1, capacity=pts.shape[0],
                         mean_sq_dist=msd, device=device)

    fx = fy = 0.9 * width
    os.makedirs(os.path.join(out_dir, "sparse/0"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "images"), exist_ok=True)

    cams = {1: cm.ColmapCamera(1, "PINHOLE", width, height,
                               np.array([fx, fy, width / 2, height / 2],
                                        np.float64))}
    imgs = {}
    for i in range(n_views):
        R, T = ring(i)
        name = f"view_{i:03d}.png"
        imgs[i + 1] = cm.ColmapImage(i + 1, cm.rotmat_to_qvec(R.T), T, 1, name)

        cam = Camera.create(R, T, fovx=2 * np.arctan(width / (2 * fx)),
                            fovy=2 * np.arctan(height / (2 * fy)),
                            width=width, height=height, device=g.device)
        with torch.no_grad():
            opa = torch.clamp_max(g.get_opacity[:, 0] * opacity_boost, 0.99)
            proj = project(g, cam, g.max_sh_degree, opa)
            feats = build_features(g, cam)
            while True:
                out = rasterize_from_projected(
                    proj, opa, feats, torch.zeros(3, device=g.device), cam,
                    feature_count=1, chunk=64, instance_cap=instance_cap)
                if int(out.dropped) == 0 or instance_cap >= 2 ** 24:
                    break
                instance_cap *= 2  # carried to the remaining views
        img = np.clip(out.color.permute(1, 2, 0).cpu().numpy(), 0, 1)
        Image.fromarray((img * 255).astype(np.uint8)).save(
            os.path.join(out_dir, "images", name))

    cm.write_cameras_binary(os.path.join(out_dir, "sparse/0/cameras.bin"), cams)
    cm.write_images_binary(os.path.join(out_dir, "sparse/0/images.bin"), imgs)
    rng = np.random.default_rng(seed + 1)
    sel = rng.choice(pts.shape[0],
                     size=max(50, int(pts.shape[0] * sfm_fraction)),
                     replace=False)
    noisy = pts[sel] + rng.normal(scale=0.02, size=(len(sel), 3)).astype(np.float32)
    cm.write_points3d_binary(os.path.join(out_dir, "sparse/0/points3D.bin"),
                             noisy.astype(np.float64), (cols[sel] * 255))
    return out_dir


def sphere_chamfer(mesh_ply: str, radius: float = 1.0) -> dict:
    """Bidirectional chamfer between the mesh and the analytic sphere."""
    from scipy.spatial import cKDTree

    from gs2m_tpu_torch.data.ply import fetch_mesh

    verts, faces, _ = fetch_mesh(mesh_ply)
    if len(faces) > 0:
        pts = sample_mesh_surface(verts.astype(np.float64), faces, 0.01)
    else:
        pts = verts.astype(np.float64)
    # mesh -> sphere: exact analytic distance.
    d_m2s = np.abs(np.linalg.norm(pts, axis=1) - radius)
    # sphere -> mesh: sampled sphere vs mesh point KD-tree (coverage term).
    rng = np.random.default_rng(0)
    v = rng.normal(size=(20000, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    d_s2m, _ = cKDTree(pts).query(v * radius, k=1, workers=-1)
    return {
        "mesh_to_surface_mean": float(d_m2s.mean()),
        "surface_to_mesh_mean": float(d_s2m.mean()),
        "chamfer_mean": float(0.5 * (d_m2s.mean() + d_s2m.mean())),
        "mesh_points": int(len(pts)),
    }


def composite_chamfer(mesh_ply: str) -> dict:
    """Bidirectional chamfer between the mesh and the analytic composite
    surface: the exact distance of the mesh's samples to the surface, and
    of 30,000 visible-surface samples to the mesh's."""
    from scipy.spatial import cKDTree

    from gs2m_tpu_torch.data.ply import fetch_mesh

    verts, faces, _ = fetch_mesh(mesh_ply)
    if len(faces) > 0:
        pts = sample_mesh_surface(verts.astype(np.float64), faces, 0.01)
    else:
        pts = verts.astype(np.float64)
    d_m2s = composite_surface_distance(pts)
    surf = sample_composite_surface(30_000, seed=1).astype(np.float64)
    d_s2m, _ = cKDTree(pts).query(surf, k=1, workers=-1)
    return {
        "mesh_to_surface_mean": float(d_m2s.mean()),
        "surface_to_mesh_mean": float(d_s2m.mean()),
        "chamfer_mean": float(0.5 * (d_m2s.mean() + d_s2m.mean())),
        "mesh_points": int(len(pts)),
    }


def main(argv=None) -> dict:
    from gs2m_tpu_torch.apps import metrics as metrics_app
    from gs2m_tpu_torch.apps import render as render_app
    from gs2m_tpu_torch.apps import train as train_app

    ap = argparse.ArgumentParser(description="gs2m_tpu_torch quality gate")
    ap.add_argument("--out", required=True)
    ap.add_argument("--iterations", type=int, default=5000)
    ap.add_argument("--width", type=int, default=400)
    ap.add_argument("--height", type=int, default=300)
    ap.add_argument("--views", type=int, default=24)
    ap.add_argument("--points", type=int, default=6000)
    ap.add_argument("--production", action="store_true",
                    help="DTU-shaped full protocol: 800x600, 49 views, 30k "
                         "iterations with the reference schedule, "
                         "noise-textured sphere")
    ap.add_argument("--smoke", action="store_true",
                    help="with --production: the same code path at 120x90, "
                         "8 views, 600 iterations with a compressed schedule")
    ap.add_argument("--scene", default="sphere",
                    choices=("sphere", "composite"),
                    help="composite = sphere + box + ground plane with an "
                         "analytic distance chamfer: sharp edges, a large "
                         "planar region, contact lines and occlusion")
    ap.add_argument("--skip_train", action="store_true",
                    help="reuse an existing trained model dir")
    ap.add_argument("--chunk", type=int, default=None,
                    help="blend chunk override for the train stage")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--profile_iterations", nargs=2, type=int, default=None,
                    metavar=("START", "STOP"),
                    help="passed to the train app: a profiler window")
    args = ap.parse_args(argv)

    if args.production:
        if args.smoke:
            args.width, args.height = 120, 90
            args.views = 8
            args.points = 1_500
            args.iterations = 600
        else:
            args.width, args.height = 800, 600
            args.views = 49
            args.points = 40_000
            if args.iterations == ap.get_default("iterations"):
                args.iterations = 30_000

    scene_dir = os.path.join(args.out, "scene")
    model_dir = os.path.join(args.out, "model")
    smoke = args.production and args.smoke
    if not os.path.exists(os.path.join(scene_dir, "sparse/0/images.bin")):
        print("[>] Building synthetic surface scene", flush=True)
        # The composite's splat scale follows its point spacing; the
        # sphere's are the JAX gate's constants.
        if args.scene == "composite":
            scale = composite_point_scale(args.points)
        else:
            scale = (0.06 if smoke else 0.02) if args.production else 0.05
        if args.production:
            # Per-point noise texture, SfM cloud = 25 % of the true points
            # (densification has to recover the rest).
            build_scene(
                scene_dir, n_views=args.views, width=args.width,
                height=args.height, n_points=args.points, opacity_boost=8.0,
                point_scale=scale, texture="noise", sfm_fraction=0.25,
                instance_cap=2 ** 15 if smoke else 2 ** 20, scene=args.scene,
                device=args.device)
        else:
            build_scene(
                scene_dir, n_views=args.views, width=args.width,
                height=args.height, n_points=args.points, opacity_boost=8.0,
                point_scale=scale, scene=args.scene, device=args.device)

    if smoke:
        # Same flag surface as production, the schedule compressed so the
        # geometry stage, densify, trim and reset all fire in 600 iterations.
        stage_flags = ["--lambda_depth_normal", "0.015",
                       "--geometry_from_iter", "200",
                       "--densify_from_iter", "100",
                       "--densify_until_iter", "500",
                       "--opacity_reset_interval", "400", "--chunk", "64"]
        test_iters = (200, 400, args.iterations)
    elif args.production:
        # The reference DTU protocol: default schedule, lambda_depth_normal
        # 0.015, the full test-iteration ladder.
        stage_flags = ["--lambda_depth_normal", "0.015"]
        ladder = (1000, 5000, 7000, 10000, 15000, 20000, 25000, 30000)
        test_iters = tuple(v for v in ladder if v < args.iterations) \
            + (args.iterations,)
    else:
        stage_flags = ["--geometry_from_iter", "1000",
                       "--densify_until_iter", str(int(args.iterations * 0.8)),
                       "--densify_from_iter", "500",
                       "--opacity_reset_interval", "3000"]
        test_iters = (1000, 2000, 3000, args.iterations)
    dev_flags = ["--device", args.device]
    prof_flags = (["--profile_iterations", *map(str, args.profile_iterations)]
                  if args.profile_iterations else [])
    chunk_flags = ["--chunk", str(args.chunk)] if args.chunk else []

    t0 = time.time()
    if not args.skip_train:
        train_app.main(
            ["-s", scene_dir, "-m", model_dir, "--eval", "-r", "1",
             "--iterations", str(args.iterations), *stage_flags, *chunk_flags,
             *dev_flags, *prof_flags,
             "--test_iterations", *map(str, test_iters),
             "--save_iterations", str(args.iterations),
             "--checkpoint_iterations", *map(str, test_iters)])
    train_min = (time.time() - t0) / 60.0
    if args.skip_train:
        # An evaluation-only rerun reports the training log's own wall time.
        with open(os.path.join(model_dir, "train_log.jsonl")) as log:
            for line in log:
                rec = json.loads(line)
                if "elapsed_s" in rec:
                    train_min = rec["elapsed_s"] / 60.0

    voxel = "0.03" if smoke else ("0.01" if args.production else "0.02")
    render_app.main(["-m", model_dir, "--extract_mesh", "--voxel_size", voxel,
                     "--sdf_trunc", str(4 * float(voxel)),
                     "--iteration", str(args.iterations), *dev_flags])
    metrics_app.main(["-m", model_dir, *dev_flags])
    metrics_app.main(["-m", model_dir, "--split", "test", *dev_flags])

    mesh = os.path.join(model_dir, "train", f"ours_{args.iterations}", "mesh",
                        "tsdf_post.ply")
    chamfer = (composite_chamfer(mesh) if args.scene == "composite"
               else sphere_chamfer(mesh))
    with open(os.path.join(model_dir, "metrics_test.json")) as f:
        metrics = json.load(f)

    # Held-out PSNR trajectory + capacity stats from the train log.
    test_psnrs, peak_points, final_points = [], 0, 0
    mv_active = rough_active = None
    with open(os.path.join(model_dir, "train_log.jsonl")) as log:
        for line in log:
            rec = json.loads(line)
            if "test_psnr" in rec:
                test_psnrs.append((rec["iteration"], rec["test_psnr"]))
            if "points" in rec:
                peak_points = max(peak_points, rec["points"])
                final_points = rec["points"]
            mv_active = rec.get("mv_active", mv_active)
            rough_active = rec.get("rough_active", rough_active)

    result = {
        "scene": ("synthetic_composite" if args.scene == "composite"
                  else "synthetic_sphere_noise" if args.production
                  else "synthetic_sphere"),
        "production": bool(args.production),
        "resolution": f"{args.width}x{args.height}",
        "views": args.views,
        "iterations": args.iterations,
        "train_minutes": round(train_min, 2),
        "chamfer": chamfer,
        "test_psnr_trajectory": test_psnrs,
        "metrics_test": metrics,
        "peak_points": peak_points,
        "final_points": final_points,
        "mv_active_steps": mv_active,
        "rough_active_steps": rough_active,
        "mesh": mesh,
    }
    with open(os.path.join(args.out, "quality_gate.json"), "w") as f:
        json.dump(result, f, indent=2)
    print("[>] quality gate:", json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
