"""Material gate: train a glossy sphere under a known analytic light, then
check what the material stage recovered, entirely through the port.

Port of scripts/run_material_gate.py, run in process (the train, render
and metrics apps' `main`) and without the TPU retry wrapper. The
GlossyBlender protocol (`--mask_gt --material --eval --white_background
--reflection_threshold 0.2 --lambda_smooth 0.5 --lambda_normal 0.5`) on
the synthetic specular sphere of `build_glossy_scene`:

  1. build the glossy scene: two rings of cameras, banded albedo, a glossy
     (roughness 0.1, y < 0) and a rough (0.5) hemisphere, masks; the GT
     images are shaded under `analytic_env` per point and rendered by the
     port at feature count 1
  2. train warmup -> geometry + material (apps.train)
  3. render the decomposition (apps.render: PBR render, albedo / roughness /
     metallic / diffuse / specular maps, envmap.png) and score it
     (apps.metrics, both splits)
  4. the checks: the learned light's luminance correlation with the
     analytic light, the recovered roughness of the two zones (glossy below
     rough), the held-out PBR PSNR, and how often the roughness and
     multi-view terms fired (train_log.jsonl)
  5. write material_gate.json with the JAX gate's keys; `pass` is its rule
     (zones ordered and luminance correlation > 0.5)

The default is the published protocol: 400x300, 36 views, 20,000 points,
10,000 iterations, cubemap 512. Below 10,000 iterations the schedule is
compressed as the JAX gate compresses it (geometry + material from half
the run, opacity resets at max(400, 0.3 x the run)). --smoke is the scale
chip_smoke.py runs: 160x120, 12 views, 3,000 points, 600 iterations; its
two rings' neighbours lie beyond the default nearby distance (2.5), so it
widens that to 3.5 for the roughness term to fire. The scene builder's
pieces (`analytic_env`, the glossy shading) are numpy copies of
tests/make_synthetic_scene.py's.

Usage: python -m gs2m_tpu_torch.apps.material_gate --out <dir> \\
           [--smoke] [--iterations N] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import time

import numpy as np
import torch

from gs2m_tpu_torch.apps.quality_gate import ring_camera

LUMA = np.array([0.2126, 0.7152, 0.0722])


def analytic_env(dirs: np.ndarray, power_scale: float = 1.0) -> np.ndarray:
    """The known analytic environment light: three colored directional
    lobes + ambient. `dirs` (..., 3) unit; returns (..., 3) linear RGB."""
    lobes = [
        (np.array([0.0, -1.0, 0.0]), np.array([1.5, 1.3, 0.9]), 8.0),   # warm top (y-down)
        (np.array([1.0, 0.0, 0.3]), np.array([0.4, 0.6, 1.4]), 6.0),    # cool side
        (np.array([-0.8, 0.3, -0.5]), np.array([0.8, 0.3, 0.2]), 4.0),  # red back
    ]
    out = np.full(dirs.shape[:-1] + (3,), 0.12, np.float64)
    for u, c, p in lobes:
        u = u / np.linalg.norm(u)
        d = np.maximum(np.einsum("...k,k->...", dirs, u), 0.0)
        out += c * (d ** (p * power_scale))[..., None]
    return out


def build_glossy_scene(out_dir: str, n_views: int = 36, width: int = 400,
                       height: int = 300, n_points: int = 20_000,
                       seed: int = 0, device=None) -> str:
    """A specular sphere under analytic_env as a COLMAP scene with masks:
    view-dependent GT (diffuse banding + sharp / broad specular per
    hemisphere) that only a material decomposition can fit. GT rendered by
    the port with feature count 1, chunk 64, opacity x8 capped at 0.99 over
    a white background, the instance cap doubled until nothing drops; the
    masks are 1 - final T; a noisy third of the points is the SfM cloud."""
    from PIL import Image

    from gs2m_tpu_torch.core.camera import Camera
    from gs2m_tpu_torch.core.gaussians import Gaussians
    from gs2m_tpu_torch.data import colmap as cm
    from gs2m_tpu_torch.ops.projection import project
    from gs2m_tpu_torch.ops.rasterize import (build_features,
                                              rasterize_from_projected)

    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n_points, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pts = v.astype(np.float32)
    # Albedo: two-tone bands; roughness: glossy north (y < 0, y is down),
    # rough south.
    band = (np.sin(4.0 * np.arctan2(v[:, 0], v[:, 2])) > 0)
    albedo = np.where(band[:, None], np.array([[0.7, 0.25, 0.2]]),
                      np.array([[0.2, 0.45, 0.7]])).astype(np.float64)
    rough = np.where(v[:, 1] < 0.0, 0.1, 0.5)

    g = Gaussians.create(pts, albedo.astype(np.float32), max_sh_degree=1,
                         capacity=n_points,
                         mean_sq_dist=np.full(n_points, 0.03 ** 2, np.float32),
                         device=device)
    dev = g.device
    fx = fy = 0.9 * width
    for d in ("sparse/0", "images", "masks"):
        os.makedirs(os.path.join(out_dir, d), exist_ok=True)

    # Diffuse irradiance of the analytic light (lobes blurred to power 1).
    irr = analytic_env(v, power_scale=1.0 / 8.0)
    cams = {1: cm.ColmapCamera(1, "PINHOLE", width, height,
                               np.array([fx, fy, width / 2, height / 2],
                                        np.float64))}
    imgs = {}
    cap = 2 ** 18
    for i in range(n_views):
        # Two rings (low + high) so reflections sweep the whole light.
        theta = 2 * np.pi * i / n_views
        R, T = ring_camera(theta, dist=4.0, height=0.8 if i % 2 == 0 else -1.2)
        name = f"view_{i:03d}.png"
        imgs[i + 1] = cm.ColmapImage(i + 1, cm.rotmat_to_qvec(R.T), T, 1, name)
        cam = Camera.create(R, T, fovx=2 * np.arctan(width / (2 * fx)),
                            fovy=2 * np.arctan(height / (2 * fy)),
                            width=width, height=height, device=dev)
        eye = cam.cam_center.cpu().numpy().astype(np.float64)
        w = eye[None, :] - v
        w /= np.linalg.norm(w, axis=1, keepdims=True)
        ndw = np.sum(v * w, axis=1, keepdims=True)
        r = 2.0 * ndw * v - w
        # Sharp lobes (power x4) in the glossy zone, broad (/4) in the rough.
        spec = np.where((rough < 0.3)[:, None],
                        analytic_env(r, power_scale=4.0),
                        analytic_env(r, power_scale=0.25))
        color = np.clip(albedo * irr + 0.35 * spec * np.maximum(ndw, 0.0),
                        0.0, 1.0).astype(np.float32)
        with torch.no_grad():
            opa = torch.clamp_max(g.get_opacity[:, 0] * 8.0, 0.99)
            proj = project(g, cam, 0, opa)
            proj = proj._replace(colors=torch.from_numpy(color).to(dev))
            feats = build_features(g, cam)
            while True:
                out = rasterize_from_projected(
                    proj, opa, feats, torch.ones(3, device=dev), cam,
                    feature_count=1, chunk=64, instance_cap=cap)
                if int(out.dropped) == 0 or cap >= 2 ** 24:
                    break
                cap *= 2
        img = np.clip(out.color.permute(1, 2, 0).cpu().numpy(), 0, 1)
        Image.fromarray((img * 255).astype(np.uint8)).save(
            os.path.join(out_dir, "images", name))
        alpha = np.clip(1.0 - out.final_T.cpu().numpy(), 0, 1)
        Image.fromarray((alpha * 255).astype(np.uint8)).save(
            os.path.join(out_dir, "masks", name))

    cm.write_cameras_binary(os.path.join(out_dir, "sparse/0/cameras.bin"), cams)
    cm.write_images_binary(os.path.join(out_dir, "sparse/0/images.bin"), imgs)
    rng2 = np.random.default_rng(seed + 1)
    sel = rng2.choice(n_points, size=n_points // 3, replace=False)
    noisy = pts[sel] + rng2.normal(scale=0.01, size=(len(sel), 3)).astype(np.float32)
    cm.write_points3d_binary(os.path.join(out_dir, "sparse/0/points3D.bin"),
                             noisy.astype(np.float64), (albedo[sel] * 255))
    with open(os.path.join(out_dir, "gt_material.json"), "w") as f:
        json.dump({"roughness_glossy": 0.1, "roughness_rough": 0.5,
                   "glossy_zone": "y<0", "spec_strength": 0.35}, f)
    return out_dir


def envmap_recovery(light: torch.Tensor, n_dirs: int = 4096) -> dict:
    """Luminance correlation between the learned cubemap and the analytic
    light over seeded random directions."""
    from gs2m_tpu_torch.pbr.cubemap import cube_lookup

    rng = np.random.default_rng(0)
    d = rng.normal(size=(n_dirs, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    with torch.no_grad():
        got = cube_lookup(light, torch.from_numpy(d.astype(np.float32)).to(
            light.device)).cpu().numpy().astype(np.float64)
    gl, wl = got @ LUMA, analytic_env(d) @ LUMA
    return {"luminance_corr": float(np.corrcoef(gl, wl)[0, 1]),
            "got_mean": float(gl.mean()), "want_mean": float(wl.mean()),
            "got_p95": float(np.quantile(gl, 0.95)),
            "want_p95": float(np.quantile(wl, 0.95))}


def roughness_zones(model_dir: str, iteration: int) -> dict:
    """Mean recovered roughness of the near-surface Gaussians in the glossy
    (y < 0) and the rough (y > 0) hemisphere, from the snapshot PLY."""
    from gs2m_tpu_torch.data.ply import load_gaussian_ply

    raw = load_gaussian_ply(os.path.join(
        model_dir, "point_cloud", f"iteration_{iteration}", "point_cloud.ply"))
    xyz = raw["xyz"]
    rough = 1.0 / (1.0 + np.exp(-raw["roughness"].reshape(-1)))
    on = np.abs(np.linalg.norm(xyz, axis=1) - 1.0) < 0.15
    glossy = rough[on & (xyz[:, 1] < 0.0)]
    roughz = rough[on & (xyz[:, 1] > 0.0)]
    return {"glossy_zone_mean": float(glossy.mean()),
            "rough_zone_mean": float(roughz.mean()),
            "n_glossy": int(glossy.size), "n_rough": int(roughz.size),
            "ordering_ok": bool(glossy.mean() < roughz.mean())}


def main(argv=None) -> dict:
    from gs2m_tpu_torch import resolve_device
    from gs2m_tpu_torch.apps import metrics as metrics_app
    from gs2m_tpu_torch.apps import render as render_app
    from gs2m_tpu_torch.apps import train as train_app
    from gs2m_tpu_torch.pbr.render import make_pbr_fns

    ap = argparse.ArgumentParser(description="gs2m_tpu_torch material gate")
    ap.add_argument("--out", required=True)
    ap.add_argument("--iterations", type=int, default=10_000)
    ap.add_argument("--views", type=int, default=36)
    ap.add_argument("--width", type=int, default=400)
    ap.add_argument("--height", type=int, default=300)
    ap.add_argument("--points", type=int, default=20_000)
    ap.add_argument("--chunk", type=int, default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="160x120, 12 views, 3,000 points, 600 iterations")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.smoke:
        args.width, args.height, args.views = 160, 120, 12
        args.points, args.iterations = 3_000, 600

    scene_dir = os.path.join(args.out, "scene")
    model_dir = os.path.join(args.out, "model")
    if not os.path.exists(os.path.join(scene_dir, "sparse/0/images.bin")):
        print("[>] Building glossy scene", flush=True)
        build_glossy_scene(scene_dir, n_views=args.views, width=args.width,
                           height=args.height, n_points=args.points,
                           device=device)

    dev_flags = ["--device", args.device]
    extra = []
    if args.chunk:
        extra += ["--chunk", str(args.chunk)]
    if args.smoke:
        extra += ["--nearby_cam_max_dist", "3.5"]
    its = args.iterations
    if its < 10_000:
        # The 10k protocol's stage structure, compressed: material (with
        # geometry) over the second half, opacity resets before it.
        extra += ["--geometry_from_iter", str(its // 2),
                  "--opacity_reset_interval", str(max(400, (3 * its) // 10))]
    test_iters = sorted({its // 5, its // 2, (7 * its) // 10, its})

    t0 = time.time()
    trainer = train_app.main(
        ["-s", scene_dir, "-m", model_dir, "--mask_gt", "--material", "--eval",
         "--white_background", "--masks", "masks", "-r", "1",
         "--reflection_threshold", "0.2", "--lambda_smooth", "0.5",
         "--lambda_normal", "0.5", "--iterations", str(its), *extra,
         *dev_flags, "--quiet",
         "--test_iterations", *map(str, test_iters),
         "--save_iterations", str(its),
         "--checkpoint_iterations", *map(str, test_iters)])
    train_min = (time.time() - t0) / 60.0

    render_app.main(["-m", model_dir, "--iteration", str(its), "--label",
                     "ours", *dev_flags])
    metrics = {}
    for split in ("train", "test"):
        res = metrics_app.main(["-m", model_dir, "--split", split, *dev_flags])
        if res:
            metrics[split] = res

    light_pkl = os.path.join(model_dir, "point_cloud", f"iteration_{its}",
                             "lighting.pkl")
    with open(light_pkl, "rb") as f:
        light = torch.from_numpy(np.asarray(pickle.load(f), np.float32)).to(device)
    # The light the run started from (the trainer's seeded init).
    start = make_pbr_fns(base_res=light.shape[1], device=device)["init_light"]()
    env = envmap_recovery(light)
    zones = roughness_zones(model_dir, its)

    # The loss EMA every 100 iterations and the held-out PSNRs from the
    # train log; the activity counters from the trainer (the log's last
    # record holds them only at a multiple of 100).
    final_loss = float(trainer.last_metrics["loss"])
    test_psnrs, test_psnrs_pbr, losses = [], [], [final_loss]
    with open(os.path.join(model_dir, "train_log.jsonl")) as log:
        for line in log:
            rec = json.loads(line)
            if "loss" in rec:
                losses.append(rec["loss"])
            if "test_psnr" in rec:
                test_psnrs.append((rec["iteration"], rec["test_psnr"]))
            if "test_psnr_pbr" in rec:
                test_psnrs_pbr.append((rec["iteration"], rec["test_psnr_pbr"]))

    result = {
        "scene": "glossy_sphere_analytic_env",
        "protocol": f"run_glossy ({its} iters, reflection_threshold 0.2)",
        "resolution": f"{args.width}x{args.height}",
        "views": args.views,
        "points": args.points,
        "iterations": its,
        "device": str(device),
        "train_minutes": round(train_min, 2),
        "test_psnr_trajectory": test_psnrs,
        "test_psnr_pbr_trajectory": test_psnrs_pbr,
        "metrics": metrics,
        "envmap_recovery": env,
        "roughness_zones": zones,
        "rough_active_steps": trainer.rough_active_count,
        "mv_active_steps": trainer.mv_active_count,
        "losses_finite": bool(np.isfinite(losses).all()),
        "final_loss": final_loss,
        "light": {"min": float(light.min()), "max": float(light.max()),
                  "mean_abs_change": float((light - start).abs().mean())},
        "pass": bool(zones["ordering_ok"] and env["luminance_corr"] > 0.5),
    }
    with open(os.path.join(args.out, "material_gate.json"), "w") as f:
        json.dump(result, f, indent=2)
    print("[>] material gate:", json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
