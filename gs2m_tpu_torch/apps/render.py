"""Render CLI: per-view map export from a trained snapshot.

Port of gs2m_tpu/apps/render.py's render path: the same flags, saved-config
merge with CLI override and points.json bookkeeping; every view's render,
GT, normal and depth maps are written as PNGs, with the instance cap
doubled and the view re-rendered while binning reports `dropped` > 0.
Runs on CUDA (default) or, when asked, on the CPU.

Not ported yet, and refused with NotImplementedError (ROADMAP.md, Queue A):
--extract_mesh and the --dtu/--tnt/--blender presets that set it ("Mesh
path and eval apps"), --spatial > 1 ("Parallelism"), material models
("Material stage").

Usage: python -m gs2m_tpu_torch.apps.render -m <model_dir> [-s <scene>]
"""
from __future__ import annotations

import json
import os
import sys
import time
from argparse import ArgumentParser
from pathlib import Path

import numpy as np
import torch


def render_views(model_cfg, pipe, args, gaussians, split, cameras,
                 camera_infos, gt_images, alpha_masks, iteration) -> list[dict]:
    """Render and save every view of one split; returns per-view stats."""
    from gs2m_tpu_torch.models.render import render
    from gs2m_tpu_torch.utils.images import (convert_normal_for_save,
                                             save_depth_colormap, save_image,
                                             save_rgba)

    if not cameras:
        print(f"[!] No views to render in {split} set")
        return []

    base = Path(model_cfg.model_path) / split / f"{args.label}_{iteration}"
    dirs = {k: base / k for k in ["render", "gt", "normal", "depth"]}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)

    point_file = Path(model_cfg.model_path) / "points.json"
    points = json.loads(point_file.read_text()) if point_file.exists() else {}
    points[f"{args.label}_{iteration}"] = gaussians.num_alive
    point_file.write_text(json.dumps(points, indent=4))

    device = gaussians.device
    bg = (torch.ones(3, device=device) if model_cfg.white_background
          else torch.zeros(3, device=device))
    instance_cap = max(int(8 * gaussians.capacity) // pipe.chunk * pipe.chunk,
                       4 * pipe.chunk)

    def render_one(cam):
        nonlocal instance_cap
        while True:
            pkg = render(gaussians, cam, bg, gaussians.max_sh_degree,
                         geometry_stage=True, material_stage=True,
                         sobel_normal=args.normal_sobel,
                         blend_metallic=model_cfg.metallic, tile=pipe.tile,
                         chunk=pipe.chunk, instance_cap=instance_cap)
            if int(pkg["dropped"]) == 0 or instance_cap >= 2 ** 26:
                return pkg
            instance_cap *= 2

    stats = []
    for i, (cam, info) in enumerate(zip(cameras, camera_infos)):
        t0 = time.perf_counter()
        pkg = render_one(cam)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        render_s = time.perf_counter() - t0
        stem = info.image_name.rsplit(".", 1)[0]
        host = {k: pkg[k].cpu().numpy()
                for k in ("render", "normal_map", "depth_map")
                + (("sobel_map",) if args.normal_sobel else ())}

        gt = np.clip(gt_images[i], 0, 1)
        if model_cfg.white_background and alpha_masks is not None:
            gt = np.where(alpha_masks[i] > 0.5, gt,
                          bg.cpu().numpy()[:, None, None])
        save_image(dirs["gt"] / f"{stem}.png", gt)

        nmap = host["sobel_map"] if args.normal_sobel else host["normal_map"]
        normal_img = convert_normal_for_save(nmap, cam, args.normal_world)
        if model_cfg.white_background and alpha_masks is not None:
            save_rgba(dirs["normal"] / f"{stem}.png", normal_img, alpha_masks[i])
        else:
            save_image(dirs["normal"] / f"{stem}.png", normal_img)
        save_depth_colormap(dirs["depth"] / f"{stem}.png", host["depth_map"][0])
        save_image(dirs["render"] / f"{stem}.png", np.clip(host["render"], 0, 1))
        stats.append({"view": stem, "render_s": render_s,
                      "export_s": time.perf_counter() - t0 - render_s,
                      "instance_cap": instance_cap,
                      "dropped": int(pkg["dropped"]),
                      "num_instances": int(pkg["num_instances"]),
                      "finite": all(bool(np.isfinite(h).all())
                                    for h in host.values())})
    return stats


def main(argv=None) -> list[dict]:
    """Returns the per-view stats of every rendered split."""
    from gs2m_tpu_torch import resolve_device
    from gs2m_tpu_torch.core.config import (ModelConfig, PipelineConfig,
                                            add_group_args, combine_args)

    parser = ArgumentParser(description="gs2m_tpu_torch rendering")
    add_group_args(parser, ModelConfig, fill_none=True)
    add_group_args(parser, PipelineConfig, fill_none=True)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--label", default="ours", type=str)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--extract_mesh", action="store_true")
    parser.add_argument("--max_depth", default=-1.0, type=float)
    parser.add_argument("--voxel_size", default=-1.0, type=float)
    parser.add_argument("--sdf_trunc", default=-1.0, type=float)
    parser.add_argument("--num_clusters", default=1, type=int)
    parser.add_argument("--filter_depth", action="store_true")
    parser.add_argument("--dtu", action="store_true")
    parser.add_argument("--tnt", action="store_true")
    parser.add_argument("--blender", action="store_true")
    parser.add_argument("--normal_world", action="store_true")
    parser.add_argument("--normal_sobel", action="store_true")
    parser.add_argument("--spatial", type=int, default=0)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args, model_cfg, pipe, _ = combine_args(parser, argv)

    if args.extract_mesh or args.dtu or args.tnt or args.blender:
        raise NotImplementedError(
            "mesh extraction (--extract_mesh, --dtu, --tnt, --blender) is not "
            "ported yet: ROADMAP.md Queue A, 'Mesh path and eval apps'")
    if args.spatial > 1:
        raise NotImplementedError(
            "--spatial > 1 is not ported yet: ROADMAP.md Queue A, "
            "'Parallelism'")
    if model_cfg.material:
        raise NotImplementedError(
            "material models are not ported yet: ROADMAP.md Queue A, "
            "'Material stage'")
    device = resolve_device(args.device)

    from gs2m_tpu_torch.core.gaussians import Gaussians
    from gs2m_tpu_torch.data.ply import load_gaussian_ply
    from gs2m_tpu_torch.data.readers import load_view_arrays
    from gs2m_tpu_torch.data.scene import Scene, search_max_iteration

    iteration = args.iteration
    if iteration == -1:
        iteration = search_max_iteration(
            os.path.join(model_cfg.model_path, "point_cloud"))
    load_dir = Path(model_cfg.model_path) / "point_cloud" / f"iteration_{iteration}"
    print(f"[>] Loading snapshot at iteration {iteration}")
    raw = load_gaussian_ply(str(load_dir / "point_cloud.ply"))
    gaussians = Gaussians.from_raw(raw, model_cfg.sh_degree, device=device)

    scene = Scene(model_cfg, shuffle=False, load_images=False, device=device)

    def view_arrays(infos, cams):
        rgbs, alphas = [], []
        for ci, cam in zip(infos, cams):
            rgb, alpha = load_view_arrays(ci, (cam.width, cam.height),
                                          model_cfg.mask_gt)
            rgbs.append(rgb)
            alphas.append(alpha if alpha is not None else np.ones_like(rgb[:1]))
        return np.stack(rgbs), np.stack(alphas)

    stats = []
    if not args.skip_train:
        gt, am = view_arrays(scene.train_camera_infos, scene.train_cameras)
        stats += render_views(model_cfg, pipe, args, gaussians, "train",
                              scene.train_cameras, scene.train_camera_infos,
                              gt, am, iteration)
    if not args.skip_test and scene.test_cameras:
        gt, am = view_arrays(scene.test_camera_infos, scene.test_cameras)
        stats += render_views(model_cfg, pipe, args, gaussians, "test",
                              scene.test_cameras, scene.test_camera_infos,
                              gt, am, iteration)
    return stats


if __name__ == "__main__":
    main(sys.argv[1:])
