"""Render + mesh-extraction CLI.

Port of gs2m_tpu/apps/render.py: the same flags, saved-config merge with
CLI override and points.json bookkeeping; every view's render, GT, normal
and depth maps are written as PNGs, with the instance cap doubled and the
view re-rendered while binning reports `dropped` > 0. --extract_mesh fuses
the views' depths (zeroed by --filter_depth's grazing-angle test) and the
colors read back from the saved render PNGs into a block-sparse TSDF,
extracts the mesh (tsdf_mesh.ply) and keeps its --num_clusters largest
clusters (tsdf_post.ply); --dtu, --tnt and --blender set the datasets'
presets (TnT bounds from transforms.json's aabb_range). A material model
(its snapshot's lighting.pkl, the JAX package's format too) renders its
PBR image as the render, writes the albedo / roughness / metallic /
diffuse / specular maps beside it and the light as envmap.png. Runs on
CUDA (default) or, when asked, on the CPU. --spatial N renders each view
in N horizontal bands (parallel/sp.py) over every local card (in turn on
one card; on the CPU under --device cpu), at a per-band instance cap of
the full frame's / N, regrown on overflow; the derived maps come from the
gathered bands.

Usage: python -m gs2m_tpu_torch.apps.render -m <model_dir> [--dtu|--tnt|--blender]
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


def extract_mesh(args, scene_extent: float, mesh_dir: Path, cameras,
                 camera_infos, render_dir: Path, fusion_depths, alpha_masks,
                 bounds=None) -> dict:
    """TSDF-fuse the views, extract and clean the mesh, write both PLYs;
    returns the volume and mesh sizes and the ms of each stage (CUDA events
    for the device stages on a card, the host clock for the rest)."""
    from PIL import Image

    from gs2m_tpu_torch.data.ply import store_mesh
    from gs2m_tpu_torch.mesh import (fuse_depths, keep_largest_clusters,
                                     marching_tetrahedra_blocks)
    from gs2m_tpu_torch.mesh.tsdf import BLOCK_EDGE, stage_timer

    os.makedirs(mesh_dir, exist_ok=True)
    max_depth = args.max_depth if args.max_depth > 0 else 2.0 * scene_extent
    voxel_size = args.voxel_size if args.voxel_size > 0 else max_depth / 1024.0
    sdf_trunc = args.sdf_trunc if args.sdf_trunc > 0 else 4.0 * voxel_size
    (mesh_dir / "config.json").write_text(json.dumps(
        {"max_depth": max_depth, "voxel_size": voxel_size,
         "sdf_trunc": sdf_trunc}, indent=4))

    colors = np.zeros((len(cameras), 3, cameras[0].height, cameras[0].width),
                      np.float32)
    for i, info in enumerate(camera_infos):
        p = render_dir / (info.image_name.rsplit(".", 1)[0] + ".png")
        img = np.asarray(Image.open(p), np.float32)[..., :3] / 255.0
        colors[i] = img.transpose(2, 0, 1)

    print("[>] TSDF fusion...")
    stages: dict[str, float] = {}
    host = torch.device("cpu")
    vol = fuse_depths(torch.stack(fusion_depths), colors, cameras,
                      voxel_size, sdf_trunc, max_depth,
                      alpha_masks=alpha_masks if bounds is None else None,
                      bounds=bounds, stages=stages)
    n_blocks = vol.block_coords.shape[0]
    print(f"[>] Extracting mesh from {n_blocks} blocks...")
    mesh = marching_tetrahedra_blocks(vol, stages=stages)
    del vol
    with stage_timer(stages, "to_host", host):
        v, f, c = (x.cpu().numpy() for x in mesh)
    del mesh
    with stage_timer(stages, "ply_write", host):
        store_mesh(str(mesh_dir / "tsdf_mesh.ply"), v, f, c)
    print(f"[>] Raw mesh: {len(v)} vertices, {len(f)} faces")
    with stage_timer(stages, "cluster", host):
        v2, f2, c2 = keep_largest_clusters(v, f, c, args.num_clusters)
    with stage_timer(stages, "ply_write", host):
        store_mesh(str(mesh_dir / "tsdf_post.ply"), v2, f2, c2)
    print(f"[>] Post-processed mesh: {len(v2)} vertices -> "
          f"{mesh_dir / 'tsdf_post.ply'}")
    return {"blocks": n_blocks, "voxels": n_blocks * BLOCK_EDGE ** 3,
            "raw_vertices": len(v), "raw_faces": len(f),
            "vertices": len(v2), "faces": len(f2),
            "finite": bool(np.isfinite(v2).all() and np.isfinite(c2).all()),
            "stage_ms": stages}


def render_views(model_cfg, pipe, args, scene_extent, gaussians, split,
                 cameras, camera_infos, gt_images, alpha_masks, iteration,
                 bounds=None, light_state=None
                 ) -> tuple[list[dict], dict | None]:
    """Render and save every view of one split, then (--extract_mesh) its
    mesh; returns the per-view stats and extract_mesh's record or None.
    With a material model (`light_state`, the (6, R, R, 3) light) the
    render is the PBR pass's, and the material maps are written too."""
    from gs2m_tpu_torch.models.render import (derive_render_pkg,
                                              feature_count_for, render)
    from gs2m_tpu_torch.utils.images import (convert_normal_for_save,
                                             save_depth_colormap, save_image,
                                             save_rgba)

    if not cameras:
        print(f"[!] No views to render in {split} set")
        return [], None

    base = Path(model_cfg.model_path) / split / f"{args.label}_{iteration}"
    dirs = {k: base / k for k in ["render", "gt", "normal", "depth"]}
    if model_cfg.material:
        dirs.update({k: base / k for k in
                     ["albedo", "roughness", "metallic", "diffuse", "specular"]})
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
    need_sobel = args.filter_depth or args.normal_sobel
    mips = None
    if model_cfg.material:
        from gs2m_tpu_torch.pbr import cubemap as cmod
        from gs2m_tpu_torch.pbr import shade as smod
        brdf_lut = smod.get_brdf_lut(device)
        with torch.no_grad():
            envmap = cmod.cubemap_to_latlong(light_state, (256, 512))
            # The light is prefiltered once for every view.
            mips = cmod.build_mips(light_state)
        save_image(base / "envmap.png",
                   np.clip(envmap.cpu().numpy(), 0, 1).transpose(2, 0, 1))

    spatial = max(int(args.spatial or 0), 0)
    if spatial > 1:
        from gs2m_tpu_torch.parallel.sp import make_sp_render
        sp_devices = ([torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
                      if device.type == "cuda" else [device])
        instance_cap = max(instance_cap // spatial // pipe.chunk * pipe.chunk,
                           4 * pipe.chunk)

    def render_one(cam):
        nonlocal instance_cap
        while spatial > 1:
            out = make_sp_render(
                sp_devices, spatial, cam.height,
                feature_count=feature_count_for(True, True,
                                                model_cfg.metallic),
                active_sh_degree=gaussians.max_sh_degree, tile=pipe.tile,
                chunk=pipe.chunk, instance_cap_per_band=instance_cap)(
                gaussians, cam, bg)
            if int(out.dropped) == 0 or instance_cap >= 2 ** 26:
                return derive_render_pkg(out, cam, bg,
                                         sobel_normal=need_sobel)
            instance_cap *= 2
        while True:
            pkg = render(gaussians, cam, bg, gaussians.max_sh_degree,
                         geometry_stage=True, material_stage=True,
                         sobel_normal=need_sobel,
                         blend_metallic=model_cfg.metallic, tile=pipe.tile,
                         chunk=pipe.chunk, instance_cap=instance_cap)
            if int(pkg["dropped"]) == 0 or instance_cap >= 2 ** 26:
                return pkg
            instance_cap *= 2

    stats, fusion_depths = [], []
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
        if args.extract_mesh:
            tsdf_depth = pkg["depth_map"][0]
            if args.filter_depth:
                # Grazing-angle filter as in the JAX package: arccos(|cos|)
                # never exceeds pi/2, so the 100 degree threshold removes
                # no depth; kept as it is there.
                rays = cam.get_rays()
                rays = rays / torch.linalg.norm(rays, dim=-1, keepdim=True)
                sm = pkg["sobel_map"].permute(1, 2, 0)
                sm = sm / (torch.linalg.norm(sm, dim=-1, keepdim=True) + 1e-12)
                ang = torch.arccos(torch.abs(torch.sum(rays * sm, -1)))
                tsdf_depth = torch.where(ang > 100.0 / 180.0 * np.pi, 0.0,
                                         tsdf_depth)
            fusion_depths.append(tsdf_depth)
        if not model_cfg.material:
            save_image(dirs["render"] / f"{stem}.png",
                       np.clip(host["render"], 0, 1))
        else:
            save_material_maps(model_cfg, dirs, stem, cam, pkg, light_state,
                               brdf_lut, mips, bg, alpha_masks, i)
        stats.append({"view": stem, "render_s": render_s,
                      "export_s": time.perf_counter() - t0 - render_s,
                      "instance_cap": instance_cap,
                      "dropped": int(pkg["dropped"]),
                      "num_instances": int(pkg["num_instances"]),
                      "finite": all(bool(np.isfinite(h).all())
                                    for h in host.values())})
    mesh = None
    if args.extract_mesh:
        mesh = extract_mesh(args, scene_extent, base / "mesh", cameras,
                            camera_infos, dirs["render"], fusion_depths,
                            alpha_masks, bounds)
    return stats, mesh


@torch.no_grad()
def save_material_maps(model_cfg, dirs, stem, cam, pkg, light_state,
                       brdf_lut, mips, bg, alpha_masks, i: int) -> None:
    """The PBR render of one view (its surface mask, or the GT mask with
    --mask_gt / a white background, filled with 0 or the background) and
    the albedo / roughness / metallic maps and the diffuse / specular shade
    composites (sRGB with --gamma)."""
    from gs2m_tpu_torch.pbr import linear_to_srgb
    from gs2m_tpu_torch.pbr.render import pbr_render
    from gs2m_tpu_torch.utils.images import save_image

    ppkg = pbr_render(light_state, cam, pkg, brdf_lut,
                      metallic_trained=model_cfg.metallic,
                      gamma=model_cfg.gamma, mips=mips)
    pbr_img = np.clip(ppkg["render_rgb"].cpu().numpy(), 0, 1).transpose(2, 0, 1)
    bg_np = bg.cpu().numpy()[:, None, None]
    masked = model_cfg.mask_gt or model_cfg.white_background
    if masked and alpha_masks is not None:
        mask = alpha_masks[i] > 0.5
    else:
        mask = pkg["normal_mask"].cpu().numpy()
    save_image(dirs["render"] / f"{stem}.png", np.where(mask, pbr_img, bg_np))

    def comp(x):
        if model_cfg.gamma:
            x = linear_to_srgb(x)
        return np.clip(x.cpu().numpy(), 0, 1).transpose(2, 0, 1)

    save_image(dirs["albedo"] / f"{stem}.png",
               np.clip(pkg["albedo_map"].cpu().numpy(), 0, 1))
    save_image(dirs["roughness"] / f"{stem}.png",
               ppkg["roughness_map"].cpu().numpy())
    save_image(dirs["metallic"] / f"{stem}.png",
               ppkg["metallic_map"].cpu().numpy())
    save_image(dirs["diffuse"] / f"{stem}.png", comp(ppkg["diffuse_rgb"]))
    save_image(dirs["specular"] / f"{stem}.png", comp(ppkg["specular_rgb"]))


def main(argv=None) -> dict:
    """-> {"views": per-view stats of every rendered split, "meshes":
    {split: extract_mesh's record}}."""
    from gs2m_tpu_torch import resolve_device
    from gs2m_tpu_torch.core.config import (ModelConfig, PipelineConfig,
                                            add_group_args, combine_args)

    parser = ArgumentParser(description="gs2m_tpu_torch rendering + mesh "
                                        "extraction")
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

    bounds = None
    if args.dtu:
        args.max_depth, args.voxel_size = 5.0, 0.002
        args.sdf_trunc = 4.0 * args.voxel_size
        args.num_clusters, args.filter_depth = 1, False
        args.extract_mesh, args.skip_test = True, True
        args.normal_world = False
    if args.tnt:
        tnt_360 = ["barn", "caterpillar", "ignatius", "truck"]
        scene_name = Path(model_cfg.model_path).name.lower()
        args.max_depth = 3.0 if scene_name in tnt_360 else 4.5
        args.num_clusters, args.filter_depth = 1, True
        args.extract_mesh, args.skip_test = True, True
        args.normal_world = False
        voxel_size = 0.002
        tf = Path(model_cfg.source_path) / "transforms.json"
        if tf.exists():
            transforms = json.loads(tf.read_text())
            if "aabb_range" in transforms:
                bounds = np.array(transforms["aabb_range"])
                voxel_size = float(np.max(bounds[:, 1] - bounds[:, 0]) / 2048)
        args.voxel_size = voxel_size
        args.sdf_trunc = 4.0 * voxel_size
    if args.blender:
        args.skip_train, args.skip_test = True, False
        args.normal_world, args.extract_mesh = True, True
        args.max_depth, args.voxel_size = 8.0, 0.004
        args.sdf_trunc = 4.0 * args.voxel_size
        args.num_clusters = 1
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
    light_state = None
    if model_cfg.material:
        import pickle
        with open(load_dir / "lighting.pkl", "rb") as f:
            light_state = torch.as_tensor(np.asarray(pickle.load(f),
                                                     np.float32)).to(device)

    scene = Scene(model_cfg, shuffle=False, load_images=False, device=device)

    def view_arrays(infos, cams):
        rgbs, alphas = [], []
        for ci, cam in zip(infos, cams):
            rgb, alpha = load_view_arrays(ci, (cam.width, cam.height),
                                          model_cfg.mask_gt)
            rgbs.append(rgb)
            alphas.append(alpha if alpha is not None else np.ones_like(rgb[:1]))
        return np.stack(rgbs), np.stack(alphas)

    splits = []
    if not args.skip_train:
        splits.append(("train", scene.train_camera_infos, scene.train_cameras,
                       bounds))
    if not args.skip_test and scene.test_cameras:
        splits.append(("test", scene.test_camera_infos, scene.test_cameras,
                       None))
    out = {"views": [], "meshes": {}}
    for split, infos, cams, split_bounds in splits:
        gt, am = view_arrays(infos, cams)
        stats, mesh = render_views(model_cfg, pipe, args,
                                   scene.cameras_extent, gaussians, split,
                                   cams, infos, gt, am, iteration,
                                   split_bounds, light_state)
        out["views"] += stats
        if mesh is not None:
            out["meshes"][split] = mesh
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
