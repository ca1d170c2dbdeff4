"""On-card smoke test of the PyTorch + CUDA port (gs2m_tpu_torch).

Builds every kernel from csrc/, makes a synthetic full-width scene from a
seed (500k Gaussians in the slab layout of bench.py, SH degree 3, four
1600x1200 views, COLMAP sparse/0, a point_cloud snapshot and cfg_args.json,
all written with the port's own writers), then:

  kernel phase  K1 (csrc/blend_fwd.cu) against its plain PyTorch version on
                view 0's real binning, with the stated tolerances, timed by
                CUDA events, beside its bound
  path phase    the render app, gs2m_tpu_torch.apps.render.main, over all
                views; launch counts are zeroed just before and read just
                after, and every kernel of the path must have launched

Prints the card's name and power limit, then one JSON line of kernel
records, and as the last line {"ok": true, "device": {...}}. Any failed
phase exits nonzero. Needs one CUDA card:

    python3 chip_smoke.py [--seed 0]
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
# H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# The render-full cell: DTU's native resolution and bench.py's 500k slab.
GAUSSIANS, WIDTH, HEIGHT, VIEWS = 500_000, 1600, 1200, 4


def fail(msg: str):
    print(f"[smoke] FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def look_at(eye: np.ndarray, target: np.ndarray):
    """COLMAP convention (y down, z forward): -> (c2w rotation, w2c T)."""
    fwd = target - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R_c2w = np.stack([right, down, fwd], axis=1)
    return R_c2w, -R_c2w.T @ eye


def build_scene(root: Path, n: int, width: int, height: int, views: int,
                seed: int):
    """Slab of n Gaussians filling the frustum (bench.py's layout: uniform
    centers, isotropic scales from mean_sq_dist 2e-5, random rotations,
    opacity logit 0.8) with random SH bands; views around the bench camera.
    Returns (scene_dir, model_dir)."""
    from PIL import Image

    from gs2m_tpu_torch.core.camera import fov2focal
    from gs2m_tpu_torch.core.config import (ModelConfig, OptimConfig,
                                            PipelineConfig, save_cfg_args)
    from gs2m_tpu_torch.core.sh import rgb_to_sh_dc
    from gs2m_tpu_torch.data import colmap as cm
    from gs2m_tpu_torch.data.ply import save_gaussian_ply

    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-1.6, 1.6, n), rng.uniform(-1.2, 1.2, n),
                    rng.uniform(-1.0, 1.0, n)], -1).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    f_rest = (0.05 * rng.normal(size=(n, 15, 3))).astype(np.float32)
    scaling = np.full((n, 3), np.log(np.sqrt(2.0e-5)), np.float32)
    rotation = rng.normal(size=(n, 4)).astype(np.float32)

    scene, model = root / "scene", root / "model"
    snap = model / "point_cloud" / "iteration_1"
    for d in (scene / "sparse" / "0", scene / "images", snap):
        d.mkdir(parents=True)
    save_gaussian_ply(str(snap / "point_cloud.ply"), pts,
                      rgb_to_sh_dc(cols)[:, None, :], f_rest,
                      np.full((n, 1), 0.8, np.float32), scaling, rotation,
                      np.ones((n, 3), np.float32), np.ones((n, 1), np.float32),
                      np.ones((n, 1), np.float32))

    fovx, fovy = 0.8, 0.62
    fx, fy = fov2focal(fovx, width), fov2focal(fovy, height)
    cams = {1: cm.ColmapCamera(1, "PINHOLE", width, height,
                               np.array([fx, fy, width / 2, height / 2]))}
    imgs = {}
    gray = np.full((height, width, 3), 128, np.uint8)
    for i in range(views):
        # View 0 is bench.py's camera (eye at z = -4 looking down +z); the
        # others orbit it by a few degrees.
        yaw, pitch = 0.12 * np.sin(1.7 * i), 0.08 * np.sin(2.3 * i)
        eye = 4.0 * np.array([np.sin(yaw) * np.cos(pitch), np.sin(pitch),
                              -np.cos(yaw) * np.cos(pitch)])
        R, T = look_at(eye, np.zeros(3))
        name = f"view_{i:03d}.png"
        imgs[i + 1] = cm.ColmapImage(i + 1, cm.rotmat_to_qvec(R.T), T, 1, name)
        Image.fromarray(gray).save(scene / "images" / name)
    cm.write_cameras_binary(str(scene / "sparse/0/cameras.bin"), cams)
    cm.write_images_binary(str(scene / "sparse/0/images.bin"), imgs)
    sel = rng.choice(n, 1000, replace=False)
    cm.write_points3d_binary(str(scene / "sparse/0/points3D.bin"),
                             pts[sel].astype(np.float64), cols[sel] * 255)
    save_cfg_args(str(model), ModelConfig(source_path=str(scene),
                                          model_path=str(model), resolution=1),
                  PipelineConfig(), OptimConfig())
    return scene, model


def time_ms(fn, runs: int) -> float:
    """Median CUDA-event time of `runs` calls (after one warm-up call)."""
    import torch

    fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def k1_work(geom, raw, chunk_tile, *, T, grid_x, width, height, chunk):
    """This run's work for K1's bound: bytes every live chunk must move and
    its (instance, pixel) pairs before termination / contributing."""
    import torch

    from gs2m_tpu_torch.ops.blend import ALPHA_MIN, LOG_EPS, pixel_coords

    V = raw.img.shape[1]
    P = raw.clogT.shape[-1]
    n_chunks = chunk_tile.shape[0]
    live = (chunk_tile < T) & ~torch.all(raw.cdone[:, 0] > 0, dim=1)
    live_idx = torch.nonzero(live)[:, 0]
    g = geom.reshape(8, n_chunks, chunk)
    pairs = contrib = 0
    for c in torch.split(live_idx, 512):
        px, py = pixel_coords(chunk_tile[c].long(), 16, grid_x)
        gc = g[:, c].permute(1, 2, 0)[..., None]
        dx = gc[:, :, 0] - px[:, None]
        dy = gc[:, :, 1] - py[:, None]
        pw = -0.5 * (gc[:, :, 2] * dx * dx + gc[:, :, 4] * dy * dy) - gc[:, :, 3] * dx * dy
        alpha = torch.clamp_max(gc[:, :, 5] * torch.exp(torch.clamp_max(pw, 0.0)), 0.99)
        inside = ((px < width) & (py < height))[:, None]
        alpha = torch.where((pw <= 0) & (alpha >= ALPHA_MIN) & inside, alpha, 0.0)
        test = raw.clogT[c] + torch.cumsum(torch.log1p(-alpha), dim=1)
        dn = (raw.cdone[c] > 0) | (test < LOG_EPS)
        pairs += int((~dn & inside).sum())
        contrib += int(((alpha > 0) & ~dn).sum())
    n_live = int(live.sum())
    bytes_ = (n_live * chunk * (6 + V) * 4          # geometry + values read
              + n_chunks * 4                         # chunk_tile
              + (T + 1) * (V + 1) * P * 4           # img, fT
              + n_chunks * (2 * P + chunk) * 4)     # carries, obs
    flops = 20 * pairs + 2 * V * contrib
    return bytes_, flops, pairs, contrib, n_live


def kernel_phase(g, cam, chunk: int, cap: int) -> dict:
    import torch

    from gs2m_tpu_torch.ops.binning import bin_gaussians, num_tiles
    from gs2m_tpu_torch.ops.blend import (LAUNCHES, blend_fwd,
                                          blend_fwd_plain, gather_instances)
    from gs2m_tpu_torch.ops.projection import project
    from gs2m_tpu_torch.ops.rasterize import build_features, pack_values

    H, W = cam.height, cam.width
    grid_y, grid_x = num_tiles(H, W, 16)
    T = grid_y * grid_x
    op = g.get_opacity[:, 0]
    proj = project(g, cam, g.max_sh_degree, op)
    binning = bin_gaussians(proj, H, W, 16, cap, chunk, op)
    if int(binning.dropped) != 0:
        fail(f"kernel phase binning dropped {int(binning.dropped)}")
    values = pack_values(proj.colors, build_features(g, cam), 9)
    geom, vals = gather_instances(values, proj.means2d, proj.conics, op,
                                  binning.gid, binning.is_null)
    kw = dict(T=T, grid_x=grid_x, width=W, height=H, tile=16, chunk=chunk)
    n0 = LAUNCHES["blend_fwd"]
    ker = blend_fwd(geom, vals, binning.chunk_tile, **kw)
    torch.cuda.synchronize()
    if LAUNCHES["blend_fwd"] != n0 + 1:
        fail("blend_fwd did not launch its kernel on a CUDA tensor")
    ref = blend_fwd_plain(geom, vals, binning.chunk_tile, **kw)
    torch.cuda.synchronize()

    report = {"V": vals.shape[0], "instances": int(binning.num_instances),
              "aligned": int(binning.num_aligned), "n_chunks": cap // chunk}
    max_err = 0.0
    for name in ("img", "fT", "clogT"):
        a, b = getattr(ker, name), getattr(ref, name)
        if not bool(torch.isfinite(a).all()):
            fail(f"K1 {name} is not finite")
        d = (a - b).abs()
        err, frac = float(d.max()), float((d > 1e-5).float().mean())
        limit = 1e-3 * (1.0 + float(b.abs().max()))
        report[f"{name}_max_abs_err"] = err
        report[f"{name}_frac_over_1e-5"] = frac
        if name != "clogT":
            max_err = max(max_err, err)
        if frac > 1e-4 or err > limit:
            fail(f"K1 {name}: max |diff| {err:.3g} (limit {limit:.3g}), "
                 f"{frac:.3g} of entries over 1e-5 (limit 1e-4)")
    for name in ("cdone", "obs"):
        eq = float((getattr(ker, name) == getattr(ref, name)).float().mean())
        report[f"{name}_equal_frac"] = eq
        if eq < 0.9999:
            fail(f"K1 {name}: only {eq:.6f} of entries equal (need 0.9999)")

    ms = time_ms(lambda: blend_fwd(geom, vals, binning.chunk_tile, **kw), 20)
    plain_ms = time_ms(lambda: blend_fwd_plain(geom, vals, binning.chunk_tile,
                                               **kw), 3)
    bytes_, flops, pairs, contrib, n_live = k1_work(
        geom, ker, binning.chunk_tile, T=T, grid_x=grid_x, width=W, height=H,
        chunk=chunk)
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    report.update(ms=ms, plain_ms=plain_ms, bytes=bytes_, flops=flops,
                  live_pairs=pairs, contributing_pairs=contrib,
                  live_chunks=n_live, bound_bytes_ms=t_bytes,
                  bound_ops_ms=t_ops, bound_ms=max(t_bytes, t_ops),
                  bound_by="bytes" if t_bytes >= t_ops else "operations",
                  max_abs_err=max_err)
    return report


def profile_render(fn, wall_ms: float) -> None:
    """Where one render's time goes: device time by kernel (torch.profiler
    over one warm call), and the device's idle share against `wall_ms`, the
    unprofiled CUDA-event time of the same call (the profiler's own overhead
    stretches its wall, so its idle share is printed only beside it)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.self_device_time_total / 1e3, e.count, e.key[:70])
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    print(f"[smoke] render profile: device busy {busy_ms:.2f} ms; idle share "
          f"{1 - busy_ms / wall_ms:.3f} of the unprofiled {wall_ms:.2f} ms "
          f"(under the profiler: wall {prof_wall_ms:.2f} ms, idle share "
          f"{1 - busy_ms / prof_wall_ms:.3f})")
    for ms, n, name in rows[:15]:
        print(f"[smoke]   {ms:8.3f} ms {n:4d}x  {name}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a card")
    from PIL import Image

    from gs2m_tpu_torch import _build
    from gs2m_tpu_torch.apps import render as render_app
    from gs2m_tpu_torch.core.config import load_cfg_args
    from gs2m_tpu_torch.core.gaussians import Gaussians
    from gs2m_tpu_torch.data.ply import load_gaussian_ply
    from gs2m_tpu_torch.data.scene import Scene
    from gs2m_tpu_torch.models.render import render
    from gs2m_tpu_torch.ops import blend

    # --- phase 1: card and build ---------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"[smoke] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    libs = _build.build()
    print(f"[smoke] built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")

    # --- phase 2: scene -------------------------------------------------------
    root = HERE / "build" / "smoke"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    scene_dir, model_dir = build_scene(root, GAUSSIANS, WIDTH, HEIGHT, VIEWS,
                                       args.seed)
    print(f"[smoke] scene: {GAUSSIANS} Gaussians, {VIEWS} views at "
          f"{WIDTH}x{HEIGHT} in {time.perf_counter() - t0:.1f} s")

    # --- phase 3: kernels against their plain versions -------------------------
    dev = torch.device("cuda")
    model_cfg, pipe, _ = load_cfg_args(str(model_dir))
    g = Gaussians.from_raw(load_gaussian_ply(
        str(model_dir / "point_cloud/iteration_1/point_cloud.ply")),
        model_cfg.sh_degree, device=dev)
    cam = Scene(model_cfg, shuffle=False, device=dev).train_cameras[0]
    cap = max(8 * g.capacity // pipe.chunk * pipe.chunk, 4 * pipe.chunk)
    k1 = kernel_phase(g, cam, pipe.chunk, cap)
    print(f"[smoke] K1 blend_fwd: {json.dumps(k1)}")

    # --- phase 4: the render app, the slice's main path --------------------------
    for k in blend.LAUNCHES:
        blend.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    stats = render_app.main(["-m", str(model_dir), "-s", str(scene_dir)])
    wall = time.perf_counter() - t0
    launches = dict(blend.LAUNCHES)
    if len(stats) != VIEWS:
        fail(f"render app rendered {len(stats)} views, expected {VIEWS}")
    regrowths = int(np.log2(stats[-1]["instance_cap"] / cap))
    for s in stats:
        if s["dropped"] != 0 or not s["finite"]:
            fail(f"view {s['view']}: dropped {s['dropped']}, finite {s['finite']}")
    if launches["blend_fwd"] != VIEWS + regrowths:
        fail(f"blend_fwd launched {launches['blend_fwd']} times on the path, "
             f"expected {VIEWS} views + {regrowths} regrowths")
    for kind in ("render", "gt", "normal", "depth"):
        files = sorted((model_dir / "train" / "ours_1" / kind).iterdir())
        if len(files) != VIEWS:
            fail(f"{kind}: {len(files)} files, expected {VIEWS}")
        for f in files:
            if Image.open(f).size != (WIDTH, HEIGHT):
                fail(f"{f.name} has size {Image.open(f).size}")
    print(f"[smoke] render app: {wall:.2f} s for {VIEWS} views "
          f"({wall / VIEWS * 1e3:.1f} ms/view with PNG export); "
          f"render ms/view {[round(s['render_s'] * 1e3, 2) for s in stats]}; "
          f"export ms/view {[round(s['export_s'] * 1e3, 1) for s in stats]}; "
          f"instances/view {[s['num_instances'] for s in stats]}; launches {launches}")

    def render_view0():
        return render(g, cam, torch.zeros(3, device=dev), 3,
                      geometry_stage=True, material_stage=True,
                      chunk=pipe.chunk, instance_cap=stats[-1]["instance_cap"])

    render_ms = time_ms(render_view0, 5)
    print(f"[smoke] render() view 0, device path: {render_ms:.2f} ms "
          f"(median of 5, CUDA events) on {card}")
    profile_render(render_view0, render_ms)

    record = {"name": "blend_fwd", "route": "cuda",
              "source": "gs2m_tpu_torch/csrc/blend_fwd.cu",
              "replaces": "gs2m_tpu/ops/blend_pallas.py:125",
              "launches": launches["blend_fwd"],
              "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
              "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
              "bound_by": k1["bound_by"], "library_ms": None}
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
