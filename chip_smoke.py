"""On-card smoke test of the PyTorch + CUDA port (gs2m_tpu_torch).

Builds every kernel from csrc/ (one nvcc per source, all at once), makes two
synthetic full-width scenes from a seed with the port's own writers, and:

  adam          csrc/adam.cu against the eager loop (train/optim.py::
                adam_update_plain) on the same card tensors, nine groups of
                2^19 and of 2^22 rows at SH degree 3 (dead rows, a group
                without a gradient, -0.0 moments, an unaligned gradient): p,
                m and v bit-equal after 3 steps, one launch a step; each
                timed by CUDA events beside its bytes bound (28 B an
                element). Every training path below also runs under an
                AdamTap, which keeps the path's last update of each set of
                groups (the material cell's light too) and holds the
                kernel's result to the loop's on clones of its inputs; the
                runner cells, whose apps run in subprocesses, hold it on
                their snapshot's parameters (adam_model)
  instance_sum  csrc/instance_sum.cu (the backward's per-Gaussian reduce
                pair) against segment_sum's chain (ops/blend.py::
                instance_sum_plain) at the dtu-wo-brdf and tnt-wo-brdf
                cells' layouts (the benchmark's state and view 0 at the
                cell's cap, K2's rows on a seeded cotangent): sums bit-equal,
                a rerun bit-equal, one launch of each kernel; both timed
                beside the pair's bytes bound. Every K2 phase below holds
                the pair the same way on its own rows (its record:
                "instance_sum")
  render scene  500k Gaussians in the slab layout of bench.py, SH degree 3,
                four 1600x1200 views, COLMAP sparse/0, a point_cloud snapshot
  kernel phase  on view 0's real binning (V=16): K1 (csrc/blend_fwd.cu), K2
                (csrc/blend_bwd.cu, seeded cotangent) and K3
                (csrc/blend_obs.cu) against their plain PyTorch versions with
                the stated tolerances, K2's per-Gaussian grads at the
                check_grads gate and bit-equal across two runs; each timed by
                CUDA events beside its bound from the run's data; the
                kernels' launch resources (registers, spills, shared bytes,
                blocks per SM), the shares of (instance, warp) steps the
                cull skips, of K2's per-instance sums it skips and of K3's
                steps and chunks its retirement skips, live chunks per tile,
                and pass 1's share of K2 (a timing probe: csrc/blend_bwd.cu
                built with GS2M_BWD_PASS1_ONLY); then the render's
                per-Gaussian preprocess pair (csrc/preprocess.cu) against
                the eager chain (ops/preprocess.py::preprocess_plain) on
                the same view at SH degree 3: integer outputs equal, floats
                at rtol 1e-4 / atol 1e-5, the nine leaves' gradients on
                seeded cotangents at utils/grad_gate's gate against the
                eager chain in float64 (on a trained state's flat Gaussians,
                where the float32 chain misses that gate too, an error
                distribution no wider than the chain's plus the gate's
                tolerances), each kernel timed beside its bytes bound.
                Every later kernel phase
                (train, dp, material, quality, runners, turntable)
                checks the pair too, at its path's shapes and SH degree
  render path   the render app, gs2m_tpu_torch.apps.render.main, over all
                views with --dtu: DTU's mesh preset (max depth 5, voxel
                0.002, trunc 0.008, one cluster kept) fuses the views'
                depths into a block-sparse TSDF, extracts, cleans and writes
                the mesh; blocks, voxels, mesh sizes, the ms of each stage
                and peak memory are printed; then a profile of one render
  sp-render     view 0 of the render scene in 4 bands of 304 rows
                (parallel/sp.py, 1200 rows padded to 1216) against the full
                frame: color, buffer and final T at K1's gate, observe counts
                and radii compared; banded and full ms per view and a profile
                of the banded view; the render app with --spatial 4 over the
                views against the --dtu run's PNGs (1 LSB)
  sp-grad       the band-sharded geometry gradient (SSIM halo, Sobel halo,
                plane prior on the bands' max radii) against the one-card
                assembly of the same terms: loss at rtol 1e-5, per-Gaussian
                gradients at utils/grad_gate's tolerances; K1 and K2 launched
                once per band; then K1 (render, V=16) and K1 + K2 (gradient,
                V=16) against their plain versions at band 1's shapes
  train scene   bench_train.py's operating point: 8 views at 800x600 (DTU at
                -r 2) on a ring, 300k points3D in its box, seeded noise GT
                images, widened neighbor thresholds
  train path    the train app, gs2m_tpu_torch.apps.train.main: warmup then
                geometry steps, densification at two boundaries, checkpoints
                at 10 and 20, a profiler trace of 12..14, evaluation and a
                snapshot at the end; a second train app resumed from the
                iteration-10 checkpoint to 20, held to the uninterrupted run
                bit for bit (loss, parameters, Adam moments, densify
                statistics); then the trim's observe counter
                over the 8 views; then warmup and geometry steps timed and
                one geometry step profiled; then the trim counter timed,
                profiled and split into its stages; then the kernel phase again at
                the train path's own shapes (the trained Gaussians on view 0,
                V=8, the trainer's chunk and instance cap)
  determinism   two runs of the same two geometry steps from one state (an
                in-memory copy of the trainer) end bit-equal: loss, every
                parameter, the Adam moments, the densify statistics; then
                one step under torch.use_deterministic_algorithms(True,
                warn_only=True), whose warnings name any op left without a
                deterministic implementation
  dp-train      two ranks of the train app (--data_parallel --distributed,
                gloo, this script spawned with --dp-worker and torchrun's
                environment) on the one card: train-full's scene and 20
                iterations (5 warmup, densification at 10 and 20), run twice;
                both ranks' and both runs' replicated state bit-equal, the
                first step's reduced gradient bit-equal to the one-process
                mean of the two views' gradients, each rank's K1/K2 launches
                as the schedule implies; the DP step's ms, the all-reduces'
                ms and bytes per step; K1 and K2 at the cell's shapes
  material      the material stage at train-full's width: the train scene
                with an all-255 masks/ dir, trained with DTU's material
                flags (scripts/run_dtu.py:46-51) for 20 iterations (5
                warmup, 15 geometry + material against a 512 cubemap),
                a checkpoint at 10 and a profile of 12..14; a second run
                resumed from it, held bit for bit to the uninterrupted
                one (loss, parameters, light); the launches the schedule
                implies by value width (K1 at V=16 for the main and nearest
                views and the evaluation, V=8 for the nearby render that
                the roughness term needs, K2 at V=16); the determinism
                check on material steps (the light and its moments too);
                material steps timed (median of 10) and profiled, with
                their device time split by the trainer's own profiler
                ranges (renders, the PBR pass with build_mips, losses,
                backward, Adam, the light step) and their peak memory;
                the render app on the model (PBR renders, material maps,
                envmap.png); then K1 and K2 at V=16 against their plain
                versions at the material step's shapes
  quality       the port's quality gate, gs2m_tpu_torch.apps.quality_gate,
                at the JAX package's smoke scale (120x90, 8 views, 600
                iterations, mesh at voxel 0.03): train -> render -> TSDF
                mesh -> chamfer against the analytic sphere and test PSNR,
                held to 1.5x the JAX package's chamfer 0.069 and 2 dB under
                its PSNR 27.73 (BASELINE.md); then the kernel phase again at
                the gate's own shapes (its trained Gaussians on view 0,
                120x90, V=8, chunk 64, its trainer's instance cap)
  material gate the port's material gate, gs2m_tpu_torch.apps.material_gate
                --smoke (the glossy sphere under the analytic light, 160x120,
                12 views, 3,000 points, 600 iterations, material from 300):
                held to finite losses, a roughness term that fired, a light
                that changed and stays >= 0, and a finite PBR test PSNR
  viewer        the SIBR bridge (apps/network_gui.py) over a loopback
                socket with train-full's Gaussians at 800x600: five requests
                for view 0, each reply within 1 LSB of render()'s image, K1
                launched once per request, ms per request
  LPIPS         utils/lpips.py on the card with synthetic VGG16 weights: two
                800x600 images within rtol 1e-4 of the CPU, ms per pair; the
                metrics app's LPIPS column on the render-full model with
                GS2M_LPIPS_WEIGHTS set
  composite     the quality gate on the composite scene (sphere + box +
                ground plane, --production --smoke --scene composite): test
                PSNR, chamfer against the analytic surface and the mesh's
                stage times; fails only on a non-finite score or an empty
                mesh (no reference number exists)
  tnt-protocol  convert_json, then the TnT runner (run_tnt) on the
                composite scene laid out as Barn at the composite smoke's
                scale (8 views, 240x180 trained at 120x90, 600 iterations),
                normalized into the unit sphere, with the official kit
                under a known similarity (the GT cloud, 1M points; the
                COLMAP log in a second frame and its trans file; the crop):
                F, P, R at tau 0.01, the recovered transform against the
                known one, the evaluator's stage seconds; the trajectory
                alignment alone held to the known similarity (1e-6), and
                the evaluator run once more on the analytic surface as the
                reconstruction, its transform held to the known one; then
                K1 and K2 at the model's shapes and the train app's final
                instance cap. Every runner path runs alone, one after the
                other, so its walls and stage seconds share the host with
                nothing
  dtu-protocol  the DTU runner as a user runs it (python -m
                gs2m_tpu_torch.apps.run_dtu, its apps in processes of their
                own): the composite scene laid out as DTU scan 24 (49 views
                at 1600x1200, trained at -r 2 = 800x600, 40k points) in
                DTU's normalized frame (the world scaled into the unit
                sphere), 600 iterations (geometry and the multi-view loss
                from 300), render --dtu, train metrics, runtime.json; then
                eval_dtu against a synthetic official directory (a 1M-point
                STL, ObsMask, Plane in the scene's frame) at a density
                scaled to the scene (0.002 = DTU's 0.2 mm x 0.01),
                report_dtu, the evaluator's stage seconds and point counts,
                what DTU's own 0.2 density does in this frame (the ball
                query's neighbor count) and which parts the cleaned mesh
                lost; walls by app, launches by app (each process logs its
                launches: ops/blend.py LAUNCH_LOG_ENV); then K1 and K2
                against their plain versions at the trained model's shapes
                and the train app's final instance cap
  turntable     vis_turntable on the dtu-protocol model (--map render) and
                on its cleaned mesh (--mesh, one surfel per face), 60 frames
                at 512 with the script's fixed instance caps: ms per frame,
                dropped per frame, K1 launches (one per frame), peak memory;
                frame 0 of each through K1 against the same frame through
                K1's plain version at K1's gate; K1 at frame 0's shapes
                (the fixed cap, its overflow kept)
  shiny-protocol the Shiny Blender runner (run_shiny) on the material
                smoke's glossy sphere laid out as `ball` (RGBA images,
                transforms_*.json, --mask_gt), 600 iterations with the
                material stage from 300: test metrics, the PBR outputs, K1
                and K2 launched at V=16; then K1 and K2 at V=16 at the
                model's shapes and the train app's final instance cap

Launch counts are zeroed just before each path and read just after; every
kernel of a path must have launched, as often as its schedule implies (the
preprocess forward once per render and per trim view, its backward once per
differentiated render; on
the runners' paths, whose apps run in processes of their own, each app that
launches a kernel must have launched it; each process appends its counts
to a fresh file, read after the runner exits).
Prints the card's name and power limit, the smoke's total wall time, then
one JSON line of kernel records (one per kernel and path, from that path's
kernel phase), and as the last line {"ok": true, "device": {...}}. Any
failed phase exits nonzero. Needs one CUDA card:

    python3 chip_smoke.py [--seed 0]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
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
# K2's timing probe: csrc/blend_bwd.cu built to stop after pass 1 (no path
# loads it).
PASS1_ONLY = ("-DGS2M_BWD_PASS1_ONLY",)
# The render-full cell: DTU's native resolution and bench.py's 500k slab.
GAUSSIANS, WIDTH, HEIGHT, VIEWS = 500_000, 1600, 1200, 4
# The train cell: bench_train.py's operating point (DTU at -r 2).
TRAIN_POINTS, TRAIN_W, TRAIN_H, TRAIN_VIEWS = 300_000, 800, 600, 8
TRAIN_ITERS, GEOMETRY_FROM, DENSIFY_FROM, DENSIFY_EVERY = 20, 5, 5, 8
EVAL_VIEWS = 5  # the train app evaluates the first five train views
CHECKPOINTS, PROFILE = (10, 20), (12, 14)
# The material cell: DTU's material flags (scripts/run_dtu.py:46-51), with
# the all-255 masks that --mask_gt reads.
MATERIAL_FLAGS = ("--material", "--mask_gt", "--masks", "masks",
                  "--reflection_threshold", "1.0", "--lambda_smooth", "0.0",
                  "--lambda_normal", "0.1")
# The quality phase's limits: 1.5x the JAX package's smoke chamfer (0.069)
# and 2 dB under its test PSNR (27.73), BASELINE.md's r4 smoke gate.
CHAMFER_MAX, TEST_PSNR_MIN = 0.10, 25.7
# The smoke gate's test and checkpoint iterations (apps/quality_gate.py).
QUALITY_EVALS = (200, 400, 600)


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
    its (instance, pixel) pairs before termination / contributing; and what
    the kernels' warp cull and K2's reduction skip see on it: the shares of
    (instance, warp) pairs of live chunks that the cull rectangles skip and
    that have no contributing lane, and the live chunks per tile. For K3:
    the pairs at which its output can still change (inside, not done,
    logT_excl > LOG_HALF), and the shares of (instance, warp) steps of live
    chunks that it walks, that the cull skips, and that it skips because
    every lane of the warp had retired, and of live chunks it skips whole."""
    import torch

    from gs2m_tpu_torch.ops.blend import (LOG_HALF, LOG_RETIRE, chunk_walk,
                                          cull_rects, pixel_coords, warp_any,
                                          warp_hits)

    V = raw.img.shape[1]
    P = raw.clogT.shape[-1]
    n_chunks = chunk_tile.shape[0]
    live = (chunk_tile < T) & ~torch.all(raw.cdone[:, 0] > 0, dim=1)
    live_idx = torch.nonzero(live)[:, 0]
    g = geom.reshape(8, n_chunks, chunk)
    pairs = contrib = hit_pairs = contrib_warps = 0
    k3_pairs = k3_walked = k3_retired = k3_skipped = 0
    for c in torch.split(live_idx, 512):
        tiles = chunk_tile[c].long()
        px, py = pixel_coords(tiles, 16, grid_x)
        gc = g[:, c].permute(1, 2, 0)
        st = chunk_walk(gc[..., None], px, py, raw.clogT[c, 0],
                        raw.cdone[c, 0] > 0, width=width, height=height)
        inside = ((px < width) & (py < height))[:, None]
        pairs += int((~st.done & inside).sum())
        contrib += int(st.contribute.sum())
        rects = cull_rects(gc.permute(2, 0, 1).reshape(8, -1))
        hits = warp_hits(rects.T.reshape(len(c), chunk, 4), tiles, grid_x)
        hit_pairs += int(hits.sum())
        contrib_warps += int(warp_any(st.contribute).sum())
        # K3: a pixel retires after the step whose test falls below
        # LOG_RETIRE (sticky; outside pixels and done carries start retired).
        k3_pairs += int((inside & ~st.done & (st.logT_excl > LOG_HALF)).sum())
        ret0 = ((raw.cdone[c, 0] > 0) | (raw.clogT[c, 0] < LOG_RETIRE)
                | ~inside[:, 0])
        below = st.test < LOG_RETIRE
        fell = torch.cummax(torch.cat([torch.zeros_like(below[:, :1]),
                                       below[:, :-1]], 1).int(), 1).values > 0
        warp_out = ~warp_any(~(ret0[:, None] | fell))   # (n, chunk, warps)
        k3_walked += int((hits & ~warp_out).sum())
        k3_retired += int((hits & warp_out).sum())
        k3_skipped += int(ret0.all(1).sum())
        del st, below, fell
    n_live = int(live.sum())
    per_tile = torch.bincount(chunk_tile[live].long(), minlength=T)
    per_tile = per_tile[per_tile > 0].double()
    warp_pairs = max(n_live * chunk * 8, 1)
    stats = dict(
        culled_share=1.0 - hit_pairs / warp_pairs,
        reduction_skipped_share=1.0 - contrib_warps / warp_pairs,
        k3_pairs=k3_pairs, k3_chunks=n_live - k3_skipped,
        k3_walked_share=k3_walked / warp_pairs,
        k3_retired_share=k3_retired / warp_pairs,
        k3_skipped_chunk_share=k3_skipped / max(n_live, 1),
        live_chunks_per_tile={
            "mean": float(per_tile.mean()) if len(per_tile) else 0.0,
            "p99": float(torch.quantile(per_tile, 0.99)) if len(per_tile) else 0.0,
            "max": int(per_tile.max()) if len(per_tile) else 0})
    bytes_ = (n_live * chunk * (6 + V) * 4          # geometry + values read
              + n_chunks * 4                         # chunk_tile
              + (T + 1) * (V + 1) * P * 4           # img, fT
              + n_chunks * (2 * P + chunk) * 4)     # carries, obs
    flops = 20 * pairs + 2 * V * contrib
    return bytes_, flops, pairs, contrib, n_live, stats


def bound(bytes_: float, flops: float) -> dict:
    """The least time the card could take: the larger of bytes over HBM rate
    and operations over fp32 rate (H100 SXM peaks)."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return dict(bytes=bytes_, flops=flops, bound_bytes_ms=t_bytes,
                bound_ops_ms=t_ops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def k2_probe(defines: tuple, args, kw):
    """A launcher of K2 built with `defines`, on K2's inputs `args`. Called
    through the C entry, not the wrapper, so it is not counted in
    LAUNCHES."""
    import ctypes

    import torch

    from gs2m_tpu_torch import _build
    from gs2m_tpu_torch.ops.blend import ALPHA_MIN, LOG_EPS, _tile_bounds

    fn = _build.library("blend_bwd", defines).gs2m_blend_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    geom, vals, chunk_tile, clogT, cdone, g_img, gT, fT = args
    V, I = vals.shape
    T, chunk = kw["T"], kw["chunk"]
    dgeom = torch.empty(8, I, device="cuda")
    dvals = torch.empty(V, I, device="cuda")
    ptrs = [t.data_ptr() for t in (geom, vals, _tile_bounds(chunk_tile, T),
                                   clogT, cdone, g_img, gT, fT, dgeom, dvals)]

    def launch():
        err = fn(*ptrs, T, I // chunk, chunk, V, kw["grid_x"], kw["width"],
                 kw["height"], LOG_EPS, ALPHA_MIN,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            fail(f"K2 probe {defines}: CUDA error {err}")
    return launch


def kernel_phase(g, cam, chunk: int, cap: int, feature_count: int,
                 band: tuple | None = None, drop_ok: bool = False):
    """K1 against its plain version on the binning of one view, with the
    value width (V) that `feature_count` gives; with `band` (y0, rows), on
    that band's binning as parallel/sp.py renders it; `drop_ok` keeps a
    binning that overflowed `cap` (a path that never regrows its cap).
    Returns (report, context) where the context carries the binning, the
    Gaussian count and K1's outputs to K2 and K3."""
    import torch

    from gs2m_tpu_torch.ops import blend
    from gs2m_tpu_torch.ops.binning import bin_gaussians, num_tiles
    from gs2m_tpu_torch.ops.blend import (LAUNCHES, blend_fwd,
                                          blend_fwd_plain, gather_instances)
    from gs2m_tpu_torch.ops.projection import crop_projected, project
    from gs2m_tpu_torch.ops.rasterize import build_features, pack_values

    H, W = cam.height, cam.width
    op = g.get_opacity[:, 0]
    proj = project(g, cam, g.max_sh_degree, op)
    if band is not None:
        proj = crop_projected(proj, band[0], band[1], 16)
        H = band[1]
    grid_y, grid_x = num_tiles(H, W, 16)
    T = grid_y * grid_x
    binning = bin_gaussians(proj, H, W, 16, cap, chunk, op)
    if int(binning.dropped) != 0 and not drop_ok:
        fail(f"kernel phase binning dropped {int(binning.dropped)}")
    values = pack_values(proj.colors, build_features(g, cam), feature_count)
    geom, vals = gather_instances(values, proj.means2d, proj.conics, op,
                                  binning.gid, binning.is_null)
    kw = dict(T=T, grid_x=grid_x, width=W, height=H, tile=16, chunk=chunk)
    n0 = LAUNCHES["blend_fwd", vals.shape[0]]
    ker = blend_fwd(geom, vals, binning.chunk_tile, **kw)
    torch.cuda.synchronize()
    if LAUNCHES["blend_fwd", vals.shape[0]] != n0 + 1:
        fail("blend_fwd did not launch its kernel on a CUDA tensor")
    ref = blend_fwd_plain(geom, vals, binning.chunk_tile, **kw)
    torch.cuda.synchronize()

    report = {"V": vals.shape[0], "instances": int(binning.num_instances),
              "aligned": int(binning.num_aligned), "n_chunks": cap // chunk,
              "dropped": int(binning.dropped)}
    max_err = 0.0
    problems = []
    for name in ("img", "fT", "clogT"):
        a, b = getattr(ker, name), getattr(ref, name)
        if not bool(torch.isfinite(a).all()):
            fail(f"K1 {name} is not finite")
        d = (a - b).abs()
        off = d > 1e-5
        err, frac = float(d.max()), float(off.float().mean())
        report[f"{name}_max_abs_err"] = err
        report[f"{name}_frac_over_1e-5"] = frac
        if frac > 1e-4:
            problems.append(f"K1 {name}: {frac:.3g} of entries over 1e-5 "
                            f"(limit 1e-4)")
        if name == "clogT":
            # A pixel whose termination flips on one ulp keeps, in every
            # later chunk of its tile, a carry off by that instance's
            # log1p(-alpha) (up to 4.6): only the share of such entries is
            # held. The larger of the two carries there shows where they sit.
            report["clogT_off_max_logT"] = (
                float(torch.maximum(a, b)[off].max()) if bool(off.any())
                else None)
            continue
        # Image and final T move by at most ~T at termination (1e-4) there.
        limit = 1e-3 * (1.0 + float(b.abs().max()))
        max_err = max(max_err, err)
        if err > limit:
            problems.append(f"K1 {name}: max |diff| {err:.3g} (limit "
                            f"{limit:.3g})")
    for name in ("cdone", "obs"):
        eq = float((getattr(ker, name) == getattr(ref, name)).float().mean())
        report[f"{name}_equal_frac"] = eq
        if eq < 0.9999:
            problems.append(f"K1 {name}: only {eq:.6f} of entries equal "
                            f"(need 0.9999)")
    if problems:
        print(f"[smoke] K1 report: {json.dumps(report)}")
        fail("; ".join(problems))

    ms = time_ms(lambda: blend_fwd(geom, vals, binning.chunk_tile, **kw), 20)
    plain_ms = time_ms(lambda: blend_fwd_plain(geom, vals, binning.chunk_tile,
                                               **kw), 3)
    bytes_, flops, pairs, contrib, n_live, stats = k1_work(
        geom, ker, binning.chunk_tile, T=T, grid_x=grid_x, width=W, height=H,
        chunk=chunk)
    report.update(ms=ms, plain_ms=plain_ms, live_pairs=pairs,
                  contributing_pairs=contrib, live_chunks=n_live,
                  max_abs_err=max_err, **bound(bytes_, flops),
                  culled_share=stats["culled_share"],
                  live_chunks_per_tile=stats["live_chunks_per_tile"],
                  resources=blend.kernel_info("blend_fwd", vals.shape[0], chunk))
    ctx = dict(geom=geom, vals=vals, binning=binning, kw=kw, k1=ker,
               C=op.shape[0], pairs=pairs, contrib=contrib, n_live=n_live,
               stats=stats)
    return report, ctx


def k2_phase(ctx: dict) -> dict:
    """K2 against its plain version on one view's binning, K1's carries and a
    seeded cotangent: per channel, >= 99.99 % of entries within
    1e-4 * max|channel| + 1e-6 (one ulp at a termination or gate edge flips
    a whole instance's term); the per-Gaussian sums of both at the
    check_grads gate; a second run bit-equal."""
    import torch

    from gs2m_tpu_torch.ops.blend import (LAUNCHES, blend_bwd,
                                          blend_bwd_plain, kernel_info,
                                          segment_sum)
    from gs2m_tpu_torch.utils.grad_gate import grad_gate

    geom, vals, b, kw, k1 = (ctx[k] for k in ("geom", "vals", "binning",
                                               "kw", "k1"))
    T, V, P, chunk = kw["T"], vals.shape[0], 256, kw["chunk"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    g_img = torch.randn(T + 1, V, P, generator=gen, device="cuda")
    gT = torch.randn(T + 1, 1, P, generator=gen, device="cuda")
    g_img[T] = 0.0
    gT[T] = 0.0
    args = (geom, vals, b.chunk_tile, k1.clogT, k1.cdone, g_img, gT, k1.fT)
    n0 = LAUNCHES["blend_bwd", V]
    ker = blend_bwd(*args, **kw)
    again = blend_bwd(*args, **kw)
    torch.cuda.synchronize()
    if LAUNCHES["blend_bwd", V] != n0 + 2:
        fail("blend_bwd did not launch its kernel on a CUDA tensor")
    ref = blend_bwd_plain(*args, **kw)
    torch.cuda.synchronize()
    report = {"V": V,
              "bit_equal_rerun": bool(torch.equal(ker.dgeom, again.dgeom)
                                      and torch.equal(ker.dvals, again.dvals))}
    if not report["bit_equal_rerun"]:
        fail("K2: two runs on the same inputs differ")
    a = torch.cat([ker.dvals, ker.dgeom])
    r = torch.cat([ref.dvals, ref.dgeom])
    if not bool(torch.isfinite(a).all()):
        fail("K2 output is not finite")
    scale = r.abs().amax(dim=1, keepdim=True)
    d = (a - r).abs()
    frac_ok = (d <= 1e-4 * scale + 1e-6).float().mean(dim=1)
    report["min_frac_within_tol"] = float(frac_ok.min())
    report["max_abs_err"] = float(d.max())
    if float(frac_ok.min()) < 0.9999:
        fail(f"K2: a channel has only {float(frac_ok.min()):.6f} of entries "
             f"within 1e-4*max+1e-6 (need 0.9999)")
    C = ctx["C"]
    key = torch.where(b.is_null, C, b.gid)
    ga, gr = segment_sum(a, key, C), segment_sum(r, key, C)
    leaves = {"values": slice(0, V), "means2d": slice(V, V + 2),
              "conics": slice(V + 2, V + 5), "opacity": slice(V + 5, V + 6),
              "abs_sink": slice(V + 6, V + 8)}
    for name, sl in leaves.items():
        rep = grad_gate(ga[sl].cpu().numpy(), gr[sl].cpu().numpy())
        report[f"gate_{name}"] = {k: rep[k] for k in ("p999", "rel_to_max",
                                                      "pass")}
        if not rep["pass"]:
            fail(f"K2 per-Gaussian {name} grads fail the gate: {rep}")
    if not torch.equal(segment_sum(a, key, C), ga):
        fail("the per-Gaussian reduction is not deterministic")
    report["instance_sum"] = instance_sum_report(ker.dvals, ker.dgeom, b, C)

    ms = time_ms(lambda: blend_bwd(*args, **kw), 20)
    plain_ms = time_ms(lambda: blend_bwd_plain(*args, **kw), 3)
    n_chunks = b.chunk_tile.shape[0]
    n_tiles = int(torch.unique(b.chunk_tile[b.chunk_tile < T]).numel())
    pairs, contrib, n_live = ctx["pairs"], ctx["contrib"], ctx["n_live"]
    # Read once: geometry (6 rows), values and carries of the live chunks,
    # each carried tile's cotangents, fT and gT; written once: 8+V rows of
    # every slot. Operations the function needs (not the kernel's second
    # walk): one alpha step (~20) per live pair; the per-pixel gradient
    # terms (~4V + 40) and the (8+V)-channel tile sums per contributing
    # pair, the only pairs whose terms are not zero.
    bytes_ = (n_live * (chunk * (6 + V) + 2 * P) * 4
              + n_tiles * (V + 2) * P * 4 + n_chunks * 4
              + n_chunks * chunk * (8 + V) * 4)
    flops = 20 * pairs + (4 * V + 40 + 8 + V) * contrib
    # Pass 1's share: K2 built to stop after its first walk.
    pass1_ms = time_ms(k2_probe(PASS1_ONLY, args, kw), 20)
    stats = ctx["stats"]
    report.update(ms=ms, plain_ms=plain_ms, **bound(bytes_, flops),
                  culled_share=stats["culled_share"],
                  reduction_skipped_share=stats["reduction_skipped_share"],
                  live_chunks_per_tile=stats["live_chunks_per_tile"],
                  pass1_ms=pass1_ms, pass1_share=pass1_ms / ms,
                  resources=kernel_info("blend_bwd", V, chunk))
    return report


def instance_sum_report(dvals, dgeom, b, C: int) -> dict:
    """The backward's per-Gaussian reduce pair (csrc/instance_sum.cu)
    against its plain version, segment_sum's chain (ops/blend.py::
    instance_sum_plain), on K2's rows dvals (V, I), dgeom (8, I) of the
    layout `b`: the (C, 8+V) sums bit-equal (torch.equal), a second run
    bit-equal, one launch of each kernel a call; both timed (CUDA events,
    median of 20) beside the pair's bytes bound: pass 1 reads exp_slot and
    the kept slots' 8+V channels and writes their rows; pass 2 reads
    exp_start, exp_kept over the walked range and the rows, and writes the
    sums."""
    import torch

    from gs2m_tpu_torch.ops.blend import (LAUNCHES, instance_sum,
                                          instance_sum_plain)

    V, I = dvals.shape
    n0 = {k: LAUNCHES[k, V] for k in ("instance_rows", "instance_sum")}
    got = instance_sum(dvals, dgeom, b, C)
    torch.cuda.synchronize()
    launched = {k: LAUNCHES[k, V] - n for k, n in n0.items()}
    again = instance_sum(dvals, dgeom, b, C)
    ref = instance_sum_plain(dvals, dgeom, b, C)
    torch.cuda.synchronize()
    rep = {"V": V, "I": I, "C": C, "launches_a_call": launched,
           "bit_equal_plain": bool(torch.equal(got, ref)),
           "bit_equal_rerun": bool(torch.equal(got, again)),
           "max_abs_err": float((got - ref).abs().max()) if C else 0.0}
    if launched != {"instance_rows": 1, "instance_sum": 1}:
        fail(f"instance_sum launched {launched}, expected one of each kernel")
    if not (rep["bit_equal_plain"] and rep["bit_equal_rerun"]):
        fail(f"instance_sum against segment_sum's chain: {rep}")
    K = V + 8
    kept = int(b.exp_kept.sum())
    walked = int(b.exp_start[-1])
    bytes_ = (4 * I + 2 * 4 * K * kept                      # pass 1
              + 4 * (C + 1) + walked + 4 * K * kept + 4 * K * C)   # pass 2
    rep.update(kept=kept, walked=walked,
               ms=time_ms(lambda: instance_sum(dvals, dgeom, b, C), 20),
               plain_ms=time_ms(lambda: instance_sum_plain(dvals, dgeom, b, C),
                                20),
               **bound(bytes_, 0.0))
    rep["share_of_bound"] = rep["bound_ms"] / rep["ms"]
    return rep


def instance_sum_phase(config: str, seed: int = 0) -> dict:
    """The reduce pair at a benchmark cell's layout (benchmark/configs/
    <config>.json): the cell's state drawn from `seed` (benchmark/cellkit/
    scene.py), its first view at the trained size binned at the cell's
    instance cap and chunk, K1, and K2 on a seeded cotangent; then
    instance_sum_report on K2's rows. Alone on a card:
        python -c "import chip_smoke; chip_smoke.instance_sum_phase('tnt-wo-brdf')"
    """
    import math

    import torch

    from benchmark.cellkit.scene import arc_camera, make_state, trained_size
    from gs2m_tpu_torch.core.camera import Camera, focal2fov
    from gs2m_tpu_torch.core.gaussians import Gaussians
    from gs2m_tpu_torch.ops.binning import bin_gaussians, num_tiles
    from gs2m_tpu_torch.ops.blend import (blend_bwd, blend_fwd,
                                          gather_instances)
    from gs2m_tpu_torch.ops.projection import project
    from gs2m_tpu_torch.ops.rasterize import build_features, pack_values

    cfg = json.loads((HERE / "benchmark" / "configs" / f"{config}.json")
                     .read_text())
    dev = torch.device("cuda")
    st = make_state(cfg, seed, dev)
    p = st.params
    g = Gaussians(xyz=p["xyz"], features_dc=p["f_dc"],
                  features_rest=p["f_rest"], scaling=p["scaling"],
                  rotation=p["rotation"], opacity=p["opacity"],
                  albedo=p["albedo"], roughness=p["roughness"],
                  metallic=p["metallic"], alive=st.alive,
                  max_sh_degree=cfg["model"]["sh_degree"])
    s = cfg["scene"]
    w, h = trained_size(cfg)
    R, T = arc_camera(-math.radians(s["arc_degrees"]) / 2,
                      s["camera_distance"], s["camera_height"])
    cam = Camera.create(R, T, focal2fov(s["focal_px"], s["image_width"]),
                        focal2fov(s["focal_px"], s["image_height"]), w, h,
                        device=dev)
    chunk, cap = cfg["pipeline"]["chunk"], int(cfg["instance_cap"])
    op = g.get_opacity[:, 0]
    proj = project(g, cam, g.max_sh_degree, op)
    b = bin_gaussians(proj, h, w, 16, cap, chunk, op)
    values = pack_values(proj.colors, build_features(g, cam), 5)     # V=8
    geom, vals = gather_instances(values, proj.means2d, proj.conics, op,
                                  b.gid, b.is_null)
    grid_y, grid_x = num_tiles(h, w, 16)
    kw = dict(T=grid_y * grid_x, grid_x=grid_x, width=w, height=h, tile=16,
              chunk=chunk)
    k1 = blend_fwd(geom, vals, b.chunk_tile, **kw)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    Tn, V = kw["T"], vals.shape[0]
    g_img = torch.randn(Tn + 1, V, 256, generator=gen, device=dev)
    gT = torch.randn(Tn + 1, 1, 256, generator=gen, device=dev)
    g_img[Tn] = 0.0
    gT[Tn] = 0.0
    k2 = blend_bwd(geom, vals, b.chunk_tile, k1.clogT, k1.cdone, g_img, gT,
                   k1.fT, **kw)
    del geom, vals, k1, g_img, gT
    rep = {"cell": config, "width": w, "height": h,
           "instances": int(b.num_instances), "aligned": int(b.num_aligned),
           "dropped": int(b.dropped),
           **instance_sum_report(k2.dvals, k2.dgeom, b, op.shape[0])}
    print(f"[smoke] instance_sum at {config}'s layout: {json.dumps(rep)}")
    return rep


def k3_phase(ctx: dict) -> dict:
    """K3 against its plain version and K1's obs on the same binning:
    equal, count for count. Its bound counts the geometry of the chunks and
    ~20 operations per pair at which the output can still change; the bound
    over every live chunk and every live pair up to termination, which K3
    was first held to, is printed beside it."""
    import torch

    from gs2m_tpu_torch.ops.blend import (LAUNCHES, blend_obs,
                                          blend_obs_plain, kernel_info)

    geom, b, kw, k1 = (ctx[k] for k in ("geom", "binning", "kw", "k1"))
    n0 = LAUNCHES["blend_obs", 0]
    ker = blend_obs(geom, b.chunk_tile, **kw)
    torch.cuda.synchronize()
    if LAUNCHES["blend_obs", 0] != n0 + 1:
        fail("blend_obs did not launch its kernel on a CUDA tensor")
    ref = blend_obs_plain(geom, b.chunk_tile, **kw)
    report = {"equal_plain": bool(torch.equal(ker, ref)),
              "equal_k1_obs": bool(torch.equal(ker, k1.obs)),
              "observed_instances": int((ker > 0).sum())}
    if not (report["equal_plain"] and report["equal_k1_obs"]):
        fail(f"K3 counts differ: {report}")
    ms = time_ms(lambda: blend_obs(geom, b.chunk_tile, **kw), 20)
    plain_ms = time_ms(lambda: blend_obs_plain(geom, b.chunk_tile, **kw), 3)
    n_chunks, chunk = b.chunk_tile.shape[0], kw["chunk"]
    # Geometry (6 rows) read of the live chunks whose tile still has an
    # inside pixel not retired at the chunk's start, obs written; ~20
    # operations per (instance, pixel) pair at which the output can still
    # change (inside, not done, logT_excl > LOG_HALF).
    stats = ctx["stats"]
    obs_bytes = n_chunks * (chunk + 1) * 4
    bytes_ = stats["k3_chunks"] * chunk * 6 * 4 + obs_bytes
    live_bytes = ctx["n_live"] * chunk * 6 * 4 + obs_bytes
    report.update(ms=ms, plain_ms=plain_ms, max_abs_err=0.0,
                  **bound(bytes_, 20 * stats["k3_pairs"]),
                  bound_live_pairs_ms=bound(live_bytes,
                                            20 * ctx["pairs"])["bound_ms"],
                  k3_pairs=stats["k3_pairs"], live_pairs=ctx["pairs"],
                  k3_chunks=stats["k3_chunks"], live_chunks=ctx["n_live"],
                  culled_share=stats["culled_share"],
                  retired_share=stats["k3_retired_share"],
                  walked_share=stats["k3_walked_share"],
                  skipped_chunk_share=stats["k3_skipped_chunk_share"],
                  resources=kernel_info("blend_obs", 8, chunk))
    return report


def preprocess_bytes(C: int, k_rest: int, deg: int) -> tuple:
    """(forward, backward) bytes the preprocess pair must move for C rows at
    SH degree `deg` with colours: each row's parameters read once (the SH
    coefficients the degree uses), the forward's outputs written once; the
    backward reads the parameters and the five cotangents and writes the
    nine leaves' gradients (all k_rest SH rows)."""
    # xyz, f_dc, f_rest, scaling, rotation, opacity, albedo, roughness,
    # metallic, alive; then the outputs in _launch_fwd's order.
    params = 12 + 12 + 12 * ((deg + 1) ** 2 - 1) + 12 + 16 + 4 + 12 + 4 + 4 + 1
    outs = 4 + 40 + 8 + 4 + 12 + 12 + 4 + 8 + 8 + 4 + 1
    cots = 4 + 40 + 8 + 12 + 12
    grads = 12 + 12 + 12 * k_rest + 12 + 16 + 4 + 12 + 4 + 4
    return C * (params + outs), C * (params + cots + grads)


def as_float64(obj):
    """A copy of a Gaussians or a Camera with its float tensors in float64."""
    import dataclasses

    import torch

    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).double() for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)
        and getattr(obj, f.name).is_floating_point()})


def preprocess_phase(cell: str, g, cam, deg: int,
                     backward: bool = True) -> dict:
    """The preprocess pair (csrc/preprocess.cu) against the eager chain
    (ops/preprocess.py::preprocess_plain) on one view at a path's shapes
    and SH degree: the forward's integer outputs equal and its floats at
    rtol 1e-4 / atol 1e-5; with `backward`, the nine leaves' gradients on
    seeded cotangents against autograd of the eager chain in float64 at
    utils/grad_gate's gate (where the float32 chain fails that gate too,
    the kernel's median and p90 relative error and its rel_to_max may
    exceed the chain's by no more than the gate's tolerances); one launch
    each way. Each kernel is timed by CUDA events (20 launches back to
    back, per launch) beside its bound, C rows x the bytes each must move
    (preprocess_bytes) over HBM's rate. Returns the reports by
    launch-counter name."""
    import torch

    from gs2m_tpu_torch.ops import preprocess as pp
    from gs2m_tpu_torch.ops.blend import LAUNCHES
    from gs2m_tpu_torch.utils.grad_gate import (DEFAULT_TOL, REL_TO_MAX_TOL,
                                                TOLERANCES, WELLCOND_FRAC,
                                                grad_gate)

    C = g.capacity
    leaves = {k: v.detach().requires_grad_(backward)
              for k, v in g.params_dict().items()}
    gl = g.with_params(leaves)
    n0 = (LAUNCHES["preprocess_fwd", 0], LAUNCHES["preprocess_bwd", 0])
    got = pp.preprocess(gl, cam, deg)
    ref = pp.preprocess_plain(gl, cam, deg)
    fields = lambda o: {"opacities": o.opacities, "features": o.features,
                        **o.proj._asdict()}
    a = {k: v.detach() for k, v in fields(got).items()}
    b = {k: v.detach() for k, v in fields(ref).items()}
    int_differ = {k: int((a[k] != b[k]).sum()) for k in a
                  if not a[k].is_floating_point()}
    float_err = {k: float((a[k] - b[k]).abs().max()) for k in a
                 if a[k].is_floating_point()}
    over = {k: int((~torch.isclose(a[k], b[k], rtol=1e-4, atol=1e-5)).sum())
            for k in float_err}
    fwd_bytes, bwd_bytes = preprocess_bytes(C, g.features_rest.shape[1], deg)
    fwd = {"rows": C, "deg": deg, "valid": int(b["valid"].sum()),
           "int_differ": int_differ, "over_gate": over,
           "max_abs_err": max(float_err.values())}
    reports = {"preprocess_fwd": fwd}
    if backward:
        gen = torch.Generator(device=g.xyz.device).manual_seed(7)
        cot = [torch.randn(C, *s, generator=gen, device=g.xyz.device)
               for s in ((), (10,), (2,), (3,), (3,))]

        def loss_of(o, cot):
            return (torch.sum(o.opacities * cot[0])
                    + torch.sum(o.features * cot[1])
                    + torch.sum(o.proj.means2d * cot[2])
                    + torch.sum(o.proj.conics * cot[3])
                    + torch.sum(o.proj.colors * cot[4]))

        def grads_of(o, cots, wrt):
            return torch.autograd.grad(loss_of(o, cots), wrt,
                                       retain_graph=True)

        def gate(x, y, k):
            """The gate's report, with the median and p90 of the relative
            error over the entries it holds (|y| >= WELLCOND_FRAC max)."""
            a, b = x.double().cpu().numpy(), y.double().cpu().numpy()
            rep = grad_gate(a, b, TOLERANCES.get(k, DEFAULT_TOL))
            out = {q: rep[q] for q in ("p999", "rel_to_max", "pass")}
            wc = (np.abs(b) >= WELLCOND_FRAC * np.abs(b).max()) & (b != 0)
            rel = np.abs(a - b)[wc] / np.abs(b)[wc]
            out["entries"] = int(rel.size)
            out["median"], out["p90"] = (
                (float(np.quantile(rel, 0.5)), float(np.quantile(rel, 0.9)))
                if rel.size else (0.0, 0.0))
            return out

        # The reference: autograd of the eager chain in float64. A trained
        # state's flat Gaussians (the plane prior drives the smallest scale
        # down) leave float32 too few bits for their covariance, so there
        # the float32 chain misses it as far as the kernel does.
        leaves64 = {k: v.detach().double().requires_grad_(True)
                    for k, v in leaves.items()}
        ref64 = pp.preprocess_plain(as_float64(g).with_params(leaves64),
                                    as_float64(cam), deg)
        wrt = list(leaves.values())
        g_ker = grads_of(got, cot, wrt)
        loss_plain = loss_of(ref, cot)
        g_ref = torch.autograd.grad(loss_plain, wrt, retain_graph=True)
        g_64 = grads_of(ref64, [c.double() for c in cot],
                        list(leaves64.values()))
        del ref64
        gates = {}
        for k, x, y, z in zip(leaves, g_ker, g_ref, g_64):
            ker, f32 = gate(x, z, k), gate(y, z, k)
            tol = TOLERANCES.get(k, DEFAULT_TOL)
            # The kernel passes the gate against float64 where the float32
            # chain does. Where that chain fails it too, the state is past
            # what float32 resolves at the gate's tail (on a small state the
            # p999 is the single worst entry, and two float32 orders of
            # rounding lose it by turns); there the kernel's error must be
            # the float32 chain's in distribution: its median and p90, and
            # its largest error over the largest gradient, no more than the
            # chain's plus the gate's tolerances. A derivation error moves
            # every row, and so the median.
            ok = ker["pass"] or (
                not f32["pass"] and bool(torch.isfinite(x).all())
                and ker["median"] <= f32["median"] + tol
                and ker["p90"] <= f32["p90"] + tol
                and ker["rel_to_max"] <= f32["rel_to_max"] + REL_TO_MAX_TOL)
            gates[k] = {"kernel_vs_f64": ker, "f32_chain_vs_f64": f32,
                        "kernel_vs_f32_chain": gate(x, y, k), "pass": ok}
        reports["preprocess_bwd"] = {
            "rows": C, "deg": deg, "gates": gates,
            "max_abs_err": max(float((x - y).abs().max())
                               for x, y in zip(g_ker, g_ref))}
    launched = (LAUNCHES["preprocess_fwd", 0] - n0[0],
                LAUNCHES["preprocess_bwd", 0] - n0[1])
    problems = [k for k, n in int_differ.items() if n] + [
        k for k, n in over.items() if n]
    if backward:
        problems += [k for k, v in reports["preprocess_bwd"]["gates"].items()
                     if not v["pass"]]
    if launched != (1, int(backward)):
        problems.append(f"launches {launched}, expected (1, "
                        f"{int(backward)})")

    # Timing: the kernels through their launchers, 20 back to back per
    # CUDA-event window, so that at large states the host issues ahead of
    # the card; at a few thousand rows the figure is the launch's.
    ins = [x.detach().contiguous() for x in pp._inputs(g, cam)]
    meta = pp._Meta(deg, 16, cam.width, cam.height, True, False,
                    float(cam.zfar))
    reps = 20
    with torch.no_grad():
        fwd["ms"] = time_ms(lambda: [pp._launch_fwd(ins, meta)
                                     for _ in range(reps)], 5) / reps
        fwd["plain_ms"] = time_ms(lambda: pp.preprocess_plain(g, cam, deg), 3)
    fwd.update(bound(fwd_bytes, 0.0))
    if backward:
        cots = tuple(cot)
        bwd = reports["preprocess_bwd"]
        bwd["ms"] = time_ms(lambda: [pp._launch_bwd(ins, cots, meta)
                                     for _ in range(reps)], 5) / reps
        bwd["plain_ms"] = time_ms(lambda: torch.autograd.grad(
            loss_plain, list(leaves.values()), retain_graph=True), 3)
        bwd.update(bound(bwd_bytes, 0.0))
    for name, rep in reports.items():
        print(f"[smoke] {cell} {name}: {json.dumps(rep)}")
    if problems:
        fail(f"{cell} preprocess pair against the eager chain: {problems}")
    return reports


# The nine Adam groups' widths at SH degree 3: 64 floats a row.
ADAM_WIDTHS = {"xyz": (3,), "f_dc": (1, 3), "f_rest": (15, 3),
               "opacity": (1,), "scaling": (3,), "rotation": (4,),
               "albedo": (3,), "roughness": (1,), "metallic": (1,)}


def adam_case(rows: int, device, seed: int = 0, count: int = 0):
    """The nine Adam groups of `rows` rows at SH degree 3, drawn from `seed`
    on `device`, with the edges the kernel must round as the eager loop
    does: the last quarter of the rows dead (zero gradients and moments),
    metallic without a gradient, roughness's moments all -0.0, and xyz's
    gradient one float past a 16-byte boundary (the wrapper copies it).
    Returns (params, grads, AdamState at `count`, lrs), lrs(step) the LRs
    of a step, which change from step to step."""
    import torch

    from gs2m_tpu_torch.core.config import OptimConfig
    from gs2m_tpu_torch.train.optim import AdamState, group_lrs

    gen = torch.Generator(device=device).manual_seed(seed)
    live = rows - rows // 4
    opt = OptimConfig()
    base_lrs = group_lrs(opt, 1.0, opt.position_lr_init)

    def draw(shape, scale):
        x = torch.randn(shape, generator=gen, device=device) * scale
        x[live:] = 0.0
        return x

    params, grads, mu, nu = {}, {}, {}, {}
    for k, w in ADAM_WIDTHS.items():
        shape = (rows, *w)
        params[k] = torch.randn(shape, generator=gen, device=device)
        grads[k] = draw(shape, 1e-3)
        mu[k] = draw(shape, 1e-4)
        nu[k] = draw(shape, 1e-3) ** 2
    grads["metallic"] = None
    mu["roughness"].fill_(-0.0)
    nu["roughness"].fill_(-0.0)
    buf = torch.empty(grads["xyz"].numel() + 1, device=device)
    buf[1:] = grads["xyz"].reshape(-1)
    grads["xyz"] = buf[1:].view(rows, 3)
    return (params, grads, AdamState(mu=mu, nu=nu, count=count),
            lambda step: {k: lr * (1.0 + 0.25 * step)
                          for k, lr in base_lrs.items()})


def adam_clone(params: dict, grads: dict, state) -> tuple:
    """Clones of an Adam update's inputs: (params, grads, AdamState)."""
    from gs2m_tpu_torch.train.optim import AdamState

    c = lambda d: {k: None if v is None else v.clone() for k, v in d.items()}
    return c(params), c(grads), AdamState(mu=c(state.mu), nu=c(state.nu),
                                          count=state.count)


def adam_bits_differ(got: tuple, ref: tuple) -> dict:
    """Elements whose bits differ, by "p.<group>", "m.<group>", "v.<group>",
    between two (params, AdamState) pairs."""
    import torch

    bits = lambda x: x.reshape(-1).view(torch.int32)
    return {f"{what}.{k}": int((bits(a[k]) != bits(b[k])).sum())
            for what, a, b in (("p", got[0], ref[0]),
                               ("m", got[1].mu, ref[1].mu),
                               ("v", got[1].nu, ref[1].nu))
            for k in a}


def adam_times(params: dict, grads: dict, state, lrs: dict,
               reps: int = 20) -> dict:
    """csrc/adam.cu and the eager loop timed by CUDA events on one update's
    inputs (each on its own clones; `reps` updates back to back per window,
    per update), beside the kernel's bound, 28 B an element over HBM's
    rate."""
    from gs2m_tpu_torch.train import optim

    p, g, s = adam_clone(params, grads, state)
    q, h, t = adam_clone(params, grads, state)
    rep = {"ms": time_ms(lambda: [optim.adam_update(p, g, s, lrs)
                                  for _ in range(reps)], 5) / reps,
           "plain_ms": time_ms(lambda: [optim.adam_update_plain(q, h, t, lrs)
                                        for _ in range(reps)], 3) / reps}
    rep.update(bound(28 * sum(x.numel() for x in params.values()), 0.0))
    return rep


def adam_phase(rows: int, seed: int = 0, reps: int = 20) -> dict:
    """csrc/adam.cu against the eager loop (train/optim.py::
    adam_update_plain) on adam_case's groups of `rows` rows, both on the
    card: p, m and v bit-equal after 3 steps, one launch a step; then each
    update timed (adam_times), and beside torch._fused_adam_ on the same
    tensors (library_ms; the port never calls it)."""
    import torch

    from gs2m_tpu_torch.launches import LAUNCHES
    from gs2m_tpu_torch.train import optim

    dev = torch.device("cuda")
    params, grads, state, lrs = adam_case(rows, dev, seed, count=15_090)
    ref, _, ref_state = adam_clone(params, {}, state)
    times = adam_times(params, grads, state, lrs(0), reps)
    n0 = LAUNCHES["adam", 0]
    for step in range(3):
        optim.adam_update(params, grads, state, lrs(step))
        optim.adam_update_plain(ref, grads, ref_state, lrs(step))
    launched = LAUNCHES["adam", 0] - n0
    differ = adam_bits_differ((params, state), (ref, ref_state))
    rep = {"rows": rows, "elements": sum(v.numel() for v in params.values()),
           "launches": launched, "bits_differ": sum(differ.values()),
           "max_abs_err": max(float((params[k] - ref[k]).abs().max())
                              for k in params), **times}
    # The yardstick: PyTorch's own fused Adam over the same tensors, one LR
    # (torch.optim.Adam(fused=True)'s call; other rounding, same bytes).
    lib = [list(d.values()) for d in (ref, ref_state.mu, ref_state.nu)]
    lib_grads = [torch.zeros_like(p) if grads[k] is None else grads[k]
                 for k, p in ref.items()]
    steps = [torch.ones((), device=dev) for _ in ref]
    rep["library_ms"] = time_ms(lambda: [torch._fused_adam_(
        lib[0], lib_grads, lib[1], lib[2], [], steps, lr=1e-3, beta1=0.9,
        beta2=0.999, weight_decay=0.0, eps=1e-15, amsgrad=False,
        maximize=False) for _ in range(reps)], 3) / reps
    print(f"[smoke] adam at {rows} rows: {json.dumps(rep)}")
    if rep["bits_differ"] or launched != 3:
        fail(f"adam kernel against the eager loop at {rows} rows: "
             f"{ {k: n for k, n in differ.items() if n} }, launches "
             f"{launched}, expected 3")
    return rep


class AdamTap:
    """csrc/adam.cu held to the eager loop on a path's own updates. Armed (a
    context manager), it stands in for adam_update where the trainer and the
    light's update call it (train/trainer.py, pbr/render.py), counts each
    set of groups' updates (the Gaussians' nine, keyed "xyz"; the light's,
    "light") and their launches, and at call `keep[key]` of a set keeps
    clones of what the path gave the kernel (parameters, gradients, moments,
    step count, LRs) and of what the kernel made of them; it syncs nothing.
    `reports()` then runs adam_update_plain on the kept inputs, compares p,
    m and v bit for bit and times both (adam_times); it fails the smoke on
    a difference, or where a kept call never came. `on_path` False marks a
    tap that no path's run went through (adam_model's)."""

    def __init__(self, cell: str, keep: dict, on_path: bool = True):
        self.cell, self.keep, self.on_path = cell, keep, on_path
        self.calls, self.launches, self.kept = {}, {}, {}

    def __enter__(self):
        from gs2m_tpu_torch.pbr import render as pbr_render
        from gs2m_tpu_torch.train import trainer as trainer_mod

        self.mods = (trainer_mod, pbr_render)
        self.saved = [m.adam_update for m in self.mods]
        for m in self.mods:
            m.adam_update = self.update
        return self

    def __exit__(self, *exc):
        for m, f in zip(self.mods, self.saved):
            m.adam_update = f

    def update(self, params, grads, state, lrs, *args, **kw):
        from gs2m_tpu_torch.launches import LAUNCHES
        from gs2m_tpu_torch.train import optim

        key = next(iter(params))
        n = self.calls[key] = self.calls.get(key, 0) + 1
        n0 = LAUNCHES["adam", 0]
        if n != self.keep.get(key):
            out = optim.adam_update(params, grads, state, lrs, *args, **kw)
        else:
            before = adam_clone(params, grads, state)
            out = optim.adam_update(params, grads, state, lrs, *args, **kw)
            after = adam_clone(params, {}, state)
            self.kept[key] = (before, (after[0], after[2]), dict(lrs), args,
                              kw)
        self.launches[key] = (self.launches.get(key, 0)
                              + LAUNCHES["adam", 0] - n0)
        return out

    def reports(self) -> dict:
        """Per set of groups: its rows, elements, updates and launches on the
        path, the kept call, bits that differ, max |kernel - loop| and
        adam_times."""
        from gs2m_tpu_torch.train import optim

        out = {}
        for key, at in self.keep.items():
            if key not in self.kept:
                fail(f"{self.cell} adam tap: update {at} of {key} never came "
                     f"({self.calls.get(key, 0)} updates)")
            (params, grads, state), got, lrs, args, kw = self.kept.pop(key)
            times = adam_times(params, grads, state, lrs)
            optim.adam_update_plain(params, grads, state, lrs, *args, **kw)
            differ = adam_bits_differ(got, (params, state))
            rep = out[key] = {
                "rows": next(iter(params.values())).shape[0],
                "elements": sum(v.numel() for v in params.values()),
                "updates": self.calls[key], "launches": self.launches[key],
                "kept_call": at, "count": state.count,
                "bits_differ": sum(differ.values()),
                "max_abs_err": max(float((got[0][k] - params[k]).abs().max())
                                   for k in params), "on_path": self.on_path,
                **times}
            print(f"[smoke] {self.cell} adam ({key}): {json.dumps(rep)}")
            if rep["bits_differ"] or rep["launches"] != rep["updates"]:
                fail(f"{self.cell} adam kernel against the eager loop on the "
                     f"path's update {at} of {key}: "
                     f"{ {k: n for k, n in differ.items() if n} }, launches "
                     f"{rep['launches']} for {rep['updates']} updates")
        return out


def adam_model(cell: str, g, seed: int) -> dict:
    """csrc/adam.cu against the eager loop at a trained model's shapes: one
    update of its own parameters (cloned) at its rows and SH degree, with
    gradients and moments drawn from `seed`, zero on its dead rows, at step
    15,090; bits compared and both timed as AdamTap.reports does."""
    import torch

    from gs2m_tpu_torch.core.config import OptimConfig
    from gs2m_tpu_torch.train import optim

    gen = torch.Generator(device=g.xyz.device).manual_seed(seed)
    live = lambda x: x * g.alive.reshape(-1, *[1] * (x.dim() - 1))
    params = {k: v.detach().clone() for k, v in g.params_dict().items()}
    grads = {k: live(torch.randn(v.shape, generator=gen, device=v.device)
                     * 1e-3) for k, v in params.items()}
    state = optim.AdamState(
        mu={k: live(torch.randn(v.shape, generator=gen, device=v.device)
                    * 1e-4) for k, v in params.items()},
        nu={k: live(torch.randn(v.shape, generator=gen, device=v.device)
                    * 1e-3) ** 2 for k, v in params.items()}, count=15_090)
    opt = OptimConfig()
    lrs = optim.group_lrs(opt, 1.0, opt.position_lr_init)
    tap = AdamTap(cell, {"xyz": 1}, on_path=False)
    tap.update(params, grads, state, lrs)
    return tap.reports()["xyz"]


def kernel_phases(cell: str, g, cam, chunk: int, cap: int,
                  feature_count: int, deg: int) -> dict:
    """K1, K2 and K3 against their plain versions on one view of a cell,
    and the preprocess pair at SH degree `deg`; returns each kernel's
    report by launch-counter name."""
    k1, ctx = kernel_phase(g, cam, chunk, cap, feature_count)
    print(f"[smoke] {cell} K1 blend_fwd: {json.dumps(k1)}")
    k2 = k2_phase(ctx)
    print(f"[smoke] {cell} K2 blend_bwd: {json.dumps(k2)}")
    k3 = k3_phase(ctx)
    print(f"[smoke] {cell} K3 blend_obs: {json.dumps(k3)}")
    return {"blend_fwd": k1, "blend_bwd": k2, "blend_obs": k3,
            **preprocess_phase(cell, g, cam, deg)}


def build_train_scene(root: Path, n: int, width: int, height: int,
                      views: int, seed: int) -> Path:
    """bench_train.py's layout as a COLMAP scene: n points uniform in its
    box with uniform colors, `views` cameras on a ring of radius 4 at height
    0.8 looking at the origin, focal 1.1 x width, seeded noise GT images."""
    from PIL import Image

    from gs2m_tpu_torch.data import colmap as cm

    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-1.6, 1.6, n), rng.uniform(-1.2, 1.2, n),
                    rng.uniform(-1.0, 1.0, n)], -1)
    cols = rng.uniform(0.1, 0.9, (n, 3))
    scene = root / "train_scene"
    for d in (scene / "sparse" / "0", scene / "images"):
        d.mkdir(parents=True)
    fx = 1.1 * width
    cams = {1: cm.ColmapCamera(1, "PINHOLE", width, height,
                               np.array([fx, fx, width / 2, height / 2]))}
    imgs = {}
    for i in range(views):
        th = 2 * np.pi * i / views
        R, T = look_at(np.array([4 * np.sin(th), 0.8, -4 * np.cos(th)]),
                       np.zeros(3))
        name = f"view_{i:03d}.png"
        imgs[i + 1] = cm.ColmapImage(i + 1, cm.rotmat_to_qvec(R.T), T, 1, name)
        Image.fromarray(rng.integers(0, 256, (height, width, 3),
                                     dtype=np.uint8)).save(scene / "images" / name)
    cm.write_cameras_binary(str(scene / "sparse/0/cameras.bin"), cams)
    cm.write_images_binary(str(scene / "sparse/0/images.bin"), imgs)
    cm.write_points3d_binary(str(scene / "sparse/0/points3D.bin"), pts,
                             cols * 255)
    return scene


def profile_call(label: str, fn, wall_ms: float) -> dict:
    """Where one call's time goes: device time by kernel (torch.profiler
    over one warm call), and the device's idle share against `wall_ms`, the
    unprofiled CUDA-event time of the same call (the profiler's own overhead
    stretches its wall, so its idle share is printed only beside it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gs2m_tpu_torch.apps.train import profile_summary

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    s = profile_summary(prof, prof_wall_ms, top=15)
    busy_ms = s["busy_ms"]
    print(f"[smoke] {label} profile: device busy {busy_ms:.2f} ms; idle share "
          f"{1 - busy_ms / wall_ms:.3f} of the unprofiled {wall_ms:.2f} ms "
          f"(under the profiler: wall {prof_wall_ms:.2f} ms, idle share "
          f"{s['idle_share']:.3f}); {s['launches']} kernel launches")
    if s["stages"]:
        print(f"[smoke] {label} device ms by stage (the trainer's profiler "
              f"ranges): " + ", ".join(f"{k} {v:.3f}"
                                       for k, v in s["stages"].items()))
    for k in s["kernels"]:
        print(f"[smoke]   {k['ms']:8.3f} ms {k['count']:4d}x  {k['name'][:70]}")
    return {"busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms}


def trim_phase(trainer, card: str) -> None:
    """The trim's observe counter (train/trainer.py::make_observe_counter)
    over the train views on the trained Gaussians: its median wall (CUDA
    events, 5 calls after a warm-up), a profile of one call, and one call
    split into count_observed's stages (projection, binning, the geometry
    gather, K3, the observe scatter), each view's stages bracketed by CUDA
    events and summed over the views."""
    import torch

    from gs2m_tpu_torch.ops import blend
    from gs2m_tpu_torch.ops.binning import bin_gaussians, num_tiles
    from gs2m_tpu_torch.ops.projection import project
    from gs2m_tpu_torch.train.trainer import make_observe_counter

    g, pipe, cap = trainer.gaussians, trainer.pipe, trainer.instance_cap
    cams = trainer.scene.train_cameras
    counter = make_observe_counter(trainer.scene, pipe, cap)
    counts, _ = counter(g)
    ms = time_ms(lambda: counter(g), 5)
    print(f"[smoke] trim counter: {ms:.3f} ms for {len(cams)} views (median "
          f"of 5, CUDA events) on {card}")
    profile_call("trim counter", lambda: counter(g), ms)

    names = ("projection", "binning", "gather", "K3", "scatter")
    split = dict.fromkeys(names, 0.0)
    again = torch.zeros_like(counts)
    with torch.no_grad():
        for cam in cams:
            H, W = cam.height, cam.width
            grid_y, grid_x = num_tiles(H, W, pipe.tile)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            ev[0].record()
            op = g.get_opacity[:, 0]
            proj = project(g, cam, 0, op, tile=pipe.tile, with_colors=False)
            ev[1].record()
            b = bin_gaussians(proj, H, W, pipe.tile, cap, pipe.chunk,
                              opacities=op)
            ev[2].record()
            geom = blend.gather_geom(proj.means2d, proj.conics, op, b.gid,
                                     b.is_null)
            ev[3].record()
            obs = blend.blend_obs(geom, b.chunk_tile, T=grid_y * grid_x,
                                  grid_x=grid_x, width=W, height=H,
                                  tile=pipe.tile, chunk=pipe.chunk)
            ev[4].record()
            observe = blend._observe_counts(obs, b, proj.means2d.shape[0])
            again += (observe > 0).to(torch.int32)
            ev[5].record()
            ev[5].synchronize()
            for i, name in enumerate(names):
                split[name] += ev[i].elapsed_time(ev[i + 1])
    if not torch.equal(again, counts):
        fail("the trim's stages, run one by one, do not give its counts")
    print(f"[smoke] trim counter by stage, one call ({len(cams)} views, CUDA "
          f"events; the stream's time between stage boundaries, host gaps "
          f"included): " + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items()))


def training_state(trainer) -> dict:
    """Every tensor a train step reads or writes, copied: the parameters,
    their Adam moments, the densify statistics, the light and its moments
    (material stage), and the last loss."""
    import dataclasses

    state = {f"param/{k}": v.clone()
             for k, v in trainer.gaussians.params_dict().items()}
    state["alive"] = trainer.gaussians.alive.clone()
    for k in trainer.opt_state.mu:
        state[f"mu/{k}"] = trainer.opt_state.mu[k].clone()
        state[f"nu/{k}"] = trainer.opt_state.nu[k].clone()
    for f in dataclasses.fields(trainer.stats):
        state[f"stats/{f.name}"] = getattr(trainer.stats, f.name).clone()
    if trainer.light_state is not None:
        state["light"] = trainer.light_state.clone()
        state["light/mu"] = trainer.light_opt_state.mu["light"].clone()
        state["light/nu"] = trainer.light_opt_state.nu["light"].clone()
    if trainer.last_metrics is not None:
        state["loss"] = trainer.last_metrics["loss"].clone()
    return state


def differing(a: dict, b: dict) -> list:
    """The keys of two training_state dicts whose tensors are not bit-equal."""
    import torch
    return sorted(k for k in a.keys() | b.keys()
                  if k not in a or k not in b or not torch.equal(a[k], b[k]))


def snapshot(trainer) -> dict:
    """The trainer's whole step state, copied in memory (no checkpoint
    file), for restore()."""
    import copy
    return {"tensors": copy.deepcopy((trainer.gaussians, trainer.opt_state,
                                      trainer.stats, trainer.light_state,
                                      trainer.light_opt_state,
                                      trainer._dropped_window)),
            "generator": trainer.generator.get_state(),
            "replica_generator": trainer.replica_generator.get_state(),
            "rng": copy.deepcopy(trainer.rng.bit_generator.state),
            "scalars": (trainer.iteration, trainer.active_sh_degree,
                        list(trainer._view_pool), trainer.mv_active_count,
                        trainer.rough_active_count, trainer.instance_cap)}


def restore(trainer, snap: dict) -> None:
    import copy
    (trainer.gaussians, trainer.opt_state, trainer.stats, trainer.light_state,
     trainer.light_opt_state,
     trainer._dropped_window) = copy.deepcopy(snap["tensors"])
    trainer.generator.set_state(snap["generator"])
    trainer.replica_generator.set_state(snap["replica_generator"])
    trainer.rng.bit_generator.state = copy.deepcopy(snap["rng"])
    (trainer.iteration, trainer.active_sh_degree, pool, trainer.mv_active_count,
     trainer.rough_active_count, trainer.instance_cap) = snap["scalars"]
    trainer._view_pool = list(pool)


def determinism_phase(trainer, label: str, steps: int = 2) -> None:
    """Two runs of the same `steps` train steps from one state must end bit
    for bit equal; then one step under torch's deterministic-algorithms
    mode with warn_only, whose warnings name each op on the step's path
    that has no deterministic implementation. The trainer ends where the
    first run ended."""
    import warnings

    import torch

    snap = snapshot(trainer)
    runs = []
    for _ in range(2):
        restore(trainer, snap)
        for _ in range(steps):
            trainer.train_step()
        torch.cuda.synchronize()
        runs.append(training_state(trainer))
    bad = differing(*runs)
    restore(trainer, snap)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            trainer.train_step()
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    named = sorted({str(w.message).split("\n")[0][:160] for w in caught
                    if "determinis" in str(w.message)})
    restore(trainer, snap)
    for _ in range(steps):
        trainer.train_step()
    print(f"[smoke] {label} determinism: {steps} steps run twice from one "
          f"state at iteration {snap['scalars'][0]}: {len(runs[0])} tensors, "
          f"{len(bad)} differ {bad[:8]}; ops without a deterministic "
          f"implementation on the step (warn_only): {named or 'none'}")
    if bad:
        fail(f"{label}: two runs of the same steps differ in {bad}")


@contextlib.contextmanager
def gate_probe():
    """While the quality gate runs: keeps its trainer (the train app's
    return) and counts the renders its stages make outside the train steps
    (the GT builder's rasterize_from_projected, the evaluations' and the
    render app's render), with those that overflowed their instance cap and
    so were rendered again (the GT builder's apart too). Those stages look
    the names up when they run; the train steps bind render when
    train/trainer.py is imported (here, before the patch) and are counted
    from the schedule."""
    import gs2m_tpu_torch.train.trainer  # noqa: F401  (binds the real render)
    from gs2m_tpu_torch.apps import train as train_app
    from gs2m_tpu_torch.models import render as render_mod
    from gs2m_tpu_torch.ops import rasterize

    probe = {"trainer": None, "renders": 0, "overflows": 0,
             "gt_overflows": 0}
    saved = (train_app.main, render_mod.render,
             rasterize.rasterize_from_projected)

    def counted(fn, dropped, own=None):
        def call(*args, **kw):
            out = fn(*args, **kw)
            over = int(dropped(out) > 0)
            probe["renders"] += 1
            probe["overflows"] += over
            if own:
                probe[own] += over
            return out
        return call

    def train_main(argv=None):
        probe["trainer"] = saved[0](argv)
        return probe["trainer"]

    train_app.main = train_main
    render_mod.render = counted(saved[1], lambda pkg: int(pkg["dropped"]))
    rasterize.rasterize_from_projected = counted(
        saved[2], lambda out: int(out.dropped), "gt_overflows")
    try:
        yield probe
    finally:
        (train_app.main, render_mod.render,
         rasterize.rasterize_from_projected) = saved


def quality_path(q_out: Path, card: str, gate_flags=()):
    """The quality gate at the JAX package's smoke scale, through
    apps.quality_gate.main, held to its limits and to the launches its
    schedule implies; returns (its result, its trainer, the launches, the
    AdamTap that kept its last update)."""
    from gs2m_tpu_torch.apps import quality_gate
    from gs2m_tpu_torch.ops import blend

    blend.LAUNCHES.clear()
    t0 = time.perf_counter()
    with gate_probe() as probe, AdamTap("quality-smoke",
                                        {"xyz": QUALITY_EVALS[-1]}) as tap:
        q = quality_gate.main(["--out", str(q_out), "--production",
                               "--smoke", *gate_flags])
    q_wall = time.perf_counter() - t0
    q_launches = blend.launch_counts()
    gate = probe["trainer"]
    test = next(iter(q["metrics_test"].values()), {})
    # What the gate's schedule launches: K1 once per GT view, once per
    # warmup step and twice per geometry step (the view and its nearest),
    # once per evaluated view (the first five train views and every test
    # view at each test iteration) and once per view of the render app's
    # two splits, plus one re-render per overflow; K2 once per step and
    # once more where the multi-view loss was active; K3 over every train
    # view at each trim (every 1,000 iterations).
    n_train = len(gate.scene.train_cameras)
    n_test = len(gate.scene.test_cameras)
    it, opt = gate.iteration, gate.opt
    n_geo = max(0, it - opt.geometry_from_iter)
    n_trims = sum(1 for k in range(1000, it + 1, 1000)
                  if opt.use_multi_view_trim and k < opt.densify_until_iter)
    want_q = {"blend_fwd": (q["views"] + it + n_geo
                            + len(QUALITY_EVALS) * (min(EVAL_VIEWS, n_train)
                                                    + n_test)
                            + n_train + n_test + probe["overflows"]),
              "blend_bwd": it + gate.mv_active_count,
              "blend_obs": n_trims * n_train}
    # The preprocess pair: forward once per render() and per trim view (every
    # K1 and K3 launch but the GT builder's, which projects through the eager
    # chain), backward once per differentiated render (each K2 launch).
    want_q["preprocess_fwd"] = (want_q["blend_fwd"] - q["views"]
                                - probe["gt_overflows"] + want_q["blend_obs"])
    want_q["preprocess_bwd"] = want_q["blend_bwd"]
    want_q["adam"] = it    # one update a step (csrc/adam.cu)
    # The backward's reduce pair once per K2 launch.
    want_q["instance_rows"] = want_q["instance_sum"] = want_q["blend_bwd"]
    print(f"[smoke] quality gate: {json.dumps(q)}")
    print(f"[smoke] quality gate (smoke scale): chamfer "
          f"{q['chamfer']['chamfer_mean']:.5f} (limit {CHAMFER_MAX}), test "
          f"PSNR {test.get('PSNR')} (limit {TEST_PSNR_MIN}), SSIM "
          f"{test.get('SSIM')}; train {q['train_minutes']} min, whole gate "
          f"{q_wall:.1f} s; {probe['renders']} renders outside the steps "
          f"({probe['overflows']} overflowed); launches {q_launches} "
          f"(expected {want_q}) on {card}")
    numbers = [*q["chamfer"].values(), test.get("PSNR"), test.get("SSIM")]
    if not all(x is not None and np.isfinite(x) for x in numbers):
        fail(f"quality gate: non-finite or missing numbers {numbers}")
    if q["chamfer"]["chamfer_mean"] > CHAMFER_MAX or test["PSNR"] < TEST_PSNR_MIN:
        fail("quality gate: chamfer or test PSNR outside its limit")
    evals = [i for i, _ in q["test_psnr_trajectory"]]
    q_ckpts = [q_out / "model" / "checkpoints" / f"ckp{i}.pkl"
               for i in QUALITY_EVALS]
    if (it != QUALITY_EVALS[-1] or evals != list(QUALITY_EVALS)
            or not all(c.is_file() for c in q_ckpts)):
        fail(f"quality gate: iteration {it}, evaluations at {evals}, "
             f"checkpoints {[c.name for c in q_ckpts if c.is_file()]}")
    if q_launches != want_q:
        fail(f"quality gate launches {q_launches}, expected {want_q}")
    return q, gate, q_launches, tap


def material_path(root: Path, train_dir: Path, argv: list, card: str, dev):
    """The material cell: the train app with DTU's material flags on the
    train scene (all-255 masks added), its checkpoint resume held bit for
    bit, its launches by value width, the determinism check, material
    steps timed and profiled (device time by stage), the render app on the
    model, and K1 and K2 at V=16 against their plain versions at the step's
    shapes.
    Returns (the kernel reports, the path's launches by kernel at V=16)."""
    import torch
    from PIL import Image

    from gs2m_tpu_torch.apps import render as render_app
    from gs2m_tpu_torch.apps import train as train_app
    from gs2m_tpu_torch.ops import blend

    masks = train_dir / "masks"
    masks.mkdir(exist_ok=True)
    full = np.full((TRAIN_H, TRAIN_W), 255, np.uint8)
    for img in sorted((train_dir / "images").iterdir()):
        Image.fromarray(full).save(masks / img.name)
    mat_argv = argv + list(MATERIAL_FLAGS)
    model = root / "material_model"
    blend.LAUNCHES.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    n_warm, n_mat = GEOMETRY_FROM, TRAIN_ITERS - GEOMETRY_FROM
    # The last update of the Gaussians and of the light is kept for the
    # kernel against the eager loop (its clones count in app_peak).
    with AdamTap("train-material", {"xyz": TRAIN_ITERS,
                                    "light": n_mat}) as tap:
        mt = train_app.main(mat_argv + ["-m", str(model),
                                        "--checkpoint_iterations",
                                        str(CHECKPOINTS[0]),
                                        "--profile_iterations",
                                        *map(str, PROFILE)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    app_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = dict(blend.LAUNCHES)
    # Warmup: K1 and K2 at V=8 once a step. Material steps: K1 at V=16 for
    # the view and its nearest, K1 at V=8 for the nearby view when the view
    # has one (the roughness term; skipped otherwise), K2 at V=16 for the
    # view and, where the multi-view term fired, its nearest. The evaluation
    # at the end renders the first five views at V=16.
    want = {("blend_fwd", 8): n_warm + mt.rough_active_count,
            ("blend_fwd", 16): 2 * n_mat + EVAL_VIEWS,
            ("blend_bwd", 8): n_warm,
            ("blend_bwd", 16): n_mat + mt.mv_active_count}
    # The preprocess pair once per render and once per differentiated one.
    want["preprocess_fwd", 0] = (want["blend_fwd", 8]
                                 + want["blend_fwd", 16])
    want["preprocess_bwd", 0] = want["blend_bwd", 8] + want["blend_bwd", 16]
    # The backward's reduce pair once per K2 launch, at K2's width.
    for V in (8, 16):
        want["instance_rows", V] = want["instance_sum", V] = want["blend_bwd", V]
    # Adam once a step, and once more for the light in a material step.
    want["adam", 0] = n_warm + 2 * n_mat
    m = mt.last_metrics
    light0 = mt.pbr_fns["init_light"]()
    print(f"[smoke] material train app: {TRAIN_ITERS} iterations ({n_warm} "
          f"warmup, {n_mat} geometry + material, cubemap "
          f"{mt.light_state.shape[1]}) in {wall:.1f} s; last loss "
          f"{float(m['loss']):.5f}, Lmat {float(m['Lmat']):.5f}; eval "
          f"{mt.last_eval}; rough_active {mt.rough_active_count}, mv_active "
          f"{mt.mv_active_count}; light min {float(mt.light_state.min()):.4f}, "
          f"mean |change| {float((mt.light_state - light0).abs().mean()):.5f}; "
          f"launches {launches} (expected {want}); peak memory "
          f"{app_peak:.2f} GiB on {card}")
    if not (np.isfinite(float(m["loss"])) and float(m["Lmat"]) > 0):
        fail(f"material train app: loss {float(m['loss'])}, Lmat "
             f"{float(m['Lmat'])}")
    if not (float(mt.light_state.min()) >= 0
            and bool((mt.light_state != light0).any())):
        fail("material train app: the light did not change or went below 0")
    if launches != want:
        fail(f"material path launches {launches}, expected {want}")
    snap = model / "point_cloud" / f"iteration_{TRAIN_ITERS}"
    if not (snap / "lighting.pkl").is_file() or "psnr_pbr" not in mt.last_eval:
        fail("material train app: no lighting.pkl or no PBR evaluation")
    summary = model / "profile" / f"summary_{PROFILE[0]}_{PROFILE[1]}.json"
    print(f"[smoke] material train app profile {PROFILE[0]}..{PROFILE[1]}: "
          f"{summary.read_text()[:1500]}")

    ckpt = model / "checkpoints" / f"ckp{CHECKPOINTS[0]}.pkl"
    t0 = time.perf_counter()
    resumed = train_app.main(mat_argv + ["-m", str(root / "material_resumed"),
                                         "--start_checkpoint", str(ckpt)])
    bad = differing(training_state(resumed), training_state(mt))
    print(f"[smoke] material resume from {ckpt.name} ({ckpt.stat().st_size} "
          f"bytes) to {resumed.iteration} in {time.perf_counter() - t0:.1f} "
          f"s: last loss {float(resumed.last_metrics['loss'])!r} "
          f"(uninterrupted {float(m['loss'])!r}); tensors not bit-equal: {bad}")
    if bad:
        fail(f"material resume is not bit-equal to the uninterrupted run in "
             f"{bad}")
    del resumed
    determinism_phase(mt, "train-material")

    def material_step():
        view, nearest, has_n, nearby, has_nb = mt.choose_views(True)
        (mt.gaussians, mt.opt_state, mt.stats, out) = mt._get_step(True, True)(
            mt.gaussians, mt.opt_state, mt.stats, view, nearest, has_n,
            mt.iteration, mt.active_sh_degree, mt.generator,
            light=mt.light_state, light_opt_state=mt.light_opt_state,
            nearby_idx=nearby, has_nearby=has_nb)
        return out

    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(material_step, 10)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[smoke] material step at {TRAIN_W}x{TRAIN_H}, "
          f"{mt.gaussians.num_alive} Gaussians, cubemap "
          f"{mt.light_state.shape[1]}: {step_ms:.2f} ms/step (median of 10, "
          f"CUDA events) on {card}; peak memory {peak:.2f} GiB")
    profile_call("material step", material_step, step_ms)

    blend.LAUNCHES.clear()
    t0 = time.perf_counter()
    out = render_app.main(["-m", str(model), "-s", str(train_dir)])
    r_wall = time.perf_counter() - t0
    r_launches = dict(blend.LAUNCHES)
    stats = out["views"]
    base = model / "train" / f"ours_{TRAIN_ITERS}"
    for kind in ("render", "albedo", "roughness", "metallic", "diffuse",
                 "specular"):
        files = sorted((base / kind).iterdir())
        if len(files) != TRAIN_VIEWS or Image.open(files[0]).size != (TRAIN_W,
                                                                      TRAIN_H):
            fail(f"material render app: {kind} has {len(files)} files")
    if not (base / "envmap.png").is_file() or not all(
            s["finite"] and s["dropped"] == 0 for s in stats):
        fail("material render app: no envmap.png, or a view dropped or was "
             "not finite")
    print(f"[smoke] material render app: {TRAIN_VIEWS} views in {r_wall:.2f} "
          f"s (PBR renders, material maps, envmap.png); render ms/view "
          f"{[round(s['render_s'] * 1e3, 2) for s in stats]}; export ms/view "
          f"{[round(s['export_s'] * 1e3, 1) for s in stats]}; launches "
          f"{r_launches}")

    # K1 and K2 at V=16 at the material step's shapes: the trained
    # Gaussians on view 0, feature count 9, the trainer's chunk and cap.
    k1, ctx = kernel_phase(mt.gaussians, mt.scene.train_cameras[0],
                           mt.pipe.chunk, mt.instance_cap, 9)
    print(f"[smoke] train-material K1 blend_fwd: {json.dumps(k1)}")
    k2 = k2_phase(ctx)
    print(f"[smoke] train-material K2 blend_bwd: {json.dumps(k2)}")
    if k1["V"] != 16 or k2["V"] != 16:
        fail(f"train-material kernels at V={k1['V']}/{k2['V']}, not 16")
    pre = preprocess_phase("train-material", mt.gaussians,
                           mt.scene.train_cameras[0], mt.active_sh_degree)
    return ({"blend_fwd": k1, "blend_bwd": k2, **pre, "adam": tap.reports()},
            {"blend_fwd": launches["blend_fwd", 16],
             "blend_bwd": launches["blend_bwd", 16],
             "preprocess_fwd": launches["preprocess_fwd", 0],
             "preprocess_bwd": launches["preprocess_bwd", 0],
             "adam": launches["adam", 0],
             "instance_sum": launches["instance_sum", 16]})


def material_gate_path(out: Path, card: str) -> dict:
    """apps.material_gate --smoke, held to finite losses, a roughness term
    that fired, a light that changed and stays >= 0, and a finite PBR test
    PSNR. Not held to `pass`: the JAX gate never completed, so there is no
    reference number at this scale."""
    from gs2m_tpu_torch.apps import material_gate

    t0 = time.perf_counter()
    res = material_gate.main(["--out", str(out), "--smoke"])
    wall = time.perf_counter() - t0
    psnr_pbr = [v for _, v in res["test_psnr_pbr_trajectory"]]
    print(f"[smoke] material gate (smoke scale, {wall:.1f} s): "
          f"{json.dumps(res)} on {card}")
    if not res["losses_finite"] or not np.isfinite(res["final_loss"]):
        fail("material gate: non-finite losses")
    if not res["rough_active_steps"]:
        fail("material gate: the roughness term never fired")
    if not (res["light"]["min"] >= 0 and res["light"]["mean_abs_change"] > 0):
        fail(f"material gate: light {res['light']}")
    if not psnr_pbr or not np.isfinite(psnr_pbr[-1]):
        fail(f"material gate: PBR test PSNR {psnr_pbr}")
    return res


# The dp-train cell: two ranks of the train app on the one card.
DP_RANKS, DP_TIMEOUT = 2, 600
DP_DENSIFY_EVERY = 10


def dp_argv(train_dir: Path, model: Path) -> list:
    """The dp-train cell's train app flags: train-full's scene and schedule
    (5 warmup and 15 geometry iterations), densification at 10 and 20, no
    evaluation (every rank launches the same kernels), each rank drawing
    from its own view partition."""
    return ["-s", str(train_dir), "-m", str(model), "-r", "1",
            "--iterations", str(TRAIN_ITERS),
            "--geometry_from_iter", str(GEOMETRY_FROM),
            "--densify_from_iter", str(DENSIFY_FROM),
            "--densification_interval", str(DP_DENSIFY_EVERY),
            "--test_iterations", str(TRAIN_ITERS + 1),
            "--save_iterations", str(TRAIN_ITERS),
            "--multi_view_max_angle", "179", "--multi_view_max_dist", "100",
            "--nearby_cam_max_angle", "179", "--nearby_cam_max_dist", "100",
            "--quiet", "--data_parallel", "--distributed"]


def dp_configs(train_dir: Path):
    """The configs the train app builds from dp_argv (model path empty)."""
    from gs2m_tpu_torch.core.config import (ModelConfig, OptimConfig,
                                            PipelineConfig)
    opt = OptimConfig(iterations=TRAIN_ITERS, geometry_from_iter=GEOMETRY_FROM,
                      densify_from_iter=DENSIFY_FROM,
                      densification_interval=DP_DENSIFY_EVERY,
                      multi_view_max_angle=179.0, multi_view_max_dist=100.0,
                      nearby_cam_max_angle=179.0, nearby_cam_max_dist=100.0)
    return (ModelConfig(source_path=str(train_dir), resolution=1),
            PipelineConfig(), opt)


def digest(t) -> str:
    import hashlib
    return hashlib.sha256(t.detach().cpu().contiguous().numpy()
                          .tobytes()).hexdigest()[:20]


def grads_digest(grads: dict) -> str:
    import hashlib
    h = hashlib.sha256()
    for k in sorted(grads):
        h.update(grads[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:20]


def dp_worker(rank: int, out: Path, train_dir: Path, full: bool) -> None:
    """One rank of the dp-train cell (spawned by dp_path with torchrun's
    environment): with `full`, first the first step's reduced gradient (a
    digest, with the rank's view), then the train app with --data_parallel
    --distributed; the digests of its replicated state and its launches;
    with `full`, DP steps timed, the all-reduces timed on buffers of the
    step's sizes and, on rank 0 after the group is gone, K1 and K2 at the
    cell's shapes against their plain versions."""
    import torch
    import torch.distributed as dist

    from gs2m_tpu_torch.apps import train as train_app
    from gs2m_tpu_torch.ops import blend
    from gs2m_tpu_torch.parallel.dp import (all_reduce_, join_process_group,
                                            make_reducer)
    from gs2m_tpu_torch.train.trainer import Trainer, make_train_step

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a card")
    proc = join_process_group("cuda", timeout_s=300)
    report = {"rank": rank, "backend": proc.backend, "device": str(proc.device)}
    mc, pipe, opt = dp_configs(train_dir)
    if full:
        # The first step's reduced gradient, from the trainer's initial state
        # (the app's) on this rank's first view.
        scene = train_app.load_scene(mc, opt, proc.device, proc, True)
        tr = Trainer(mc, pipe, opt, scene, data_parallel=True,
                     distributed=True)
        view, nearest, has, _, _ = tr.draw_batch(False)
        reducer, kept = make_reducer(), {}

        def reduce(*args):
            out_ = reducer(*args)
            kept["grads"] = out_[0]
            return out_

        make_train_step(mc, pipe, opt, scene, tr.instance_cap, False,
                        reduce=reduce)(tr.gaussians, tr.opt_state, tr.stats,
                                       view, nearest, has, 1, 0, tr.generator)
        report["first_step"] = {"view": view, "grad_digest": grads_digest(
            kept["grads"]), "instance_cap": tr.instance_cap}
        del tr, scene, kept
        torch.cuda.empty_cache()

    blend.LAUNCHES.clear()
    t0 = time.perf_counter()
    # Rank 0's last update is kept for the kernel against the eager loop.
    keep = {"xyz": TRAIN_ITERS} if full and rank == 0 else {}
    with AdamTap("dp-train", keep) as tap:
        trainer = train_app.main(dp_argv(train_dir, out / "model"))
    torch.cuda.synchronize()
    report["app_s"] = time.perf_counter() - t0
    report["launches"] = blend.launch_counts()
    report["mv_active"] = trainer.mv_active_count
    report["densify"] = trainer.last_densify_info
    report["alive"] = trainer.gaussians.num_alive
    report["loss"] = float(trainer.last_metrics["loss"])
    report["loaded_views"] = (None if trainer.scene.loaded_views is None
                              else sorted(trainer.scene.loaded_views))
    report["digests"] = {k: digest(v)
                         for k, v in training_state(trainer).items()}
    if full:
        step = trainer._get_step(True)

        def dp_step():
            v, n, has, _, _ = trainer.draw_batch(False)
            (trainer.gaussians, trainer.opt_state, trainer.stats,
             out_) = step(trainer.gaussians, trainer.opt_state, trainer.stats,
                          v, n, has, trainer.iteration,
                          trainer.active_sh_degree, trainer.generator)
            return out_

        report["dp_step_ms"] = time_ms(dp_step, 3)
        C = trainer.gaussians.capacity
        n_sum = sum(p.numel() for p in trainer.gaussians.params_dict().values())
        n_sum += 3 * C + 7       # three statistics rows and the metrics
        flat = torch.zeros(n_sum, device=proc.device)
        radii = torch.zeros(C, device=proc.device)
        host = torch.zeros(n_sum, pin_memory=proc.device.type == "cuda")

        def wall_ms(fn, runs=3):
            fn()
            ts = []
            for _ in range(runs):
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t) * 1e3)
            return float(np.median(ts))

        report["allreduce_sum_ms"] = wall_ms(lambda: all_reduce_(flat))
        report["allreduce_max_ms"] = wall_ms(
            lambda: all_reduce_(radii, dist.ReduceOp.MAX))
        report["host_allreduce_ms"] = wall_ms(lambda: dist.all_reduce(host))
        report["bytes_per_step"] = 4 * (n_sum + C)
        report["capacity"] = C
    if proc.created:
        dist.destroy_process_group()
    if full and rank == 0:
        report["kernels"] = kernel_phases(
            "dp-train", trainer.gaussians, trainer.scene.train_cameras[0],
            trainer.pipe.chunk, trainer.instance_cap, 5,
            trainer.active_sh_degree)
        report["kernels"]["adam"] = tap.reports()
    (out / f"rank{rank}.json").write_text(json.dumps(report))
    print(f"[smoke] dp worker {rank} done", flush=True)


def dp_run(root: Path, train_dir: Path, full: bool) -> list:
    """Two ranks of dp_worker as subprocesses on the one card (gloo: NCCL
    refuses two ranks on one device), each with a timeout; returns their
    reports."""
    import socket

    out = root / ("dp_full" if full else "dp_again")
    out.mkdir(parents=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs, logs = [], []
    for r in range(DP_RANKS):
        env = dict(os.environ, WORLD_SIZE=str(DP_RANKS), RANK=str(r),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(DP_RANKS),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        logs.append(open(out / f"rank{r}.log", "w+"))
        procs.append(subprocess.Popen(
            [sys.executable, str(HERE / "chip_smoke.py"), "--dp-worker",
             str(r), "--dp-out", str(out), "--dp-scene", str(train_dir)]
            + (["--dp-full"] if full else []),
            cwd=HERE, env=env, stdout=logs[r], stderr=subprocess.STDOUT,
            text=True))
    deadline = time.monotonic() + DP_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, f) in enumerate(zip(procs, logs)):
        f.seek(0)
        text = f.read()
        f.close()
        if p.returncode != 0:
            fail(f"dp-train rank {r} exited with {p.returncode}:\n"
                 f"{text[-3000:]}")
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(DP_RANKS)]


def one_process_mean_digest(train_dir: Path, first_steps: list, dev) -> str:
    """The digest of the mean of the ranks' first-step gradients computed
    one after the other in this process, from the same initial state."""
    from gs2m_tpu_torch.data.scene import Scene
    from gs2m_tpu_torch.train.trainer import Trainer, make_train_step

    mc, pipe, opt = dp_configs(train_dir)
    scene = Scene(mc, opt, device=dev)
    grads = []
    for fs in first_steps:
        tr = Trainer(mc, pipe, opt, scene)
        if tr.instance_cap != fs["instance_cap"]:
            fail(f"dp-train: instance cap {tr.instance_cap} here, "
                 f"{fs['instance_cap']} on the ranks")
        kept = {}

        def keep(g, light, contrib, metrics):
            kept["grads"] = g
            return g, light, contrib, metrics

        make_train_step(mc, pipe, opt, scene, tr.instance_cap, False,
                        reduce=keep)(tr.gaussians, tr.opt_state, tr.stats,
                                     fs["view"], fs["view"], False, 1, 0,
                                     tr.generator)
        grads.append(kept["grads"])
        del tr
    n = len(grads)
    return grads_digest({k: sum(g[k] for g in grads) / n for k in grads[0]})


def dp_path(root: Path, train_dir: Path, card: str, dev, geo_ms: float):
    """The dp-train cell: two ranks of the train app (--data_parallel
    --distributed) on the one card, twice. Fails unless both ranks end
    bit-equal (parameters, Adam moments, statistics, alive mask, loss), the
    second run equals the first, the first step's reduced gradient equals
    the one-process mean of the two views' gradients bit for bit, and each
    rank's K1 and K2 launches are what the schedule implies. Returns
    (rank 0's kernel reports, its launches)."""
    t0 = time.perf_counter()
    first = dp_run(root, train_dir, True)
    again = dp_run(root, train_dir, False)
    wall = time.perf_counter() - t0
    r0 = first[0]
    n_warm, n_geo = GEOMETRY_FROM, TRAIN_ITERS - GEOMETRY_FROM
    # Per rank: K1 once per warmup step and twice per geometry step (the
    # view and its nearest), K2 once per step and once more where the
    # multi-view term fired (mv_active counts both ranks' steps).
    want = {"blend_fwd": n_warm + 2 * n_geo,
            "blend_bwd": n_warm + n_geo + r0["mv_active"] // DP_RANKS,
            "blend_obs": 0}
    # The preprocess pair once per render and once per differentiated one.
    want["preprocess_fwd"] = want["blend_fwd"]
    want["preprocess_bwd"] = want["blend_bwd"]
    want["adam"] = TRAIN_ITERS    # one update a step
    want["instance_rows"] = want["instance_sum"] = want["blend_bwd"]
    mean = one_process_mean_digest(train_dir, [r["first_step"] for r in first],
                                   dev)
    print(f"[smoke] dp-train: {DP_RANKS} ranks ({r0['backend']}, "
          f"{r0['device']}) of the train app, {TRAIN_ITERS} iterations "
          f"({n_warm} warmup, {n_geo} geometry, densify "
          f"{r0['densify']}), twice, in {wall:.1f} s; app {r0['app_s']:.1f} "
          f"s; last loss {r0['loss']!r}, alive {r0['alive']}, mv_active "
          f"{r0['mv_active']}, views loaded {r0['loaded_views']}; launches "
          f"per rank {[r['launches'] for r in first]} (expected {want}); "
          f"first-step views {[r['first_step']['view'] for r in first]}, "
          f"reduced grad {r0['first_step']['grad_digest']} vs one-process "
          f"mean {mean}")
    print(f"[smoke] dp-train step at {TRAIN_W}x{TRAIN_H}, capacity "
          f"{r0['capacity']}: {r0['dp_step_ms']:.2f} ms/step on rank 0 (rank "
          f"1 {first[1]['dp_step_ms']:.2f}; median of 3, CUDA events; one "
          f"process's geometry step {geo_ms:.2f} ms); all-reduce of "
          f"{r0['bytes_per_step']} bytes per step: sum "
          f"{r0['allreduce_sum_ms']:.2f} ms + max {r0['allreduce_max_ms']:.2f}"
          f" ms (staged through pinned host memory; the sum's gloo part "
          f"alone {r0['host_allreduce_ms']:.2f} ms), "
          f"{(r0['allreduce_sum_ms'] + r0['allreduce_max_ms']) / r0['dp_step_ms']:.3f}"
          f" of the step (host clock around synchronized calls, median of "
          f"3), on {card}")
    bad = sorted(k for k in r0["digests"]
                 if any(r["digests"].get(k) != r0["digests"][k]
                        for r in first[1:] + again))
    if bad or any(r["digests"].keys() != r0["digests"].keys()
                  for r in first + again):
        fail(f"dp-train: the ranks' or the runs' states differ in {bad}")
    if r0["first_step"]["grad_digest"] != mean:
        fail("dp-train: the first step's reduced gradient is not the "
             "one-process mean of the two views' gradients")
    if any(r["launches"] != want for r in first + again):
        fail(f"dp-train launches {[r['launches'] for r in first + again]}, "
             f"expected {want} per rank")
    if r0["densify"] is None or not np.isfinite(r0["loss"]):
        fail(f"dp-train: densify {r0['densify']}, loss {r0['loss']}")
    return r0["kernels"], r0["launches"]


# The sp cells: render-full's Gaussians in 4 bands on the one card.
SP_BANDS = 4


def k1_gate(a, b) -> tuple:
    """(share of entries off by > 1e-5, max |a - b|): K1's gate is a share
    of at most 1e-4."""
    d = (a - b).abs()
    return float((d > 1e-5).float().mean()), float(d.max())


def sp_path(g, cam, scene_dir: Path, model_dir: Path, full_cap: int,
            card: str, dev, render_ms: float):
    """The sp-render and sp-grad cells: render-full's view 0 in 4 bands
    against the full frame (color, buffer and final T at K1's gate; observe
    counts and radii compared), the render app with --spatial 4 over the 4
    views against the full-frame app's PNGs (1 LSB), the band-sharded
    geometry gradient against the one-card assembly of the same terms
    (loss at rtol 1e-5, per-Gaussian gradients at utils/grad_gate's
    tolerances), then K1 (render) and K1 + K2 (gradient) at one band's
    shapes against their plain versions. Returns (kernel reports, launches)
    by cell."""
    import torch
    from PIL import Image

    from gs2m_tpu_torch.apps import render as render_app
    from gs2m_tpu_torch.models import losses as L
    from gs2m_tpu_torch.models.render import derive_render_pkg, render
    from gs2m_tpu_torch.ops import blend
    from gs2m_tpu_torch.ops.projection import project
    from gs2m_tpu_torch.ops.rasterize import (build_features,
                                              rasterize_from_projected)
    from gs2m_tpu_torch.parallel.sp import (make_sp_geometry_grad,
                                            make_sp_render, padded_height)
    from gs2m_tpu_torch.utils.grad_gate import (DEFAULT_TOL, TOLERANCES,
                                                grad_gate)

    H, W, chunk = cam.height, cam.width, 256
    local_h = padded_height(H, SP_BANDS) // SP_BANDS
    bg = torch.zeros(3, device=dev)
    cap = max(full_cap // SP_BANDS // chunk * chunk, 4 * chunk)
    with torch.no_grad():
        op = g.get_opacity[:, 0]
        full = rasterize_from_projected(project(g, cam, 3, op), op,
                                        build_features(g, cam), bg, cam,
                                        feature_count=9, chunk=chunk,
                                        instance_cap=full_cap)
    while True:
        sp_render = make_sp_render([dev], SP_BANDS, H, feature_count=9,
                                   active_sh_degree=3, chunk=chunk,
                                   instance_cap_per_band=cap)
        out = sp_render(g, cam, bg)
        if int(out.dropped) == 0:
            break
        cap *= 2
    report = {"bands": SP_BANDS, "band_rows": local_h, "cap_per_band": cap,
              "instances": int(out.num_instances),
              "instances_full": int(full.num_instances)}
    problems = []
    for k in ("color", "buffer", "final_T"):
        frac, err = k1_gate(getattr(out, k), getattr(full, k))
        report[f"{k}_frac_over_1e-5"], report[f"{k}_max_abs_err"] = frac, err
        if frac > 1e-4:
            problems.append(f"{k}: {frac:.3g} of entries off by > 1e-5")
    for k in ("observe", "radii"):
        report[f"{k}_differ"] = int((getattr(out, k) != getattr(full, k)).sum())
    if report["radii_differ"]:
        problems.append(f"radii differ in {report['radii_differ']} rows")
    def banded_view():
        return derive_render_pkg(sp_render(g, cam, bg), cam, bg)

    sp_ms = time_ms(banded_view, 5)
    print(f"[smoke] sp-render view 0 in {SP_BANDS} bands of {local_h} rows "
          f"against the full frame: {json.dumps(report)}; banded "
          f"{sp_ms:.2f} ms/view against the full frame's render() "
          f"{render_ms:.2f} ms/view (median of 5, CUDA events) on {card}")
    if problems:
        fail("sp-render: " + "; ".join(problems))
    profile_call("sp-render", banded_view, sp_ms)

    blend.LAUNCHES.clear()
    t0 = time.perf_counter()
    stats = render_app.main(["-m", str(model_dir), "-s", str(scene_dir),
                             "--spatial", str(SP_BANDS), "--label", "sp"])[
        "views"]
    app_wall = time.perf_counter() - t0
    render_launches = blend.launch_counts()
    # The app's first band cap: its full-frame cap (8 x capacity) / bands.
    cap0 = max(max(8 * g.capacity // chunk * chunk, 4 * chunk) // SP_BANDS
               // chunk * chunk, 4 * chunk)
    regrowths = int(np.log2(stats[-1]["instance_cap"] / cap0))
    if render_launches["blend_fwd"] != SP_BANDS * (VIEWS + regrowths):
        fail(f"render app --spatial {SP_BANDS}: K1 launched "
             f"{render_launches['blend_fwd']} times, expected {SP_BANDS} x "
             f"({VIEWS} views + {regrowths} regrowths)")
    # One preprocess per banded render (the one card's copy feeds every
    # band), none backward.
    if (render_launches["preprocess_fwd"], render_launches["preprocess_bwd"]
            ) != (VIEWS + regrowths, 0):
        fail(f"render app --spatial {SP_BANDS}: preprocess launches "
             f"{render_launches}, expected {VIEWS + regrowths} forward and "
             f"none backward")
    worst = 0
    for kind in ("render", "normal", "depth"):
        a_dir = model_dir / "train" / "ours_1" / kind
        b_dir = model_dir / "train" / "sp_1" / kind
        names = sorted(p.name for p in a_dir.iterdir())
        if names != sorted(p.name for p in b_dir.iterdir()):
            fail(f"render app --spatial: {kind} files differ")
        for n in names:
            a = np.asarray(Image.open(a_dir / n), np.int32)
            b = np.asarray(Image.open(b_dir / n), np.int32)
            worst = max(worst, int(np.abs(a - b).max()))
    print(f"[smoke] render app --spatial {SP_BANDS}: {len(stats)} views in "
          f"{app_wall:.2f} s; render ms/view "
          f"{[round(s['render_s'] * 1e3, 2) for s in stats]}; per-band cap "
          f"{stats[-1]['instance_cap']}; launches {render_launches}; PNGs "
          f"against the full-frame app's: max {worst} LSB")
    if worst > 1:
        fail(f"render app --spatial: PNGs differ by {worst} LSB")

    # The geometry gradient: SSIM 0.2, depth-normal 0.05, plane 100 (the
    # trainer's defaults) against a seeded noise target.
    lam, ldn, lpl = 0.2, 0.05, 100.0
    target = torch.rand(3, H, W, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(5))
    params = g.params_dict()
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}

    def full_grad():
        gg = g.with_params(leaves)
        pkg = render(gg, cam, bg, 3, geometry_stage=True, sobel_normal=True,
                     chunk=chunk, instance_cap=full_cap)
        loss = (L.rgb_loss(L.clip(pkg["render"], 0.0, 1.0), target, lam)
                + lpl * L.plane_loss(pkg["visibility_filter"], gg.get_scaling)
                + ldn * L.depth_normal_loss(pkg["normal_map"],
                                            pkg["sobel_map"], target))
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        return loss.detach(), {k: torch.zeros_like(v) if d is None else d
                               for (k, v), d in zip(leaves.items(), grads)}

    sp_grad = make_sp_geometry_grad(
        [dev], SP_BANDS, H, W, active_sh_degree=3, chunk=chunk,
        instance_cap_per_band=cap, lambda_ssim=lam,
        lambda_depth_normal=ldn, lambda_plane=lpl)
    l_full, g_full = full_grad()
    blend.LAUNCHES.clear()
    l_sp, g_sp = sp_grad(params, g, cam, bg, target, torch.ones(1, H, W,
                                                                 device=dev))
    torch.cuda.synchronize()
    grad_launches = blend.launch_counts()
    rel = abs(float(l_sp) - float(l_full)) / abs(float(l_full))
    gates = {}
    for k in g_full:
        rep = grad_gate(g_sp[k].cpu().numpy(), g_full[k].cpu().numpy(),
                        TOLERANCES.get(k, DEFAULT_TOL))
        gates[k] = {x: rep[x] for x in ("p999", "rel_to_max", "pass")}
    full_ms = time_ms(full_grad, 3)
    band_ms = time_ms(lambda: sp_grad(params, g, cam, bg, target,
                                      torch.ones(1, H, W, device=dev)), 3)
    print(f"[smoke] sp-grad (geometry objective without the cross-view term, "
          f"{SP_BANDS} bands): loss {float(l_sp)!r} vs one card "
          f"{float(l_full)!r} (rel {rel:.3g}); gates {json.dumps(gates)}; "
          f"launches {grad_launches}; banded {band_ms:.2f} ms, one card "
          f"{full_ms:.2f} ms (median of 3, CUDA events) on {card}")
    if rel > 1e-5 or not all(v["pass"] for v in gates.values()):
        fail("sp-grad: the banded geometry gradient disagrees with the "
             "one-card assembly")
    if grad_launches != {"blend_fwd": SP_BANDS, "blend_bwd": SP_BANDS,
                         "blend_obs": 0, "preprocess_fwd": 1,
                         "preprocess_bwd": 1, "adam": 0,
                         "instance_rows": SP_BANDS, "instance_sum": SP_BANDS}:
        fail(f"sp-grad launches {grad_launches}, expected {SP_BANDS} each of "
             f"K1, K2 and the reduce pair, one each of the preprocess pair "
             f"and no update")
    del g_full, g_sp, leaves

    # One band's shapes: band 1 (rows 304..607 at 1200 rows).
    band = (local_h, local_h)
    k1r, _ = kernel_phase(g, cam, chunk, cap, 9, band=band)
    print(f"[smoke] sp-render K1 blend_fwd (band 1): {json.dumps(k1r)}")
    k1g, ctx = kernel_phase(g, cam, chunk, cap, 10, band=band)
    print(f"[smoke] sp-grad K1 blend_fwd (band 1): {json.dumps(k1g)}")
    k2g = k2_phase(ctx)
    print(f"[smoke] sp-grad K2 blend_bwd (band 1): {json.dumps(k2g)}")
    return ({"sp-render": {"blend_fwd": k1r},
             "sp-grad": {"blend_fwd": k1g, "blend_bwd": k2g}},
            {"sp-render": render_launches, "sp-grad": grad_launches})


def lpips_weights(path: Path, seed: int) -> None:
    """Synthetic VGG16 + linear-head weights in the torchvision / LPIPS
    layout (tests/test_lpips.py's recipe: conv weights N(0, 0.05), zero
    biases, heads U(0, 1)), written as npz."""
    rng = np.random.default_rng(seed)
    w, cin = {}, 3
    for idx, cout in {0: 64, 2: 64, 5: 128, 7: 128, 10: 256, 12: 256,
                      14: 256, 17: 512, 19: 512, 21: 512, 24: 512, 26: 512,
                      28: 512}.items():
        w[f"features.{idx}.weight"] = rng.normal(
            scale=0.05, size=(cout, cin, 3, 3)).astype(np.float32)
        w[f"features.{idx}.bias"] = np.zeros(cout, np.float32)
        cin = cout
    for i, c in enumerate([64, 128, 256, 512, 512]):
        w[f"lin{i}.model.1.weight"] = rng.uniform(0, 1, c).astype(np.float32)
    np.savez(path, **w)


def lpips_path(root: Path, model_dir: Path, card: str, seed: int) -> None:
    """LPIPS on the card (utils/lpips.py) with synthetic weights: two
    800x600 images, the card's value within rtol 1e-4 of the CPU's, ms per
    image pair; then the metrics app on the render-full model with
    GS2M_LPIPS_WEIGHTS set, whose LPIPS column must not be null."""
    import torch

    from gs2m_tpu_torch.apps import metrics as metrics_app
    from gs2m_tpu_torch.utils.lpips import lpips

    path = root / "lpips_weights.npz"
    lpips_weights(path, seed)
    rng = np.random.default_rng(seed + 1)
    a = rng.uniform(0, 1, (3, TRAIN_H, TRAIN_W)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=a.shape), 0, 1).astype(np.float32)
    card_val = float(lpips(a, b, str(path), "cuda"))
    ms = time_ms(lambda: lpips(a, b, str(path), "cuda"), 10)
    t0 = time.perf_counter()
    cpu_val = float(lpips(a, b, str(path), "cpu"))
    cpu_s = time.perf_counter() - t0
    rel = abs(card_val - cpu_val) / abs(cpu_val)
    print(f"[smoke] LPIPS (synthetic weights) at {TRAIN_W}x{TRAIN_H}: card "
          f"{card_val!r}, CPU {cpu_val!r} (rel {rel:.3g}, limit 1e-4); "
          f"{ms:.2f} ms per image pair on the card (median of 10, CUDA "
          f"events; the CPU took {cpu_s:.1f} s) on {card}")
    if not (np.isfinite(card_val) and rel <= 1e-4):
        fail("LPIPS on the card differs from the CPU's")
    old = os.environ.get("GS2M_LPIPS_WEIGHTS")
    os.environ["GS2M_LPIPS_WEIGHTS"] = str(path)
    try:
        t0 = time.perf_counter()
        res = metrics_app.main(["-m", str(model_dir)])
    finally:
        if old is None:
            del os.environ["GS2M_LPIPS_WEIGHTS"]
        else:
            os.environ["GS2M_LPIPS_WEIGHTS"] = old
    print(f"[smoke] metrics app with GS2M_LPIPS_WEIGHTS on the render-full "
          f"model ({VIEWS} views at {WIDTH}x{HEIGHT}): {json.dumps(res)} in "
          f"{time.perf_counter() - t0:.1f} s")
    vals = [r.get("LPIPS") for r in res.values()]
    if not vals or not all(v is not None and np.isfinite(v) for v in vals):
        fail(f"metrics app: LPIPS column {vals}")
    torch.cuda.empty_cache()


def viewer_path(trainer, card: str, requests: int = 5) -> None:
    """The SIBR bridge (apps/network_gui.py) over a loopback socket at
    800x600 with train-full's Gaussians: a client thread sends view 0's
    camera `requests` times; each reply's bytes within 1 LSB of render()'s
    image for the same camera, K1 launched once per request, ms per
    request."""
    import socket
    import threading

    import torch

    from gs2m_tpu_torch.apps.network_gui import NetworkGUI, serve_render
    from gs2m_tpu_torch.models.render import render
    from gs2m_tpu_torch.ops import blend

    g, cam = trainer.gaussians, trainer.scene.train_cameras[0]
    W, H = cam.width, cam.height
    wv = cam.world_view.cpu().numpy().copy()
    fp = cam.full_proj.cpu().numpy().copy()
    wv[:, 1] *= -1
    wv[:, 2] *= -1
    fp[:, 1] *= -1
    fovx = 2 * np.arctan(float(cam.tanfovx))
    fovy = 2 * np.arctan(float(cam.tanfovy))
    msg = json.dumps({
        "resolution_x": W, "resolution_y": H, "train": True,
        "fov_x": fovx, "fov_y": fovy, "z_near": cam.znear,
        "z_far": cam.zfar, "shs_python": False, "rot_scale_python": False,
        "keep_alive": True, "scaling_modifier": 1.0,
        "view_matrix": wv.reshape(-1).tolist(),
        "view_projection_matrix": fp.reshape(-1).tolist()}).encode()
    gui = NetworkGUI(port=0)
    port = gui.listener.getsockname()[1]
    replies = []

    def client():
        s = socket.create_connection(("127.0.0.1", port))
        for _ in range(requests):
            s.sendall(len(msg).to_bytes(4, "little") + msg)
            img = b""
            while len(img) < W * H * 3:
                img += s.recv(W * H * 3 - len(img))
            n = int.from_bytes(s.recv(4), "little")
            replies.append((np.frombuffer(img, np.uint8).reshape(H, W, 3),
                            s.recv(n).decode("ascii")))
        s.close()

    t = threading.Thread(target=client)
    t.start()
    n0 = blend.LAUNCHES["blend_fwd", 8]
    served, ms = 0, []
    deadline = time.perf_counter() + 60
    while served < requests and time.perf_counter() < deadline:
        t0 = time.perf_counter()
        out = serve_render(gui, g, "viewer-smoke", chunk=trainer.pipe.chunk,
                           instance_cap=trainer.instance_cap)
        if out is None:
            if gui.conn is None:
                time.sleep(0.01)
            continue
        ms.append((time.perf_counter() - t0) * 1e3)
        served += 1
    t.join(timeout=30)
    gui.listener.close()
    launched = blend.LAUNCHES["blend_fwd", 8] - n0
    with torch.no_grad():
        pkg = render(g, cam, torch.zeros(3, device=g.device),
                     g.max_sh_degree, chunk=trainer.pipe.chunk,
                     instance_cap=trainer.instance_cap)
    ref = (np.clip(pkg["render"].cpu().numpy(), 0, 1).transpose(1, 2, 0)
           * 255).astype(np.uint8)
    lsb = max((int(np.abs(img.astype(np.int32) - ref).max())
               for img, _ in replies), default=None)
    print(f"[smoke] viewer bridge at {W}x{H}, {g.num_alive} Gaussians: "
          f"{len(replies)} of {requests} requests answered, max "
          f"{lsb} LSB from render()'s image, verify "
          f"{sorted({v for _, v in replies})}, K1 launched {launched}; ms per "
          f"request (host clock, render + transfer) "
          f"{[round(x, 2) for x in ms]} on {card}")
    if (len(replies) != requests or lsb is None or lsb > 1
            or launched != requests or int(pkg["dropped"])
            or any(v != "viewer-smoke" for _, v in replies)):
        fail("viewer bridge: replies, bytes or launches wrong")


def composite_path(out: Path, card: str) -> dict:
    """The quality gate on the composite scene (sphere + box + ground
    plane) at smoke scale: test PSNR, chamfer against the analytic surface
    and the mesh's stage times (the render app's own record). Fails only on
    a non-finite score or an empty mesh: the JAX package has no composite
    reference number."""
    from gs2m_tpu_torch.apps import quality_gate
    from gs2m_tpu_torch.apps import render as render_app

    meshes = []
    saved = render_app.main

    def render_main(argv=None):
        res = saved(argv)
        meshes.append(res["meshes"].get("train"))
        return res

    render_app.main = render_main
    t0 = time.perf_counter()
    try:
        q = quality_gate.main(["--out", str(out), "--production", "--smoke",
                               "--scene", "composite"])
    finally:
        render_app.main = saved
    wall = time.perf_counter() - t0
    test = next(iter(q["metrics_test"].values()), {})
    mesh = meshes[-1] if meshes else None
    stages = mesh["stage_ms"] if mesh else {}
    total = sum(stages.values())
    print(f"[smoke] composite gate (smoke scale, {wall:.1f} s): "
          f"{json.dumps(q)} on {card}")
    print(f"[smoke] composite gate: test PSNR {test.get('PSNR')}, SSIM "
          f"{test.get('SSIM')}, chamfer {q['chamfer']['chamfer_mean']}; mesh "
          f"{mesh and mesh['faces']} faces; stage ms "
          + ", ".join(f"{k} {v:.1f}" for k, v in stages.items())
          + f", total {total:.1f}; the host cluster's share "
          f"{stages.get('cluster', 0.0) / max(total, 1e-9):.3f}")
    numbers = [*q["chamfer"].values(), test.get("PSNR"), test.get("SSIM")]
    if not all(x is not None and np.isfinite(x) for x in numbers):
        fail(f"composite gate: non-finite or missing numbers {numbers}")
    if mesh is None or not mesh["faces"] or q["scene"] != "synthetic_composite":
        fail(f"composite gate: empty mesh or wrong scene ({q['scene']})")
    return q


# --- the benchmark harness paths (apps/run_*.py, eval_*, vis_turntable) ----
# The dtu-protocol cell: the composite scene laid out as DTU scan 24 (49
# views at 1600x1200, which run_dtu's fixed -r 2 trains at DTU's 800x600;
# 40k points as in the production gate) in DTU's normalized frame: the
# world scaled by UNIT_NORM so the scene's farthest visible point (a ground
# corner, at 2.32) lies on the unit sphere (the images do not change). Cut
# from 30k to 600 iterations with the geometry stage (and the multi-view
# loss) from 300 and densification from 100 to 500; the trim (K3, every
# 1,000 iterations) stays covered by train-full. A 1M-point STL.
DTU_SCAN, DTU_VIEWS, DTU_W, DTU_H, DTU_POINTS = 24, 49, 1600, 1200, 40_000
UNIT_NORM = 1.0 / 2.3173
DTU_ITERS = 600
DTU_EXTRA = ("--geometry_from_iter", "300", "--densify_from_iter", "100",
             "--densify_until_iter", "500", "--quiet")
DTU_STL_POINTS = 1_000_000
# DTU scores in millimetres at a 0.2 mm sample density, a 60 mm patch and
# a 20 mm clip; in the normalized frame the --dtu preset meshes in, one
# unit is ~100 mm of a DTU object (the unit sphere spans a ~200 mm scan),
# so the scaled evaluation runs at 1/100 of those.
DTU_EVAL_SCALE = 0.01
# The tnt-protocol cell: the composite scene at the composite smoke's scale
# (8 views, 1,500 points, 600 iterations; built at 240x180 for run_tnt's
# fixed -r 2 to train at 120x90) named Barn (the --tnt preset's 360-degree
# depth 3.0 and the toolbox's tau 0.01), normalized into the unit sphere as
# the dtu-protocol scene is (at the ring's 3.4 the preset's depth would
# stop short of the objects), the GT cloud (1M points) under a known
# similarity.
TNT_VIEWS, TNT_W, TNT_H, TNT_POINTS, TNT_ITERS = 8, 240, 180, 1_500, 600
TNT_EXTRA = ("--geometry_from_iter", "200", "--densify_from_iter", "100",
             "--densify_until_iter", "500", "--opacity_reset_interval", "400",
             "--chunk", "64", "--quiet")
TNT_GT_POINTS = 1_000_000
# The evaluator's own checks: the trajectory alignment alone must give the
# known similarity to rounding (ALIGN_TOL; arccos resolves ~1e-6 degrees),
# and the whole evaluation on the analytic surface as the reconstruction
# (TNT_WITNESS_POINTS, another seed) must land within WITNESS_TOL of it
# (the two samplings keep ICP from exact: 6e-6, 4e-4 degrees, 5e-6 on the
# CPU). Limits on |scale ratio - 1|, degrees of rotation and translation
# (GT units; the GT scene spans ~3).
TNT_WITNESS_POINTS = 500_000
ALIGN_TOL = {"scale": 1e-6, "rotation_deg": 1e-4, "translation": 1e-6}
WITNESS_TOL = {"scale": 1e-4, "rotation_deg": 1e-2, "translation": 1e-4}
# The shiny-protocol cell: the material smoke's glossy sphere (160x120, 12
# views, 3,000 points, 600 iterations) as the Shiny Blender scene `ball`
# (--mask_gt), with the material stage from 300 and the nearby-camera
# distance widened as the material smoke widens it.
SHINY_VIEWS, SHINY_W, SHINY_H, SHINY_POINTS = 12, 160, 120, 3_000
SHINY_EXTRA = ("--iterations", "600", "--geometry_from_iter", "300",
               "--opacity_reset_interval", "400", "--nearby_cam_max_dist",
               "3.5", "--quiet")
APP_TIMEOUT = 900


def start_app(module: str, argv: list, log: Path, launch_log: Path) -> dict:
    """Start `python -m gs2m_tpu_torch.apps.<module> argv` as a user runs
    it: its output to `log` (each line with its arrival second, read by a
    thread), every process it starts appending its kernel launches to
    `launch_log` (ops/blend.py LAUNCH_LOG_ENV). finish_app waits for it."""
    import threading

    from gs2m_tpu_torch.ops.blend import LAUNCH_LOG_ENV

    cmd = [sys.executable, "-m", f"gs2m_tpu_torch.apps.{module}", *argv]
    env = dict(os.environ, PYTHONPATH=str(HERE),
               **{LAUNCH_LOG_ENV: str(launch_log)})
    job = {"module": module, "lines": [], "t0": time.perf_counter()}
    f = open(log, "a")
    try:
        f.write("$ " + " ".join(cmd) + "\n")
        f.flush()
        job["proc"] = subprocess.Popen(cmd, cwd=HERE, env=env, text=True,
                                       stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT)
    except BaseException:
        f.close()
        raise

    def read():
        with f:
            for line in job["proc"].stdout:
                job["lines"].append((time.perf_counter() - job["t0"],
                                     line.rstrip("\n")))
                f.write(line)
        job["t_end"] = time.perf_counter()   # the output closed: it exited

    job["reader"] = threading.Thread(target=read, daemon=True)
    job["reader"].start()
    return job


def finish_app(job: dict) -> tuple:
    """Wait for a started app (at most APP_TIMEOUT from its start); ->
    (wall s, its output lines with their arrival seconds). Fails on a
    nonzero exit or the timeout."""
    proc = job["proc"]
    try:
        proc.wait(timeout=max(APP_TIMEOUT - (time.perf_counter() - job["t0"]),
                              1))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    job["reader"].join(timeout=60)
    wall = job.get("t_end", time.perf_counter()) - job["t0"]
    if proc.returncode != 0:
        tail = "\n".join(text for _, text in job["lines"][-40:])
        fail(f"{job['module']} exited with {proc.returncode}:\n{tail}")
    return wall, job["lines"]


def run_app(module: str, argv: list, log: Path, launch_log: Path) -> tuple:
    """start_app then finish_app: -> (wall s, output lines)."""
    return finish_app(start_app(module, argv, log, launch_log))


def app_walls(lines: list, wall: float) -> dict:
    """A runner's wall per launched app: from the runner's `[>] <python> -m
    gs2m_tpu_torch.apps.<app>` line to the next such line (the last app to
    the runner's exit)."""
    marks = [(t, text.split(" -m ")[1].split()[0].rsplit(".", 1)[1])
             for t, text in lines
             if text.startswith("[>] ") and " -m gs2m_tpu_torch.apps." in text]
    ends = [t for t, _ in marks[1:]] + [wall]
    walls: dict = {}
    for (t, app), end in zip(marks, ends):
        walls[app] = walls.get(app, 0.0) + end - t
    return walls


def launch_log(path: Path) -> tuple:
    """-> (launch counts by kernel over every logged process, by (kernel, V),
    by app: the module each process ran)."""
    from collections import Counter

    by_kernel, by_width, by_app = Counter(), Counter(), {}
    if path.exists():
        for line in path.read_text().splitlines():
            rec = json.loads(line)
            app = Path(rec["argv"][0]).stem
            counts = by_app.setdefault(app, Counter())
            for name, V, n in rec["launches"]:
                by_kernel[name] += n
                by_width[name, V] += n
                counts[name] += n
    from gs2m_tpu_torch.ops.blend import KERNELS

    out = dict.fromkeys(KERNELS, 0)
    out.update(by_kernel)
    return out, dict(by_width), {k: dict(v) for k, v in by_app.items()}


def stage_line(lines: list, prefix: str) -> dict:
    """The JSON an app printed after `prefix` (its last such line)."""
    found = [text.split(prefix, 1)[1] for _, text in lines if prefix in text]
    if not found:
        fail(f"no '{prefix}' line in the output")
    return json.loads(found[-1])


def train_cap(lines: list) -> int:
    """The instance cap a runner's train app ended with (its `Training
    complete ...; instance cap N, ...` line)."""
    found = [text for _, text in lines
             if text.startswith("[>] Training complete")
             and "instance cap " in text]
    if not found:
        fail("no 'Training complete ... instance cap' line in the output")
    return int(found[-1].split("instance cap ")[1].split(",")[0])


def model_kernels(cell: str, model_dir: Path, feature_count: int, cap: int,
                  dev) -> dict:
    """K1 and K2 against their plain versions at a trained model's shapes:
    its last snapshot on its scene's first train view, at its training
    resolution, chunk and `cap`, the instance cap its train app ended
    with; the preprocess pair there, and Adam on the snapshot's parameters
    (adam_model: the runner's train app runs in a subprocess, whose updates
    no AdamTap sees)."""
    from gs2m_tpu_torch.core.config import load_cfg_args
    from gs2m_tpu_torch.core.gaussians import Gaussians
    from gs2m_tpu_torch.data.ply import load_gaussian_ply
    from gs2m_tpu_torch.data.scene import Scene, search_max_iteration

    model_cfg, pipe, _ = load_cfg_args(str(model_dir))
    it = search_max_iteration(str(model_dir / "point_cloud"))
    g = Gaussians.from_raw(load_gaussian_ply(str(
        model_dir / "point_cloud" / f"iteration_{it}" / "point_cloud.ply")),
        model_cfg.sh_degree, device=dev)
    cam = Scene(model_cfg, shuffle=False, load_images=False,
                device=dev).train_cameras[0]
    print(f"[smoke] {cell} kernels: {g.capacity} Gaussians at iteration "
          f"{it}, view 0 at {cam.width}x{cam.height}, chunk {pipe.chunk}, "
          f"cap {cap}")
    k1, ctx = kernel_phase(g, cam, pipe.chunk, cap, feature_count)
    print(f"[smoke] {cell} K1 blend_fwd: {json.dumps(k1)}")
    k2 = k2_phase(ctx)
    print(f"[smoke] {cell} K2 blend_bwd: {json.dumps(k2)}")
    return {"blend_fwd": k1, "blend_bwd": k2,
            **preprocess_phase(cell, g, cam, g.max_sh_degree),
            "adam": {"xyz": adam_model(cell, g, 11)}}


def make_dtu_official(root: Path, scan: int, seed: int, scale: float,
                      res: float = 0.01) -> Path:
    """A synthetic DTU `Official_DTU_Dataset` for the composite scene scaled
    by `scale`, in the scene's frame: Points/stl/stl{scan:03}_total.ply
    sampled from the analytic visible surface, ObsMask/ObsMask{scan}_10.mat
    (the cells within two cells of the surface, over its bounding box BB at
    Res) and ObsMask/Plane{scan}.mat (the ground plane, y down: points with
    y < ground + 0.01 are above it)."""
    from scipy.io import savemat
    from scipy.ndimage import binary_dilation

    from gs2m_tpu_torch.apps.quality_gate import (COMPOSITE,
                                                  sample_composite_surface)
    from gs2m_tpu_torch.data.ply import store_point_cloud

    (root / "ObsMask").mkdir(parents=True)
    (root / "Points" / "stl").mkdir(parents=True)
    stl = scale * sample_composite_surface(DTU_STL_POINTS, seed=seed + 11
                                           ).astype(np.float64)
    lo, hi = stl.min(0) - 0.05, stl.max(0) + 0.05
    shape = np.ceil((hi - lo) / res).astype(int) + 1
    mask = np.zeros(shape, bool)
    mask[tuple(np.around((stl - lo) / res).astype(int).T)] = True
    mask = binary_dilation(mask, iterations=2)
    savemat(root / "ObsMask" / f"ObsMask{scan}_10.mat",
            {"ObsMask": mask, "BB": np.stack([lo, hi]), "Res": res})
    savemat(root / "ObsMask" / f"Plane{scan}.mat",
            {"P": np.array([0.0, -1.0, 0.0,
                            scale * (COMPOSITE["ground_y"] + 0.01)])})
    store_point_cloud(str(root / "Points" / "stl" / f"stl{scan:03}_total.ply"),
                      stl.astype(np.float32), np.full((len(stl), 3), 128.0))
    return root


def default_density_probe(mesh_ply: Path, density: float = 0.2,
                          subset: int = 10_000, seed: int = 0) -> dict:
    """What DTU's 0.2 mm density does to a mesh in the normalized frame:
    the mean neighbor count of radius_downsample's ball query on the whole
    mesh (from 500 seeded query points), the neighbor lists' total
    entries for the whole mesh, and the seconds and kept points of
    radius_downsample on a seeded subset of `subset` vertices."""
    from scipy.spatial import cKDTree

    from gs2m_tpu_torch.apps.eval_dtu import radius_downsample
    from gs2m_tpu_torch.data.ply import fetch_mesh

    verts = fetch_mesh(str(mesh_ply))[0].astype(np.float64)
    rng = np.random.default_rng(seed)
    q = verts[rng.choice(len(verts), min(500, len(verts)), replace=False)]
    mean_nb = float(cKDTree(verts).query_ball_point(
        q, r=density, return_length=True, workers=-1).mean())
    sub = verts[rng.choice(len(verts), min(subset, len(verts)), replace=False)]
    t0 = time.perf_counter()
    kept = radius_downsample(sub, density)
    return {"mesh_points": len(verts), "mean_neighbors": mean_nb,
            "list_entries": mean_nb * len(verts),
            "subset": len(sub), "subset_s": time.perf_counter() - t0,
            "subset_kept": len(kept)}


def rescale_colmap(scene_dir: Path, scale: float) -> None:
    """Scale a COLMAP scene's world by `scale` (camera translations and the
    SfM points): the images stay valid, the scene shrinks about the
    origin."""
    from gs2m_tpu_torch.data import colmap as cm

    sparse = scene_dir / "sparse" / "0"
    imgs = cm.read_images_binary(str(sparse / "images.bin"))
    for im in imgs.values():
        im.tvec = np.asarray(im.tvec) * scale
    cm.write_images_binary(str(sparse / "images.bin"), imgs)
    xyz, rgb, _ = cm.read_points3d_binary(str(sparse / "points3D.bin"))
    cm.write_points3d_binary(str(sparse / "points3D.bin"), xyz * scale,
                             rgb.astype(np.float64))


def stl_coverage(mesh_ply: Path, stl_ply: Path, scale: float,
                 radius: float) -> dict:
    """The share of the STL's points of each composite part (sphere, box,
    ground) with no vertex of the mesh within `radius`: which parts the
    mesh lost (the --dtu preset keeps one cluster)."""
    from scipy.spatial import cKDTree

    from gs2m_tpu_torch.apps.quality_gate import COMPOSITE
    from gs2m_tpu_torch.data.ply import fetch_mesh, fetch_point_cloud

    c = COMPOSITE
    verts = fetch_mesh(str(mesh_ply))[0]
    stl = fetch_point_cloud(str(stl_ply))[0].astype(np.float64) / scale
    d, _ = cKDTree(verts).query(stl * scale, k=1, distance_upper_bound=radius,
                                workers=-1)
    q = np.abs(stl - c["box_c"]) - c["box_h"]
    parts = {
        "sphere": np.abs(np.linalg.norm(stl - c["sphere_c"], axis=1)
                         - c["sphere_r"]),
        "box": np.abs(np.linalg.norm(np.maximum(q, 0), axis=1)
                      + np.minimum(q.max(1), 0)),
        "ground": np.abs(stl[:, 1] - c["ground_y"])}
    which = np.argmin(np.stack(list(parts.values())), 0)
    return {name: float(np.isinf(d[which == k]).mean())
            for k, name in enumerate(parts)}


def dtu_protocol_path(root: Path, card: str, seed: int) -> dict:
    """run_dtu on the composite scene laid out as a DTU scan, the chamfer
    of its --dtu mesh against a synthetic official directory at a density
    scaled to the scene (the runner's own eval step runs DTU's millimetre
    density on the normalized-frame mesh: its cost is probed instead),
    report_dtu; walls per app, the evaluator's stages, launches by app."""
    from gs2m_tpu_torch.apps.quality_gate import (build_scene,
                                                  composite_point_scale)

    data, out, official = root / "dtu", root / "dtu_out", root / "dtu_official"
    log, launches_file = root / "dtu.log", root / "dtu_launches.jsonl"
    iterations, scale = DTU_ITERS, UNIT_NORM
    t0 = time.perf_counter()
    build_scene(str(data / f"scan{DTU_SCAN}"), n_views=DTU_VIEWS,
                width=DTU_W, height=DTU_H, n_points=DTU_POINTS,
                opacity_boost=8.0, point_scale=composite_point_scale(DTU_POINTS),
                texture="noise", sfm_fraction=0.25, instance_cap=2 ** 20,
                scene="composite", seed=seed)
    rescale_colmap(data / f"scan{DTU_SCAN}", scale)
    make_dtu_official(official, DTU_SCAN, seed, scale)
    print(f"[smoke] dtu-protocol: scan{DTU_SCAN} ({DTU_VIEWS} views at "
          f"{DTU_W}x{DTU_H}, {DTU_POINTS} composite points, world "
          f"x{scale:.4f}) and its official directory ({DTU_STL_POINTS} STL "
          f"points) built in {time.perf_counter() - t0:.1f} s")

    wall, lines = run_app("run_dtu", [
        "--data", str(data), "--out", str(out), "--scenes", str(DTU_SCAN),
        "--iterations", str(iterations), "--extra", *DTU_EXTRA], log,
        launches_file)
    walls = app_walls(lines, wall)
    launches, by_width, by_app = launch_log(launches_file)
    scan = out / f"scan{DTU_SCAN}"
    mesh = scan / "train" / f"ours_wo-brdf_{iterations}" / "mesh" / "tsdf_post.ply"
    s = DTU_EVAL_SCALE
    e_wall, e_lines = run_app("eval_dtu", [
        "--data", str(mesh), "--scan", str(DTU_SCAN), "--dataset_dir",
        str(official), "--vis_out_dir", str(scan), "--downsample_density",
        str(0.2 * s), "--patch_size", str(60 * s), "--max_dist", str(20 * s)],
        log, launches_file)
    stages = stage_line(e_lines, "[>] eval_dtu stages: ")
    probe = default_density_probe(mesh)
    lost = stl_coverage(mesh, official / "Points" / "stl"
                        / f"stl{DTU_SCAN:03}_total.ply", scale, 20 * s)
    r_wall, _ = run_app("report_dtu", ["--out", str(out), "--iterations",
                                       str(iterations)], log, launches_file)
    runtime = json.loads((out / "runtime.json").read_text())
    results = json.loads((scan / "results.json").read_text())
    metrics = json.loads((scan / "metrics_train.json").read_text())
    psnr = metrics[f"ours_wo-brdf_{iterations}"]["PSNR"]
    table = json.loads((out / "chamfer.json").read_text())
    mesh_lines = [t for _, t in lines if "mesh:" in t]
    print(f"[smoke] dtu-protocol: run_dtu {wall:.1f} s; walls by app (s) "
          + ", ".join(f"{k} {v:.1f}" for k, v in walls.items())
          + f"; eval_dtu {e_wall:.1f} s, report_dtu {r_wall:.1f} s; "
          f"runtime.json {runtime}; {mesh_lines}")
    print(f"[smoke] dtu-protocol: chamfer {results} (density "
          f"{0.2 * s:g}, patch {60 * s:g}, clip {20 * s:g}), train PSNR "
          f"{psnr}, report mean {table['mean']}; eval_dtu stages "
          f"{json.dumps(stages)}")
    print(f"[smoke] dtu-protocol: at DTU's 0.2 density in this frame "
          f"{json.dumps(probe)}; share of STL points with no mesh vertex "
          f"within {20 * s:g}, by part: {lost}")
    print(f"[smoke] dtu-protocol launches {launches} by (kernel, V) "
          f"{by_width} by app {by_app} on {card}")
    numbers = [results["mean_d2s"], results["mean_s2d"], results["overall"],
               psnr]
    if not all(np.isfinite(x) for x in numbers) or "ours_wo-brdf" not in runtime:
        fail(f"dtu-protocol: non-finite scores {numbers} or runtime {runtime}")
    if table[f"scan{DTU_SCAN}"]["overall"] != results["overall"]:
        fail("dtu-protocol: report_dtu's table disagrees with results.json")
    # K3 runs at the trim, every 1,000 iterations.
    want = {"train": ("blend_fwd", "blend_bwd", "preprocess_fwd",
                      "preprocess_bwd")
            + (("blend_obs",) if iterations >= 1000 else ()),
            "render": ("blend_fwd", "preprocess_fwd")}
    for app, names in want.items():
        for name in names:
            if by_app.get(app, {}).get(name, 0) < 1:
                fail(f"dtu-protocol: {app} launched {name} no time")
    steps = by_app.get("train", {}).get("blend_fwd", 0)
    if steps < iterations:
        fail(f"dtu-protocol: K1 launched {steps} times in {iterations} steps")
    return {"launches": launches, "model": scan, "mesh": mesh,
            "cap": train_cap(lines)}


def write_tnt_kit(scene_dir: Path, name: str, seed: int,
                  scale: float) -> np.ndarray:
    """The TnT evaluation kit for the composite scene scaled by `scale`,
    under a known similarity S from the scene's frame to the GT frame: <name>.ply (the
    analytic visible surface), <name>_COLMAP_SfM.log (the cameras' c2w
    poses, in image order, in a second frame Q), <name>_trans.txt (S Q^-1,
    the GT alignment of that log) and <name>.json (a Y-axis polygon crop
    around the scene). Returns S."""
    from gs2m_tpu_torch.apps.eval_tnt import apply_T, write_trajectory_log
    from gs2m_tpu_torch.apps.quality_gate import (COMPOSITE,
                                                  sample_composite_surface)
    from gs2m_tpu_torch.data import colmap as cm
    from gs2m_tpu_torch.data.ply import store_point_cloud

    def similarity(scale, angle, t):
        c, s = np.cos(angle), np.sin(angle)
        T = np.eye(4)
        T[:3, :3] = scale * np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        T[:3, 3] = t
        return T

    S = similarity(1.5, 0.4, [2.0, -0.5, 1.0])
    Q = similarity(0.7, -1.1, [-3.0, 0.25, 4.0])
    gt = apply_T(scale * sample_composite_surface(TNT_GT_POINTS,
                                                  seed=seed + 21)
                 .astype(np.float64), S)
    store_point_cloud(str(scene_dir / f"{name}.ply"), gt.astype(np.float32),
                      np.full((len(gt), 3), 128.0))
    imgs = cm.read_images_binary(str(scene_dir / "sparse/0/images.bin"))
    poses = []
    for img in sorted(imgs.values(), key=lambda im: im.name):
        w2c = np.eye(4)
        w2c[:3, :3] = cm.qvec_to_rotmat(img.qvec)
        w2c[:3, 3] = img.tvec
        c2w = np.linalg.inv(w2c)
        c2w[:3, :3] = Q[:3, :3] / 0.7 @ c2w[:3, :3]
        c2w[:3, 3] = apply_T(c2w[None, :3, 3], Q)[0]
        poses.append(c2w)
    write_trajectory_log(np.stack(poses), str(scene_dir / f"{name}_COLMAP_SfM.log"))
    np.savetxt(scene_dir / f"{name}_trans.txt", S @ np.linalg.inv(Q))
    # The crop: the objects and a margin of ground around them, as the
    # toolbox's crops bound a scene's region of interest.
    c = COMPOSITE
    lo = np.minimum(c["sphere_c"] - c["sphere_r"], c["box_c"] - c["box_h"]) - 0.4
    hi = np.maximum(c["sphere_c"] + c["sphere_r"], c["box_c"] + c["box_h"]) + 0.4
    corners = apply_T(scale * np.array([[lo[0], 0, lo[2]], [hi[0], 0, lo[2]],
                                        [hi[0], 0, hi[2]], [lo[0], 0, hi[2]]]),
                      S)
    (scene_dir / f"{name}.json").write_text(json.dumps({
        "class_name": "SelectionPolygonVolume", "orthogonal_axis": "Y",
        "axis_min": float(gt[:, 1].min() - 0.1),
        "axis_max": float(gt[:, 1].max() + 0.1),
        "bounding_polygon": corners.tolist()}))
    return S


def transform_error(T: np.ndarray, S: np.ndarray) -> dict:
    """A recovered similarity against the known one: scale ratio, rotation
    angle (degrees) and translation distance."""
    sT = np.cbrt(np.linalg.det(T[:3, :3]))
    sS = np.cbrt(np.linalg.det(S[:3, :3]))
    ang = None
    if sT > 0:   # (a collapsed scale leaves no rotation to compare)
        dR = (T[:3, :3] / sT) @ (S[:3, :3] / sS).T
        ang = float(np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2,
                                                 -1, 1))))
    return {"scale_ratio": float(sT / sS), "rotation_deg": ang,
            "translation": float(np.linalg.norm(T[:3, 3] - S[:3, 3]))}


def check_transform(label: str, err: dict, tol: dict) -> None:
    """Fail when a transform_error exceeds its limits."""
    off = {"scale": abs(err["scale_ratio"] - 1),
           "rotation_deg": err["rotation_deg"],
           "translation": err["translation"]}
    if not all(off[k] is not None and off[k] <= tol[k] for k in tol):
        fail(f"tnt-protocol: {label} is {err}, off the known similarity "
             f"beyond {tol}")


def tnt_protocol_path(root: Path, card: str, seed: int) -> dict:
    """The composite scene laid out as TnT's Barn with the official kit
    under a known similarity, convert_json on it, then run_tnt: F, P, R,
    the recovered transform against the known similarity, the evaluator's
    stage seconds, walls and launches by app; the trajectory alignment
    alone and the evaluator on the analytic surface, each held to the
    known similarity. (The runner's estimated trajectory is the model's
    cameras.json, which the render app rewrites in image order, the COLMAP
    log's.)"""
    from gs2m_tpu_torch.apps import eval_tnt
    from gs2m_tpu_torch.apps.quality_gate import (build_scene,
                                                  composite_point_scale,
                                                  sample_composite_surface)
    from gs2m_tpu_torch.data.ply import store_point_cloud

    data, out = root / "tnt", root / "tnt_out"
    log, launches_file = root / "tnt.log", root / "tnt_launches.jsonl"
    scene_dir = data / "Barn"
    t0 = time.perf_counter()
    build_scene(str(scene_dir), n_views=TNT_VIEWS, width=TNT_W, height=TNT_H,
                n_points=TNT_POINTS, opacity_boost=8.0,
                point_scale=composite_point_scale(TNT_POINTS),
                texture="noise", sfm_fraction=0.25, instance_cap=2 ** 15,
                scene="composite", seed=seed)
    rescale_colmap(scene_dir, UNIT_NORM)
    S = write_tnt_kit(scene_dir, "Barn", seed, UNIT_NORM)
    print(f"[smoke] tnt-protocol: Barn ({TNT_VIEWS} views at {TNT_W}x{TNT_H}, "
          f"{TNT_POINTS} composite points, world x{UNIT_NORM:.4f}, a "
          f"{TNT_GT_POINTS}-point GT cloud) built in "
          f"{time.perf_counter() - t0:.1f} s")
    c_wall, _ = run_app("convert_json", ["--data_dir", str(scene_dir)], log,
                        launches_file)
    wall, lines = run_app("run_tnt", [
        "--data", str(data), "--out", str(out), "--scenes", "Barn",
        "--iterations", str(TNT_ITERS), "--extra", *TNT_EXTRA], log,
        launches_file)
    walls = app_walls(lines, wall)
    launches, by_width, by_app = launch_log(launches_file)
    stages = stage_line(lines, "[>] eval_tnt stages: ")
    res = json.loads((out / "Barn" / "evaluation" / "evaluation.json")
                     .read_text())
    err = transform_error(np.asarray(res["transform"]), S)
    # The trajectory alignment alone (the evaluator's first step, before
    # its three ICP stages), from the same files.
    traj = str(out / "Barn" / "cameras.json")
    gt_traj = str(scene_dir / "Barn_COLMAP_SfM.log")
    gt_trans = scene_dir / "Barn_trans.txt"
    est = eval_tnt.load_trajectory(traj)
    gt = eval_tnt.apply_T(eval_tnt.load_trajectory(gt_traj)[:, :3, 3],
                          np.loadtxt(gt_trans))
    err0 = transform_error(eval_tnt.umeyama_similarity(est[:, :3, 3], gt), S)
    # The whole evaluation once more, on the analytic surface in the
    # reconstruction's frame: what the evaluator recovers from a perfect
    # reconstruction with the same kit and trajectory.
    witness = root / "tnt_witness"
    witness.mkdir()
    surf = UNIT_NORM * sample_composite_surface(TNT_WITNESS_POINTS,
                                                seed=seed + 31)
    store_point_cloud(str(witness / "surface.ply"), surf.astype(np.float32),
                      np.full((len(surf), 3), 128.0))
    w_stages: dict = {}
    w_res = eval_tnt.evaluate(
        str(witness / "surface.ply"), str(scene_dir / "Barn.ply"),
        eval_tnt.SCENES_TAU["Barn"], crop_json=str(scene_dir / "Barn.json"),
        out_dir=str(witness), traj=traj, gt_traj=gt_traj,
        gt_trans=str(gt_trans), stages=w_stages)
    w_err = transform_error(np.asarray(w_res["transform"]), S)
    mesh_lines = [t for _, t in lines if "mesh:" in t]
    print(f"[smoke] tnt-protocol: convert_json {c_wall:.1f} s, run_tnt "
          f"{wall:.1f} s; walls by app (s) "
          + ", ".join(f"{k} {v:.1f}" for k, v in walls.items())
          + f"; transforms.json "
          f"{json.loads((scene_dir / 'transforms.json').read_text())}; "
          f"{mesh_lines}")
    print(f"[smoke] tnt-protocol: F {res['fscore']}, P {res['precision']}, "
          f"R {res['recall']} at tau {res['tau']} (mean distances "
          f"{res['mean_d_recon_to_gt']:.5f} / {res['mean_d_gt_to_recon']:.5f})"
          f"; recovered transform "
          f"{np.round(np.asarray(res['transform']), 5).tolist()} vs the "
          f"known similarity: {err} (the trajectory alignment alone: "
          f"{err0}); eval_tnt stages {json.dumps(stages)}")
    print(f"[smoke] tnt-protocol: the evaluator on the analytic surface "
          f"({TNT_WITNESS_POINTS} points) with the same kit: F "
          f"{w_res['fscore']}, transform vs the known similarity {w_err}; "
          f"stages {json.dumps(w_stages)}")
    print(f"[smoke] tnt-protocol launches {launches} by (kernel, V) "
          f"{by_width} by app {by_app} on {card}")
    numbers = [res["fscore"], res["precision"], res["recall"]]
    if not all(np.isfinite(x) for x in numbers):
        fail(f"tnt-protocol: non-finite scores {numbers}")
    check_transform("the trajectory alignment", err0, ALIGN_TOL)
    check_transform("the transform from the analytic surface", w_err,
                    WITNESS_TOL)
    for app, names in {"train": ("blend_fwd", "blend_bwd", "preprocess_fwd",
                                 "preprocess_bwd"),
                       "render": ("blend_fwd", "preprocess_fwd")}.items():
        for name in names:
            if by_app.get(app, {}).get(name, 0) < 1:
                fail(f"tnt-protocol: {app} launched {name} no time")
    return {"launches": launches, "model": out / "Barn",
            "cap": train_cap(lines)}


def blender_scene(colmap_dir: Path, out_dir: Path, test_every: int = 8) -> None:
    """A COLMAP scene with masks/ as a Shiny Blender scene: RGBA PNGs
    (alpha = the mask) under train/ and test/ (every `test_every`-th view
    held out, as the COLMAP reader's --eval split holds them out), their
    OpenGL c2w poses in transforms_{train,test}.json, the SfM points as
    points3d.ply."""
    from PIL import Image

    from gs2m_tpu_torch.data import colmap as cm
    from gs2m_tpu_torch.data.ply import store_point_cloud

    sparse = colmap_dir / "sparse" / "0"
    cam = next(iter(cm.read_cameras_binary(str(sparse / "cameras.bin"))
                    .values()))
    fx = float(cam.params[0])
    frames = {"train": [], "test": []}
    for i, img in enumerate(sorted(cm.read_images_binary(
            str(sparse / "images.bin")).values(), key=lambda im: im.name)):
        split = "test" if i % test_every == 0 else "train"
        (out_dir / split).mkdir(parents=True, exist_ok=True)
        rgb = Image.open(colmap_dir / "images" / img.name).convert("RGB")
        alpha = Image.open(colmap_dir / "masks" / img.name).convert("L")
        rgb.putalpha(alpha)
        rgb.save(out_dir / split / f"r_{i}.png")
        w2c = np.eye(4)
        w2c[:3, :3] = cm.qvec_to_rotmat(img.qvec)
        w2c[:3, 3] = img.tvec
        c2w = np.linalg.inv(w2c)
        c2w[:3, 1:3] *= -1     # COLMAP (y down, z forward) -> OpenGL
        frames[split].append({"file_path": f"./{split}/r_{i}",
                              "transform_matrix": c2w.tolist()})
    for split, fr in frames.items():
        (out_dir / f"transforms_{split}.json").write_text(json.dumps({
            "camera_angle_x": 2 * np.arctan(cam.width / (2 * fx)),
            "frames": fr}))
    xyz, rgb, _ = cm.read_points3d_binary(str(sparse / "points3D.bin"))
    store_point_cloud(str(out_dir / "points3d.ply"), xyz, rgb.astype(np.float64))


def shiny_protocol_path(root: Path, card: str, seed: int) -> dict:
    """run_shiny on the glossy sphere laid out as Shiny Blender's `ball`
    (--mask_gt): the material stage on its path (K1 and K2 at V=16), the
    --blender render's PBR outputs, test metrics, launches by app and
    width."""
    from gs2m_tpu_torch.apps.material_gate import build_glossy_scene

    data, out = root / "shiny", root / "shiny_out"
    log, launches_file = root / "shiny.log", root / "shiny_launches.jsonl"
    t0 = time.perf_counter()
    colmap_dir = root / "shiny_colmap"
    build_glossy_scene(str(colmap_dir), n_views=SHINY_VIEWS, width=SHINY_W,
                       height=SHINY_H, n_points=SHINY_POINTS, seed=seed)
    blender_scene(colmap_dir, data / "ball")
    print(f"[smoke] shiny-protocol: ball ({SHINY_VIEWS} views at "
          f"{SHINY_W}x{SHINY_H}, {SHINY_POINTS} points) built in "
          f"{time.perf_counter() - t0:.1f} s")
    wall, lines = run_app("run_shiny", [
        "--data", str(data), "--out", str(out), "--scenes", "ball",
        "--extra", *SHINY_EXTRA], log, launches_file)
    walls = app_walls(lines, wall)
    launches, by_width, by_app = launch_log(launches_file)
    model = out / "ball"
    its = int(SHINY_EXTRA[SHINY_EXTRA.index("--iterations") + 1])
    metrics = json.loads((model / "metrics_test.json").read_text())
    test = metrics.get(f"ours_{its}", {})
    method = model / "test" / f"ours_{its}"
    outputs = {d: len(list((method / d).glob("*.png"))) for d in
               ("render", "albedo", "roughness", "metallic", "diffuse",
                "specular")}
    runtime = json.loads((out / "runtime.json").read_text())
    print(f"[smoke] shiny-protocol: run_shiny {wall:.1f} s; walls by app (s) "
          + ", ".join(f"{k} {v:.1f}" for k, v in walls.items())
          + f"; test PSNR {test.get('PSNR')}, SSIM {test.get('SSIM')}; PBR "
          f"outputs {outputs}, envmap {(method / 'envmap.png').is_file()}; "
          f"runtime.json {runtime}")
    print(f"[smoke] shiny-protocol launches {launches} by (kernel, V) "
          f"{by_width} by app {by_app} on {card}")
    if not (test.get("PSNR") is not None and np.isfinite(test["PSNR"])):
        fail(f"shiny-protocol: no finite test PSNR in {metrics}")
    if min(outputs.values()) < 1 or "ours" not in runtime:
        fail(f"shiny-protocol: missing material outputs {outputs} or "
             f"runtime {runtime}")
    for name in ("blend_fwd", "blend_bwd"):
        if by_width.get((name, 16), 0) < 1:
            fail(f"shiny-protocol: {name} never launched at V=16")
    for name in ("preprocess_fwd", "preprocess_bwd"):
        if launches[name] < 1:
            fail(f"shiny-protocol: {name} never launched")
    return {"launches": launches, "by_width": by_width, "model": model,
            "cap": train_cap(lines)}


def turntable_path(root: Path, model_dir: Path, mesh_ply: Path,
                   card: str) -> tuple:
    """vis_turntable on a trained model (--map render) and on its cleaned
    mesh (--mesh), the script's defaults: ms per frame, each frame's
    dropped, K1 launches, peak memory; frame 0 of each mode through K1
    held against the same frame through K1's plain version at K1's gate.
    Returns (K1 reports by mode, launches by mode)."""
    import torch

    from gs2m_tpu_torch.apps import vis_turntable as vis
    from gs2m_tpu_torch.core.gaussians import Gaussians
    from gs2m_tpu_torch.data.ply import load_gaussian_ply
    from gs2m_tpu_torch.data.scene import search_max_iteration
    from gs2m_tpu_torch.ops import blend

    dev = torch.device("cuda")
    frames, size = 60, 512   # the script's defaults
    it = search_max_iteration(str(model_dir / "point_cloud"))
    runs = {"model": ["-m", str(model_dir)],
            "mesh": ["-m", str(model_dir), "--mesh", str(mesh_ply)]}
    reports, launches = {}, {}
    # The app's surfels, kept for the frame-0 check (the app looks
    # mesh_to_surfels up when it runs).
    surfels, to_surfels = {}, vis.mesh_to_surfels

    def kept_surfels(path):
        t = time.perf_counter()
        surfels[path] = to_surfels(path)
        surfels["s"] = time.perf_counter() - t
        return surfels[path]

    for mode, argv in runs.items():
        blend.LAUNCHES.clear()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        vis.mesh_to_surfels = kept_surfels
        try:
            res = vis.main([*argv, "--frames", str(frames), "--size",
                            str(size), "--out",
                            str(root / f"turntable_{mode}.webp")])
        finally:
            vis.mesh_to_surfels = to_surfels
        wall = time.perf_counter() - t0
        launches[mode] = blend.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        dropped = res["dropped"]
        print(f"[smoke] turntable {mode}: {frames} frames at {size}x{size} "
              f"in {wall:.1f} s ({res['gaussians']} Gaussians"
              + (f"; mesh_to_surfels {surfels['s']:.1f} s" if mode == "mesh"
                 else "") + f"); ms per "
              f"frame median {np.median(res['ms_per_frame']):.2f}, first "
              f"{res['ms_per_frame'][0]:.2f}; dropped per frame {dropped}; "
              f"launches {launches[mode]}; peak memory {peak} GiB; webp "
              f"{Path(res['out']).stat().st_size} bytes on {card}")
        if (launches[mode]["blend_fwd"], launches[mode]["preprocess_fwd"]
                ) != (frames, frames):
            fail(f"turntable {mode}: K1 and the preprocess forward launched "
                 f"{launches[mode]} times for {frames} frames")

        # Frame 0 as the app renders it, through K1 and through its plain
        # version (the render's blend_fwd looked up at call time).
        if mode == "mesh":
            centers, quats, log_scales, normals = surfels[str(mesh_ply)]
            g = vis.surfel_gaussians(centers, quats, log_scales, dev)
            center, dist = vis.orbit_distance(centers, -1.0)
            centers_d = torch.as_tensor(centers, device=dev)
            normals_d = torch.as_tensor(normals, device=dev)

            def frame(cam):
                return vis.mesh_frame(g, centers_d, normals_d, cam)
        else:
            raw = load_gaussian_ply(str(model_dir / "point_cloud"
                                        / f"iteration_{it}" / "point_cloud.ply"))
            g = Gaussians.from_raw(raw, 3, device=dev)
            center, dist = vis.orbit_distance(np.asarray(raw["xyz"]), -1.0)

            def frame(cam):
                return vis.model_frame(g, cam, "render", 3)
        cam = vis.orbit_camera(0, frames, center, dist, 0.35, size, dev)
        img, drop = frame(cam)
        saved = blend.blend_fwd
        blend.blend_fwd = blend.blend_fwd_plain
        try:
            ref, ref_drop = frame(cam)
        finally:
            blend.blend_fwd = saved
        d = np.abs(img - ref)
        frac = float((d > 1e-5).mean())
        print(f"[smoke] turntable {mode} frame 0, K1 vs plain: max |diff| "
              f"{float(d.max()):.3g}, share over 1e-5 {frac:.3g}, dropped "
              f"{drop} / {ref_drop}")
        if frac > 1e-4 or float(d.max()) > 1e-3 * (1 + float(np.abs(ref).max())):
            fail(f"turntable {mode}: frame 0 through K1 differs from its "
                 f"plain version beyond K1's gate")
        # K1 at frame 0's shapes: the app's fixed cap, its overflow kept.
        cap = (vis.MESH_INSTANCE_CAP if mode == "mesh"
               else vis.MODEL_INSTANCE_CAP)
        rep, _ = kernel_phase(g, cam, 256, cap, 1, drop_ok=True)
        print(f"[smoke] turntable-{mode} K1 blend_fwd (cap {cap}): "
              f"{json.dumps(rep)}")
        reports[mode] = {"blend_fwd": rep, **preprocess_phase(
            f"turntable-{mode}", g, cam, 0 if mode == "mesh" else 3,
            backward=False)}
        del g
    return reports, launches


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    # One rank of the dp-train cell (dp_run spawns them).
    ap.add_argument("--dp-worker", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--dp-out", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--dp-scene", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--dp-full", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.dp_worker is not None:
        dp_worker(args.dp_worker, args.dp_out, args.dp_scene, args.dp_full)
        return
    t_start = time.perf_counter()

    def mark(label: str) -> None:
        print(f"[smoke] t={time.perf_counter() - t_start:.1f} s: {label}",
              flush=True)

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a card")
    from PIL import Image

    from gs2m_tpu_torch import _build
    from gs2m_tpu_torch.apps import render as render_app
    from gs2m_tpu_torch.apps import train as train_app
    from gs2m_tpu_torch.core.config import load_cfg_args
    from gs2m_tpu_torch.core.gaussians import Gaussians
    from gs2m_tpu_torch.data.ply import load_gaussian_ply
    from gs2m_tpu_torch.data.scene import Scene
    from gs2m_tpu_torch.models.render import render
    from gs2m_tpu_torch.ops import blend
    from gs2m_tpu_torch.train.trainer import (choose_neighbor,
                                              make_observe_counter)

    # --- phase 1: card and build ---------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"[smoke] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    libs = _build.build([*_build.sources(), ("blend_bwd", PASS1_ONLY)])
    print(f"[smoke] built {sorted(map(str, libs))} in "
          f"{time.perf_counter() - t0:.1f} s")

    # The Adam kernel against the eager loop, and timed, at the DTU and TnT
    # cells' rows (the paths' records hold it on their own updates).
    for e in (19, 22):
        adam_phase(1 << e, args.seed)
    # The backward's reduce pair against segment_sum's chain, and timed, at
    # the DTU and TnT cells' layouts (every K2 phase below holds it too).
    for config in ("dtu-wo-brdf", "tnt-wo-brdf"):
        instance_sum_phase(config, args.seed)
        torch.cuda.empty_cache()

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
    cam = Scene(model_cfg, shuffle=False, load_images=False,
                device=dev).train_cameras[0]
    cap = max(8 * g.capacity // pipe.chunk * pipe.chunk, 4 * pipe.chunk)
    # The material-stage package's width, V=16 (feature_count 9).
    render_kernels = kernel_phases("render-full", g, cam, pipe.chunk, cap, 9,
                                   g.max_sh_degree)

    # --- phase 4: the render app with DTU's mesh preset --------------------------
    mark("phase 4")
    blend.LAUNCHES.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = render_app.main(["-m", str(model_dir), "-s", str(scene_dir), "--dtu"])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = blend.launch_counts()
    stats, mesh = out["views"], out["meshes"].get("train")
    if len(stats) != VIEWS:
        fail(f"render app rendered {len(stats)} views, expected {VIEWS}")
    regrowths = int(np.log2(stats[-1]["instance_cap"] / cap))
    for s in stats:
        if s["dropped"] != 0 or not s["finite"]:
            fail(f"view {s['view']}: dropped {s['dropped']}, finite {s['finite']}")
    if (launches["blend_fwd"], launches["preprocess_fwd"]) != (
            VIEWS + regrowths,) * 2 or launches["preprocess_bwd"]:
        fail(f"render app launches {launches}, expected K1 and the "
             f"preprocess forward {VIEWS} views + {regrowths} regrowths "
             f"each, no backward")
    for kind in ("render", "gt", "normal", "depth"):
        files = sorted((model_dir / "train" / "ours_1" / kind).iterdir())
        if len(files) != VIEWS:
            fail(f"{kind}: {len(files)} files, expected {VIEWS}")
        for f in files:
            if Image.open(f).size != (WIDTH, HEIGHT):
                fail(f"{f.name} has size {Image.open(f).size}")
    if mesh is None or mesh["faces"] == 0 or not mesh["finite"]:
        fail(f"--dtu mesh is empty or not finite: {mesh}")
    mesh_ms = sum(mesh["stage_ms"].values())
    print(f"[smoke] render app --dtu: {wall:.2f} s for {VIEWS} views and the "
          f"mesh ({(wall - mesh_ms / 1e3) / VIEWS * 1e3:.1f} ms/view with PNG "
          f"export); render ms/view "
          f"{[round(s['render_s'] * 1e3, 2) for s in stats]}; "
          f"export ms/view {[round(s['export_s'] * 1e3, 1) for s in stats]}; "
          f"instances/view {[s['num_instances'] for s in stats]}; launches {launches}")
    print(f"[smoke] DTU-preset mesh (voxel 0.002, trunc 0.008, max depth 5, "
          f"{VIEWS} views at {WIDTH}x{HEIGHT}): {mesh['blocks']} blocks, "
          f"{mesh['voxels']} voxels; raw {mesh['raw_vertices']} vertices / "
          f"{mesh['raw_faces']} faces, cleaned {mesh['vertices']} / "
          f"{mesh['faces']}; stage ms (CUDA events on the card, host clock "
          f"for to_host, cluster, ply_write) "
          + ", ".join(f"{k} {v:.1f}" for k, v in mesh["stage_ms"].items())
          + f", total {mesh_ms:.1f}; peak memory {peak:.2f} GiB on {card}")

    def render_view0():
        return render(g, cam, torch.zeros(3, device=dev), 3,
                      geometry_stage=True, material_stage=True,
                      chunk=pipe.chunk, instance_cap=stats[-1]["instance_cap"])

    render_ms = time_ms(render_view0, 5)
    print(f"[smoke] render() view 0, device path: {render_ms:.2f} ms "
          f"(median of 5, CUDA events) on {card}")
    profile_call("render", render_view0, render_ms)

    # --- phase 4b: the same Gaussians in 4 bands (sp-render, sp-grad) ------
    mark("phase 4b")
    sp_kernels, sp_launches = sp_path(g, cam, scene_dir, model_dir,
                                      stats[-1]["instance_cap"], card, dev,
                                      render_ms)
    del g

    # --- phase 5: the train app (this slice's path) -------------------------------
    mark("phase 5")
    t0 = time.perf_counter()
    train_dir = build_train_scene(root, TRAIN_POINTS, TRAIN_W, TRAIN_H,
                                  TRAIN_VIEWS, args.seed)
    print(f"[smoke] train scene: {TRAIN_POINTS} points, {TRAIN_VIEWS} views "
          f"at {TRAIN_W}x{TRAIN_H} in {time.perf_counter() - t0:.1f} s")
    train_model = root / "train_model"
    argv = ["-s", str(train_dir), "-r", "1",
            "--iterations", str(TRAIN_ITERS),
            "--geometry_from_iter", str(GEOMETRY_FROM),
            "--densify_from_iter", str(DENSIFY_FROM),
            "--densification_interval", str(DENSIFY_EVERY),
            "--test_iterations", str(TRAIN_ITERS),
            "--save_iterations", str(TRAIN_ITERS),
            "--multi_view_max_angle", "179", "--multi_view_max_dist", "100",
            "--nearby_cam_max_angle", "179", "--nearby_cam_max_dist", "100",
            "--quiet"]
    blend.LAUNCHES.clear()
    t0 = time.perf_counter()
    with AdamTap("train-full", {"xyz": TRAIN_ITERS}) as train_tap:
        trainer = train_app.main(
            argv + ["-m", str(train_model),
                    "--checkpoint_iterations", *map(str, CHECKPOINTS),
                    "--profile_iterations", *map(str, PROFILE)])
    counts, trim_drop = make_observe_counter(trainer.scene, trainer.pipe,
                                             trainer.instance_cap)(
        trainer.gaussians)
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    train_launches = blend.launch_counts()

    n_warm = GEOMETRY_FROM
    n_geo = TRAIN_ITERS - GEOMETRY_FROM
    n_densify = sum(1 for it in range(1, TRAIN_ITERS + 1)
                    if it > DENSIFY_FROM and it % DENSIFY_EVERY == 0)
    want = {"blend_fwd": n_warm + 2 * n_geo + EVAL_VIEWS,
            "blend_bwd": n_warm + 2 * n_geo, "blend_obs": TRAIN_VIEWS}
    # The preprocess pair: forward once per render and per trim view,
    # backward once per differentiated render.
    want["preprocess_fwd"] = want["blend_fwd"] + want["blend_obs"]
    want["preprocess_bwd"] = want["blend_bwd"]
    want["adam"] = TRAIN_ITERS    # one update a step
    want["instance_rows"] = want["instance_sum"] = want["blend_bwd"]
    m = trainer.last_metrics
    loss = float(m["loss"])
    snap = train_model / "point_cloud" / f"iteration_{TRAIN_ITERS}" / "point_cloud.ply"
    alive = trainer.gaussians.alive
    seen2 = float(((counts >= 2) & alive).sum()) / max(int(alive.sum()), 1)
    print(f"[smoke] train app: {TRAIN_ITERS} iterations ({n_warm} warmup, "
          f"{n_geo} geometry, {n_densify} densifications) + trim counter in "
          f"{train_wall:.1f} s; last loss {loss:.5f}, dropped "
          f"{int(m['dropped'])}, eval PSNR {trainer.last_eval['psnr']:.3f}; "
          f"densify {trainer.last_densify_info}; alive "
          f"{trainer.gaussians.num_alive} of {trainer.gaussians.capacity}; "
          f"instance cap {trainer.instance_cap}; trim: {seen2:.4f} of alive "
          f"Gaussians seen in >= 2 views, dropped {int(trim_drop)}; "
          f"launches {train_launches} (expected {want})")
    if trainer.iteration != TRAIN_ITERS or not np.isfinite(loss):
        fail(f"train app: iteration {trainer.iteration}, loss {loss}")
    if int(m["dropped"]) != 0 or int(trim_drop) != 0:
        fail("train path: binning dropped instances")
    if not np.isfinite(trainer.last_eval["psnr"]) or not snap.exists():
        fail("train app: no finite evaluation or no snapshot")
    if n_densify != 2 or trainer.last_densify_info is None:
        fail("train app: the densification boundaries did not run")
    if train_launches != want:
        fail(f"train path launches {train_launches}, expected {want}")
    for name, leaf in trainer.gaussians.params_dict().items():
        if not bool(torch.isfinite(leaf).all()):
            fail(f"train app: parameter {name} is not finite")
    trace = train_model / "profile" / f"trace_{PROFILE[0]}_{PROFILE[1]}.json"
    ckpts = [train_model / "checkpoints" / f"ckp{it}.pkl" for it in CHECKPOINTS]
    if not trace.is_file() or not all(c.is_file() for c in ckpts):
        fail(f"train app: missing checkpoints {ckpts} or trace {trace}")
    t0 = time.perf_counter()
    resumed = train_app.main(argv + ["-m", str(root / "train_resumed"),
                                     "--start_checkpoint", str(ckpts[0])])
    resume_wall = time.perf_counter() - t0
    if resumed.iteration != TRAIN_ITERS or not all(
            bool(torch.isfinite(leaf).all())
            for leaf in resumed.gaussians.params_dict().values()):
        fail(f"resumed train app: iteration {resumed.iteration}, parameters "
             f"not finite")
    resumed_loss = float(resumed.last_metrics["loss"])
    bad = differing(training_state(resumed), training_state(trainer))
    print(f"[smoke] train app checkpoints {[c.stat().st_size for c in ckpts]} "
          f"bytes, trace {trace.stat().st_size} bytes; resumed from "
          f"{ckpts[0].name} to {resumed.iteration} in {resume_wall:.1f} s, "
          f"alive {resumed.gaussians.num_alive} (uninterrupted "
          f"{trainer.gaussians.num_alive}), last loss {resumed_loss!r} "
          f"(uninterrupted {loss!r}); tensors not bit-equal: {bad}")
    if bad:
        fail(f"resumed train app is not bit-equal to the uninterrupted run "
             f"in {bad}")
    del resumed
    determinism_phase(trainer, "train-full geometry")

    # Steps timed through the trainer's own step functions (no maintenance
    # inside the window), then one geometry step profiled.
    def one_step(geometry: bool):
        view = trainer._next_view()
        nearest, has = choose_neighbor(trainer.rng,
                                       trainer.scene.nearest_table[view],
                                       trainer.scene.nearest_mask[view], view)
        (trainer.gaussians, trainer.opt_state, trainer.stats,
         out) = trainer._get_step(geometry)(
            trainer.gaussians, trainer.opt_state, trainer.stats, view,
            nearest, has, trainer.iteration, trainer.active_sh_degree,
            trainer.generator)
        return out

    torch.cuda.reset_peak_memory_stats()
    warm_ms = time_ms(lambda: one_step(False), 5)
    geo_ms = time_ms(lambda: one_step(True), 10)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with torch.no_grad():
        pkg = render(trainer.gaussians, trainer.scene.train_cameras[0],
                     torch.zeros(3, device=dev), trainer.active_sh_degree,
                     geometry_stage=True, chunk=trainer.pipe.chunk,
                     instance_cap=trainer.instance_cap)
    print(f"[smoke] train step at {TRAIN_W}x{TRAIN_H}, "
          f"{trainer.gaussians.num_alive} Gaussians, "
          f"{int(pkg['num_instances'])} instances in view 0: warmup "
          f"{warm_ms:.2f} ms/step (median of 5), geometry {geo_ms:.2f} "
          f"ms/step (median of 10), CUDA events, on {card}; peak memory "
          f"{peak:.2f} GiB")
    profile_call("geometry step", lambda: one_step(True), geo_ms)

    # The trim alone on the trained Gaussians, after the timed steps (its
    # profiler session would otherwise precede them).
    trim_phase(trainer, card)

    # --- phase 6: the kernels at the shapes the train path gives them ------
    mark("phase 6")
    # After the timed steps, so the plain versions' large buffers do not sit
    # in the allocator while steps are timed. The trained Gaussians on view 0
    # at 800x600, the geometry stage's V=8 (feature_count 5), the trainer's
    # chunk and instance cap.
    train_kernels = kernel_phases(
        "train-full", trainer.gaussians, trainer.scene.train_cameras[0],
        trainer.pipe.chunk, trainer.instance_cap, 5, trainer.active_sh_degree)
    train_kernels["adam"] = train_tap.reports()

    # --- phase 6a: the viewer bridge with train-full's Gaussians -----------
    mark("phase 6a")
    viewer_path(trainer, card)
    del trainer

    # --- phase 6b: two data-parallel ranks of the train app (dp-train) -----
    mark("phase 6b")
    dp_kernels, dp_launches = dp_path(root, train_dir, card, dev, geo_ms)

    material_kernels, mat_launches = material_path(root, train_dir, argv,
                                                   card, dev)

    # --- phase 7: the quality gate at the JAX package's smoke scale ---------
    mark("phase 7")
    q, gate, q_launches, q_tap = quality_path(root / "quality", card)

    # --- phase 8: the kernels at the shapes the quality path gives them ----
    mark("phase 8")
    # The gate's trained Gaussians (its iteration-600 snapshot's state) on
    # view 0 at 120x90, the steps' V=8 (feature_count 5), chunk 64 and its
    # trainer's instance cap.
    quality_kernels = kernel_phases(
        "quality-smoke", gate.gaussians, gate.scene.train_cameras[0],
        gate.pipe.chunk, gate.instance_cap, 5, gate.active_sh_degree)
    quality_kernels["adam"] = q_tap.reports()

    # --- phase 9: the material gate at smoke scale ---------------------------
    mark("phase 9")
    material_gate_path(root / "material_gate", card)

    # --- phase 10: LPIPS on the card, the metrics app's LPIPS column --------
    mark("phase 10")
    lpips_path(root, model_dir, card, args.seed)

    # --- phase 11: the quality gate on the composite scene at smoke scale ---
    mark("phase 11")
    composite_path(root / "composite", card)
    del gate
    torch.cuda.empty_cache()   # the runners' apps run in processes of their own

    # --- phase 12: the TnT protocol through run_tnt (tnt-protocol) ----------
    mark("tnt-protocol")
    tnt = tnt_protocol_path(root, card, args.seed)
    tnt_kernels = model_kernels("tnt-protocol", tnt["model"], 5, tnt["cap"],
                                dev)
    torch.cuda.empty_cache()

    # --- phase 13: the DTU protocol through run_dtu (dtu-protocol) ----------
    mark("dtu-protocol")
    dtu = dtu_protocol_path(root, card, args.seed)
    # (K3 is not on this path: the trim's first boundary, 1,000, lies past
    # its 600 iterations.)
    dtu_kernels = model_kernels("dtu-protocol", dtu["model"], 5, dtu["cap"],
                                dev)
    torch.cuda.empty_cache()

    # --- phase 14: turntables of the dtu-protocol model and its mesh --------
    mark("turntable")
    tt_kernels, tt_launches = turntable_path(root, dtu["model"], dtu["mesh"],
                                             card)
    torch.cuda.empty_cache()

    # --- phase 15: Shiny Blender's ball through run_shiny (shiny-protocol) --
    mark("shiny-protocol")
    shiny = shiny_protocol_path(root, card, args.seed)
    shiny_kernels = model_kernels("shiny-protocol", shiny["model"], 9,
                                  shiny["cap"], dev)
    shiny_launches = {name: shiny["by_width"].get((name, 16), 0)
                      for name in ("blend_fwd", "blend_bwd", "instance_sum")}
    shiny_launches.update({name: shiny["launches"][name]
                           for name in ("preprocess_fwd", "preprocess_bwd",
                                        "adam")})

    # One record per kernel and path, each from the kernel phase run at that
    # path's own shapes. K2 and K3 at the render cell (V=16) and K3 at the
    # quality cell are checked above, but their paths do not launch them
    # (the render app takes no backward; the gate's trim would fire at
    # 1,000), so they have no record here; nor has the preprocess backward
    # at the render cell. The material and shiny cells' records are K1 and
    # K2 at V=16, with their V=16 launches; the runner cells' launches are
    # summed over the apps each runner started. The sp cells' preprocess
    # runs on render-full's Gaussians and view, so their records carry
    # render-full's preprocess reports. The preprocess pair replaces no
    # kernel: the JAX package computes it in XLA code (project and the
    # Gaussians' activations); nor does Adam (its optimiser is XLA code).
    # Adam has one record per set of groups a training path updates (the
    # material cell's light as "<cell>-light"): held on the path's own kept
    # update (AdamTap), its launches the tap's count of them, which must add
    # up to the path's; the runner cells' on their snapshot (adam_model),
    # their launches the path's.
    pre = lambda *names: {k: render_kernels[k] for k in names}
    replaces = {"blend_fwd": "ops/blend_pallas.py:125",
                "blend_bwd": "ops/blend_pallas.py:322",
                "blend_obs": "ops/blend_pallas.py:227",
                "preprocess_fwd": "ops/projection.py:132",
                "preprocess_bwd": "ops/projection.py:132",
                "adam": "train/optim.py:42",
                "instance_sum": "ops/blend_pallas.py:513"}
    records = []
    for cell, reports, path_launches in (
            ("train-full", train_kernels, train_launches),
            ("render-full", pre("blend_fwd", "preprocess_fwd"), launches),
            ("quality-smoke", {k: quality_kernels[k]
                               for k in ("blend_fwd", "blend_bwd",
                                         "preprocess_fwd", "preprocess_bwd",
                                         "adam")},
             q_launches),
            ("train-material", material_kernels, mat_launches),
            ("dp-train", {k: dp_kernels[k]
                          for k in ("blend_fwd", "blend_bwd",
                                    "preprocess_fwd", "preprocess_bwd",
                                    "adam")},
             dp_launches),
            ("sp-render", {**sp_kernels["sp-render"], **pre("preprocess_fwd")},
             sp_launches["sp-render"]),
            ("sp-grad", {**sp_kernels["sp-grad"],
                         **pre("preprocess_fwd", "preprocess_bwd")},
             sp_launches["sp-grad"]),
            ("dtu-protocol", dtu_kernels, dtu["launches"]),
            ("turntable-model", tt_kernels["model"], tt_launches["model"]),
            ("turntable-mesh", tt_kernels["mesh"], tt_launches["mesh"]),
            ("tnt-protocol", tnt_kernels, tnt["launches"]),
            ("shiny-protocol", shiny_kernels, shiny_launches)):
        rows = [(name, cell, rep, path_launches[name])
                for name, rep in reports.items() if name != "adam"]
        # The reduce pair, held and timed in each K2 phase, as one record.
        if "blend_bwd" in reports:
            rows.append(("instance_sum", cell,
                         reports["blend_bwd"]["instance_sum"],
                         path_launches["instance_sum"]))
        adam = reports.get("adam", {})
        if adam and all(r["on_path"] for r in adam.values()):
            tapped = sum(r["launches"] for r in adam.values())
            if tapped != path_launches["adam"]:
                fail(f"{cell}: the adam tap counted {tapped} launches, the "
                     f"path {path_launches['adam']}")
        for key, rep in adam.items():
            rows.append(("adam", cell if key == "xyz" else f"{cell}-{key}",
                         rep, rep["launches"] if rep["on_path"]
                         else path_launches["adam"]))
        for name, rec_cell, rep, n in rows:
            source = ("preprocess" if name.startswith("preprocess")
                      else name)
            records.append({
                "name": name, "cell": rec_cell, "route": "cuda",
                "source": f"gs2m_tpu_torch/csrc/{source}.cu",
                "replaces": f"gs2m_tpu/{replaces[name]}",
                "launches": n, "max_abs_err": rep["max_abs_err"],
                "ms": rep["ms"], "plain_ms": rep["plain_ms"],
                "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
                "library_ms": None, "V": rep.get("V")})
    print(f"[smoke] total wall {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
