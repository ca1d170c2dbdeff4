"""Training CLI: the warmup, geometry and (--material) material stages.

Port of gs2m_tpu/apps/train.py: the same flag surface (model, pipeline and
optimization groups, test/save iteration lists), the same staging
defaults, cfg_args.json persistence for the render app, train_log.jsonl
every 100 iterations, PLY snapshots at the save iterations, versioned
checkpoints (checkpoints/ckp{it}.pkl at --checkpoint_iterations, resumed
with --start_checkpoint) and a torch.profiler trace (--profile_iterations
START STOP: opened before iteration START and closed after iteration STOP,
as the JAX package's window, written under <model>/profile/). --material
trains the material stage (from geometry_from_iter on) against a learned
cubemap light and writes lighting.pkl with each snapshot; the run's last
line prints the instance cap. The JAX package's blend flags are accepted
and have no effect here (core/config.py). Runs on CUDA (default) or,
when asked, on the CPU.

--data_parallel trains one view per rank of a torch.distributed group per
step (parallel/dp.py), joined from torchrun's environment; a plain launch
is a world of one. Without --distributed every rank loads every image and
draws the same global batch; with it each rank draws from its own view
partition and loads only its closure of images (--distributed with more
than one rank requires --data_parallel). Rank 0 alone writes the config,
logs, snapshots, checkpoints and the profile, and evaluates.

Usage: python -m gs2m_tpu_torch.apps.train -s <scene> -m <out> [--iterations N]
       torchrun --nproc_per_node N -m gs2m_tpu_torch.apps.train -s <scene> \
           -m <out> --data_parallel [--distributed]
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from argparse import ArgumentParser

import numpy as np
import torch


def start_profiler(device: torch.device):
    """A running torch.profiler session: CPU activity, and CUDA activity on
    a card. Syncs the device first so the window's wall starts clean."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    profiler = profile(activities=activities)
    profiler.start()
    profiler.t0 = time.perf_counter()
    return profiler


def profile_summary(profiler, wall_ms: float, top: int = 25) -> dict:
    """The window's device time by kernel (self time, from key_averages;
    the device spans of profiler ranges are not kernels), its sum (busy
    ms), launches, the idle share of the profiled wall and the train steps'
    device time by stage (step_stages)."""
    from torch.autograd import DeviceType

    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key[:90])
                   for e in profiler.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    return {"wall_ms": wall_ms, "busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms if wall_ms > 0 else None,
            "launches": sum(r[1] for r in rows),
            "stages": step_stages(profiler, busy),
            "kernels": [{"ms": ms, "count": n, "name": name}
                        for ms, n, name in rows[:top]]}


def step_stages(profiler, busy_ms: float) -> dict:
    """Device ms of the profiled train steps by stage, from the spans of
    train/trainer.py::make_train_step (utils/spans.py::STAGES): "render"
    (the step's renders), "pbr" (the PBR pass with build_mips), "losses"
    (the rest of the forward), "backward" (what step/backward launches,
    and every kernel launched on the autograd engine's own threads, where
    a card's backward runs), "reduce" (the data-parallel step's
    collectives), "update" (densification statistics and Adam), "light"
    (the light's Adam step) and "other" (the rest of `busy_ms`: work
    outside the steps). Empty when the window holds no step."""
    from torch.autograd import DeviceType

    from gs2m_tpu_torch.utils.spans import STAGES

    ev = [e for e in profiler.events() if e.device_type == DeviceType.CPU]
    steps = {e.thread for e in ev if e.name == STAGES["forward"]}
    if not steps:
        return {}

    def ms(stage):
        return sum(e.device_time_total for e in ev
                   if e.name == STAGES[stage]) / 1e3

    engine = sum(e.device_time_total for e in ev
                 if e.cpu_parent is None and e.thread not in steps) / 1e3
    out = {"render": ms("render"), "pbr": ms("pbr")}
    out["losses"] = ms("forward") - out["render"] - out["pbr"]
    out["backward"] = ms("backward") + engine
    out["reduce"] = ms("reduce")
    out["update"] = ms("update")
    out["light"] = ms("light")
    out["other"] = busy_ms - sum(out.values())
    return out


def stop_profiler(profiler, device: torch.device, out_dir: str, window):
    """Sync the device, close the session, write its Chrome trace and, on a
    card, its summary (summary_<start>_<stop>.json: busy ms, idle share of
    the profiled wall, launches, the top kernels by device time)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall_ms = (time.perf_counter() - profiler.t0) * 1e3
    profiler.stop()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"trace_{window[0]}_{window[1]}.json")
    profiler.export_chrome_trace(path)
    print(f"[>] profile trace written to {path}")
    if device.type == "cuda":
        summary = profile_summary(profiler, wall_ms)
        with open(os.path.join(out_dir, f"summary_{window[0]}_{window[1]}"
                               ".json"), "w") as f:
            json.dump(summary, f, indent=1)
        print(f"[>] profile {window[0]}..{window[1]}: device busy "
              f"{summary['busy_ms']:.2f} ms of {wall_ms:.2f} ms wall (idle "
              f"share {summary['idle_share']:.3f}, under the profiler), "
              f"{summary['launches']} launches")


def main(argv=None):
    """Train; returns the Trainer (its state is the trained model)."""
    from gs2m_tpu_torch import resolve_device
    from gs2m_tpu_torch.core.config import (ModelConfig, OptimConfig,
                                            PipelineConfig, add_group_args,
                                            extract_group)

    parser = ArgumentParser(description="gs2m_tpu_torch training")
    add_group_args(parser, ModelConfig)
    add_group_args(parser, PipelineConfig)
    add_group_args(parser, OptimConfig)
    parser.add_argument("--test_iterations", nargs="+", type=int,
                        default=[5_000, 7_000, 10_000, 15_000, 20_000, 25_000,
                                 30_000])
    parser.add_argument("--save_iterations", nargs="+", type=int,
                        default=[7_000, 30_000])
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int,
                        default=[])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--profile_iterations", nargs=2, type=int,
                        default=None, metavar=("START", "STOP"))
    parser.add_argument("--data_parallel", action="store_true")
    parser.add_argument("--distributed", action="store_true")
    args = parser.parse_args(argv)

    model_cfg = extract_group(args, ModelConfig)
    pipe = extract_group(args, PipelineConfig)
    opt = extract_group(args, OptimConfig)
    proc = None
    if args.data_parallel or args.distributed:
        from gs2m_tpu_torch.parallel.dp import join_process_group
        proc = join_process_group(args.device)
        device = proc.device
        print(f"[>] rank {proc.rank} of {proc.world}: backend "
              f"{proc.backend}, device {device}", flush=True)
    else:
        device = resolve_device(args.device)
    try:
        if proc is not None and proc.world > 1 and args.distributed \
                and not args.data_parallel:
            # Without DP the view pool stays global while each rank loaded
            # only its own images (other rows zero): refused, as the JAX
            # package refuses it.
            raise SystemExit("--distributed with more than one rank requires "
                             "--data_parallel (per-rank view partitions only "
                             "make sense under data parallelism)")
        return train(args, model_cfg, pipe, opt, device, proc)
    finally:
        if proc is not None and proc.created:
            import torch.distributed as dist
            dist.destroy_process_group()


def load_scene(model_cfg, opt, device, proc=None, distributed=False):
    """The training scene of this rank: every image, or under
    `distributed` with more than one rank only the closure of the rank's
    view partition (parallel/dp.py). Ranks other than 0 write nothing to
    the model directory."""
    from gs2m_tpu_torch.data.scene import Scene

    rank, world = (0, 1) if proc is None else (proc.rank, proc.world)
    if rank != 0:
        model_cfg = dataclasses.replace(model_cfg, model_path="")
    if not (distributed and world > 1):
        return Scene(model_cfg, opt, device=device)
    from gs2m_tpu_torch.parallel.dp import host_view_closure, partition_views
    scene = Scene(model_cfg, load_images=False, device=device)
    scene.training_setup(opt)
    local = partition_views(len(scene.train_cameras), rank, world)
    closure = host_view_closure(local, scene.nearest_table, scene.nearest_mask,
                                scene.nearby_table, scene.nearby_mask)
    scene.load_train_image_subset(closure)
    print(f"[>] rank {rank} of {world}: {len(local)} local views, "
          f"{len(closure)} images loaded", flush=True)
    return scene


def train(args, model_cfg, pipe, opt, device, proc=None):
    """The training loop of main (on every rank under data parallelism)."""
    from gs2m_tpu_torch.core.config import save_cfg_args
    from gs2m_tpu_torch.train.reporting import TrainingReporter, evaluate_views
    from gs2m_tpu_torch.train.trainer import Trainer

    rank = 0 if proc is None else proc.rank
    quiet = args.quiet or rank != 0
    say = print if rank == 0 else (lambda *a, **k: None)
    save_iterations = sorted(set(args.save_iterations + [opt.iterations]))
    os.makedirs(model_cfg.model_path, exist_ok=True)
    if rank == 0:
        save_cfg_args(model_cfg.model_path, model_cfg, pipe, opt)

    say(f"[>] Loading scene: {model_cfg.source_path}")
    scene = load_scene(model_cfg, opt, device, proc, args.distributed)
    say(f"[>] {len(scene.train_cameras)} train / {len(scene.test_cameras)} "
        f"test views at {scene.train_cameras[0].width}x"
        f"{scene.train_cameras[0].height}; extent {scene.cameras_extent:.3f}")
    reporter = TrainingReporter(model_cfg.model_path, enable=not quiet)
    pbr_fns = None
    if model_cfg.material:
        from gs2m_tpu_torch.pbr import make_pbr_fns
        pbr_fns = make_pbr_fns(device=device)
    trainer = Trainer(model_cfg, pipe, opt, scene, pbr_fns=pbr_fns,
                      data_parallel=args.data_parallel,
                      distributed=args.distributed)
    if args.data_parallel:
        say(f"[>] Data-parallel over {trainer.n_devices} ranks "
            f"({trainer.n_devices} views/step)")
    if args.start_checkpoint:
        trainer.load_checkpoint(args.start_checkpoint)
        say(f"[>] Resumed from {args.start_checkpoint} at iteration "
            f"{trainer.iteration}")
    say(f"[>] Capacity {trainer.gaussians.capacity}, "
        f"{trainer.gaussians.num_alive} alive, on {device}")
    # The train split's evaluation: the first five views (of the loaded
    # ones, where a rank loaded a subset).
    eval_views = (list(range(min(5, len(scene.train_cameras))))
                  if scene.loaded_views is None
                  else sorted(scene.loaded_views)[:5])

    t0 = time.time()
    log_path = (os.path.join(model_cfg.model_path, "train_log.jsonl")
                if rank == 0 else os.devnull)
    ema = None
    prof = args.profile_iterations if rank == 0 else None
    profiler = None
    with open(log_path, "a") as log_file:
        while trainer.iteration < opt.iterations:
            if prof and trainer.iteration + 1 == prof[0]:
                profiler = start_profiler(device)
            metrics = trainer.train_step()
            it = trainer.iteration
            if profiler is not None and it == prof[1]:
                stop_profiler(profiler, device, os.path.join(
                    model_cfg.model_path, "profile"), prof)
                profiler = None
            # Metrics stay on the device; reading them every step would add a
            # host sync per iteration.
            if it % 100 == 0:
                loss = float(metrics["loss"])
                ema = loss if ema is None else 0.4 * loss + 0.6 * ema
                if not np.isfinite(loss):
                    print(f"[!] non-finite loss at iteration {it} — model "
                          f"state is likely corrupted", flush=True)
                # Corrupt params can render as pure background (finite
                # loss): check the leaves themselves.
                for name, leaf in trainer.gaussians.params_dict().items():
                    if not bool(torch.isfinite(leaf).all()):
                        print(f"[!] non-finite values in param '{name}' at "
                              f"iteration {it}", flush=True)
                        break
                alive = trainer.gaussians.num_alive
                dt = time.time() - t0
                if not quiet:
                    print(f"[{it:>6}] loss {ema:.5f} Lrgb "
                          f"{float(metrics['Lrgb']):.5f} Lgeo "
                          f"{float(metrics['Lgeo']):.5f} Lmat "
                          f"{float(metrics['Lmat']):.5f} points {alive} "
                          f"({it / dt:.1f} it/s)", flush=True)
                rec = {"iteration": it, "loss": ema, "points": alive,
                       "elapsed_s": dt, "dropped": int(metrics["dropped"]),
                       "mv_active": trainer.mv_active_count,
                       "rough_active": trainer.rough_active_count}
                if trainer.last_trim_seconds is not None:
                    rec["trim_s"] = round(trainer.last_trim_seconds, 2)
                log_file.write(json.dumps(rec) + "\n")
                log_file.flush()
                reporter.scalars(it, {k: float(v) for k, v in metrics.items()},
                                 alive, iter_time_ms=1e3 * dt / it)

            if it in args.test_iterations and rank == 0:
                res = evaluate_views(trainer,
                                     [scene.train_cameras[v] for v in eval_views],
                                     scene.gt_images[eval_views],
                                     log_images_to=reporter, iteration=it,
                                     tag="train")
                line = f"[ITER {it:>6}] train PSNR {res['psnr']:.2f}"
                if "psnr_pbr" in res:
                    line += f" (PBR {res['psnr_pbr']:.2f})"
                if scene.test_cameras:
                    tres = evaluate_views(trainer, scene.test_cameras,
                                          scene.load_test_images(),
                                          log_images_to=reporter, iteration=it,
                                          tag="test")
                    line += (f"  test PSNR {tres['psnr']:.2f} L1 "
                             f"{tres['l1']:.4f} ({len(scene.test_cameras)} "
                             f"views)")
                    scal = {"test_psnr": tres["psnr"], "test_l1": tres["l1"]}
                    if "psnr_pbr" in tres:
                        # The material stage's quality signal is the PBR
                        # render.
                        line += f"  test PSNR(PBR) {tres['psnr_pbr']:.2f}"
                        scal.update(test_psnr_pbr=tres["psnr_pbr"],
                                    test_l1_pbr=tres["l1_pbr"])
                    reporter.scalars(it, scal, trainer.gaussians.num_alive)
                    log_file.write(json.dumps({"iteration": it, **scal})
                                   + "\n")
                    log_file.flush()
                trainer.last_eval = res
                print(line)
                g = trainer.gaussians
                reporter.histogram(it, "scene/opacity_histogram",
                                   torch.sigmoid(g.opacity[g.alive]))

            if it in save_iterations and rank == 0:
                print(f"[ITER {it:>6}] Saving snapshot")
                trainer.save_snapshot(it)
            if it in args.checkpoint_iterations:
                trainer.save_checkpoint(os.path.join(
                    model_cfg.model_path, "checkpoints", f"ckp{it}.pkl"))

    if profiler is not None:  # the run ended inside the window
        stop_profiler(profiler, device,
                      os.path.join(model_cfg.model_path, "profile"), prof)
    wall_min = (time.time() - t0) / 60.0
    if rank == 0:
        with open(os.path.join(model_cfg.model_path, "runtime.json"),
                  "w") as f:
            json.dump({"minutes": wall_min, "iterations": opt.iterations}, f)
    say(f"[>] Training complete in {wall_min:.1f} min; instance cap "
        f"{trainer.instance_cap}")
    reporter.close()
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
