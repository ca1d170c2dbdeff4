"""Staged training loop: RGB warmup -> geometry -> (optional) material.

Port of gs2m_tpu/train/trainer.py: per iteration a random view, the staged
losses (L_rgb + plane + alpha; + multi-view and depth-normal in the
geometry stage; in the material stage, which starts with geometry, the
PBR / smoothness / normal-TV / roughness losses in place of L_rgb, with
the learned cubemap light stepped by its own Adam), densification every
100 iterations in (densify_from_iter, densify_until_iter], the multi-view
observe trim every 1000, opacity resets, an SH degree bump every 1000, and
growth of the instance buffer on binning overflow (`dropped`).

PyTorch runs eagerly, so `make_train_step` and friends are plain functions:
one Python call per step, autograd for the backward (the blend's backward
is kernel K2), and the package's own Adam updating the parameters in place.
Where the JAX package fuses the geometry step's main and nearest renders
into one pair core (blend_pallas.py:712-936), the port takes that
package's own non-pair branch: two render() calls. Its backward compaction
(`compact_bwd`) has no counterpart: K2 skips chunks whose tile had
terminated. Nor has its binning termination cut, which was exact, so
every render, loss and gradient is the uncut one: the trainer bins with
one instance cap, grown on overflow at the 100-iteration boundaries. Both
flags stay in PipelineConfig for cfg_args.json compatibility and have no
effect here, like `use_pallas`.

Data parallelism (parallel/dp.py): with `data_parallel`, each rank of a
torch.distributed group trains on its own view of a D-view batch per
step and the step reduces the gradients, statistics and metrics over the
group before the update, so the replicated state (parameters, Adam
moments, statistics, light) stays bit-equal on every rank. Every host-side
decision (capacity growth, densification, heal, trim, opacity reset) reads
only replicated or reduced values, so every rank takes the same branch.
Without `distributed` every rank draws the same global batch from the
shared host rng and takes its own entry; with it each rank draws from its
own partition of the views (parallel/dp.py::partition_views).

Randomness: host-side choices (the view order, each step's nearest view
and, in the material stage, its nearby view) come from a numpy Generator
seeded from `seed`, as the JAX package's view order does. Device-side
draws come from two torch.Generators on the device: the per-view pixel
samples of the multi-view and roughness losses from `generator`, one
stream per rank, and the split noise of densification, which changes the
replicated state, from `replica_generator`, one stream that advances
identically on every rank (the JAX package's base key and per-device
splits). Host syncs happen only at the 100-iteration boundaries (overflow
check, densification) and at the trim; the loss-activity counters count
host-side choices (under data parallelism, reduced device counts).
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import time

import numpy as np
import torch

from gs2m_tpu_torch.core.config import ModelConfig, OptimConfig, PipelineConfig
from gs2m_tpu_torch.core.gaussians import Gaussians
from gs2m_tpu_torch.data.scene import Scene
from gs2m_tpu_torch.models import losses as L
from gs2m_tpu_torch.models.render import count_observed, render
from gs2m_tpu_torch.train import densify as D
from gs2m_tpu_torch.train.optim import (AdamState, adam_init, adam_update,
                                        group_lrs, xyz_lr_schedule)
from gs2m_tpu_torch.utils.spans import STAGES, set_step, span


def choose_neighbor(rng: np.random.Generator, table_row: np.ndarray,
                    mask_row: np.ndarray, self_idx: int) -> tuple[int, bool]:
    """A random valid neighbor index; the view itself when none is valid."""
    count = int(mask_row.sum())
    r = int(rng.integers(0, max(count, 1)))
    return (int(table_row[r]), True) if count > 0 else (self_idx, False)


def make_view_objective(model_cfg: ModelConfig, pipe: PipelineConfig,
                        opt: OptimConfig, scene: Scene, instance_cap: int,
                        geometry_stage: bool, material_stage: bool = False,
                        pbr_fns: dict | None = None):
    """The per-view staged loss as a function of the parameters (and, in
    the material stage, of the light)."""
    if material_stage and pbr_fns is None:
        raise ValueError("the material stage needs pbr_fns "
                         "(pbr.render.make_pbr_fns)")
    use_alpha_loss = model_cfg.white_background or model_cfg.mask_gt
    render_kw = dict(tile=pipe.tile, chunk=pipe.chunk,
                     instance_cap=instance_cap, z_depth=pipe.z_depth,
                     blend_metallic=model_cfg.metallic)

    def view_objective(gaussians: Gaussians, params: dict, sink, abs_sink,
                       view_idx: int, nearest_idx: int, has_nearest: bool,
                       active_sh_degree: int,
                       generator: torch.Generator | None = None,
                       mv_indices: torch.Tensor | None = None,
                       light: torch.Tensor | None = None,
                       nearby_idx: int = 0, has_nearby: bool = False):
        cam = scene.train_cameras[view_idx]
        gt = scene.gt_images[view_idx]
        bg = gt.new_zeros(3)
        g = gaussians.with_params(params)
        with span(STAGES["render"]):
            pkg = render(g, cam, bg, active_sh_degree,
                         geometry_stage=geometry_stage,
                         material_stage=material_stage,
                         sobel_normal=geometry_stage, m2d_sink=sink,
                         m2d_abs_sink=abs_sink, **render_kw)

        rgb = L.clip(pkg["render"], 0.0, 1.0)
        Lrgb = L.rgb_loss(rgb, gt, opt.lambda_ssim)
        loss = opt.lambda_plane * L.plane_loss(pkg["visibility_filter"],
                                               g.get_scaling)
        if use_alpha_loss:
            loss = loss + opt.lambda_alpha * L.binary_cross_entropy(
                pkg["alpha_map"], scene.alpha_masks[view_idx])
        if not material_stage:
            loss = loss + Lrgb

        Lgeo = gt.new_zeros(())
        dropped = pkg["dropped"]
        if geometry_stage:
            nearest_cam = scene.train_cameras[nearest_idx]
            with span(STAGES["render"]):
                npkg = render(g, nearest_cam, bg, active_sh_degree,
                              geometry_stage=True,
                              material_stage=material_stage, **render_kw)
            dropped = torch.maximum(dropped, npkg["dropped"])
            Ldn = L.depth_normal_loss(pkg["normal_map"], pkg["sobel_map"], gt)
            Lgeo = opt.lambda_depth_normal * Ldn
            if has_nearest and opt.lambda_multi_view != 0.0:
                mv = L.multi_view_loss(
                    opt, cam, nearest_cam, pkg, npkg,
                    scene.gray_images[view_idx], scene.gray_images[nearest_idx],
                    material_stage, scene.ncc_scale, generator=generator,
                    indices=mv_indices)
                Lgeo = Lgeo + opt.lambda_multi_view * mv.loss
            loss = loss + Lgeo

        Lmat = gt.new_zeros(())
        if material_stage:
            Lmat, _ = pbr_fns["material_losses"](
                g, cam, pkg, gt, light, opt, model_cfg,
                scene.train_cameras[nearby_idx], has_nearby,
                scene.gray_images[view_idx], scene.gray_images[nearby_idx],
                scene.ncc_scale, active_sh_degree, render_kw,
                generator=generator)
            loss = loss + Lmat

        aux = {"Lrgb": Lrgb, "Lgeo": Lgeo, "Lmat": Lmat, "radii": pkg["radii"],
               "observe": pkg["observe"],
               "visibility": pkg["visibility_filter"], "dropped": dropped}
        return loss, aux

    return view_objective


def make_train_step(model_cfg: ModelConfig, pipe: PipelineConfig,
                    opt: OptimConfig, scene: Scene, instance_cap: int,
                    geometry_stage: bool, material_stage: bool = False,
                    pbr_fns: dict | None = None, reduce=None):
    """The step of one stage: loss, gradients, densification statistics and
    the in-place Adam update; in the material stage also the light's Adam
    step (at opacity_lr, then clamped to >= 0), in place on `light` and
    `light_opt_state`. `reduce` (parallel/dp.py::make_dp_train_step) maps
    this view's (parameter grads, light grad, statistics contribution,
    metrics) to the data-parallel batch's before the update. Its stages are
    spans (utils/spans.py::STAGES: "step/forward", "step/render",
    "step/pbr", "step/backward", "step/reduce", "step/update",
    "step/light"): profiler ranges under a profiler session, which
    apps/train.py::step_stages reads, and host times when the span
    recorder is on."""
    xyz_lr_fn = xyz_lr_schedule(opt, scene.cameras_extent)
    H = scene.train_cameras[0].height
    W = scene.train_cameras[0].width
    objective = make_view_objective(model_cfg, pipe, opt, scene, instance_cap,
                                    geometry_stage, material_stage, pbr_fns)

    def step(gaussians: Gaussians, opt_state: AdamState, stats: D.DensifyStats,
             view_idx: int, nearest_idx: int, has_nearest: bool,
             iteration: int, active_sh_degree: int,
             generator: torch.Generator | None = None,
             mv_indices: torch.Tensor | None = None,
             light: torch.Tensor | None = None,
             light_opt_state: AdamState | None = None,
             nearby_idx: int = 0, has_nearby: bool = False):
        with span(STAGES["forward"]):
            C = gaussians.capacity
            params = {k: v.detach().requires_grad_(True)
                      for k, v in gaussians.params_dict().items()}
            sink = gaussians.xyz.new_zeros(C, 2, requires_grad=True)
            abs_sink = gaussians.xyz.new_zeros(C, 2, requires_grad=True)
            light_leaf = (light.detach().requires_grad_(True)
                          if material_stage else None)
            loss, aux = objective(gaussians, params, sink, abs_sink, view_idx,
                                  nearest_idx, has_nearest, active_sh_degree,
                                  generator, mv_indices, light_leaf,
                                  nearby_idx, has_nearby)
        leaves = list(params.values()) + [sink, abs_sink]
        if material_stage:
            leaves.append(light_leaf)
        with span(STAGES["backward"]):
            grads = [torch.zeros_like(x) if g is None else g for x, g in zip(
                leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
        light_grad = grads.pop() if material_stage else None
        param_grads = dict(zip(params, grads))
        metrics = {"loss": loss.detach(), "Lrgb": aux["Lrgb"].detach(),
                   "Lgeo": aux["Lgeo"].detach(), "Lmat": aux["Lmat"].detach(),
                   "dropped": aux["dropped"],
                   "mv_active": int(geometry_stage and has_nearest),
                   "rough_active": int(material_stage and has_nearby)}
        with span(STAGES["update"]):
            contrib = D.stats_contribution(grads[-2], grads[-1],
                                           aux["visibility"], aux["radii"],
                                           aux["observe"], W, H)
        if reduce is not None:
            with span(STAGES["reduce"]):
                param_grads, light_grad, contrib, metrics = reduce(
                    param_grads, light_grad, contrib, metrics)
        with span(STAGES["update"]):
            stats = D.accumulate_stats(stats, contrib)
            lrs = group_lrs(opt, scene.cameras_extent, xyz_lr_fn(iteration))
            adam_update(gaussians.params_dict(), param_grads, opt_state, lrs)
        if material_stage:
            with span(STAGES["light"]):
                pbr_fns["light_update"](light, light_grad, light_opt_state,
                                        opt.opacity_lr)
        return gaussians, opt_state, stats, metrics

    return step


def make_observe_counter(scene: Scene, pipe: PipelineConfig,
                         instance_cap: int):
    """Count, per Gaussian, in how many train views it is observed (the
    trim prunes those seen in < 2 views), with the max binning overflow
    across views — the counts are trustworthy only when it is zero. Rides
    the observe-only pass (count_observed, kernel K3)."""

    def count(gaussians: Gaussians, active_sh_degree: int = 0):
        del active_sh_degree  # observe counts are color-free
        counts = torch.zeros(gaussians.capacity, dtype=torch.int32,
                             device=gaussians.device)
        drop = torch.zeros((), dtype=torch.int32, device=gaussians.device)
        for cam in scene.train_cameras:
            observe, dropped = count_observed(gaussians, cam, tile=pipe.tile,
                                              chunk=pipe.chunk,
                                              instance_cap=instance_cap)
            counts += (observe > 0).to(torch.int32)
            drop = torch.maximum(drop, dropped)
        return counts, drop

    return count


class Trainer:
    """Host-side orchestration: stage gates, schedules, capacity growth."""

    # The (8+V, I) f32 instance tables cost ~100 MB per 2^20 instances; the
    # JAX package's ceiling, kept.
    MAX_INSTANCE_CAP = 2 ** 26

    def __init__(self, model_cfg: ModelConfig, pipe: PipelineConfig,
                 opt: OptimConfig, scene: Scene, seed: int = 0,
                 pbr_fns: dict | None = None, data_parallel: bool = False,
                 group=None, distributed: bool = False):
        self.model_cfg, self.pipe, self.opt, self.scene = model_cfg, pipe, opt, scene
        self.device = scene.device
        # Data parallelism: one view per rank of `group` (None: the default
        # group) per step; without an initialized group, a world of one.
        # `distributed`: each rank draws from its own view partition (and
        # may have loaded only that partition's closure of images).
        self.data_parallel = data_parallel
        self.group = group
        self.rank, self.n_devices = 0, 1
        if data_parallel:
            from gs2m_tpu_torch.parallel.dp import rank_and_world
            self.rank, self.n_devices = rank_and_world(group)
        self.distributed = distributed and self.n_devices > 1
        # The material stage starts with geometry.
        self.material_from_iter = (opt.geometry_from_iter if model_cfg.material
                                   else opt.iterations)
        if model_cfg.material and pbr_fns is None:
            raise ValueError("the material stage needs pbr_fns "
                             "(pbr.render.make_pbr_fns)")
        self.pbr_fns = pbr_fns

        n0 = scene.info.points.shape[0]
        cap = max(2 ** int(np.ceil(np.log2(max(n0 * 4, 1024)))), 1024)
        self.gaussians = Gaussians.create(scene.info.points, scene.info.colors,
                                          model_cfg.sh_degree, capacity=cap,
                                          device=self.device)
        if opt.prune_init_points:
            self.gaussians = D.prune_init_points(self.gaussians)
        self.opt_state = adam_init(self.gaussians.params_dict())
        self.stats = D.DensifyStats.zeros(cap, self.device)
        self.active_sh_degree = 0
        # The learned environment light and its own Adam state (None
        # without the material stage).
        self.light_state = self.light_opt_state = None
        if model_cfg.material:
            self.light_state = pbr_fns["init_light"]()
            self.light_opt_state = pbr_fns["init_light_opt"](self.light_state)

        # Chunk alignment pads every nonempty tile to a chunk multiple, so the
        # instance buffer needs a per-tile floor on top of the per-Gaussian
        # multiplier; rounded like the JAX package's.
        H0, W0 = scene.train_cameras[0].height, scene.train_cameras[0].width
        n_tiles = (-(-H0 // pipe.tile)) * (-(-W0 // pipe.tile))
        want = int(pipe.instance_cap_mult * cap) + n_tiles * pipe.chunk
        gran = max(64 * pipe.chunk, 2 ** 13)
        self.instance_cap = max(-(-want // gran) * gran, 4 * pipe.chunk)

        self._steps: dict[tuple, object] = {}
        self._observe_counter = None
        # Running max of binning drops since the last boundary check, kept
        # on the device (no sync per step).
        self._dropped_window = torch.zeros((), dtype=torch.int32,
                                           device=self.device)
        if pipe.term_cut:
            print("[trainer] term_cut has no effect in this package: the "
                  "cut was exact, so the results are the same without it",
                  flush=True)
        # Always None: the JAX package's split cap, read only by the
        # benchmark's cap-change count (benchmark/cellkit/program.py::caps).
        self.expand_cap = None
        # Steps where the multi-view / roughness terms fired: host ints, or
        # device counts under data parallelism (read by the properties).
        self._mv_active = 0
        self._rough_active = 0
        self.rng = np.random.default_rng(seed)
        # Per-view draws: one stream per rank (rank 0's is the single-view
        # trainer's); the split noise: one stream, the same on every rank.
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed + 1_000_003 * self.rank)
        self.replica_generator = torch.Generator(
            device=self.device).manual_seed(seed + 1)
        self._view_pool: list[int] = []
        self.iteration = 0
        self.last_densify_info: dict | None = None
        self.last_trim_seconds: float | None = None
        self.last_metrics: dict | None = None   # the latest step's, on device
        self.last_eval: dict | None = None      # set by the train app

        for name, mask in (("nearest", scene.nearest_mask),
                           ("nearby", scene.nearby_mask)):
            n_bare = int(np.sum(~mask.any(axis=1)))
            if n_bare:
                print(f"[trainer] WARNING: {n_bare}/{mask.shape[0]} views have "
                      f"no {name} camera — their multi-view losses will be "
                      f"zero (widen the *_max_angle/_max_dist thresholds if "
                      f"unintended)", flush=True)

    # --- step dispatch ---------------------------------------------------------

    def _stage_flags(self, iteration: int) -> tuple[bool, bool]:
        # A model without the material stage stays without it past
        # opt.iterations too (steps driven beyond the schedule).
        return (iteration > self.opt.geometry_from_iter,
                self.model_cfg.material and iteration > self.material_from_iter)

    def _get_step(self, geometry_stage: bool, material_stage: bool = False):
        key = (geometry_stage, material_stage, self.gaussians.capacity,
               self.instance_cap)
        if key not in self._steps:
            if self.data_parallel:
                from gs2m_tpu_torch.parallel.dp import make_dp_train_step
                self._steps[key] = make_dp_train_step(
                    self.model_cfg, self.pipe, self.opt, self.scene,
                    self.instance_cap, geometry_stage, material_stage,
                    self.pbr_fns, group=self.group)
            else:
                self._steps[key] = make_train_step(
                    self.model_cfg, self.pipe, self.opt, self.scene,
                    self.instance_cap, geometry_stage, material_stage,
                    self.pbr_fns)
        return self._steps[key]

    @property
    def mv_active_count(self) -> int:
        return int(self._mv_active)

    @mv_active_count.setter
    def mv_active_count(self, value: int):
        self._mv_active = value

    @property
    def rough_active_count(self) -> int:
        return int(self._rough_active)

    @rough_active_count.setter
    def rough_active_count(self, value: int):
        self._rough_active = value

    def choose_views(self, material_stage: bool):
        """The next view, its nearest view and, in the material stage, its
        nearby view, all from the host rng: (view, nearest, has_nearest,
        nearby, has_nearby)."""
        scene = self.scene
        view = self._next_view()
        nearest, has_nearest = choose_neighbor(
            self.rng, scene.nearest_table[view], scene.nearest_mask[view], view)
        nearby, has_nearby = 0, False
        if material_stage:
            nearby, has_nearby = choose_neighbor(
                self.rng, scene.nearby_table[view], scene.nearby_mask[view], 0)
        return view, nearest, has_nearest, nearby, has_nearby

    def draw_batch(self, material_stage: bool):
        """This rank's entry of the step's view batch (choose_views' tuple).
        Under data parallelism without `distributed`, every rank draws the
        whole batch of n_devices views from the shared host rng and takes
        entry `rank`; with it, each rank draws its own view from its own
        partition."""
        if self.distributed or self.n_devices == 1:
            return self.choose_views(material_stage)
        batch = [self.choose_views(material_stage)
                 for _ in range(self.n_devices)]
        return batch[self.rank]

    def _next_view(self) -> int:
        if not self._view_pool:
            n = len(self.scene.train_cameras)
            if self.distributed:
                from gs2m_tpu_torch.parallel.dp import partition_views
                pool = partition_views(n, self.rank, self.n_devices).tolist()
            else:
                pool = list(range(n))
            self.rng.shuffle(pool)
            self._view_pool = pool
        return self._view_pool.pop()

    # --- public API ------------------------------------------------------------

    def train_step(self) -> dict:
        self.iteration += 1
        it = self.iteration
        set_step(it)
        if it % 1000 == 0 and self.active_sh_degree < self.gaussians.max_sh_degree:
            self.active_sh_degree += 1

        geometry_stage, material_stage = self._stage_flags(it)
        view, nearest, has_nearest, nearby, has_nearby = self.draw_batch(
            material_stage)
        (self.gaussians, self.opt_state, self.stats,
         metrics) = self._get_step(geometry_stage, material_stage)(
            self.gaussians, self.opt_state, self.stats, view, nearest,
            has_nearest, it, self.active_sh_degree, self.generator,
            light=self.light_state, light_opt_state=self.light_opt_state,
            nearby_idx=nearby, has_nearby=has_nearby)

        # No silent caps: binning overflow grows the instance buffer. The
        # window max catches drop bursts between the boundary checks too.
        self._dropped_window = torch.maximum(self._dropped_window,
                                             metrics["dropped"])
        self._mv_active = self._mv_active + metrics["mv_active"]
        self._rough_active = self._rough_active + metrics["rough_active"]
        if it % 100 == 0:
            dw = int(self._dropped_window)
            if dw > 0:
                self._grow_instance_cap(dropped=dw)
            self._dropped_window = torch.zeros_like(self._dropped_window)

        self._maintenance(it)
        self.last_metrics = metrics
        return metrics

    def _maintenance(self, it: int):
        opt = self.opt
        if it <= opt.densify_until_iter:
            if it > opt.densify_from_iter and it % opt.densification_interval == 0:
                self._heal_nonfinite_rows(it)
                self._maybe_grow()
                (self.gaussians, self.opt_state, self.stats,
                 info) = D.densify_and_prune(
                    self.gaussians, self.opt_state, self.stats,
                    opt.densify_grad_threshold, opt.densify_grad_abs_threshold,
                    opt.opacity_prune_threshold, self.scene.cameras_extent,
                    opt.percent_dense, opt.radii2D_threshold,
                    use_radii_threshold=it > opt.opacity_reset_interval,
                    generator=self.replica_generator)
                self.last_densify_info = {k: int(v) for k, v in info.items()}

        if (opt.use_multi_view_trim and it % 1000 == 0
                and it < opt.densify_until_iter):
            t0 = time.perf_counter()
            if self._observe_counter is None:
                self._observe_counter = make_observe_counter(
                    self.scene, self.pipe, self.instance_cap)
            counts, drop = self._observe_counter(self.gaussians,
                                                 self.active_sh_degree)
            drop = int(drop)
            self.last_trim_seconds = time.perf_counter() - t0
            if drop > 0:
                # Overflowed binning makes the counts untrustworthy: grow the
                # buffer and skip this trim (no silent mass-pruning).
                self._grow_instance_cap()
            else:
                trim = (counts < 2) & self.gaussians.alive
                if int(trim.sum()) < self.gaussians.num_alive:
                    self.gaussians, self.opt_state, self.stats = D.prune_rows(
                        self.gaussians, self.opt_state, self.stats, trim)

        if it <= opt.densify_until_iter:
            if opt.use_opacity_reduce and it % opt.opacity_reduce_interval == 0:
                self.gaussians, self.opt_state = D.reset_opacity(
                    self.gaussians, self.opt_state, cap=0.8)
            if it % opt.opacity_reset_interval == 0 or (
                    self.model_cfg.white_background
                    and it == opt.densify_from_iter):
                self.gaussians, self.opt_state = D.reset_opacity(
                    self.gaussians, self.opt_state, cap=0.01)

    def _grow_instance_cap(self, dropped: int | None = None):
        """Resize the instance buffer after overflow: to demand + 15% (in
        2^17 steps) when the drop count is known, else double."""
        if self.instance_cap >= self.MAX_INSTANCE_CAP:
            print(f"[trainer] WARNING: binning overflow at the maximum "
                  f"instance cap ({self.instance_cap}); instances will be "
                  f"dropped (farthest-in-depth last)", flush=True)
            return
        if dropped:
            want = int((self.instance_cap + int(dropped)) * 1.15)
            new_cap = -(-want // 2 ** 17) * 2 ** 17
        else:
            new_cap = self.instance_cap * 2
        self.instance_cap = min(max(new_cap, self.instance_cap + 2 ** 17),
                                self.MAX_INSTANCE_CAP)
        self._steps.clear()
        self._observe_counter = None

    def _heal_nonfinite_rows(self, it: int):
        """Prune rows with non-finite parameters instead of letting them
        poison densification copies."""
        g = self.gaussians
        bad = ~(torch.isfinite(g.xyz).all(-1) & torch.isfinite(g.opacity).all(-1)
                & torch.isfinite(g.scaling).all(-1)
                & torch.isfinite(g.rotation).all(-1)
                & torch.isfinite(g.features_dc).all(-1).all(-1)) & g.alive
        n_bad = int(bad.sum())
        if n_bad:
            print(f"[trainer] WARNING: pruning {n_bad} rows with non-finite "
                  f"parameters at iteration {it}", flush=True)
            self.gaussians, self.opt_state, self.stats = D.prune_rows(
                self.gaussians, self.opt_state, self.stats, bad)

    def _maybe_grow(self):
        """Double the capacity when fewer than 1/8 of the rows are free."""
        cap = self.gaussians.capacity
        if cap - self.gaussians.num_alive < cap // 8:
            new_cap = cap * 2
            self.gaussians, self.opt_state, self.stats = D.grow_capacity(
                self.gaussians, self.opt_state, self.stats, new_cap)
            self.instance_cap += int(self.pipe.instance_cap_mult
                                     * (new_cap - cap)
                                     // self.pipe.chunk * self.pipe.chunk)
            self._steps.clear()
            self._observe_counter = None

    # --- persistence -------------------------------------------------------------

    def save_snapshot(self, iteration: int):
        """PLY snapshot of the alive Gaussians, as the render app reads it,
        and with the material stage the light as lighting.pkl (a pickled
        numpy (6, R, R, 3) array, the JAX package's format)."""
        from gs2m_tpu_torch.data.ply import save_gaussian_ply

        g = self.gaussians
        alive = g.alive.cpu().numpy()

        def take(x):
            return x.detach().cpu().numpy()[alive]

        d = self.scene.save_dir(iteration)
        save_gaussian_ply(os.path.join(d, "point_cloud.ply"),
                          take(g.xyz), take(g.features_dc),
                          take(g.features_rest), take(g.opacity),
                          take(g.scaling), take(g.rotation), take(g.albedo),
                          take(g.roughness), take(g.metallic))
        if self.light_state is not None:
            with open(os.path.join(d, "lighting.pkl"), "wb") as f:
                pickle.dump(self.light_state.detach().cpu().numpy(), f)

    # Bump when the checkpoint layout changes; load_checkpoint refuses a
    # newer one instead of resuming from silently misread state.
    CHECKPOINT_VERSION = 2

    def save_checkpoint(self, path: str):
        """Pickle the whole training state as numpy arrays and Python
        scalars: the JAX package's version-2 top-level keys (its split cap
        always None, as the JAX package writes it without the termination
        cut; the light and its Adam state None without the material stage)
        plus the state that decides the next steps, so a resumed run repeats
        the uninterrupted one: the host rng, the device generators, the view
        pool and the drop window.
        Under data parallelism every rank must call it (the ranks' own
        rng, per-view generator and view pool are gathered into "ranks");
        rank 0 writes the file."""
        def host(x):
            return x.detach().cpu().numpy()

        g = self.gaussians
        gaussians = {f.name: host(getattr(g, f.name))
                     for f in dataclasses.fields(g) if f.name != "max_sh_degree"}
        gaussians["max_sh_degree"] = g.max_sh_degree
        state = {
            "version": self.CHECKPOINT_VERSION,
            "iteration": self.iteration,
            "active_sh_degree": self.active_sh_degree,
            "capacity": g.capacity,
            "instance_cap": self.instance_cap,
            "expand_cap": None,
            "gaussians": gaussians,
            "opt_state": {"mu": {k: host(v) for k, v in self.opt_state.mu.items()},
                          "nu": {k: host(v) for k, v in self.opt_state.nu.items()},
                          "count": self.opt_state.count},
            "stats": {f.name: host(getattr(self.stats, f.name))
                      for f in dataclasses.fields(self.stats)},
            "light_state": (None if self.light_state is None
                            else host(self.light_state)),
            "light_opt_state": (None if self.light_opt_state is None else {
                "mu": host(self.light_opt_state.mu["light"]),
                "nu": host(self.light_opt_state.nu["light"]),
                "count": self.light_opt_state.count}),
            "mv_active_count": self.mv_active_count,
            "rough_active_count": self.rough_active_count,
            "replica_generator": host(self.replica_generator.get_state()),
            "dropped_window": int(self._dropped_window),
        }
        local = {"rng": self.rng.bit_generator.state,
                 "generator": host(self.generator.get_state()),
                 "view_pool": list(self._view_pool)}
        state.update(local)
        if self.n_devices > 1:
            import torch.distributed as dist
            state["ranks"] = [None] * self.n_devices
            dist.all_gather_object(state["ranks"], local, self.group)
        if self.rank != 0:
            return
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(state, f)

    def load_checkpoint(self, path: str):
        """Restore a save_checkpoint pickle onto this trainer's device.
        Refuses a newer version and a capacity that does not match the
        restored arrays. The JAX package's checkpoints pickle its own
        classes (JAX arrays, its Gaussians and optimizer states), so the
        port cannot read them; resume those in the JAX package."""
        with open(path, "rb") as f:
            state = pickle.load(f)
        version = state.get("version", 1)
        if version > self.CHECKPOINT_VERSION:
            raise ValueError(
                f"checkpoint {path} is version {version}, this build reads "
                f"<= {self.CHECKPOINT_VERSION} — update the code or retrain")
        dev = self.device

        def dev_t(x):
            return torch.from_numpy(np.array(x)).to(dev)

        g = dict(state["gaussians"])
        max_sh = g.pop("max_sh_degree")
        gaussians = Gaussians(**{k: dev_t(v) for k, v in g.items()},
                              max_sh_degree=max_sh)
        if state["capacity"] != gaussians.capacity:
            raise ValueError(
                f"checkpoint capacity {state['capacity']} != restored array "
                f"capacity {gaussians.capacity} — corrupted checkpoint")
        o = state["opt_state"]
        self.gaussians = gaussians
        self.opt_state = AdamState(mu={k: dev_t(v) for k, v in o["mu"].items()},
                                   nu={k: dev_t(v) for k, v in o["nu"].items()},
                                   count=int(o["count"]))
        self.stats = D.DensifyStats(**{k: dev_t(v)
                                       for k, v in state["stats"].items()})
        self.iteration = int(state["iteration"])
        self.active_sh_degree = int(state["active_sh_degree"])
        # An older checkpoint's split cap and its two windows (written under
        # the termination cut) are ignored: one cap bins everything.
        self.instance_cap = int(state["instance_cap"])
        self.mv_active_count = int(state["mv_active_count"])
        self.rough_active_count = int(state.get("rough_active_count", 0))
        if state.get("light_state") is not None:
            lo = state["light_opt_state"]
            self.light_state = dev_t(state["light_state"])
            self.light_opt_state = AdamState(mu={"light": dev_t(lo["mu"])},
                                             nu={"light": dev_t(lo["nu"])},
                                             count=int(lo["count"]))
        ranks = state.get("ranks")
        if (ranks is not None or self.n_devices > 1) and (
                ranks is None or len(ranks) != self.n_devices):
            raise ValueError(
                f"checkpoint {path} was written by "
                f"{1 if ranks is None else len(ranks)} rank(s); it resumes "
                f"only at that world size, not at {self.n_devices}")
        local = state if ranks is None else ranks[self.rank]
        self.rng.bit_generator.state = local["rng"]
        self.generator.set_state(torch.from_numpy(local["generator"]))
        self._view_pool = list(local["view_pool"])
        # Checkpoints from before the split noise had its own stream carry
        # one generator.
        self.replica_generator.set_state(torch.from_numpy(
            state.get("replica_generator", state["generator"])))
        self._dropped_window = torch.tensor(state["dropped_window"],
                                            dtype=torch.int32, device=dev)
        # Restored state invalidates the steps built for the old shapes.
        self._steps.clear()
        self._observe_counter = None
