"""Training observability: TensorBoard scalars/images + periodic evaluation.

Port of gs2m_tpu/train/reporting.py: per-iteration loss/iter-time/point-
count scalars, and at the test iterations PSNR and L1 over a view list
with image grids and an opacity histogram; in the material stage also the
PBR render's PSNR and L1, the material and shade grids and the
environment map. TensorBoard output goes through tensorboardX when it is
installed; without it the reporter says so once and records nothing.
"""
from __future__ import annotations

import numpy as np
import torch


class TrainingReporter:
    def __init__(self, model_path: str, enable: bool = True):
        self.writer = None
        if enable:
            try:
                from tensorboardX import SummaryWriter
                self.writer = SummaryWriter(model_path)
            except Exception as e:  # tensorboardX missing or unusable
                print(f"[!] TensorBoard unavailable: {e}")

    def scalars(self, iteration: int, metrics: dict, points: int,
                iter_time_ms: float | None = None):
        if self.writer is None:
            return
        for k, v in metrics.items():
            self.writer.add_scalar(f"train_loss_patches/{k}", float(v), iteration)
        self.writer.add_scalar("total_points", points, iteration)
        if iter_time_ms is not None:
            self.writer.add_scalar("iter_time", iter_time_ms, iteration)

    def histogram(self, iteration: int, name: str, values):
        if self.writer is None:
            return
        v = _numpy(values)
        v = v[np.isfinite(v)]
        if v.size:
            self.writer.add_histogram(name, v, iteration)

    def image(self, iteration: int, name: str, img_chw):
        if self.writer is None:
            return
        self.writer.add_image(name, np.clip(_numpy(img_chw), 0, 1), iteration)

    def close(self):
        if self.writer is not None:
            self.writer.close()


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@torch.no_grad()
def _render_guarded(trainer, camera, material_stage: bool = False):
    """One eval render that refuses to report on a silently truncated frame:
    while binning overflows (pkg['dropped'] > 0) the instance cap grows (the
    trainer's own policy) and the view is rendered again; bounded retries,
    and at the hard cap the last frame is returned with a warning."""
    from gs2m_tpu_torch.models.render import render

    kw = dict(tile=trainer.pipe.tile, chunk=trainer.pipe.chunk,
              z_depth=trainer.pipe.z_depth,
              blend_metallic=trainer.model_cfg.metallic)
    bg = torch.full((3,), float(trainer.model_cfg.white_background),
                    device=trainer.device)
    for _ in range(4):
        pkg = render(trainer.gaussians, camera, bg, trainer.active_sh_degree,
                     geometry_stage=True, material_stage=material_stage,
                     instance_cap=trainer.instance_cap, **kw)
        dropped = int(pkg["dropped"])
        if dropped == 0:
            return pkg
        before = trainer.instance_cap
        trainer._grow_instance_cap(dropped=dropped)
        if trainer.instance_cap == before:  # at MAX_INSTANCE_CAP
            print(f"[!] eval render dropped {dropped} instances at the "
                  f"maximum instance cap — PSNR is a lower bound", flush=True)
            return pkg
    print(f"[!] eval render still dropping {dropped} instances after repeated "
          f"cap growth (cap now {trainer.instance_cap}) — PSNR is a lower "
          f"bound", flush=True)
    return pkg


@torch.no_grad()
def evaluate_views(trainer, cameras, gt_images, n_views: int | None = None,
                   log_images_to: TrainingReporter | None = None,
                   iteration: int = 0, tag: str = "test") -> dict:
    """PSNR and L1 over a view list, rendered with the trainer's state. In
    the material stage also the deferred PBR pass per view (psnr_pbr,
    l1_pbr; albedo/roughness/metallic/PBR/diffuse/specular grids) and the
    environment map, with the light prefiltered once for the whole list."""
    material_stage = (trainer.pbr_fns is not None
                      and trainer._stage_flags(trainer.iteration)[1])
    mips = None
    if material_stage:
        from gs2m_tpu_torch.pbr import cubemap as cmod
        from gs2m_tpu_torch.pbr.render import pbr_render
        mips = cmod.build_mips(trainer.light_state)
        if log_images_to is not None:
            env = _numpy(cmod.cubemap_to_latlong(trainer.light_state,
                                                 (256, 512)))
            log_images_to.image(iteration, "scene/envmap",
                                np.clip(env, 0, 1).transpose(2, 0, 1))

    n = len(cameras) if n_views is None else min(n_views, len(cameras))
    bg_np = np.full((3, 1, 1), float(trainer.model_cfg.white_background),
                    np.float32)
    psnrs, l1s, psnrs_pbr, l1s_pbr = [], [], [], []
    for i in range(n):
        pkg = _render_guarded(trainer, cameras[i], material_stage)
        img = np.clip(_numpy(pkg["render"]), 0, 1)
        gt = np.clip(_numpy(gt_images[i]), 0, 1)
        mse = float(np.mean((img - gt) ** 2))
        psnrs.append(20 * np.log10(1.0 / np.sqrt(max(mse, 1e-12))))
        l1s.append(float(np.mean(np.abs(img - gt))))

        ppkg = None
        if material_stage:
            ppkg = pbr_render(trainer.light_state, cameras[i], pkg,
                              trainer.pbr_fns["brdf_lut"],
                              metallic_trained=trainer.model_cfg.metallic,
                              gamma=trainer.model_cfg.gamma, mips=mips)
            # The PBR image over the background outside the surface mask.
            pbr_img = np.where(_numpy(pkg["normal_mask"]), np.clip(
                _numpy(ppkg["render_rgb"]).transpose(2, 0, 1), 0, 1),
                bg_np)
            mse_p = float(np.mean((pbr_img - gt) ** 2))
            psnrs_pbr.append(20 * np.log10(1.0 / np.sqrt(max(mse_p, 1e-12))))
            l1s_pbr.append(float(np.mean(np.abs(pbr_img - gt))))

        if log_images_to is not None and i < 5:
            log_images_to.image(iteration, f"{tag}_view_{i}/render", img)
            log_images_to.image(iteration, f"{tag}_view_{i}/gt", gt)
            d = _numpy(pkg["depth_map"][0])
            lo, hi = np.percentile(d, 1), np.percentile(d, 99)
            log_images_to.image(iteration, f"{tag}_view_{i}/depth",
                                ((d - lo) / (hi - lo + 1e-8))[None])
            log_images_to.image(iteration, f"{tag}_view_{i}/normal",
                                _numpy(pkg["normal_map"]) * 0.5 + 0.5)
            if ppkg is not None:
                hwc = lambda k: _numpy(ppkg[k]).transpose(2, 0, 1)
                for name, im in (
                        ("albedo", _numpy(pkg["albedo_map"])),
                        ("roughness", _numpy(ppkg["roughness_map"])),
                        ("metallic", _numpy(ppkg["metallic_map"])),
                        ("z_pbr_render", pbr_img),
                        ("z_shade_diffuse", hwc("diffuse_rgb")),
                        ("z_shade_specular", hwc("specular_rgb"))):
                    log_images_to.image(iteration, f"{tag}_view_{i}/{name}",
                                        im)
    res = {"psnr": float(np.mean(psnrs)), "l1": float(np.mean(l1s))}
    if material_stage:
        res["psnr_pbr"] = float(np.mean(psnrs_pbr))
        res["l1_pbr"] = float(np.mean(l1s_pbr))
    return res
