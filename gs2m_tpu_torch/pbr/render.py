"""Deferred PBR pass + the material-stage loss bundle for the trainer.

Port of gs2m_tpu/pbr/render.py: `pbr_render` rebuilds the mips per step,
detaches and normalizes the normals, estimates metallic as alpha * (1 -
roughness) when it is not trained, remaps roughness to [0.04, 1] and
detaches it; `make_pbr_fns` holds the light's init, its Adam step with
the clamp to >= 0, and the material losses (PBR photometric, roughness /
metallic and albedo smoothness, the roughness-weighted normal TV and the
roughness-from-reflection term against a nearby view).

The nearby view is chosen on the host by the trainer (its numpy
Generator, as for the nearest view), so a view without a nearby camera
skips the neighbor render outright, the semantics of the JAX package's
lax.cond. The neighbor render runs without gradient: the V=8 geometry
render, kernel K1 only, on the step's background.

With the span recorder on (utils/spans.py), each material step logs the
pixels the pass shades (`pbr_pixels`, the whole frame) and those inside
the surface mask that the PBR loss keeps (`pbr_fg_pixels`).
"""
from __future__ import annotations

import numpy as np
import torch

from gs2m_tpu_torch.models import losses as L
from gs2m_tpu_torch.pbr import cubemap as cm
from gs2m_tpu_torch.pbr import shade as sh
from gs2m_tpu_torch.train.optim import adam_init, adam_update
from gs2m_tpu_torch.utils import spans
from gs2m_tpu_torch.utils.spans import STAGES, span


def view_dirs_world(camera) -> torch.Tensor:
    """(H, W, 3) unit directions surface->camera."""
    H, W = camera.height, camera.width
    dev = camera.device
    y, x = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev),
                          indexing="ij")
    rays = torch.stack([(x.reshape(-1) - camera.cx + 0.5) / camera.fx,
                        (y.reshape(-1) - camera.cy + 0.5) / camera.fy,
                        torch.ones(H * W, device=dev)], -1)
    rays = rays / (torch.linalg.norm(rays, dim=-1, keepdim=True) + 1e-12)
    vd = -(rays @ camera.world_view[:3, :3].T)
    vd = vd / (torch.linalg.norm(vd, dim=-1, keepdim=True) + 1e-12)
    return vd.reshape(H, W, 3)


def pbr_render(light_base: torch.Tensor, camera, render_pkg: dict,
               brdf_lut: torch.Tensor, metallic_trained: bool,
               gamma: bool = False, mips=None) -> dict:
    """The deferred shading pass. Differentiable in light_base and in the
    blended albedo/metallic maps (normals and roughness detached). `mips`
    lets a caller shading many views from one unchanged light pass the
    prefiltered (diffuse, specular) stack once."""
    diffuse, specular = cm.build_mips(light_base) if mips is None else mips

    normal_map = render_pkg["normal_map"].detach()                 # (3, H, W)
    nrm = torch.linalg.norm(normal_map, dim=0, keepdim=True)
    normal_map = torch.where(nrm > 0, normal_map / (nrm + 1e-12), normal_map)

    albedo = L.clip(render_pkg["albedo_map"], 0.0, 1.0)
    roughness = render_pkg["roughness_map"]
    if metallic_trained:
        metallic = render_pkg["metallic_map"]
    else:
        alpha = render_pkg["alpha_map"].detach()
        metallic = (alpha * L.clip(1.0 - roughness, 0.0, 1.0)).detach()
    roughness = (roughness * (1.0 - 0.04) + 0.04).detach()

    H, W = camera.height, camera.width
    hwc = lambda x: x.permute(1, 2, 0)
    dev = light_base.device
    pkg = sh.pbr_shading(
        diffuse, specular,
        normals=hwc(normal_map), view_dirs=view_dirs_world(camera),
        albedo=hwc(albedo), roughness=hwc(roughness), brdf_lut=brdf_lut,
        metallic=hwc(metallic), gamma=gamma,
        occlusion=torch.ones(H, W, 1, device=dev),
        irradiance=torch.zeros(H, W, 1, device=dev))
    pkg["roughness_map"] = roughness
    pkg["metallic_map"] = metallic
    return pkg


def make_pbr_fns(base_res: int = 512, seed: int = 0, light=None,
                 device=None) -> dict:
    """The trainer's material-stage plug (Trainer(pbr_fns=...)). The light
    starts from `light` when given (a numpy (6, R, R, 3) array, e.g. the
    JAX package's light), else uniform [0.25, 0.75) from a torch.Generator
    seeded with `seed`."""
    from gs2m_tpu_torch import resolve_device

    device = resolve_device(device)
    brdf_lut = sh.get_brdf_lut(device)

    def init_light() -> torch.Tensor:
        if light is not None:
            return torch.from_numpy(np.array(light, np.float32)).to(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        return cm.init_cubemap(gen, base_res, device=device)

    def init_light_opt(light_base: torch.Tensor):
        return adam_init({"light": light_base})

    def light_update(light_base, grad, opt_state, lr):
        """Adam on the light, then the clamp to >= 0; in place."""
        adam_update({"light": light_base}, {"light": grad}, opt_state,
                    {"light": lr})
        with torch.no_grad():
            light_base.clamp_min_(0.0)
        return light_base, opt_state

    def material_losses(g, cam, pkg, gt, light_base, opt, model_cfg,
                        nearby_cam, has_nearby: bool, gray_ref, gray_nea,
                        ncc_scale, active_sh_degree, render_kw,
                        generator=None, indices=None, bg=None):
        """`bg`: the step's background (black when None), which the nearby
        view's render composites on."""
        from gs2m_tpu_torch.models.render import render as render_fn

        normal_mask = pkg["normal_mask"]
        with span(STAGES["pbr"]):
            pbr_pkg = pbr_render(light_base, cam, pkg, brdf_lut,
                                 metallic_trained=model_cfg.metallic,
                                 gamma=model_cfg.gamma)
            # The pixels the pass shades and those of them the loss keeps;
            # the sum only while the recorder is on (a launch otherwise).
            spans.count("pbr_pixels", cam.height * cam.width)
            if spans.recording():
                spans.count("pbr_fg_pixels", normal_mask.sum())

        render_pbr = L.clip(pbr_pkg["render_rgb"].permute(2, 0, 1), 0.0, 1.0)
        render_pbr = torch.where(normal_mask, render_pbr, 0.0)

        Lpbr = L.rgb_loss(render_pbr, gt, opt.lambda_ssim)

        arm = (torch.cat([pkg["roughness_map"], pkg["metallic_map"]], 0)
               if model_cfg.metallic else pkg["roughness_map"])
        Lsm = (opt.lambda_smooth * L.tv_loss(gt, arm, norm1=False)
               + 0.01 * L.tv_loss(gt, pkg["albedo_map"]))

        weight_normal = (1.0 - pkg["roughness_map"]).detach()
        weight_normal = L.clip(0.5 * torch.tanh(8.0 * (weight_normal - 0.5))
                               + 0.5, 0.0, 1.0)
        Ltv = opt.lambda_normal * L.tv_loss(gt, pkg["normal_map"],
                                            weight_map=weight_normal)

        Lr = gt.new_zeros(())
        if has_nearby:
            with torch.no_grad(), span(STAGES["render"]):
                npkg = render_fn(g, nearby_cam,
                                 gt.new_zeros(3) if bg is None else bg,
                                 active_sh_degree, geometry_stage=True,
                                 **render_kw)
            Lr = L.roughness_loss(opt, cam, nearby_cam, pkg, npkg, gray_ref,
                                  gray_nea, ncc_scale, generator=generator,
                                  indices=indices)
        Lmat = Lpbr + Lsm + Ltv + opt.lambda_rough * Lr
        return Lmat, {"rough_active": bool(has_nearby)}

    return {"init_light": init_light, "init_light_opt": init_light_opt,
            "light_update": light_update, "material_losses": material_losses,
            "brdf_lut": brdf_lut}
