"""The reference training step on the configuration's background.

step.py's reference renders every view on black, as the JAX package's
trainer does. GS-2M's own trainer composites on the dataset's background:
white under --white_background (the Shiny and Glossy Blender protocols,
whose ground truth is composited on white), black otherwise. This is the
same plain-PyTorch step with that background: each render's colour is
`render + final_T * bg`, and the depth-normal target is the normals of the
rendered depth composited as `n * alpha + (1 - alpha) * bg`. Everything
else (the draws, the losses, Adam, the light) is step.py's.

It runs in float32 with TF32 off: the module turns TF32 off as it loads,
and the harness loads it for the sound reading before any control turns
TF32 on for a reading of its own.
"""
from __future__ import annotations

import torch

from . import losses as L
from . import pbr as P
from . import raster as R
from . import step

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def render(bg: torch.Tensor, *args, **kwargs) -> dict:
    """raster.render's package with its colour and depth-normal target
    composited on `bg`."""
    pkg = R.render(*args, **kwargs)
    pkg["render"] = pkg["render"] + pkg["final_T"][None] * bg[:, None, None]
    if "sobel_map" in pkg:
        a = pkg["alpha_map"]
        pkg["sobel_map"] = pkg["sobel_map"] + (1.0 - a) * bg[:, None, None]
    return pkg


class Reference(step.Reference):
    """step.Reference with every render of the step on the configured
    background."""

    def __init__(self, cfg: dict, scene, state, seed: int):
        super().__init__(cfg, scene, state, seed)
        white = float(bool(cfg["model"]["white_background"]))
        self.bg = torch.full((3,), white, device=scene.gt.device)

    def loss(self, params, light, view, nearest, has_nearest, nearby, has_nearby):
        o, cam, bg = self.o, self.cams[view], self.bg
        gt = self.gt[view]
        fc = 9 if self.material else 5
        rkw = dict(tile=self.tile, chunk=self.chunk)
        pkg = render(bg, params, self.alive, cam, self.deg, fc, sobel=True, **rkw)
        Lrgb = L.rgb_loss(L.clip(pkg["render"], 0.0, 1.0), gt, o["lambda_ssim"])
        s = torch.exp(params["scaling"])
        loss = o["lambda_plane"] * L.plane_loss(pkg["visibility_filter"], s)
        if self.mask_gt or self.cfg["model"]["white_background"]:
            loss = loss + o["lambda_alpha"] * L.bce(pkg["alpha_map"],
                                                    self.alpha[view])
        if not self.material:
            loss = loss + Lrgb
        ncam = self.cams[nearest]
        npkg = render(bg, params, self.alive, ncam, self.deg, fc, **rkw)
        Lgeo = o["lambda_depth_normal"] * L.depth_normal_loss(
            pkg["normal_map"], pkg["sobel_map"], gt)
        if has_nearest and o["lambda_multi_view"] != 0.0:
            Lgeo = Lgeo + o["lambda_multi_view"] * L.multi_view_loss(
                o, cam, ncam, pkg, npkg, self.gray[view], self.gray[nearest],
                self.material, self.ncc_scale, self.generator)
        loss = loss + Lgeo
        Lmat = gt.new_zeros(())
        if self.material:
            render_nearby = lambda c: render(bg, params, self.alive, c, self.deg, 5,
                                             **rkw)
            Lmat = P.material_loss(o, cam, pkg, gt, light, self.cams[nearby],
                                   has_nearby, self.gray[view], self.gray[nearby],
                                   self.ncc_scale, render_nearby,
                                   self.generator, self.lut)
            loss = loss + Lmat
        return loss, {"Lrgb": Lrgb.detach(), "Lgeo": Lgeo.detach(),
                      "Lmat": Lmat.detach()}
