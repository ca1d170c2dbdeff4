"""The reference training step of GS-2M's geometry and material stages, and
the run of the compared steps.

A frozen plain-PyTorch copy of what one training iteration computes after
densification has ended: the view drawn from an epoch shuffle and its
nearest (and, with the material stage, nearby) neighbour drawn from a
numpy Generator seeded with the run's seed; the staged loss of the view;
its gradient by autograd (the blend's backward written out in raster.py);
and Adam with the published per-group learning rates (eps 1e-15, one step
count for bias correction), the learned light stepped by its own Adam and
clamped at 0. The multi-view and roughness terms draw their pixels from a
torch.Generator on the device seeded like the program's, so a sound
program and this reference draw the same pixels.
"""
from __future__ import annotations


import numpy as np
import torch

from . import losses as L
from . import pbr as P
from . import raster as R
from .camera import Cam, focal2fov, neighbor_tables, pick_resolution

PARAMS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation", "albedo",
          "roughness", "metallic")


def xyz_lr(o: dict, extent: float, step: int) -> float:
    """The log-linear position schedule (no delay steps), in float32."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    s = f32(step)
    t = torch.clamp(s / o["position_lr_max_steps"], 0.0, 1.0)
    lerp = torch.exp(f32(np.log(o["position_lr_init"] * extent)) * (1 - t)
                     + f32(np.log(o["position_lr_final"] * extent)) * t)
    return float(1.0 * lerp * (s >= 0))


def group_lrs(o: dict, extent: float, step: int) -> dict:
    return {"xyz": xyz_lr(o, extent, step), "f_dc": o["feature_lr"],
            "f_rest": o["feature_lr"] / 20.0, "opacity": o["opacity_lr"],
            "scaling": o["scaling_lr"], "rotation": o["rotation_lr"],
            "albedo": o["opacity_lr"], "roughness": o["opacity_lr"],
            "metallic": o["opacity_lr"]}


@torch.no_grad()
def adam(params: dict, grads: dict, mu: dict, nu: dict, count: int, lrs: dict,
         b1=0.9, b2=0.999, eps=1e-15):
    """One Adam step in place; `count` is the step count after this step."""
    t = torch.tensor(float(count), dtype=torch.float32)
    c1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** t)
    c2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** t)
    for k, p in params.items():
        g = grads[k]
        mu[k].mul_(b1).add_((1 - b1) * g)
        nu[k].mul_(b2).add_((1 - b2) * g * g)
        p.sub_(float(lrs[k]) * (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps))


class Reference:
    """The reference's training state and step, built from the benchmark's
    inputs alone: `scene` and `state` (cellkit.scene.Scene, State)."""

    def __init__(self, cfg: dict, scene, state, seed: int):
        dev = scene.gt.device
        self.cfg, self.o = cfg, cfg["optim"]
        m = cfg["model"]
        self.material = bool(m["material"])
        self.mask_gt = bool(m["mask_gt"])
        self.tile, self.chunk = cfg["pipeline"]["tile"], cfg["pipeline"]["chunk"]
        self.extent = scene.extent
        self.cams = []
        for Rm, Tm in zip(scene.Rs, scene.Ts):
            w, h = pick_resolution(scene.width, scene.height, m["resolution"])
            self.cams.append(Cam.create(Rm, Tm, focal2fov(scene.fx, scene.width),
                                        focal2fov(scene.fy, scene.height), w, h,
                                        dev))
        (self.near, self.near_mask, self.nearby,
         self.nearby_mask) = neighbor_tables(scene.Rs, scene.Ts, self.o)
        self.ncc_scale = (self.o["multi_view_ncc_scale"]
                          if self.o["multi_view_ncc_scale"] > 0
                          else 1.0 / m["resolution"])
        self.gt, self.gray, self.alpha = scene.gt, scene.gray, scene.alpha
        self.params = {k: v.clone() for k, v in state.params.items()}
        self.alive = state.alive
        self.mu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.nu = {k: state.nu0[k].expand_as(v).clone()
                   for k, v in self.params.items()}
        self.count = state.iteration
        self.iteration = state.iteration
        self.deg = m["sh_degree"]
        self.light = state.light.clone() if self.material else None
        if self.material:
            self.light_mu = torch.zeros_like(self.light)
            self.light_nu = state.light_nu0.expand_as(self.light).clone()
            self.lut = torch.from_numpy(P.brdf_lut()).to(dev)
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        self.pool: list[int] = []
        self.views: list[tuple] = []

    def _neighbor(self, table, mask, view, fallback):
        count = int(mask[view].sum())
        r = int(self.rng.integers(0, max(count, 1)))
        return (int(table[view][r]), True) if count > 0 else (fallback, False)

    def draw(self):
        if not self.pool:
            pool = list(range(len(self.cams)))
            self.rng.shuffle(pool)
            self.pool = pool
        view = self.pool.pop()
        nearest, has_nearest = self._neighbor(self.near, self.near_mask, view, view)
        nearby, has_nearby = 0, False
        if self.material:
            nearby, has_nearby = self._neighbor(self.nearby, self.nearby_mask,
                                                view, 0)
        return view, nearest, has_nearest, nearby, has_nearby

    def loss(self, params, light, view, nearest, has_nearest, nearby, has_nearby):
        o, cam = self.o, self.cams[view]
        gt = self.gt[view]
        fc = 9 if self.material else 5
        rkw = dict(tile=self.tile, chunk=self.chunk)
        pkg = R.render(params, self.alive, cam, self.deg, fc, sobel=True, **rkw)
        Lrgb = L.rgb_loss(L.clip(pkg["render"], 0.0, 1.0), gt, o["lambda_ssim"])
        s = torch.exp(params["scaling"])
        loss = o["lambda_plane"] * L.plane_loss(pkg["visibility_filter"], s)
        if self.mask_gt:
            loss = loss + o["lambda_alpha"] * L.bce(pkg["alpha_map"],
                                                    self.alpha[view])
        if not self.material:
            loss = loss + Lrgb
        ncam = self.cams[nearest]
        npkg = R.render(params, self.alive, ncam, self.deg, fc, **rkw)
        Lgeo = o["lambda_depth_normal"] * L.depth_normal_loss(
            pkg["normal_map"], pkg["sobel_map"], gt)
        if has_nearest and o["lambda_multi_view"] != 0.0:
            Lgeo = Lgeo + o["lambda_multi_view"] * L.multi_view_loss(
                o, cam, ncam, pkg, npkg, self.gray[view], self.gray[nearest],
                self.material, self.ncc_scale, self.generator)
        loss = loss + Lgeo
        Lmat = gt.new_zeros(())
        if self.material:
            render_nearby = lambda c: R.render(params, self.alive, c, self.deg, 5,
                                               **rkw)
            Lmat = P.material_loss(o, cam, pkg, gt, light, self.cams[nearby],
                                   has_nearby, self.gray[view], self.gray[nearby],
                                   self.ncc_scale, render_nearby,
                                   self.generator, self.lut)
            loss = loss + Lmat
        return loss, {"Lrgb": Lrgb.detach(), "Lgeo": Lgeo.detach(),
                      "Lmat": Lmat.detach()}

    def step(self) -> dict:
        """One iteration; returns its loss terms as floats."""
        self.iteration += 1
        drawn = self.draw()
        self.views.append(drawn)
        params = {k: v.detach().requires_grad_(True) for k, v in self.params.items()}
        leaves = list(params.values())
        light = None
        if self.material:
            light = self.light.detach().requires_grad_(True)
            leaves.append(light)
        loss, terms = self.loss(params, light, *drawn)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(
            leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
        self.count += 1
        adam(self.params, dict(zip(PARAMS, grads[:len(PARAMS)])), self.mu, self.nu,
             self.count, group_lrs(self.o, self.extent, self.iteration))
        if self.material:
            lmu, lnu = {"light": self.light_mu}, {"light": self.light_nu}
            adam({"light": self.light}, {"light": grads[-1]}, lmu, lnu, self.count,
                 {"light": self.o["opacity_lr"]})
            with torch.no_grad():
                self.light.clamp_min_(0.0)
        return {"loss": float(loss.detach()), **{k: float(v) for k, v in terms.items()}}
