"""Band-sharded rendering and backward over a list of devices.

Port of gs2m_tpu/parallel/sp.py. The JAX package shard_maps an N-device
"sp" mesh, one horizontal band of one view per device; here one process
drives a list of devices (the JAX package's single controller) and band d
of N runs on devices[d % len(devices)]: on one card the bands run in turn,
on the CPU all of them run on it.

* Band d owns image rows [d*h, (d+1)*h), h = padded_height(H, N) / N (H
  padded to a multiple of N tiles); it renders those of its rows that lie
  inside the frame, and its rows below it are zeros, so a partial tile row
  at the frame's bottom counts the same pixels (observe) as in the full
  frame. The Gaussians and the camera are
  replicated: each device projects once, and each band shifts the
  projection into its window (ops/projection.py::crop_projected) and runs
  the standard binning and blend (kernel K1; K2 in the backward) at the
  band's height. For bands that start on a tile boundary the shift is
  exact, so each band's pixels are the full-frame render's.
* Outputs gather onto devices[0]: images by concatenating the bands' rows,
  per-Gaussian observe counts, `dropped`, `num_instances` and `num_kept`
  as sums over the bands (each Gaussian's instances split disjointly over
  them), radii as their max.
* Window losses cross band edges by halo exchange (`halo_extend`): the
  band's slab gains the neighbors' boundary rows, copied from their
  devices; the backward of that copy is the JAX package's transposed
  ppermute, so halo-row gradients flow back to the band that produced
  them. Edge bands get zeros, the zero padding of a full-frame "same"
  window.

Instance capacity: each band sees about 1/N of the instances, so callers
pass the single-frame cap / N rounded to the chunk, and grow it on
`dropped` as for a full frame.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from gs2m_tpu_torch.core.camera import Camera
from gs2m_tpu_torch.core.gaussians import Gaussians
from gs2m_tpu_torch.models import losses as L
from gs2m_tpu_torch.ops.normals import normal_from_depth_image
from gs2m_tpu_torch.ops.preprocess import preprocess
from gs2m_tpu_torch.ops.projection import crop_projected
from gs2m_tpu_torch.ops.rasterize import RasterOut, rasterize_from_projected
from gs2m_tpu_torch.ops.ssim import ssim_map

SSIM_HALO = 5  # the 11x11 SSIM window's radius (ops/ssim.py)


def padded_height(height: int, n_bands: int, tile: int = 16) -> int:
    q = n_bands * tile
    return (height + q - 1) // q * q


def to_device(obj, device: torch.device):
    """A Gaussians or Camera with every tensor on `device` (itself when it
    is there already)."""
    if obj.device == device:
        return obj
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


def halo_extend(bands: list, r: int) -> list:
    """(..., h, W) bands -> (..., h + 2r, W) slabs, each extended with r
    rows from its neighbors (copied to its device); edge bands get zeros.
    Differentiable: the copies' backward returns the halo rows' gradients
    to the bands that produced them."""
    out = []
    for d, x in enumerate(bands):
        zeros = x.new_zeros(x.shape[:-2] + (r, x.shape[-1]))
        above = bands[d - 1][..., -r:, :].to(x.device) if d > 0 else zeros
        below = (bands[d + 1][..., :r, :].to(x.device)
                 if d + 1 < len(bands) else zeros)
        out.append(torch.cat([above, x, below], dim=-2))
    return out


class _Bands:
    """The per-band render of one call: each device's copy of the
    Gaussians (from `params` when given, differentiably), camera and
    background, its projection and features, and each band's RasterOut."""

    def __init__(self, devices, n_bands, height, gaussians, camera, bg,
                 active_sh_degree, feature_count, tile, chunk, cap,
                 params=None):
        self.local_h = padded_height(height, n_bands, tile) // n_bands
        self.devices = [devices[d % len(devices)] for d in range(n_bands)]
        per_dev = {}
        for dev in dict.fromkeys(self.devices):
            g = to_device(gaussians, dev)
            if params is not None:
                g = g.with_params({k: v.to(dev) for k, v in params.items()})
            cam = to_device(camera, dev)
            op, feats, proj = preprocess(g, cam, active_sh_degree, tile=tile)
            per_dev[dev] = (g, cam, bg.to(dev), op, proj, feats)
        self.per_dev = per_dev
        self.outs = []
        h = self.local_h
        for d, dev in enumerate(self.devices):
            g, cam, bgd, op, proj, feats = per_dev[dev]
            # The band renders its rows inside the image, so pixels below
            # the frame stay outside as in the full-frame render; the rest
            # of its rows are zeros.
            rows = min(h, max(height - d * h, 0))
            if rows == 0:
                zero = op.new_zeros((), dtype=torch.int32)
                self.outs.append(RasterOut(
                    color=op.new_zeros(3, h, cam.width),
                    buffer=op.new_zeros(10, h, cam.width),
                    final_T=op.new_zeros(h, cam.width), radii=proj.radii,
                    observe=torch.zeros_like(proj.radii), dropped=zero,
                    num_instances=zero, aligned_demand=zero,
                    num_kept=zero))
                continue
            projc = crop_projected(proj, d * h, rows, tile)
            local_cam = dataclasses.replace(cam, height=rows)
            out = rasterize_from_projected(
                projc, op, feats, bgd, local_cam,
                feature_count=feature_count, tile=tile, chunk=chunk,
                instance_cap=cap)
            pad = (0, 0, 0, h - rows)
            self.outs.append(out._replace(
                color=F.pad(out.color, pad), buffer=F.pad(out.buffer, pad),
                final_T=F.pad(out.final_T, pad)))

    def row_mask(self, d: int, height: int) -> torch.Tensor:
        """(1, h, 1) float mask of band d's rows inside the image."""
        rows = d * self.local_h + torch.arange(self.local_h,
                                               device=self.devices[d])
        return (rows < height).float()[None, :, None]

    def gather(self, height: int) -> RasterOut:
        """The full frame's RasterOut on devices[0]."""
        dev0 = self.devices[0]

        def cat(xs, dim):
            return torch.cat([x.to(dev0) for x in xs], dim=dim)

        outs = self.outs
        return RasterOut(
            color=cat([o.color for o in outs], 1)[:, :height],
            buffer=cat([o.buffer for o in outs], 1)[:, :height],
            final_T=cat([o.final_T for o in outs], 0)[:height],
            radii=torch.stack([o.radii.to(dev0) for o in outs]).amax(0),
            observe=sum(o.observe.to(dev0) for o in outs),
            dropped=sum(o.dropped.to(dev0) for o in outs),
            num_instances=sum(o.num_instances.to(dev0) for o in outs),
            aligned_demand=sum(o.aligned_demand.to(dev0) for o in outs),
            num_kept=sum(o.num_kept.to(dev0) for o in outs))


def make_sp_render(devices, n_bands: int, height: int, *,
                   feature_count: int = 10, active_sh_degree: int = 3,
                   tile: int = 16, chunk: int = 128,
                   instance_cap_per_band: int = 2 ** 17):
    """(gaussians, camera, bg) -> the full frame's rasterizer surface
    (RasterOut) rendered in `n_bands` bands over `devices`, on devices[0].
    The camera is the full frame's (`height` rows)."""
    assert instance_cap_per_band % chunk == 0

    @torch.no_grad()
    def render_sp(gaussians: Gaussians, camera: Camera,
                  bg: torch.Tensor) -> RasterOut:
        return _Bands(devices, n_bands, height, gaussians, camera, bg,
                      active_sh_degree, feature_count, tile, chunk,
                      instance_cap_per_band).gather(height)

    return render_sp


def _banded_rgb_sums(colms: list, tgtms: list, masks: list,
                     lambda_ssim: float, local_h: int):
    """Per band: (L1 sum, SSIM sum) of the masked color against the masked
    target. SSIM windows cross band edges through a 5-row halo of both
    images; every kept pixel's window lies inside its slab."""
    l1 = [torch.sum(L.abs_(c - t)) for c, t in zip(colms, tgtms)]
    if lambda_ssim == 0.0:
        return l1, [c.new_zeros(()) for c in colms]
    ext = halo_extend([torch.stack([c, t]) for c, t in zip(colms, tgtms)],
                      SSIM_HALO)
    ssim = []
    for e, m in zip(ext, masks):
        sm = ssim_map(e[:1], e[1:].detach())   # gradients to the color only
        ssim.append(torch.sum(sm[0, :, SSIM_HALO:SSIM_HALO + local_h] * m))
    return l1, ssim


def _leaves(params: dict) -> dict:
    return {k: v.detach().requires_grad_(True) for k, v in params.items()}


def _band_target(target: torch.Tensor, n_bands: int, local_h: int, d: int,
                 dev) -> torch.Tensor:
    pad = n_bands * local_h - target.shape[-2]
    return F.pad(target, (0, 0, 0, pad))[..., d * local_h:(d + 1) * local_h,
                                         :].to(dev)


def make_sp_grad(devices, n_bands: int, height: int, width: int, *,
                 feature_count: int = 10, active_sh_degree: int = 3,
                 tile: int = 16, chunk: int = 128,
                 instance_cap_per_band: int = 2 ** 17,
                 lambda_ssim: float = 0.0):
    """The band-sharded backward of the photometric objective
    (1-l)*L1 + l*(1-SSIM) of the clipped color against `target` (3, H, W):
    (params, gaussians, camera, bg, target) -> (loss, per-Gaussian grads of
    `params`, on devices[0]). Each band sums its masked L1 (and halo SSIM)
    terms; the loss is their normalized total, so it and its gradients
    equal the full-frame objective's up to summation order."""
    assert instance_cap_per_band % chunk == 0
    local_h = padded_height(height, n_bands, tile) // n_bands
    assert lambda_ssim == 0.0 or local_h >= SSIM_HALO, (
        "SSIM halo exchange needs bands of at least 5 rows")

    def grad_sp(params: dict, gaussians: Gaussians, camera: Camera,
                bg: torch.Tensor, target: torch.Tensor):
        leaves = _leaves(params)
        bands = _Bands(devices, n_bands, height, gaussians, camera, bg,
                       active_sh_degree, feature_count, tile, chunk,
                       instance_cap_per_band, params=leaves)
        masks = [bands.row_mask(d, height) for d in range(n_bands)]
        colms = [L.clip(o.color, 0.0, 1.0) * m
                 for o, m in zip(bands.outs, masks)]
        tgtms = [_band_target(target, n_bands, local_h, d, bands.devices[d])
                 * m for d, m in enumerate(masks)]
        l1, ssim = _banded_rgb_sums(colms, tgtms, masks, lambda_ssim, local_h)
        denom = 3.0 * height * width
        dev0 = bands.devices[0]
        loss = lambda_ssim + sum(
            (((1.0 - lambda_ssim) * a - lambda_ssim * s) / denom).to(dev0)
            for a, s in zip(l1, ssim))
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        return loss.detach(), {k: torch.zeros_like(v) if g is None else g
                               for (k, v), g in zip(leaves.items(), grads)}

    return grad_sp


def make_sp_geometry_grad(devices, n_bands: int, height: int, width: int, *,
                          active_sh_degree: int = 3, tile: int = 16,
                          chunk: int = 128,
                          instance_cap_per_band: int = 2 ** 17,
                          lambda_ssim: float = 0.2,
                          lambda_depth_normal: float = 0.05,
                          lambda_plane: float = 100.0,
                          lambda_alpha: float = 0.0):
    """The band-sharded backward of the geometry stage's objective without
    the cross-view term (multi-view NCC reprojects across the whole frame
    and stays on the data-parallel axis):

        (1-l)*L1 + l*(1-SSIM) + lambda_plane*Lplane
        [+ lambda_alpha*BCE(alpha, gt_alpha)] + lambda_depth_normal*Ldn

    (params, gaussians, camera, bg, target, gt_alpha) -> (loss, grads), on
    devices[0]. SSIM takes a 5-row halo; the Sobel normal-from-depth a
    1-row depth halo, back-projected with the band's global rows
    (normal_from_depth_image(row0=)), and the true image border rows of
    the normals are zeroed before the alpha composite, as the full frame's
    1-px border is. The depth-normal weights are normalized over the full
    target. The plane prior is a per-Gaussian ratio, nonlinear in the band
    sums: it is evaluated once, replicated, on the bands' max radii and
    added after the band sums."""
    assert instance_cap_per_band % chunk == 0
    local_h = padded_height(height, n_bands, tile) // n_bands
    assert local_h >= SSIM_HALO, "SSIM halo needs bands of at least 5 rows"
    denom = float(height * width)

    def grad_sp(params: dict, gaussians: Gaussians, camera: Camera,
                bg: torch.Tensor, target: torch.Tensor,
                gt_alpha: torch.Tensor):
        leaves = _leaves(params)
        bands = _Bands(devices, n_bands, height, gaussians, camera, bg,
                       active_sh_degree, 10, tile, chunk,
                       instance_cap_per_band, params=leaves)
        with torch.no_grad():
            wdn = torch.clamp(1.0 - L._img_grad_weight(target), 0.0, 1.0) ** 2
        rays = F.pad(camera.get_rays(), (0, 0, 0, 0, 0,
                                         n_bands * local_h - height))
        masks, colms, tgtms, depths = [], [], [], []
        for d, (o, dev) in enumerate(zip(bands.outs, bands.devices)):
            m = bands.row_mask(d, height)
            masks.append(m)
            colms.append(L.clip(o.color, 0.0, 1.0) * m)
            tgtms.append(_band_target(target, n_bands, local_h, d, dev) * m)
            cam = bands.per_dev[dev][1]
            n_flat = o.buffer[2:5].permute(1, 2, 0).reshape(-1, 3)
            local_n = n_flat @ cam.world_view[:3, :3]
            r = rays[d * local_h:(d + 1) * local_h].to(dev)
            dn = torch.sum(local_n * r.reshape(-1, 3), -1).reshape(
                1, local_h, -1)
            depths.append(o.buffer[1:2] / -(dn + 1e-8))
        l1, ssim = _banded_rgb_sums(colms, tgtms, masks, lambda_ssim, local_h)
        ext_d = halo_extend(depths, 1)
        dev0 = bands.devices[0]
        loss = torch.zeros((), device=dev0)
        for d, (o, dev) in enumerate(zip(bands.outs, bands.devices)):
            cam, bgd = bands.per_dev[dev][1], bands.per_dev[dev][2]
            y0 = d * local_h
            c2w = torch.linalg.inv_ex(cam.world_view.T).inverse
            n_sob = normal_from_depth_image(ext_d[d][0], cam.get_K(), c2w,
                                            row0=y0 - 1)[1:-1]
            rows = y0 + torch.arange(local_h, device=dev)
            border = (rows == 0) | (rows == height - 1)
            n_sob = torch.where(border[:, None, None], 0.0, n_sob)
            alpha = o.buffer[0:1]
            a1 = alpha[0][..., None]
            sobel = (n_sob * a1 + bgd[None, None, :] * (1.0 - a1)).permute(
                2, 0, 1)
            dn_sum = torch.sum(
                wdn_band(wdn, n_bands, local_h, d, dev)
                * torch.sum(L.abs_(sobel - o.buffer[2:5]), dim=0)
                * masks[d][0])
            val = (((1.0 - lambda_ssim) * l1[d] - lambda_ssim * ssim[d])
                   / (3 * denom) + lambda_depth_normal * dn_sum / denom)
            if lambda_alpha:
                gta = _band_target(gt_alpha, n_bands, local_h, d, dev)
                val = val + lambda_alpha * torch.sum(
                    L.binary_cross_entropy_map(alpha, gta) * masks[d]) / denom
            loss = loss + val.to(dev0)
        loss = lambda_ssim + loss
        # The plane prior, replicated, on the bands' max radii (its
        # visibility is index-valued: no gradient through it).
        radii = torch.stack([o.radii.to(dev0) for o in bands.outs]).amax(0)
        g0 = to_device(gaussians, dev0).with_params(leaves)
        loss = loss + lambda_plane * L.plane_loss(radii > 0, g0.get_scaling)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        return loss.detach(), {k: torch.zeros_like(v) if g is None else g
                               for (k, v), g in zip(leaves.items(), grads)}

    return grad_sp


def wdn_band(wdn: torch.Tensor, n_bands: int, local_h: int, d: int,
             dev) -> torch.Tensor:
    """Band d's rows of the full-frame (H, W) depth-normal weights, padded."""
    return _band_target(wdn[None], n_bands, local_h, d, dev)[0]
