"""The reference renderer: activations, projection, binning, the blend and
its backward, and the derived maps, in plain PyTorch.

A frozen copy of the math the port renders with (3DGS EWA splatting with
GS-2M's 13-map render package): the same culls, tile rectangles, (tile,
depth) order, chunk layout and per-(instance, pixel) recurrence, so that a
sound program agrees with it to rounding. It runs in float32 with TF32 off
unless the caller turns TF32 on (the control). The per-chunk walk is
vectorised across tiles; the blend's backward is written out (the same
derivative the program's backward kernel computes), its per-Gaussian sums
taken in float64.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

# --- activations ----------------------------------------------------------------

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def sh_basis(deg: int, dirs: torch.Tensor) -> torch.Tensor:
    out = [torch.full_like(dirs[..., 0], SH_C0)]
    if deg > 0:
        x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
        out += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            out += [SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (2.0 * zz - xx - yy),
                    SH_C2[3] * xz, SH_C2[4] * (xx - yy)]
            if deg > 2:
                out += [SH_C3[0] * y * (3.0 * xx - yy), SH_C3[1] * xy * z,
                        SH_C3[2] * y * (4.0 * zz - xx - yy),
                        SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                        SH_C3[4] * x * (4.0 * zz - xx - yy),
                        SH_C3[5] * z * (xx - yy), SH_C3[6] * x * (xx - 3.0 * yy)]
    return torch.stack(out, dim=-1)


def sh_to_rgb(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    K = (deg + 1) ** 2
    x = torch.sum(sh_basis(deg, dirs)[..., None] * sh[..., :K, :], dim=-2) + 0.5
    return torch.maximum(x, x.new_zeros(()))


def rot_elems(q: torch.Tensor) -> tuple:
    """(..., 4) unit quaternion (r, x, y, z) -> row-major rotation entries."""
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return (1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
            2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
            2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y))


class Splats(NamedTuple):
    """Activated per-row quantities of the padded state."""
    xyz: torch.Tensor
    features: torch.Tensor   # (C, K, 3)
    scaling: torch.Tensor    # (C, 3) activated
    rot: tuple               # 9 rotation entries
    opacity: torch.Tensor    # (C,) zero on dead rows
    albedo: torch.Tensor
    roughness: torch.Tensor
    metallic: torch.Tensor


def activate(p: dict, alive: torch.Tensor) -> Splats:
    q = p["rotation"]
    q = q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + 1e-20)
    return Splats(xyz=p["xyz"], features=torch.cat([p["f_dc"], p["f_rest"]], 1),
                  scaling=torch.exp(p["scaling"]), rot=rot_elems(q),
                  opacity=(torch.sigmoid(p["opacity"]) * alive[:, None])[:, 0],
                  albedo=torch.sigmoid(p["albedo"]),
                  roughness=torch.sigmoid(p["roughness"]),
                  metallic=torch.sigmoid(p["metallic"]))


def covariance(s: Splats) -> torch.Tensor:
    """(C, 6) world covariance R S S^T R^T (xx xy xz yy yz zz)."""
    e = s.rot
    s0, s1, s2 = s.scaling[:, 0] ** 2, s.scaling[:, 1] ** 2, s.scaling[:, 2] ** 2

    def sig(i, j):
        return (s0 * e[3 * i] * e[3 * j] + s1 * e[3 * i + 1] * e[3 * j + 1]
                + s2 * e[3 * i + 2] * e[3 * j + 2])

    return torch.stack([sig(0, 0), sig(0, 1), sig(0, 2), sig(1, 1), sig(1, 2),
                        sig(2, 2)], dim=-1)


def normals_toward(s: Splats, cam_center: torch.Tensor) -> torch.Tensor:
    """The rotation column of the shortest axis, flipped toward the camera."""
    e = s.rot
    s0, s1, s2 = s.scaling[:, 0], s.scaling[:, 1], s.scaling[:, 2]
    m0 = (s0 <= s1) & (s0 <= s2)
    m1 = ~m0 & (s1 <= s2)

    def col(i):
        return torch.where(m0, e[3 * i], torch.where(m1, e[3 * i + 1],
                                                     e[3 * i + 2]))

    n = torch.stack([col(0), col(1), col(2)], dim=-1)
    flip = torch.sum(n * (cam_center[None, :] - s.xyz), -1, keepdim=True) < 0.0
    n = torch.where(flip, -n, n)
    return n / torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True) + 1e-20)


# --- projection ---------------------------------------------------------------------

class Projected(NamedTuple):
    means2d: torch.Tensor
    depths: torch.Tensor
    conics: torch.Tensor
    colors: torch.Tensor
    radii: torch.Tensor
    rect_min: torch.Tensor
    rect_max: torch.Tensor
    valid: torch.Tensor


def _tile_index(v, tile, hi):
    return torch.clamp((v / tile).to(torch.int32), 0, hi)


def project(s: Splats, alive: torch.Tensor, cam, deg: int, tile: int) -> Projected:
    """EWA projection with the near cull at z <= 0.2, the 1.3 tan-fov clamp,
    the det <= 0 cull, the 3-sigma radius and the alpha >= 1/255 tile rect."""
    xyz = s.xyz
    W, H = cam.width, cam.height
    gx, gy = (W + tile - 1) // tile, (H + tile - 1) // tile
    wv = cam.world_view
    p_view = xyz @ wv[:3, :3] + wv[3, :3]
    p_hom = torch.cat([xyz, torch.ones_like(xyz[:, :1])], -1) @ cam.full_proj
    in_front = p_view[:, 2] > 0.2
    w_safe = torch.where(in_front, p_hom[:, 3], 1.0)
    p_proj = p_hom[:, :3] * (1.0 / (w_safe + 1e-7))[:, None]

    t = p_view
    tz = torch.where(t[:, 2] > 0.2, t[:, 2], 1.0)
    limx, limy = 1.3 * cam.tanfovx, 1.3 * cam.tanfovy
    tx = torch.clamp(t[:, 0] / tz, -limx, limx) * tz
    ty = torch.clamp(t[:, 1] / tz, -limy, limy) * tz
    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    R = wv[:3, :3].T
    c = covariance(s)

    def quad(u, v):
        return (c[:, 0] * (u[0] * v[0]) + c[:, 3] * (u[1] * v[1])
                + c[:, 5] * (u[2] * v[2]) + c[:, 1] * (u[0] * v[1] + u[1] * v[0])
                + c[:, 2] * (u[0] * v[2] + u[2] * v[0])
                + c[:, 4] * (u[1] * v[2] + u[2] * v[1]))

    M00, M01, M02 = quad(R[0], R[0]), quad(R[0], R[1]), quad(R[0], R[2])
    M11, M12, M22 = quad(R[1], R[1]), quad(R[1], R[2]), quad(R[2], R[2])
    j00, j02 = cam.fx * inv_z, -cam.fx * tx * inv_z2
    j11, j12 = cam.fy * inv_z, -cam.fy * ty * inv_z2
    cxx = j00 * j00 * M00 + 2 * j00 * j02 * M02 + j02 * j02 * M22
    cxy = j00 * j11 * M01 + j00 * j12 * M02 + j02 * j11 * M12 + j02 * j12 * M22
    cyy = j11 * j11 * M11 + 2 * j11 * j12 * M12 + j12 * j12 * M22

    det = cxx * cyy - cxy * cxy
    det_ok = det > 0.0
    det_inv = 1.0 / torch.where(det_ok, det, 1.0)
    conic = torch.stack([cyy * det_inv, -cxy * det_inv, cxx * det_inv], -1)
    mid = 0.5 * (cxx + cyy)
    disc = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    lambda1 = mid + disc
    radius = torch.ceil(3.0 * torch.sqrt(torch.maximum(lambda1, mid - disc)))
    q = 2.0 * torch.log(torch.clamp_min(s.opacity.detach(), 1e-12) * 255.0)
    r_op = torch.sqrt((torch.clamp_min(q, 0.0) + 1e-3)
                      * torch.clamp_min(lambda1, 0.0))
    rect_radius = torch.minimum(radius, torch.ceil(r_op) + 1.0)

    px = ((p_proj[:, 0] + 1.0) * W - 1.0) * 0.5
    py = ((p_proj[:, 1] + 1.0) * H - 1.0) * 0.5
    rmin = torch.stack([_tile_index(px - rect_radius, tile, gx),
                        _tile_index(py - rect_radius, tile, gy)], -1)
    rmax = torch.stack([_tile_index(px + rect_radius + tile - 1, tile, gx),
                        _tile_index(py + rect_radius + tile - 1, tile, gy)], -1)
    a3x = (_tile_index(px + radius + tile - 1, tile, gx)
           - _tile_index(px - radius, tile, gx))
    a3y = (_tile_index(py + radius + tile - 1, tile, gy)
           - _tile_index(py - radius, tile, gy))
    valid = in_front & det_ok & (a3x * a3y > 0) & alive

    dirs = xyz - cam.cam_center[None, :]
    dirs = dirs / torch.sqrt(torch.sum(dirs * dirs, -1, keepdim=True) + 1e-20)
    colors = sh_to_rgb(deg, s.features, dirs)
    v = valid[:, None]
    safe = torch.tensor([1.0, 0.0, 1.0], device=xyz.device)
    return Projected(
        means2d=torch.where(v, torch.stack([px, py], -1), -1e4),
        depths=torch.where(valid, p_view[:, 2], cam.zfar),
        conics=torch.where(v, conic, safe), colors=colors,
        radii=torch.where(valid, radius, 0.0).to(torch.int32),
        rect_min=rmin, rect_max=rmax, valid=valid)


# --- binning --------------------------------------------------------------------------

class Layout(NamedTuple):
    """Per tile, the instances in (depth, Gaussian) order, padded to whole
    chunks: gid (I,) with -1 for padding, chunk_tile (n_chunks,)."""
    gid: torch.Tensor
    chunk_tile: torch.Tensor
    pairs: int


def bin_instances(pr: Projected, opacity: torch.Tensor, H: int, W: int,
                  tile: int, chunk: int) -> Layout:
    """Every (tile, Gaussian) pair of the tile rectangles, row-major per
    Gaussian, less the pairs whose tile the Gaussian's alpha >= 1/255
    ellipse misses; stably sorted by (tile, depth); each tile's run padded
    to a chunk multiple."""
    dev = opacity.device
    gx, gy = (W + tile - 1) // tile, (H + tile - 1) // tile
    T = gx * gy
    valid = pr.valid
    wx = (pr.rect_max[:, 0] - pr.rect_min[:, 0]).clamp_min(0)
    wy = (pr.rect_max[:, 1] - pr.rect_min[:, 1]).clamp_min(0)
    count = torch.where(valid, wx * wy, 0).long()
    g = torch.repeat_interleave(torch.arange(count.shape[0], device=dev), count)
    start = torch.cumsum(count, 0) - count
    j = torch.arange(g.shape[0], device=dev) - start[g]
    w = torch.clamp_min(wx[g].long(), 1)
    tx = pr.rect_min[g, 0].long() + j % w
    ty = pr.rect_min[g, 1].long() + j // w
    con = pr.conics[g].detach()
    ca, cb, cc = con[:, 0], con[:, 1], con[:, 2]
    disc = torch.sqrt(0.25 * (ca - cc) ** 2 + cb * cb + 1e-20)
    lmin = torch.clamp_min(0.5 * (ca + cc) - disc, 0.0)
    qmax = 2.0 * torch.log(torch.clamp_min(opacity.detach()[g], 1e-12) * 255.0)
    mx, my = pr.means2d[g, 0].detach(), pr.means2d[g, 1].detach()
    cx = torch.minimum(torch.maximum(mx, (tx * tile).float()),
                       (tx * tile + tile - 1).float())
    cy = torch.minimum(torch.maximum(my, (ty * tile).float()),
                       (ty * tile + tile - 1).float())
    keep = lmin * ((mx - cx) ** 2 + (my - cy) ** 2) <= qmax + 1e-3
    g, tid = g[keep], (ty * gx + tx)[keep]
    depth_bits = pr.depths.detach()[g].contiguous().view(torch.int32).long()
    order = torch.sort((tid << 32) | depth_bits, stable=True).indices
    g, tid = g[order], tid[order]
    n_t = torch.bincount(tid, minlength=T)
    padded = (n_t + chunk - 1) // chunk * chunk
    astart = torch.cumsum(padded, 0) - padded
    rank = torch.arange(g.shape[0], device=dev) - (torch.cumsum(n_t, 0) - n_t)[tid]
    total = int(padded.sum())
    gid = torch.full((total,), -1, dtype=torch.long, device=dev)
    gid[astart[tid] + rank] = g
    chunk_tile = torch.repeat_interleave(torch.arange(T, device=dev),
                                         padded // chunk)
    return Layout(gid=gid, chunk_tile=chunk_tile, pairs=int(g.shape[0]))


# --- the blend ------------------------------------------------------------------------

LOG_EPS = float(np.float32(math.log(1e-4)))     # termination: T < 1e-4
ALPHA_MIN = float(np.float32(1.0 / 255.0))


def _walk(gc, px, py, logT0, done0, W, H):
    """One chunk walked at its tile's pixels: gc (n, chunk, 6, 1) geometry
    rows (mean x, mean y, conic a, b, c, opacity), px/py (n, P)."""
    dx = gc[:, :, 0] - px[:, None]
    dy = gc[:, :, 1] - py[:, None]
    power = (-0.5 * (gc[:, :, 2] * dx * dx + gc[:, :, 4] * dy * dy)
             - gc[:, :, 3] * dx * dy)
    G = torch.exp(torch.clamp_max(power, 0.0))
    alpha = torch.clamp_max(gc[:, :, 5] * G, 0.99)
    inside = ((px < W) & (py < H))[:, None]
    alpha = torch.where((power <= 0.0) & (alpha >= ALPHA_MIN) & inside, alpha, 0.0)
    log1m = torch.log1p(-alpha)
    test = logT0[:, None] + torch.cumsum(log1m, dim=1)
    done = done0[:, None] | (test < LOG_EPS)
    return dx, dy, G, alpha, log1m, test, test - log1m, done, (alpha > 0) & ~done


def _pixels(tiles, tile, gx):
    lane = torch.arange(tile * tile, device=tiles.device)
    px = (tiles[:, None] % gx) * tile + lane % tile
    py = (tiles[:, None] // gx) * tile + lane // tile
    return px.float(), py.float()


class _Blend(torch.autograd.Function):
    """values (C, F), means2d (C, 2), conics (C, 3), opacity (C,) -> image
    (F, H, W) (no background) and final T (H, W)."""

    @staticmethod
    def forward(ctx, values, means2d, conics, opacity, lay, H, W, tile, chunk,
                counts=None):
        dev = values.device
        gx, gy = (W + tile - 1) // tile, (H + tile - 1) // tile
        T, P, F = gx * gy, tile * tile, values.shape[1]
        nc = lay.chunk_tile.shape[0]
        null = lay.gid < 0
        gid = lay.gid.clamp_min(0)
        geom = torch.cat([means2d, conics, opacity[:, None]], -1)[gid]
        geom = torch.where(null[:, None], 0.0, geom).reshape(nc, chunk, 6)
        vals = values[gid].reshape(nc, chunk, F)
        bounds = torch.searchsorted(lay.chunk_tile, torch.arange(
            T + 1, device=dev, dtype=lay.chunk_tile.dtype))
        n_of = bounds[1:] - bounds[:-1]
        logT = torch.zeros(T, P, device=dev)
        done = torch.zeros(T, P, dtype=torch.bool, device=dev)
        img = torch.zeros(T, F, P, device=dev)
        clogT = torch.zeros(nc, P, device=dev)
        cdone = torch.zeros(nc, P, dtype=torch.bool, device=dev)
        batch = max(1, 2 ** 27 // (chunk * P))
        for r in range(int(n_of.max()) if nc else 0):
            for tiles in torch.split(torch.nonzero(n_of > r)[:, 0], batch):
                c = bounds[tiles] + r
                clogT[c], cdone[c] = logT[tiles], done[tiles]
                px, py = _pixels(tiles, tile, gx)
                st = _walk(geom[c][..., None], px, py, logT[tiles], done[tiles],
                           W, H)
                alpha, log1m, logT_excl, dn, contrib = st[3], st[4], st[6], st[7], st[8]
                w = torch.where(contrib, alpha * torch.exp(logT_excl), 0.0)
                if counts is not None:
                    counts["pairs"] += int(contrib.sum())
                img[tiles] += torch.bmm(vals[c].transpose(1, 2), w)
                logT[tiles] += torch.sum(torch.where(contrib, log1m, 0.0), 1)
                done[tiles] = dn[:, -1]
        fT = torch.exp(logT)
        ctx.save_for_backward(geom, vals, clogT, cdone, fT, lay.gid,
                              lay.chunk_tile)
        ctx.dims = (H, W, tile, chunk, values.shape[0])
        return _untile(img, gy, gx, tile)[:, :H, :W], \
            _untile(fT[:, None], gy, gx, tile)[0, :H, :W]

    @staticmethod
    def backward(ctx, g_img, g_fT):
        geom, vals, clogT, cdone, fT, gid, chunk_tile = ctx.saved_tensors
        H, W, tile, chunk, C = ctx.dims
        dev = geom.device
        gx, gy = (W + tile - 1) // tile, (H + tile - 1) // tile
        T, P, F = gx * gy, tile * tile, vals.shape[2]
        nc = chunk_tile.shape[0]
        Hp, Wp = gy * tile, gx * tile
        gi = torch.zeros(F, Hp, Wp, device=dev)
        gt = torch.zeros(Hp, Wp, device=dev)
        if g_img is not None:
            gi[:, :H, :W] = g_img
        if g_fT is not None:
            gt[:H, :W] = g_fT
        gi = gi.reshape(F, gy, tile, gx, tile).permute(1, 3, 0, 2, 4).reshape(T, F, P)
        gt = gt.reshape(gy, tile, gx, tile).permute(0, 2, 1, 3).reshape(T, P)
        bounds = torch.searchsorted(chunk_tile, torch.arange(
            T + 1, device=dev, dtype=chunk_tile.dtype))
        n_of = bounds[1:] - bounds[:-1]
        S = fT * gt
        dgeom = torch.zeros(nc, chunk, 6, device=dev)
        dvals = torch.zeros(nc, chunk, F, device=dev)
        batch = max(1, 2 ** 25 // (chunk * P))
        for r in reversed(range(int(n_of.max()) if nc else 0)):
            for tiles in torch.split(torch.nonzero(n_of > r)[:, 0], batch):
                c = bounds[tiles] + r
                px, py = _pixels(tiles, tile, gx)
                gc = geom[c][..., None]
                ca, cb, cc, op = gc[:, :, 2], gc[:, :, 3], gc[:, :, 4], gc[:, :, 5]
                dx, dy, G, alpha, _, _, logT_excl, _, contrib = _walk(
                    gc, px, py, clogT[c], cdone[c], W, H)
                T_excl = torch.exp(logT_excl)
                w = torch.where(contrib, alpha * T_excl, 0.0)
                gtile = gi[tiles]
                u = torch.bmm(vals[c], gtile)
                wu = w * u
                total = torch.sum(wu, dim=1, keepdim=True)
                S_after = (S[tiles][:, None] + total) - torch.cumsum(wu, dim=1)
                dalpha = torch.where(contrib & (op * G < 0.99),
                                     T_excl * u - S_after / (1.0 - alpha), 0.0)
                dpower = alpha * dalpha
                ddx = -(ca * dx + cb * dy) * dpower
                ddy = -(cc * dy + cb * dx) * dpower
                dgeom[c] = torch.stack([
                    ddx.sum(2), ddy.sum(2), (-0.5 * dx * dx * dpower).sum(2),
                    (-dx * dy * dpower).sum(2), (-0.5 * dy * dy * dpower).sum(2),
                    (G * dalpha).sum(2)], -1)
                dvals[c] = torch.bmm(w, gtile.transpose(1, 2))
                S[tiles] += total[:, 0]
        keep = gid >= 0
        rows = torch.cat([dvals.reshape(-1, F), dgeom.reshape(-1, 6)], 1)[keep]
        acc = torch.zeros(C, F + 6, dtype=torch.float64, device=dev)
        acc.index_add_(0, gid[keep], rows.double())
        acc = acc.float()
        return (acc[:, :F], acc[:, F:F + 2], acc[:, F + 2:F + 5], acc[:, F + 5],
                None, None, None, None, None, None)


def _untile(x, gy, gx, tile):
    """(T, F, P) -> (F, gy*tile, gx*tile)."""
    F = x.shape[1]
    return x.reshape(gy, gx, F, tile, tile).permute(2, 0, 3, 1, 4).reshape(
        F, gy * tile, gx * tile)


# --- render ---------------------------------------------------------------------------

def depth_normals(depth: torch.Tensor, K: torch.Tensor,
                  c2w: torch.Tensor) -> torch.Tensor:
    """(H, W) depth -> (H, W, 3) world normals from central differences of
    the back-projected points, zero on the 1-pixel border."""
    H, W = depth.shape
    y, x = torch.meshgrid(torch.arange(H, dtype=depth.dtype, device=depth.device),
                          torch.arange(W, dtype=depth.dtype, device=depth.device),
                          indexing="ij")
    pts = torch.stack([x * depth, y * depth, depth], -1) @ torch.linalg.inv(K).T
    pts = pts @ c2w[:3, :3].T + c2w[:3, 3]
    n = torch.linalg.cross(pts[1:H - 1, 2:W] - pts[1:H - 1, 0:W - 2],
                           pts[0:H - 2, 1:W - 1] - pts[2:H, 1:W - 1], dim=-1)
    n = n / torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True) + 1e-20)
    return torch.nn.functional.pad(n, (0, 0, 1, 1, 1, 1))


def render(p: dict, alive: torch.Tensor, cam, deg: int, feature_count: int,
           tile: int, chunk: int, sobel: bool = False,
           counts: dict | None = None) -> dict:
    """The render package of one view on a black background: render, alpha,
    distance, depth, normal, local normal, albedo, roughness maps, normal
    mask, visibility, and (sobel) the normals of the rendered depth.
    `counts` gathers the blend's contributing pairs and visible Gaussians."""
    s = activate(p, alive)
    H, W = cam.height, cam.width
    normals = normals_toward(s, cam.cam_center)
    wv = cam.world_view
    cam_n = normals @ wv[:3, :3]
    cam_p = s.xyz @ wv[:3, :3] + wv[3, :3]
    feats = torch.cat([torch.ones_like(cam_p[:, :1]),
                       torch.abs(torch.sum(cam_n * cam_p, -1))[:, None],
                       normals, s.albedo, s.roughness, s.metallic], -1)
    pr = project(s, alive, cam, deg, tile)
    with torch.no_grad():
        lay = bin_instances(pr, s.opacity, H, W, tile, chunk)
    values = torch.cat([pr.colors, feats[:, :feature_count]], -1)
    if counts is not None:
        counts["visible"] += int(pr.valid.sum())
    img, fT = _Blend.apply(values, pr.means2d, pr.conics, s.opacity, lay,
                           H, W, tile, chunk, counts)
    buf = torch.cat([img[3:], img.new_zeros(10 - feature_count, H, W)])
    normal_map = buf[2:5]
    local_n = normal_map.permute(1, 2, 0).reshape(-1, 3) @ wv[:3, :3]
    distance = buf[1:2]
    denoms = torch.sum(local_n * cam.get_rays().reshape(-1, 3), -1).reshape(1, H, W)
    depth = distance / -(denoms + 1e-8)
    pkg = {"render": img[0:3], "alpha_map": buf[0:1], "distance_map": distance,
           "depth_map": depth, "normal_map": normal_map,
           "local_normal_map": local_n.reshape(H, W, 3).permute(2, 0, 1),
           "albedo_map": buf[5:8], "roughness_map": buf[8:9],
           "metallic_map": buf[9:10],
           "normal_mask": torch.all(normal_map.detach() != 0.0, 0, keepdim=True),
           "visibility_filter": pr.radii > 0, "final_T": fT,
           "pairs": lay.pairs}
    if sobel:
        c2w = torch.linalg.inv(wv.T)
        n = depth_normals(depth[0], cam.get_K(), c2w)
        a = pkg["alpha_map"][0][..., None]
        pkg["sobel_map"] = (n * a).permute(2, 0, 1)
    return pkg


@torch.no_grad()
def instances(p: dict, alive: torch.Tensor, cam, tile: int) -> int:
    """(tile, Gaussian) pairs of a view's tile rectangles before any cull:
    the instances a binning of this view expands."""
    s = activate(p, alive)
    pr = project(s, alive, cam, 0, tile)
    wx = (pr.rect_max[:, 0] - pr.rect_min[:, 0]).clamp_min(0).long()
    wy = (pr.rect_max[:, 1] - pr.rect_min[:, 1]).clamp_min(0).long()
    return int(torch.where(pr.valid, wx * wy, 0).sum())
