"""The render's per-Gaussian preprocess: from the raw parameters to what
render() hands to rasterize_from_projected.

`preprocess` returns the opacities (C,), the 10-channel features (C, 10)
and the Projected of one view. On CPU tensors it runs the eager chain
`preprocess_plain` (Gaussians.get_opacity and get_normals,
ops/rasterize.py::build_features, ops/projection.py::project), the plain
version every port-vs-JAX test holds. On CUDA tensors it runs one
torch.autograd.Function whose forward and backward are one kernel each,
csrc/preprocess.cu. The JAX package computes this in XLA code
(gs2m_tpu/ops/projection.py, core/gaussians.py, core/sh.py), with no Pallas
kernel of its own; the port's kernels were added because the eager chain
is ~560 launches forward and ~790 backward per render, and the training
step is bound by the host's launch rate.

Design. One thread per Gaussian row of the capacity C, 128 a block; the
camera's device tensors (world_view, full_proj, cam_center, fx, fy,
tanfov) are read into shared memory by each block, so nothing is copied
to the host and nothing syncs. The forward follows the plain code's
formulas and operation order, built with -fmad=false: the near cull and
w_safe, the 1.3 tanfov clamp, the det <= 0 cull, the guarded
discriminant, the opacity-aware rect, the culled rows' safe values, the
normal from the first minimal scale flipped toward the camera, the colour
through torch.maximum(x, 0). The backward saves only the inputs and
recomputes its row's forward, then maps the cotangents of opacities,
features, means2d, conics and colors to the nine leaves' gradients with
autograd's conventions at ties (maximum halves the gradient at a tie,
clamp passes it at its bounds, abs has gradient 0 at 0, where routes it to
the chosen branch); means2d and conics carry no gradient on culled rows,
whose other gradients stay finite. Each row writes only its own gradients:
no atomics, so the step stays bit-reproducible. The plain PyTorch twin of
the backward, `preprocess_bwd_plain`, is held against autograd of
`preprocess_plain` on the CPU (tests/test_torch_preprocess.py); the card
tests hold both kernels against the plain path on the card.

Bound on an H100 SXM (3.35 TB/s): bytes. Each row reads its parameters
once (257 bytes at SH degree 3) and writes its outputs once (105 bytes
forward); the backward reads the parameters and the cotangents (76 bytes)
and writes the gradients (256 bytes). At the benchmark's 2^19 rows that is
190 MB forward and 309 MB backward: 57 and 92 us.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from gs2m_tpu_torch.core import sh as shlib
from gs2m_tpu_torch.core.camera import Camera
from gs2m_tpu_torch.core.gaussians import Gaussians
from gs2m_tpu_torch.launches import LAUNCHES
from gs2m_tpu_torch.ops.projection import Projected, project
from gs2m_tpu_torch.ops.rasterize import build_features


class Preprocessed(NamedTuple):
    opacities: torch.Tensor  # (C,) sigmoid(opacity) * alive
    features: torch.Tensor   # (C, 10) ops/rasterize.py::build_features
    proj: Projected


def preprocess_plain(gaussians: Gaussians, camera: Camera,
                     active_sh_degree: int, tile: int = 16,
                     with_colors: bool = True,
                     z_depth: bool = False) -> Preprocessed:
    """The eager chain, differentiable through autograd."""
    opacities = gaussians.get_opacity[:, 0]
    normals = gaussians.get_normals(camera.cam_center)
    features = build_features(gaussians, camera, z_depth=z_depth,
                              normals=normals)
    proj = project(gaussians, camera, active_sh_degree, opacities, tile=tile,
                   with_colors=with_colors)
    return Preprocessed(opacities, features, proj)


def preprocess(gaussians: Gaussians, camera: Camera, active_sh_degree: int,
               tile: int = 16, with_colors: bool = True,
               z_depth: bool = False) -> Preprocessed:
    """Opacities, features and the Projected of one view, differentiable in
    the nine parameter leaves. The kernel pair on CUDA tensors (or an
    error), the eager chain on CPU tensors. with_colors=False gives zero
    colors (the observe pass needs none)."""
    x = gaussians.xyz
    if x.is_cuda:
        return _preprocess_card(gaussians, camera, active_sh_degree, tile,
                                with_colors, z_depth)
    if x.device.type != "cpu":
        raise ValueError(f"preprocess runs on cuda or cpu, not {x.device}")
    return preprocess_plain(gaussians, camera, active_sh_degree, tile,
                            with_colors, z_depth)


class _Meta(NamedTuple):
    deg: int
    tile: int
    width: int
    height: int
    with_colors: bool
    z_depth: bool
    zfar: float


def _inputs(g: Gaussians, cam: Camera) -> list:
    """The kernels' 17 inputs, in their order."""
    return [g.xyz, g.features_dc, g.features_rest, g.scaling, g.rotation,
            g.opacity, g.albedo, g.roughness, g.metallic, g.alive,
            cam.world_view, cam.full_proj, cam.cam_center, cam.fx, cam.fy,
            cam.tanfovx, cam.tanfovy]


def _check(ins: list, deg: int) -> None:
    """Raise on what the kernels do not take: float32 tensors (alive bool)
    of the Gaussians' and the camera's shapes on one CUDA device, and an
    SH degree of 0..3 that the coefficients carry."""
    C = ins[0].shape[0]
    k_rest = ins[2].shape[1] if ins[2].dim() == 3 else -1
    shapes = [(C, 3), (C, 1, 3), (C, k_rest, 3), (C, 3), (C, 4), (C, 1),
              (C, 3), (C, 1), (C, 1), (C,), (4, 4), (4, 4), (3,), (), (), (),
              ()]
    names = ["xyz", "features_dc", "features_rest", "scaling", "rotation",
             "opacity", "albedo", "roughness", "metallic", "alive",
             "world_view", "full_proj", "cam_center", "fx", "fy", "tanfovx",
             "tanfovy"]
    dev = ins[0].device
    for name, x, shape in zip(names, ins, shapes):
        dt = torch.bool if name == "alive" else torch.float32
        if x.device != dev or x.dtype != dt or tuple(x.shape) != shape:
            raise ValueError(f"preprocess: {name} must be a {dt} tensor of "
                             f"shape {shape} on {dev}")
    if not 0 <= deg <= 3 or shlib.num_sh_coeffs(deg) > k_rest + 1:
        raise ValueError(f"preprocess: SH degree {deg} needs "
                         f"{shlib.num_sh_coeffs(deg)} coefficients, the "
                         f"Gaussians carry {k_rest + 1}")


@functools.cache
def _entry(name: str):
    """The C entry gs2m_<name> of csrc/preprocess.cu, built at first use."""
    from gs2m_tpu_torch import _build

    fn = getattr(_build.library("preprocess"), f"gs2m_{name}")
    fn.restype = ctypes.c_int
    fwd = name == "preprocess_fwd"
    fn.argtypes = ([ctypes.c_void_p] * (2 if fwd else 4) + [ctypes.c_int] * 8
                   + [ctypes.c_float] * fwd + [ctypes.c_void_p])
    return fn


def _ptrs(ts) -> ctypes.Array:
    return (ctypes.c_void_p * len(ts))(
        *[0 if t is None else t.data_ptr() for t in ts])


def _call(name: str, dev: torch.device, *args) -> None:
    """Launch on the current stream; raise on a refused launch."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name, 0] += 1


def _launch_fwd(ins: list, m: _Meta) -> tuple:
    """The forward kernel: opacities, features, means2d, depths, conics,
    colors, radii, rect_min, rect_max, tiles_touched, valid."""
    C, dev = ins[0].shape[0], ins[0].device
    f = lambda *s: torch.empty(*s, device=dev)
    i = lambda *s: torch.empty(*s, dtype=torch.int32, device=dev)
    outs = (f(C), f(C, 10), f(C, 2), f(C), f(C, 3), f(C, 3), i(C), i(C, 2),
            i(C, 2), i(C), torch.empty(C, dtype=torch.bool, device=dev))
    _call("preprocess_fwd", dev, _ptrs(ins), _ptrs(outs), C,
          ins[2].shape[1], m.deg, int(m.with_colors), int(m.z_depth), m.tile,
          m.width, m.height, m.zfar)
    return outs


def _launch_bwd(ins: list, cots: tuple, m: _Meta) -> list:
    """The backward kernel: the nine leaves' gradients from the cotangents
    of opacities, features, means2d, conics and colors (None for zeros)."""
    C, dev = ins[0].shape[0], ins[0].device
    strides = []
    for g in cots:
        if g is not None and (g.dtype != torch.float32 or g.device != dev):
            raise ValueError("preprocess: cotangents must be float32 on "
                             f"{dev}")
        strides += ([0, 0] if g is None else
                    [g.stride(0), g.stride(1) if g.dim() == 2 else 0])
    grads = [torch.empty_like(x) for x in ins[:9]]
    _call("preprocess_bwd", dev, _ptrs(ins), _ptrs(cots),
          (ctypes.c_longlong * 10)(*strides), _ptrs(grads), C,
          ins[2].shape[1], m.deg, int(m.with_colors), int(m.z_depth), m.tile,
          m.width, m.height)
    return grads


class _Preprocess(torch.autograd.Function):
    """The kernel pair behind one autograd node. Inputs: the 17 tensors of
    _inputs, then the _Meta; outputs: opacities, features and the nine
    Projected fields (depths and the integer fields carry no gradient)."""

    @staticmethod
    def forward(ctx, *args):
        *ins, meta = args
        ins = [x.contiguous() for x in ins]
        outs = _launch_fwd(ins, meta)
        ctx.save_for_backward(*ins)
        ctx.meta = meta
        ctx.mark_non_differentiable(outs[3], *outs[6:])
        ctx.set_materialize_grads(False)
        return outs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_op, g_feat, g_m2d, _g_depth, g_con, g_col, *_):
        grads = _launch_bwd(list(ctx.saved_tensors),
                            (g_op, g_feat, g_m2d, g_con, g_col), ctx.meta)
        return (*[g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad)],
                *[None] * 9)


def _preprocess_card(g: Gaussians, cam: Camera, deg: int, tile: int,
                     with_colors: bool, z_depth: bool) -> Preprocessed:
    ins = _inputs(g, cam)
    _check(ins, deg)
    meta = _Meta(deg, tile, cam.width, cam.height, bool(with_colors),
                 bool(z_depth), float(cam.zfar))
    op, feat, *p = _Preprocess.apply(*ins, meta)
    return Preprocessed(op, feat, Projected(*p))


# --- the backward kernel in plain PyTorch -------------------------------------

def _sh_basis_vjp(deg: int, x, y, z, gb: list) -> tuple:
    """d (sum_k gb_k basis_k) / d dir, the kernel's sh_basis_vjp."""
    C1, C2, C3 = shlib.C1, shlib.C2, shlib.C3
    gx = gy = gz = torch.zeros_like(x)
    if deg > 0:
        gy = gy + -C1 * gb[1]
        gz = gz + C1 * gb[2]
        gx = gx + -C1 * gb[3]
    if deg > 1:
        xx, yy, zz = x * x, y * y, z * z
        gx = gx + C2[0] * y * gb[4]
        gy = gy + C2[0] * x * gb[4]
        gy = gy + C2[1] * z * gb[5]
        gz = gz + C2[1] * y * gb[5]
        gx = gx + -2.0 * C2[2] * x * gb[6]
        gy = gy + -2.0 * C2[2] * y * gb[6]
        gz = gz + 4.0 * C2[2] * z * gb[6]
        gx = gx + C2[3] * z * gb[7]
        gz = gz + C2[3] * x * gb[7]
        gx = gx + 2.0 * C2[4] * x * gb[8]
        gy = gy + -2.0 * C2[4] * y * gb[8]
        if deg > 2:
            gx = gx + 6.0 * C3[0] * x * y * gb[9]
            gy = gy + C3[0] * (3.0 * xx - 3.0 * yy) * gb[9]
            gx = gx + C3[1] * y * z * gb[10]
            gy = gy + C3[1] * x * z * gb[10]
            gz = gz + C3[1] * x * y * gb[10]
            gx = gx + -2.0 * C3[2] * x * y * gb[11]
            gy = gy + C3[2] * (4.0 * zz - xx - 3.0 * yy) * gb[11]
            gz = gz + 8.0 * C3[2] * y * z * gb[11]
            gx = gx + -6.0 * C3[3] * x * z * gb[12]
            gy = gy + -6.0 * C3[3] * y * z * gb[12]
            gz = gz + C3[3] * (6.0 * zz - 3.0 * xx - 3.0 * yy) * gb[12]
            gx = gx + C3[4] * (4.0 * zz - 3.0 * xx - yy) * gb[13]
            gy = gy + -2.0 * C3[4] * x * y * gb[13]
            gz = gz + 8.0 * C3[4] * x * z * gb[13]
            gx = gx + 2.0 * C3[5] * x * z * gb[14]
            gy = gy + -2.0 * C3[5] * y * z * gb[14]
            gz = gz + C3[5] * (xx - yy) * gb[14]
            gx = gx + C3[6] * (3.0 * xx - 3.0 * yy) * gb[15]
            gy = gy + -6.0 * C3[6] * x * y * gb[15]
    return gx, gy, gz


def _cols(g, k: int, zero: torch.Tensor) -> list:
    """A cotangent's k columns as (C,) tensors (zeros for None)."""
    return [zero if g is None else g[:, j] for j in range(k)]


def preprocess_bwd_plain(gaussians: Gaussians, camera: Camera, g_op, g_feat,
                         g_m2d, g_con, g_col, *, deg: int, tile: int = 16,
                         with_colors: bool = True,
                         z_depth: bool = False) -> dict:
    """The backward kernel in plain PyTorch, step for step: the nine
    leaves' gradients (keyed as Gaussians.params_dict) from the cotangents
    of opacities (C,), features (C, 10), means2d (C, 2), conics (C, 3) and
    colors (C, 3), any of them None for zeros. It recomputes the forward
    from the parameters as the kernel does."""
    g = gaussians
    W = camera.world_view
    F = camera.full_proj
    cc = camera.cam_center
    fx, fy = camera.fx, camera.fy
    limx, limy = 1.3 * camera.tanfovx, 1.3 * camera.tanfovy
    Wd, Hd = camera.width, camera.height
    grid_x, grid_y = (Wd + tile - 1) // tile, (Hd + tile - 1) // tile
    x, y, z = g.xyz[:, 0], g.xyz[:, 1], g.xyz[:, 2]
    zero = torch.zeros_like(x)
    g_op = g_op if g_op is not None else zero
    gf = _cols(g_feat, 10, zero)
    gm = _cols(g_m2d, 2, zero)
    gk = _cols(g_con, 3, zero)
    gcol = _cols(g_col, 3, zero)

    # The forward of each row, recomputed (the kernel's geometry()).
    alive = g.alive.to(x.dtype)
    sig_o = torch.sigmoid(g.opacity[:, 0])
    op = sig_o * alive
    s = torch.exp(g.scaling)
    s = [s[:, 0], s[:, 1], s[:, 2]]
    q = [g.rotation[:, k] for k in range(4)]
    nq = torch.sqrt(((q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]) + q[3] * q[3]
                    + 1e-20)
    qn = [qk / nq for qk in q]
    r_, x_, y_, z_ = qn
    e = [1 - 2 * (y_ * y_ + z_ * z_), 2 * (x_ * y_ - r_ * z_),
         2 * (x_ * z_ + r_ * y_), 2 * (x_ * y_ + r_ * z_),
         1 - 2 * (x_ * x_ + z_ * z_), 2 * (y_ * z_ - r_ * x_),
         2 * (x_ * z_ - r_ * y_), 2 * (y_ * z_ + r_ * x_),
         1 - 2 * (x_ * x_ + y_ * y_)]
    dot3 = lambda a, b, c, M, k: (a * M[0, k] + b * M[1, k]) + c * M[2, k]
    t = [dot3(x, y, z, W, k) + W[3, k] for k in range(3)]
    ph = [dot3(x, y, z, F, k) + F[3, k] for k in range(4)]
    in_front = t[2] > 0.2
    pw = 1.0 / (torch.where(in_front, ph[3], 1.0) + 1e-7)
    s2 = [sk * sk for sk in s]
    pairs = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
    sig = [(s2[0] * e[3 * i] * e[3 * j] + s2[1] * e[3 * i + 1] * e[3 * j + 1])
           + s2[2] * e[3 * i + 2] * e[3 * j + 2] for i, j in pairs]
    tz = torch.where(t[2] > 0.2, t[2], 1.0)
    ux, uy = t[0] / tz, t[1] / tz
    uxc = torch.clamp(ux, -limx, limx)
    uyc = torch.clamp(uy, -limy, limy)
    tx, ty = uxc * tz, uyc * tz
    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    R = W[:3, :3].T

    def uv(a, b):
        u, v = R[a], R[b]
        return (u[0] * v[0], u[1] * v[1], u[2] * v[2], u[0] * v[1] + u[1] * v[0],
                u[0] * v[2] + u[2] * v[0], u[1] * v[2] + u[2] * v[1])

    def quad(a, b):
        c = uv(a, b)
        return (sig[0] * c[0] + sig[3] * c[1] + sig[5] * c[2] + sig[1] * c[3]
                + sig[2] * c[4] + sig[4] * c[5])

    M = [quad(a, b) for a, b in pairs]
    j00 = fx * inv_z
    j02 = -fx * tx * inv_z2
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z2
    cxx = j00 * j00 * M[0] + 2 * j00 * j02 * M[2] + j02 * j02 * M[5]
    cxy = (j00 * j11 * M[1] + j00 * j12 * M[2] + j02 * j11 * M[4]
           + j02 * j12 * M[5])
    cyy = j11 * j11 * M[3] + 2 * j11 * j12 * M[4] + j12 * j12 * M[5]
    det = cxx * cyy - cxy * cxy
    det_ok = det > 0.0
    det_inv = 1.0 / torch.where(det_ok, det, 1.0)
    mid = 0.5 * (cxx + cyy)
    disc = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.maximum(mid + disc, mid - disc)))
    px = ((ph[0] * pw + 1.0) * Wd - 1.0) * 0.5
    py = ((ph[1] * pw + 1.0) * Hd - 1.0) * 0.5
    ti = lambda v, hi: torch.clamp((v / tile).to(torch.int32), 0, hi)
    a3x = ti(px + radius + tile - 1, grid_x) - ti(px - radius, grid_x)
    a3y = ti(py + radius + tile - 1, grid_y) - ti(py - radius, grid_y)
    valid = in_front & det_ok & (a3x * a3y > 0) & g.alive

    # Opacity and the material sigmoids.
    svjp = lambda gr, yv: gr * (1.0 - yv) * yv
    out = {"opacity": svjp(g_op * alive, sig_o)[:, None]}
    out["albedo"] = torch.stack(
        [svjp(gf[5 + c], torch.sigmoid(g.albedo[:, c])) for c in range(3)], -1)
    out["roughness"] = svjp(gf[8], torch.sigmoid(g.roughness[:, 0]))[:, None]
    out["metallic"] = svjp(gf[9], torch.sigmoid(g.metallic[:, 0]))[:, None]

    gx = [zero, zero, zero]
    gt = [zero, zero, zero]
    ge = [zero] * 9
    gs2 = [zero, zero, zero]

    # Colors -> SH coefficients and the view direction.
    K = shlib.num_sh_coeffs(deg)
    g_rest = torch.zeros_like(g.features_rest)
    g_dc = torch.zeros_like(g.features_dc)
    if with_colors:
        v = [x - cc[0], y - cc[1], z - cc[2]]
        nd = torch.sqrt(((v[0] * v[0] + v[1] * v[1]) + v[2] * v[2]) + 1e-20)
        d = torch.stack([vk / nd for vk in v], -1)
        b = shlib._sh_basis(deg, d)
        sh = torch.cat([g.features_dc, g.features_rest], 1)
        gb = [zero] * K
        for c in range(3):
            acc = b[:, 0] * sh[:, 0, c]
            for k in range(1, K):
                acc = acc + b[:, k] * sh[:, k, c]
            xc = acc + 0.5
            gxc = torch.where(xc > 0.0, gcol[c],
                              torch.where(xc == 0.0, gcol[c] * 0.5, 0.0))
            g_dc[:, 0, c] = gxc * b[:, 0]
            for k in range(1, K):
                g_rest[:, k - 1, c] = gxc * b[:, k]
                gb[k] = gb[k] + gxc * sh[:, k, c]
        gd = _sh_basis_vjp(deg, d[:, 0], d[:, 1], d[:, 2], gb)
        dot = (gd[0] * v[0] + gd[1] * v[1]) + gd[2] * v[2]
        nd3 = nd * nd * nd
        gx = [gx[k] + (gd[k] / nd - v[k] * (dot / nd3)) for k in range(3)]

    # Features: the normal and the plane distance |n_cam . t| (or t_z).
    m0 = (s[0] <= s[1]) & (s[0] <= s[2])
    m1 = ~m0 & (s[1] <= s[2])
    col = [torch.where(m0, e[3 * j], torch.where(m1, e[3 * j + 1], e[3 * j + 2]))
           for j in range(3)]
    vv = [cc[0] - x, cc[1] - y, cc[2] - z]
    flip = ((col[0] * vv[0] + col[1] * vv[1]) + col[2] * vv[2]) < 0.0
    nf = [torch.where(flip, -c, c) for c in col]
    nn = torch.sqrt(((nf[0] * nf[0] + nf[1] * nf[1]) + nf[2] * nf[2]) + 1e-20)
    n = [c / nn for c in nf]
    gn = [gf[2], gf[3], gf[4]]
    if z_depth:
        gt[2] = gt[2] + gf[1]
    else:
        cn = [dot3(n[0], n[1], n[2], W, k) for k in range(3)]
        dot = (cn[0] * t[0] + cn[1] * t[1]) + cn[2] * t[2]
        gdot = torch.where(dot > 0.0, gf[1], torch.where(dot < 0.0, -gf[1], 0.0))
        gt = [gt[k] + gdot * cn[k] for k in range(3)]
        gn = [gn[j] + (((gdot * t[0]) * W[j, 0] + (gdot * t[1]) * W[j, 1])
                       + (gdot * t[2]) * W[j, 2]) for j in range(3)]
    dot = (gn[0] * nf[0] + gn[1] * nf[1]) + gn[2] * nf[2]
    nn3 = nn * nn * nn
    for k in range(3):
        gnf = gn[k] / nn - nf[k] * (dot / nn3)
        gc = torch.where(flip, -gnf, gnf)
        ge[3 * k] = ge[3 * k] + torch.where(m0, gc, 0.0)
        ge[3 * k + 1] = ge[3 * k + 1] + torch.where(~m0 & m1, gc, 0.0)
        ge[3 * k + 2] = ge[3 * k + 2] + torch.where(~m0 & ~m1, gc, 0.0)

    # means2d -> the clip-space position (valid rows only).
    vz = lambda a: torch.where(valid, a, 0.0)
    gpx = vz(gm[0] * 0.5 * Wd)
    gpy = vz(gm[1] * 0.5 * Hd)
    gph0, gph1 = gpx * pw, gpy * pw
    gpw = gpx * ph[0] + gpy * ph[1]
    gph3 = torch.where(in_front, gpw * -(pw * pw), 0.0)
    gx = [gx[j] + ((gph0 * F[j, 0] + gph1 * F[j, 1]) + gph3 * F[j, 3])
          for j in range(3)]

    # conics -> the 2D covariance.
    ga, gb_, gc_ = vz(gk[0]), vz(gk[1]), vz(gk[2])
    ginv = (ga * cyy + gb_ * -cxy) + gc_ * cxx
    gdet = ginv * -(det_inv * det_inv)
    gcxx = gc_ * det_inv + gdet * cyy
    gcyy = ga * det_inv + gdet * cxx
    gcxy = -(gb_ * det_inv) - 2.0 * gdet * cxy

    # The 2D covariance -> R Sigma R^T and the Jacobian.
    gM = [gcxx * (j00 * j00), gcxy * (j00 * j11),
          gcxx * (2.0 * j00 * j02) + gcxy * (j00 * j12), gcyy * (j11 * j11),
          gcxy * (j02 * j11) + gcyy * (2.0 * j11 * j12),
          gcxx * (j02 * j02) + gcxy * (j02 * j12) + gcyy * (j12 * j12)]
    gj00 = gcxx * (2.0 * j00 * M[0] + 2.0 * j02 * M[2]) + gcxy * (
        j11 * M[1] + j12 * M[2])
    gj02 = gcxx * (2.0 * j00 * M[2] + 2.0 * j02 * M[5]) + gcxy * (
        j11 * M[4] + j12 * M[5])
    gj11 = gcyy * (2.0 * j11 * M[3] + 2.0 * j12 * M[4]) + gcxy * (
        j00 * M[1] + j02 * M[4])
    gj12 = gcyy * (2.0 * j11 * M[4] + 2.0 * j12 * M[5]) + gcxy * (
        j00 * M[2] + j02 * M[5])
    ginv_z2 = gj02 * (-fx * tx) + gj12 * (-fy * ty)
    ginv_z = gj00 * fx + gj11 * fy + 2.0 * inv_z * ginv_z2
    gtx = gj02 * -fx * inv_z2
    gty = gj12 * -fy * inv_z2
    gtz = -ginv_z * (inv_z * inv_z)
    gux = torch.where((ux >= -limx) & (ux <= limx), gtx * tz, 0.0)
    guy = torch.where((uy >= -limy) & (uy <= limy), gty * tz, 0.0)
    gtz = gtz + (gtx * uxc + gty * uyc)
    gt[0] = gt[0] + gux / tz
    gt[1] = gt[1] + guy / tz
    gtz = gtz + (-gux * (t[0] / (tz * tz)) - guy * (t[1] / (tz * tz)))
    gt[2] = gt[2] + torch.where(t[2] > 0.2, gtz, 0.0)

    # R Sigma R^T -> Sigma -> the squared scales and the rotation elements.
    gsig = [zero] * 6
    for m, (a, b_) in enumerate(pairs):
        c = uv(a, b_)
        for slot, coef in zip((0, 3, 5, 1, 2, 4), c):
            gsig[slot] = gsig[slot] + gM[m] * coef
    for p, (i, j) in enumerate(pairs):
        a, b_ = 3 * i, 3 * j
        for k in range(3):
            gs2[k] = gs2[k] + gsig[p] * (e[a + k] * e[b_ + k])
            ge[a + k] = ge[a + k] + gsig[p] * s2[k] * e[b_ + k]
            ge[b_ + k] = ge[b_ + k] + gsig[p] * s2[k] * e[a + k]

    # The view-space position -> xyz.
    out["xyz"] = torch.stack(
        [gx[j] + ((gt[0] * W[j, 0] + gt[1] * W[j, 1]) + gt[2] * W[j, 2])
         for j in range(3)], -1)
    out["scaling"] = torch.stack([gs2[k] * 2.0 * s[k] * s[k] for k in range(3)],
                                 -1)
    # Rotation elements -> the normalised quaternion -> the raw one.
    r, qx, qy, qz = qn
    gq = [2.0 * (-qz * ge[1] + qy * ge[2] + qz * ge[3] - qx * ge[5]
                 - qy * ge[6] + qx * ge[7]),
          2.0 * (qy * ge[1] + qz * ge[2] + qy * ge[3] - r * ge[5] + qz * ge[6]
                 + r * ge[7]) - 4.0 * qx * (ge[4] + ge[8]),
          2.0 * (qx * ge[1] + r * ge[2] + qx * ge[3] + qz * ge[5] - r * ge[6]
                 + qz * ge[7]) - 4.0 * qy * (ge[0] + ge[8]),
          2.0 * (-r * ge[1] + qx * ge[2] + r * ge[3] + qy * ge[5] + qx * ge[6]
                 + qy * ge[7]) - 4.0 * qz * (ge[0] + ge[4])]
    qdot = ((gq[0] * q[0] + gq[1] * q[1]) + gq[2] * q[2]) + gq[3] * q[3]
    nq3 = nq * nq * nq
    out["rotation"] = torch.stack([gq[k] / nq - q[k] * (qdot / nq3)
                                   for k in range(4)], -1)
    out["f_dc"] = g_dc
    out["f_rest"] = g_rest
    return {k: out[k] for k in g.params_dict()}
