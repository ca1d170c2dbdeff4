"""Block-sparse TSDF fusion of rendered depth maps.

Port of gs2m_tpu/mesh/tsdf.py (Open3D ScalableTSDFVolume semantics:
projective SDF truncated at sdf_trunc, per-observation weight 1, running
average color; depth 0 and depth >= max_depth rejected), as torch on the
device of the cameras:

* Discovery: each view's depth samples (stride 2) are back-projected in
  float64, where numpy promotes them in the JAX package (Python-float
  intrinsics, f32 rotation, the floor), floored to block coordinates,
  dilated by the truncation band and united over the views. The union is
  one sort of packed int64 keys (`block_keys`): with every coordinate
  offset into 21 bits, key order is the lexicographic order of (x, y, z),
  so `block_coords` come out in the JAX package's sorted(set(...)) order.
* Voxel centers in float64, then f32, as there.
* Integration in f32 like the JAX scan body, over slabs of blocks (peak
  memory bounded; voxels are independent, so the result does not depend on
  the slab size), the views in order inside each slab. The view transform
  is spelled out elementwise, ((c0 w0 + c1 w1) + c2 w2) + t, so no matmul
  (TF32 or otherwise) enters, and every division is by a tensor on the
  device (CUDA turns division by a host scalar into a reciprocal multiply):
  CPU and CUDA give the same volume bit for bit. torch.round rounds half to
  even, like jnp.round.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time

import numpy as np
import torch

BLOCK_EDGE = 8  # voxels per block edge (8^3 = 512 voxels per block)
_KEY_BITS = 21  # per coordinate in a packed block key
_KEY_OFF = 1 << (_KEY_BITS - 1)


@dataclasses.dataclass
class TSDFVolume:
    block_coords: torch.Tensor  # (B, 3) int64 block indices, sorted
    tsdf: torch.Tensor          # (B, E^3) f32 in [-1, 1] (units of sdf_trunc)
    weight: torch.Tensor        # (B, E^3) f32
    color: torch.Tensor         # (B, E^3, 3) f32
    voxel_size: float
    sdf_trunc: float


@contextlib.contextmanager
def stage_timer(stages: dict | None, name: str, device: torch.device):
    """Adds the milliseconds of the enclosed work to stages[name]: CUDA
    events on a CUDA device, the host clock otherwise; nothing when
    `stages` is None."""
    if stages is None:
        yield
        return
    if device.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        yield
        b.record()
        b.synchronize()
        ms = a.elapsed_time(b)
    else:
        t0 = time.perf_counter()
        yield
        ms = (time.perf_counter() - t0) * 1e3
    stages[name] = stages.get(name, 0.0) + ms


def block_keys(coords: torch.Tensor) -> torch.Tensor:
    """(N, 3) int64 block coordinates -> (N,) int64 keys whose order is the
    rows' lexicographic order."""
    c = coords + _KEY_OFF
    if c.numel() and (int(c.min()) < 0 or int(c.max()) >= 1 << _KEY_BITS):
        raise ValueError(f"block coordinates outside +-2^{_KEY_BITS - 1}")
    return (c[:, 0] << 2 * _KEY_BITS) | (c[:, 1] << _KEY_BITS) | c[:, 2]


def keys_to_coords(keys: torch.Tensor) -> torch.Tensor:
    mask = (1 << _KEY_BITS) - 1
    return torch.stack([keys >> 2 * _KEY_BITS, (keys >> _KEY_BITS) & mask,
                        keys & mask], -1) - _KEY_OFF


def _block_voxel_offsets(device) -> torch.Tensor:
    r = torch.arange(BLOCK_EDGE, device=device)
    zz, yy, xx = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([xx, yy, zz], -1).reshape(-1, 3)  # (E^3, 3) x-fastest


def _f64(x, device) -> torch.Tensor:
    return torch.tensor(float(x), dtype=torch.float64, device=device)


def _back_project(z: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                  cam) -> torch.Tensor:
    """Pixels (xs, ys) at depth z (f32) -> (N, 3) float64 world points:
    ((x - cx) / fx * z, (y - cy) / fy * z, z) in camera space, then
    (p - t) R^T with the f32 world_view's rotation R and translation t."""
    dev = z.device
    zd = z.double()
    pc = torch.stack([(xs.double() - float(cam.cx)) / _f64(cam.fx, dev) * zd,
                      (ys.double() - float(cam.cy)) / _f64(cam.fy, dev) * zd,
                      zd], -1)
    wv = cam.world_view.double()
    q = pc - wv[3, :3]
    R = wv[:3, :3]
    return q[:, 0:1] * R[:, 0] + q[:, 1:2] * R[:, 1] + q[:, 2:3] * R[:, 2]


def discover_blocks(depths: torch.Tensor, cameras, alpha_masks,
                    voxel_size: float, sdf_trunc: float, max_depth: float,
                    stride: int = 2) -> torch.Tensor:
    """Union of blocks touched by back-projected depth points, dilated by
    the truncation band -> (B, 3) int64, sorted. depths (V, H, W)."""
    device = depths.device
    band = math.ceil(sdf_trunc / (voxel_size * BLOCK_EDGE)) + 1
    offs = torch.arange(-band, band + 1, device=device)
    ox, oy, oz = torch.meshgrid(offs, offs, offs, indexing="ij")
    dilate = torch.stack([ox, oy, oz], -1).reshape(-1, 3)
    block = _f64(voxel_size * BLOCK_EDGE, device)

    keys = torch.zeros(0, dtype=torch.int64, device=device)
    for v, cam in enumerate(cameras):
        d = depths[v]
        H, W = d.shape
        if alpha_masks is not None:
            d = torch.where(alpha_masks[v][0] >= 0.5, d, 0.0)
        ys, xs = torch.meshgrid(torch.arange(0, H, stride, device=device),
                                torch.arange(0, W, stride, device=device),
                                indexing="ij")
        z = d[::stride, ::stride]
        ok = (z > 0) & (z < max_depth)
        if not bool(ok.any()):
            continue
        pw = _back_project(z[ok], xs[ok], ys[ok], cam)
        bc = keys_to_coords(torch.unique(block_keys(
            torch.floor(pw / block).to(torch.int64))))
        keys = torch.unique(torch.cat([keys, block_keys(
            (bc[:, None, :] + dilate[None]).reshape(-1, 3))]))
    return keys_to_coords(keys)


def mask_to_bounds(depths: torch.Tensor, cameras, bounds) -> torch.Tensor:
    """Zero the depth samples whose world point leaves the (3, 2) AABB."""
    V, H, W = depths.shape
    device = depths.device
    b = torch.as_tensor(np.asarray(bounds, np.float64), device=device)
    ys, xs = torch.meshgrid(torch.arange(H, device=device),
                            torch.arange(W, device=device), indexing="ij")
    masked = []
    for v, cam in enumerate(cameras):
        pw = _back_project(depths[v].reshape(-1), xs.reshape(-1),
                           ys.reshape(-1), cam)
        out = ((pw < b[:, 0]) | (pw > b[:, 1])).any(-1).reshape(H, W)
        masked.append(torch.where(out, 0.0, depths[v]))
    return torch.stack(masked, 0)


def _integrate_slab(centers, world_views, intr, depths, colors, masks,
                    max_depth: float, trunc: torch.Tensor):
    """The JAX scan body over views for one slab of voxel centers (N, 3)
    f32 -> (tsdf, weight, color) f32."""
    V, H, W = depths.shape
    N = centers.shape[0]
    cx_, cy_, cz_ = centers[:, 0], centers[:, 1], centers[:, 2]
    tsdf = centers.new_zeros(N)
    wsum = centers.new_zeros(N)
    csum = centers.new_zeros(N, 3)
    for v in range(V):
        wv = world_views[v]
        px, py, z = ((cx_ * wv[0, j] + cy_ * wv[1, j]) + cz_ * wv[2, j]
                     + wv[3, j] for j in range(3))
        fx, fy, cx, cy = intr[v]
        u = px / z * fx + cx
        vv = py / z * fy + cy
        ui = torch.round(u).clamp(0, W - 1).nan_to_num(0).to(torch.int64)
        vi = torch.round(vv).clamp(0, H - 1).nan_to_num(0).to(torch.int64)
        idx = vi * W + ui
        d = depths[v].reshape(-1)[idx]
        if masks is not None:
            d = torch.where(masks[v].reshape(-1)[idx] >= 0.5, d, 0.0)
        inside = (z > 0) & (u >= 0) & (u < W) & (vv >= 0) & (vv < H)
        valid_d = (d > 0) & (d < max_depth)
        sdf = d - z
        w = (inside & valid_d & (sdf > -trunc)).to(torch.float32)
        tsdf = tsdf + torch.clamp(sdf / trunc, -1.0, 1.0) * w
        wsum = wsum + w
        csum = csum + colors[v].reshape(3, -1)[:, idx].T * w[:, None]
    w = torch.clamp_min(wsum, 1e-12)
    return tsdf / w, wsum, csum / w[:, None]


def fuse_depths(depths, colors, cameras, voxel_size: float, sdf_trunc: float,
                max_depth: float, alpha_masks=None, bounds=None,
                slab_blocks: int = 32768,
                stages: dict | None = None) -> TSDFVolume:
    """Integrate V views on the cameras' device. depths (V, H, W); colors
    (V, 3, H, W) in [0, 1]; alpha_masks (V, 1, H, W) or None; `bounds`
    (3, 2) world AABB replaces the alpha mask when given. Numpy arrays or
    tensors. `slab_blocks` blocks are integrated at a time; `stages`, when
    given, receives the ms of "discover" and "integrate"."""
    device = cameras[0].device
    V = len(cameras)
    H, W = int(cameras[0].height), int(cameras[0].width)
    depths = torch.as_tensor(depths, dtype=torch.float32,
                             device=device).reshape(V, H, W)
    if bounds is not None:
        depths = mask_to_bounds(depths, cameras, bounds)
        alpha_masks = None
    masks = (None if alpha_masks is None else torch.as_tensor(
        alpha_masks, dtype=torch.float32, device=device).reshape(V, 1, H, W))

    with stage_timer(stages, "discover", device):
        block_coords = discover_blocks(depths, cameras, masks, voxel_size,
                                       sdf_trunc, max_depth)
    B = block_coords.shape[0]
    E3 = BLOCK_EDGE ** 3
    tsdf = torch.zeros(B, E3, device=device)
    weight = torch.zeros(B, E3, device=device)
    color = torch.zeros(B, E3, 3, device=device)
    if B == 0:
        return TSDFVolume(block_coords, tsdf, weight, color, voxel_size,
                          sdf_trunc)

    with stage_timer(stages, "integrate", device):
        offsets = _block_voxel_offsets(device)
        world_views = torch.stack([c.world_view for c in cameras], 0)
        intr = [(c.fx, c.fy, c.cx, c.cy) for c in cameras]
        cols = torch.as_tensor(colors, dtype=torch.float32,
                               device=device).reshape(V, 3, H, W)
        if masks is not None:
            masks = masks.reshape(V, H, W)
        trunc = torch.tensor(sdf_trunc, dtype=torch.float32, device=device)
        for s in range(0, B, slab_blocks):
            bc = block_coords[s:s + slab_blocks]
            centers = ((((bc[:, None, :] * BLOCK_EDGE + offsets[None])
                         .to(torch.float64) + 0.5) * voxel_size)
                       .to(torch.float32).reshape(-1, 3))
            t, w, c = _integrate_slab(centers, world_views, intr, depths,
                                      cols, masks, max_depth, trunc)
            n = bc.shape[0]
            tsdf[s:s + n] = t.reshape(n, E3)
            weight[s:s + n] = w.reshape(n, E3)
            color[s:s + n] = c.reshape(n, E3, 3)
    return TSDFVolume(block_coords, tsdf, weight, color, voxel_size, sdf_trunc)
