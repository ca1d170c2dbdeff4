"""Tiled alpha blending, forward: the port of ops/blend_pallas.py's forward.

Counterpart of gs2m_tpu/ops/blend_pallas.py (`blend_tiles_pallas` forward:
`_gather_instances`, kernel K1, `_untile`, the observe scatter) and of the
math its XLA twin gs2m_tpu/ops/blend_xla.py shares. Backward (K2) and the
autograd.Function arrive with the training slice.

K1 — csrc/blend_fwd.cu, replacing gs2m_tpu/ops/blend_pallas.py::_fwd_kernel
(launched by `_run_forward`). For each chunk of depth-sorted instances of one
16x16 tile it computes, per pixel:
  gated alpha = min(.99, op*exp(min(power, 0))), gate power <= 0 &
    alpha >= 1/255 & pixel inside the image
  log-transmittance test = logT0 + cumsum(log1p(-alpha)), done once
    test < log(1e-4) (termination)
  w = alpha * exp(test - log1p(-alpha)) where alpha > 0 and not done
  img += vals . w (V = 8 or 16 channels), per-chunk start carries (logT,
    done) for the backward, final T, and per-instance observe counts
    (contributing pixels with T > 0.5)
and skips chunks whose tile had fully terminated.

Design. The TPU walks the chunks as one sequential grid and carries the
tile state in VMEM scratch; on Hopper blocks run in parallel in no order,
so ONE BLOCK OWNS ONE TILE (256 threads, one per pixel) and loops over the
tile's contiguous chunk range [bounds[t], bounds[t+1]) (chunk_tile never
decreases). Each chunk's geometry (6 of the 8 rows) and values are staged
in shared memory (24 KB at V=16, chunk 256) and every thread walks the
instances in order with the log-space recurrence written as the JAX
package writes it — test = logT0 + running sum, logT_excl = test - log1m —
not as a running product, so termination edges fall where the reference's
do. Accumulators live in registers. Observe counts are a per-warp
__ballot_sync/__popc into a shared [8][chunk] table summed in fixed order:
deterministic. Warps stop walking a chunk once all their inside pixels are
done, and a chunk whose tile is done everywhere is skipped after writing
its carries. The padding chunks of the dummy tile T only ever hold
logT 0, done 0, obs 0: extra blocks fill them without walking them.
Built with expf/log1pf, -fmad=false and no fast math, so the arithmetic
rounds like the plain PyTorch version below.

Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32): max(bytes / 3.35 TB/s,
flops / 67 TFLOP/s), bytes = geometry (6 rows) and values read once for
the live chunks + img, fT, carries and obs written once; flops ~20 per live
(instance, pixel) pair before termination + 2V per contributing pair. At
the render app's full-width cell (1600x1200, 500k Gaussians, V=16) the
flops term dominates: chip_smoke.py computes both from the run's data and
prints them beside the kernel's time.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from gs2m_tpu_torch.ops.binning import Binning, num_tiles

# f32 thresholds, rounded once in numpy so the kernel and the plain version
# compare against the same values the JAX package does.
LOG_EPS = float(np.float32(math.log(1e-4)))   # termination, T < 1e-4
LOG_HALF = float(np.float32(math.log(0.5)))   # observe, T > 0.5
ALPHA_MIN = float(np.float32(1.0 / 255.0))

# Launches of each kernel of this module: one per launch, nowhere else.
LAUNCHES = {"blend_fwd": 0}


class BlendOut(NamedTuple):
    image: torch.Tensor    # (V, Hp, Wp): rows 0-2 RGB (no bg), rest features
    final_T: torch.Tensor  # (Hp, Wp)
    observe: torch.Tensor  # (C,) int32


class FwdRaw(NamedTuple):
    """K1's five raw outputs (the Pallas kernel's out_shape, same layout)."""
    img: torch.Tensor      # (T+1, V, P) f32 per-tile image
    fT: torch.Tensor       # (T+1, 1, P) f32 final transmittance
    clogT: torch.Tensor    # (n_chunks, 1, P) f32 logT at each chunk's start
    cdone: torch.Tensor    # (n_chunks, 1, P) f32 done (0/1) at each chunk's start
    obs: torch.Tensor      # (n_chunks, 1, chunk) i32 per-instance observe counts


def pixel_coords(tiles: torch.Tensor, tile: int, grid_x: int):
    """(n, P) f32 pixel x, y of each tile's row-major in-tile pixels."""
    lane = torch.arange(tile * tile, device=tiles.device)
    px = (tiles[:, None] % grid_x) * tile + lane % tile
    py = (tiles[:, None] // grid_x) * tile + lane // tile
    return px.float(), py.float()


def blend_fwd_plain(geom: torch.Tensor, vals: torch.Tensor,
                    chunk_tile: torch.Tensor, *, T: int, grid_x: int,
                    width: int, height: int, tile: int,
                    chunk: int) -> FwdRaw:
    """K1 in plain PyTorch: the same five outputs. Loops over a chunk's rank
    inside its tile, vectorized across tiles (in batches that bound the
    (tiles, chunk, P) intermediates), with torch.cumsum inside each chunk.
    Tiles without chunks get img 0, fT 1 (their rows are masked by _untile);
    the dummy tile T's chunks get logT 0, done 0, obs 0 — what K1 computes
    for them."""
    dev = geom.device
    P = tile * tile
    V = vals.shape[0]
    n_chunks = chunk_tile.shape[0]
    bounds = torch.searchsorted(chunk_tile,
                                torch.arange(T + 1, dtype=chunk_tile.dtype,
                                             device=dev))
    n_of_tile = bounds[1:] - bounds[:-1]
    logT = torch.zeros(T + 1, P, device=dev)
    done = torch.zeros(T + 1, P, dtype=torch.bool, device=dev)
    img = torch.zeros(T + 1, V, P, device=dev)
    clogT = torch.zeros(n_chunks, P, device=dev)
    cdone = torch.zeros(n_chunks, P, device=dev)
    obs = torch.zeros(n_chunks, chunk, dtype=torch.int32, device=dev)
    g = geom.reshape(8, n_chunks, chunk)
    v = vals.reshape(V, n_chunks, chunk)
    batch = max(1, 2 ** 27 // (chunk * P))

    max_rank = int(n_of_tile.max()) if T > 0 else 0
    for r in range(max_rank):
        active = torch.nonzero(n_of_tile > r)[:, 0]
        for tiles in torch.split(active, batch):
            c = bounds[tiles] + r
            clogT[c] = logT[tiles]
            cdone[c] = done[tiles].float()
            px, py = pixel_coords(tiles, tile, grid_x)           # (n, P)
            gc = g[:, c].permute(1, 2, 0)[..., None]              # (n, chunk, 8, 1)
            dx = gc[:, :, 0] - px[:, None]                        # (n, chunk, P)
            dy = gc[:, :, 1] - py[:, None]
            power_raw = (-0.5 * (gc[:, :, 2] * dx * dx + gc[:, :, 4] * dy * dy)
                         - gc[:, :, 3] * dx * dy)
            alpha = torch.clamp_max(
                gc[:, :, 5] * torch.exp(torch.clamp_max(power_raw, 0.0)), 0.99)
            inside = ((px < width) & (py < height))[:, None]
            gate = (power_raw <= 0.0) & (alpha >= ALPHA_MIN) & inside
            alpha = torch.where(gate, alpha, 0.0)
            del dx, dy, power_raw, gate
            log1m = torch.log1p(-alpha)
            test = logT[tiles][:, None] + torch.cumsum(log1m, dim=1)
            dn = done[tiles][:, None] | (test < LOG_EPS)
            contribute = (alpha > 0.0) & ~dn
            logT_excl = test - log1m
            w = torch.where(contribute, alpha * torch.exp(logT_excl), 0.0)
            img[tiles] += torch.bmm(v[:, c].permute(1, 0, 2), w)
            obs[c] = torch.sum(contribute & (logT_excl > LOG_HALF), dim=2,
                               dtype=torch.int32)
            logT[tiles] += torch.sum(torch.where(contribute, log1m, 0.0), dim=1)
            done[tiles] = dn[:, -1]
    return FwdRaw(img=img, fT=torch.exp(logT)[:, None], clogT=clogT[:, None],
                  cdone=cdone[:, None], obs=obs[:, None])


@functools.cache
def _kernel():
    """The C entry of csrc/blend_fwd.cu, built and loaded at first use."""
    from gs2m_tpu_torch import _build

    fn = _build.library("blend_fwd").gs2m_blend_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    return fn


def _launch_blend_fwd(geom, vals, chunk_tile, *, T, grid_x, width, height,
                      tile, chunk) -> FwdRaw:
    """K1 on the card (csrc/blend_fwd.cu)."""
    V = vals.shape[0]
    I = geom.shape[1]
    n_chunks = I // chunk
    P = tile * tile
    if tile != 16 or V not in (8, 16) or chunk > 1024:
        raise ValueError(f"blend_fwd kernel takes tile 16, V in (8, 16) and "
                         f"chunk <= 1024; got tile {tile}, V {V}, chunk {chunk}")
    for name, x, dt, shape in (("geom", geom, torch.float32, (8, I)),
                               ("vals", vals, torch.float32, (V, I)),
                               ("chunk_tile", chunk_tile, torch.int32,
                                (n_chunks,))):
        if (x.device != geom.device or x.dtype != dt
                or tuple(x.shape) != shape or not x.is_contiguous()):
            raise ValueError(f"blend_fwd: {name} must be a contiguous {dt} "
                             f"tensor of shape {shape} on {geom.device}")
    dev = geom.device
    bounds = torch.searchsorted(
        chunk_tile, torch.arange(T + 1, dtype=torch.int32, device=dev),
        out_int32=True)
    img = torch.empty(T + 1, V, P, device=dev)
    fT = torch.empty(T + 1, 1, P, device=dev)
    clogT = torch.empty(n_chunks, 1, P, device=dev)
    cdone = torch.empty(n_chunks, 1, P, device=dev)
    obs = torch.empty(n_chunks, 1, chunk, dtype=torch.int32, device=dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            geom.data_ptr(), vals.data_ptr(),
            bounds.data_ptr(), img.data_ptr(), fT.data_ptr(),
            clogT.data_ptr(), cdone.data_ptr(), obs.data_ptr(),
            T, n_chunks, chunk, V, grid_x, width, height,
            LOG_EPS, LOG_HALF, ALPHA_MIN, stream)
    if err != 0:
        raise RuntimeError(f"blend_fwd kernel launch failed: CUDA error {err}")
    LAUNCHES["blend_fwd"] += 1
    return FwdRaw(img=img, fT=fT, clogT=clogT, cdone=cdone, obs=obs)


def blend_fwd(geom: torch.Tensor, vals: torch.Tensor, chunk_tile: torch.Tensor,
              *, T: int, grid_x: int, width: int, height: int, tile: int,
              chunk: int) -> FwdRaw:
    """K1: geom (8, I) rows (mx, my, conic a, b, c, opacity, 0, 0), vals
    (V, I), chunk_tile (n_chunks,) int32 non-decreasing. On a CUDA tensor it
    launches the kernel (or raises); the plain version runs only for tensors
    on the CPU."""
    kw = dict(T=T, grid_x=grid_x, width=width, height=height, tile=tile,
              chunk=chunk)
    if geom.is_cuda:
        return _launch_blend_fwd(geom, vals, chunk_tile, **kw)
    if geom.device.type != "cpu":
        raise ValueError(f"blend_fwd runs on cuda or cpu, not {geom.device}")
    return blend_fwd_plain(geom, vals, chunk_tile, **kw)


def gather_instances(values, means2d, conics, opacities, gid, is_null):
    """Per-instance tables geom (8, I) and vals (V, I) from ONE column
    gather of the (8+V, C) table; null slots get a zero geometry column
    (opacity 0 gates them)."""
    C = values.shape[0]
    src = torch.cat([means2d, conics, opacities[:, None],
                     values.new_zeros(C, 2), values], dim=-1).T.contiguous()
    tab = torch.index_select(src, 1, gid.long())                  # (8+V, I)
    return torch.where(is_null[None, :], 0.0, tab[:8]), tab[8:]


def untile(img_tiles, fT_tiles, tile_nonempty, grid_y: int, grid_x: int,
           tile: int):
    """(T+1, V, P), (T+1, P) -> (V, Hp, Wp), (Hp, Wp). torch.where, not a
    multiply: rows of tiles no chunk carried are masked whatever they hold."""
    T = grid_y * grid_x
    V = img_tiles.shape[1]
    img = torch.where(tile_nonempty[:, None, None], img_tiles[:T], 0.0)
    fT = torch.where(tile_nonempty[:, None], fT_tiles[:T], 1.0)
    img = img.reshape(grid_y, grid_x, V, tile, tile)
    img = img.permute(2, 0, 3, 1, 4).reshape(V, grid_y * tile, grid_x * tile)
    fT = fT.reshape(grid_y, grid_x, tile, tile)
    fT = fT.permute(0, 2, 1, 3).reshape(grid_y * tile, grid_x * tile)
    return img, fT


def blend_tiles(values, means2d, conics, opacities, binning: Binning,
                height: int, width: int, tile: int, chunk: int) -> BlendOut:
    """Forward of the JAX package's blend_tiles_pallas: values (C, V),
    means2d (C, 2), conics (C, 3), opacities (C,) -> image (V, Hp, Wp),
    final_T (Hp, Wp) and per-Gaussian observe counts (C,) int32."""
    grid_y, grid_x = num_tiles(height, width, tile)
    T = grid_y * grid_x
    geom, vals = gather_instances(values, means2d, conics, opacities,
                                  binning.gid, binning.is_null)
    raw = blend_fwd(geom, vals, binning.chunk_tile, T=T, grid_x=grid_x,
                    width=width, height=height, tile=tile, chunk=chunk)
    img, fT = untile(raw.img, raw.fT[:, 0], binning.tile_nonempty, grid_y,
                     grid_x, tile)
    # Null slots add 0; spreading them over all rows (instead of their gid 0)
    # keeps millions of no-op atomics off one address.
    C = values.shape[0]
    slot = torch.arange(binning.gid.shape[0], device=values.device)
    target = torch.where(binning.is_null, slot % C, binning.gid.long())
    observe = torch.zeros(C, dtype=torch.int32, device=values.device).index_add_(
        0, target, torch.where(binning.is_null, 0, raw.obs.reshape(-1)))
    return BlendOut(image=img, final_T=fT, observe=observe)
