"""Tiled alpha blending, forward, backward and observe counting.

Counterpart of gs2m_tpu/ops/blend_pallas.py: `blend_tiles` is
`blend_tiles_pallas` (`_gather_instances`, kernel K1, `_untile`, the observe
scatter) as a torch.autograd.Function whose backward is `_retile`, kernel
K2 and the per-Gaussian reduction; `observe_tiles` is
`observe_tiles_pallas` (`_gather_geom`, kernel K3, the observe scatter).
The math is the one its XLA twin gs2m_tpu/ops/blend_xla.py shares.

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
so ONE BLOCK OWNS ONE TILE (256 threads, one per pixel, each warp an 8x4
pixel block) and loops over the tile's contiguous chunk range
[bounds[t], bounds[t+1]) (chunk_tile never decreases). Every thread walks
the instances in order with the log-space recurrence written as the JAX
package writes it — test = logT0 + running sum, logT_excl = test - log1m —
not as a running product, so termination edges fall where the reference's
do. Accumulators live in registers. The kernel is bound by the
instructions of that step (expf, log1pf, expf per pair), not by bytes, and
is built around that:
  - exact warp cull: when a chunk is staged each instance gets a
    conservative pixel rectangle (`cull_rects` is its twin here) and each
    warp a bit mask of the instances that may reach its block; a warp walks
    only those. Elsewhere alpha is 0 at every lane, and the step would add
    log1p(-0) = -0 and change nothing, so outputs are unchanged;
  - overlapped staging: geometry (6 of the 8 rows) and values are
    double-buffered in shared memory, the next chunk's cp.async copies in
    flight while this one is walked;
  - observe counts: a __ballot_sync/__popc per walked instance into a shared
    [8][chunk] table summed in fixed order: deterministic.
Warps stop walking a chunk once all their inside pixels are done, and a
chunk whose tile is done everywhere is skipped after writing its carries.
The padding chunks of the dummy tile T only ever hold logT 0, done 0,
obs 0: extra blocks fill them without walking them. Built with
expf/log1pf, -fmad=false and no fast math, so the arithmetic rounds like
the plain PyTorch version below.

Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32): max(bytes / 3.35 TB/s,
flops / 67 TFLOP/s), bytes = geometry (6 rows) and values read once for
the live chunks + img, fT, carries and obs written once; flops ~20 per live
(instance, pixel) pair before termination + 2V per contributing pair. At
the render app's full-width cell (1600x1200, 500k Gaussians, V=16) the
flops term dominates: chip_smoke.py computes both from the run's data and
prints them beside the kernel's time.

K2 — csrc/blend_bwd.cu, replacing gs2m_tpu/ops/blend_pallas.py::_bwd_kernel
(launched by `_run_backward`). Per tile it sweeps the chunks in reverse from
K1's chunk-start carries, with S = fT*gT + sum of later w*u (u = g.v):
  dalpha = T_excl*u - S_after/(1 - alpha), S_after = S + total - prefix(w*u)
  (0 where not contributing and at the 0.99 clamp), dvals = sum_p w*g, and
  dgeom rows d mx, d my, d conic a/b/c, d opacity, sum|ddx|, sum|ddy|
  (AbsGS); a chunk whose tile was all done at its start gets zeros.
Design. Same block/tile ownership and warp blocks as K1, walking the chunk
range backwards with S and the V cotangents in registers. The TPU's
in-chunk inclusive prefix is a triangular matmul; here each chunk is walked
forward twice with K1's recurrence term for term (pass 1: total = sum w*u;
pass 2: the running prefix, S_after = (S + total) - prefix), not as a
reverse running sum or the CUDA reference's T-division, so termination and
gate edges fall where K1's did. Bound by instructions, like K1, and built
around that:
  - pass 1 walks only the instances K1's cull leaves the warp, and marks
    those at which some lane had alpha > 0 before it was done; pass 2 walks
    only the marked ones (elsewhere every live lane has alpha 0, and a done
    lane never contributes again);
  - per-instance outputs are sums over 256 pixels in 8+V channels. A warp
    with no contributing lane issues no shuffle and is left out of the sum;
    otherwise one transposed reduce-scatter (each step a lane sends half its
    channels and keeps half: 15 shuffles at V=8, 25 at V=16, against 5 per
    channel) and a fixed-order sum of the contributing warps through shared
    memory, 32 instances per barrier (double-buffered partials: 8 warps x
    (8+V) channels x 32 x 2 = 32 or 48 KB) — no atomics, so two runs are
    bit-equal;
  - the chunk's rows are staged into one shared buffer with cp.async; a
    second buffer that loads the next chunk during the walk measured no
    faster (the 2-3 resident blocks per SM hide the loads), so K2 has one
    layout.
Each output column belongs to one chunk of one tile and is written once;
the dummy tile's padding chunks get zeros from extra blocks.
Bound: bytes = geometry (6 rows), values and carries of the live chunks,
the tiles' cotangents, fT and gT read once + dgeom/dvals (8+V rows of all
I slots) written once; flops = what the function needs, not the kernel's
second walk: one alpha step (~20) per live (instance, pixel) pair, and
the per-pixel gradient terms (~4V + 40) plus the (8+V)-channel tile sums
per contributing pair (every other pair adds zeros). chip_smoke.py
computes both from the run's data.

K3 — csrc/blend_obs.cu, replacing gs2m_tpu/ops/blend_pallas.py::_obs_kernel
(launched by `observe_tiles_pallas`). Its only output is, per instance, the
count of contributing pixels with T > 0.5 before it. K1's alpha sweep and
recurrence without values, image or carries; the same arithmetic and build
flags, so its counts are bit-identical to K1's obs. Same block/tile
ownership, warp blocks and exact warp cull as K1; the 6 geometry rows are
staged with cp.async into one shared buffer (a second one, loading the next
chunk during the walk, measured no faster); and one more skip:
  - retirement: once a pixel's running test = logT0 + cum falls below
    LOG_HALF - RETIRE_MARGIN after a walked step, no later instance can be
    counted there, and the pixel counts as done for the warp's early exit
    and the tile's chunk skip (which writes zeros and stages nothing).
    Exact: log1p(-alpha) <= 0, so the f32 running sum never rises; a later
    step's logT_excl = fl(fl(logT0 + cum) - log1m) is within a few f32
    roundings of the previous step's test, and every magnitude is at most
    ~14 while the pixel is not done (test >= log 1e-4, log1m >= log 0.01),
    so the error (< 4e-6) is far below the margin. Across chunks the
    carried logT0 + contributed equals the last test exactly while the
    pixel is not done: its non-contributing steps have alpha 0 and add -0.
    Termination (test < LOG_EPS) retires a pixel at the same step.
Bound: geometry read of the live chunks whose tile still has an inside
pixel not retired at the chunk's start, + obs written; flops ~20 per
(instance, pixel) pair inside the image, not done and with logT_excl >
LOG_HALF — the pairs at which the output can still change. (The bound over
every live chunk and every live pair up to termination, which K3 was first
held to, is printed beside it by chip_smoke.py as bound_live_pairs_ms.)

The three kernels share one per-(instance, pixel) step, the gated alpha
and the recurrence, in csrc/blend_common.cuh; their plain versions share
its PyTorch twin, `chunk_walk`.

The per-Gaussian reduction of K2's per-instance rows (`segment_sum`) is
torch code, as it is XLA code in the JAX package: a stable sort on the
Gaussian id (null slots keyed C) and torch.segment_reduce, so each
Gaussian's segment is summed on its own — never as the difference of two
global prefixes, whose rounding at ULP(global sum) breached the JAX
package's grad gate (blend_pallas.py:574-589). Deterministic: no atomics.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

# The port's launch counter, re-exported: K1-K3 count their launches here.
from gs2m_tpu_torch.launches import (KERNELS, LAUNCH_LOG_ENV,  # noqa: F401
                                     LAUNCHES, launch_counts)
from gs2m_tpu_torch.ops.binning import Binning, num_tiles

# f32 thresholds, rounded once in numpy so the kernel and the plain version
# compare against the same values the JAX package does.
LOG_EPS = float(np.float32(math.log(1e-4)))   # termination, T < 1e-4
LOG_HALF = float(np.float32(math.log(0.5)))   # observe, T > 0.5
ALPHA_MIN = float(np.float32(1.0 / 255.0))
# K3 retires a pixel once its running test falls below LOG_RETIRE: no later
# instance can be counted there (see the K3 note above; the margin is 25x
# the f32 rounding it covers).
RETIRE_MARGIN = 1e-4
LOG_RETIRE = float(np.float32(LOG_HALF - RETIRE_MARGIN))

# Null slots per segment of the per-Gaussian reduction (see segment_sum).
NULL_RUN = 256


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


class ChunkWalk(NamedTuple):
    """One batch of chunks walked at their tiles' pixels, (n, chunk, P)."""
    dx: torch.Tensor          # mean minus pixel
    dy: torch.Tensor
    G: torch.Tensor           # exp(min(power, 0))
    alpha: torch.Tensor       # min(.99, op*G), 0 where gated out
    log1m: torch.Tensor       # log1p(-alpha)
    test: torch.Tensor        # logT0 + running sum of log1m (log T after it)
    logT_excl: torch.Tensor   # transmittance before the instance (log)
    done: torch.Tensor        # terminated at or before the instance
    contribute: torch.Tensor  # alpha > 0 and not done


def chunk_walk(gc: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
               logT0: torch.Tensor, done0: torch.Tensor, *, width: int,
               height: int) -> ChunkWalk:
    """The kernels' per-(instance, pixel) step (csrc/blend_common.cuh) for a
    batch of chunks: gc (n, chunk, 8, 1) geometry columns, px/py (n, P)
    pixel coordinates, the chunk-start carries logT0 (n, P) and done0 (n, P)
    bool. The gated alpha and the log-space recurrence test = logT0 +
    cumsum(log1p(-alpha)), written as the JAX package writes them."""
    dx = gc[:, :, 0] - px[:, None]                                # (n, chunk, P)
    dy = gc[:, :, 1] - py[:, None]
    power_raw = (-0.5 * (gc[:, :, 2] * dx * dx + gc[:, :, 4] * dy * dy)
                 - gc[:, :, 3] * dx * dy)
    G = torch.exp(torch.clamp_max(power_raw, 0.0))
    alpha = torch.clamp_max(gc[:, :, 5] * G, 0.99)
    inside = ((px < width) & (py < height))[:, None]
    gate = (power_raw <= 0.0) & (alpha >= ALPHA_MIN) & inside
    del power_raw
    alpha = torch.where(gate, alpha, 0.0)
    del gate
    log1m = torch.log1p(-alpha)
    test = logT0[:, None] + torch.cumsum(log1m, dim=1)
    done = done0[:, None] | (test < LOG_EPS)
    return ChunkWalk(dx=dx, dy=dy, G=G, alpha=alpha, log1m=log1m, test=test,
                     logT_excl=test - log1m, done=done,
                     contribute=(alpha > 0.0) & ~done)


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
            st = chunk_walk(gc, px, py, logT[tiles], done[tiles],
                            width=width, height=height)
            w = torch.where(st.contribute,
                            st.alpha * torch.exp(st.logT_excl), 0.0)
            img[tiles] += torch.bmm(v[:, c].permute(1, 0, 2), w)
            obs[c] = torch.sum(st.contribute & (st.logT_excl > LOG_HALF),
                               dim=2, dtype=torch.int32)
            logT[tiles] += torch.sum(torch.where(st.contribute, st.log1m, 0.0),
                                     dim=1)
            done[tiles] = st.done[:, -1]
            del st, w
    return FwdRaw(img=img, fT=torch.exp(logT)[:, None], clogT=clogT[:, None],
                  cdone=cdone[:, None], obs=obs[:, None])


# The kernels' warp cull (csrc/blend_common.cuh): the Q-form widening and
# the margins on q and in pixels.
CULL_GAMMA, CULL_Q_MARGIN, CULL_PX_MARGIN = 1e-6, 1e-3, 1.0


def cull_rects(geom: torch.Tensor) -> torch.Tensor:
    """(4, I) f32 pixel rectangles (x0, x1, y0, y1), closed, outside which
    chunk_walk's gate is closed for each instance of geom (8, I): the PyTorch
    twin of csrc/blend_common.cuh::cull_rect, in the same double arithmetic.
    The gate needs Q = a dx^2 + 2b dx dy + c dy^2 <= q = 2 ln(op/alpha_min);
    f32 rounding moves Q by at most CULL_GAMMA * (a dx^2 + c dy^2 + 2|b dx
    dy|), so the rectangle bounds the widened form a(1-g), c(1-g), |b|(1+g),
    plus CULL_Q_MARGIN on q and CULL_PX_MARGIN pixels. op < alpha_min gives
    an empty rectangle (+inf, -inf); a non-finite input or a form that is not
    positive definite gives no cull (-inf, +inf)."""
    mx, my, a, b, c, op = geom[:6].double()
    g = CULL_GAMMA
    A, C, B = a * (1.0 - g), c * (1.0 - g), b.abs() * (1.0 + g)
    det = A * C - B * B
    q = torch.clamp_min(2.0 * torch.log(op / ALPHA_MIN), 0.0) + CULL_Q_MARGIN
    ex = torch.sqrt(q * C / det) + CULL_PX_MARGIN
    ey = torch.sqrt(q * A / det) + CULL_PX_MARGIN
    keep_all = ~((det > 0) & (A > 0) & torch.isfinite(ex) & torch.isfinite(ey)
                 & torch.isfinite(mx) & torch.isfinite(my))
    empty = op < ALPHA_MIN
    inf = torch.full_like(mx, math.inf)
    lo = lambda x: torch.where(empty, inf, torch.where(keep_all, -inf, x))
    hi = lambda x: torch.where(empty, -inf, torch.where(keep_all, inf, x))
    return torch.stack([lo(mx - ex), hi(mx + ex), lo(my - ey),
                        hi(my + ey)]).float()


# Each warp of the kernels is an 8x4 pixel block of the 16x16 tile: warp w
# covers x in [8 (w % 2), +8), y in [4 (w // 2), +4).
WARP_W, WARP_H = 8, 4


def warp_any(x: torch.Tensor, tile: int = 16) -> torch.Tensor:
    """(..., warps) bool: any of x (..., P) over each warp's pixel block,
    warps in the kernels' order."""
    x = x.reshape(*x.shape[:-1], tile // WARP_H, WARP_H, tile // WARP_W, WARP_W)
    return x.any(dim=-1).any(dim=-2).flatten(-2)


def warp_hits(rects: torch.Tensor, tiles: torch.Tensor, grid_x: int,
              tile: int = 16) -> torch.Tensor:
    """(n, chunk, warps) bool: the instance's rectangle meets the warp's
    pixel block, for rects (n, chunk, 4) of chunks in tiles (n,) — the
    kernels' cull masks."""
    w = torch.arange((tile // WARP_W) * (tile // WARP_H), device=rects.device)
    x0 = ((tiles % grid_x) * tile)[:, None] + (w % (tile // WARP_W)) * WARP_W
    y0 = ((tiles // grid_x) * tile)[:, None] + (w // (tile // WARP_W)) * WARP_H
    x0, y0 = x0.float()[:, None], y0.float()[:, None]             # (n, 1, warps)
    r = rects[..., None]
    return ((r[:, :, 1] >= x0) & (r[:, :, 0] <= x0 + (WARP_W - 1))
            & (r[:, :, 3] >= y0) & (r[:, :, 2] <= y0 + (WARP_H - 1)))



class BwdRaw(NamedTuple):
    """K2's two raw outputs (the Pallas kernel's out_shape, same layout)."""
    dgeom: torch.Tensor    # (8, I) d mx, d my, d conic a/b/c, d opacity,
    #                        sum |d mx|, sum |d my| per instance
    dvals: torch.Tensor    # (V, I)


def blend_bwd_plain(geom, vals, chunk_tile, clogT, cdone, g_img, gT, fT, *,
                    T: int, grid_x: int, width: int, height: int, tile: int,
                    chunk: int) -> BwdRaw:
    """K2 in plain PyTorch: the same two outputs. Walks a chunk's rank inside
    its tile from the last down, vectorized across tiles like
    blend_fwd_plain, rebuilding each chunk's forward from K1's carries
    (clogT, cdone) and carrying S = fT*gT + sum of later w*u per tile. The
    in-chunk suffix is total - inclusive cumsum, as in the JAX kernel."""
    dev = geom.device
    P = tile * tile
    V = vals.shape[0]
    n_chunks = chunk_tile.shape[0]
    bounds = torch.searchsorted(chunk_tile,
                                torch.arange(T + 1, dtype=chunk_tile.dtype,
                                             device=dev))
    n_of_tile = bounds[1:] - bounds[:-1]
    S = fT[:, 0] * gT[:, 0]                                       # (T+1, P)
    dgeom = torch.zeros(8, n_chunks, chunk, device=dev)
    dvals = torch.zeros(V, n_chunks, chunk, device=dev)
    g = geom.reshape(8, n_chunks, chunk)
    v = vals.reshape(V, n_chunks, chunk)
    batch = max(1, 2 ** 25 // (chunk * P))

    max_rank = int(n_of_tile.max()) if T > 0 else 0
    for r in reversed(range(max_rank)):
        active = torch.nonzero(n_of_tile > r)[:, 0]
        for tiles in torch.split(active, batch):
            c = bounds[tiles] + r
            px, py = pixel_coords(tiles, tile, grid_x)           # (n, P)
            gc = g[:, c].permute(1, 2, 0)[..., None]              # (n, chunk, 8, 1)
            ca, cb, cc, op = gc[:, :, 2], gc[:, :, 3], gc[:, :, 4], gc[:, :, 5]
            st = chunk_walk(gc, px, py, clogT[c, 0], cdone[c, 0] > 0.0,
                            width=width, height=height)
            dx, dy, G, alpha = st.dx, st.dy, st.G, st.alpha
            contribute = st.contribute
            T_excl = torch.exp(st.logT_excl)
            w = torch.where(contribute, alpha * T_excl, 0.0)
            gt = g_img[tiles]                                     # (n, V, P)
            u = torch.bmm(v[:, c].permute(1, 2, 0), gt)           # (n, chunk, P)
            wu = w * u
            total = torch.sum(wu, dim=1, keepdim=True)
            S_after = (S[tiles][:, None] + total) - torch.cumsum(wu, dim=1)
            dalpha = torch.where(contribute & (op * G < 0.99),
                                 T_excl * u - S_after / (1.0 - alpha), 0.0)
            dpower = alpha * dalpha
            ddx = -(ca * dx + cb * dy) * dpower
            ddy = -(cc * dy + cb * dx) * dpower
            dgeom[:, c] = torch.stack([
                ddx.sum(2), ddy.sum(2), (-0.5 * dx * dx * dpower).sum(2),
                (-dx * dy * dpower).sum(2), (-0.5 * dy * dy * dpower).sum(2),
                (G * dalpha).sum(2), ddx.abs().sum(2), ddy.abs().sum(2)])
            dvals[:, c] = torch.bmm(w, gt.transpose(1, 2)).permute(2, 0, 1)
            S[tiles] += total[:, 0]
    return BwdRaw(dgeom=dgeom.reshape(8, -1), dvals=dvals.reshape(V, -1))


def blend_obs_plain(geom: torch.Tensor, chunk_tile: torch.Tensor, *, T: int,
                    grid_x: int, width: int, height: int, tile: int,
                    chunk: int) -> torch.Tensor:
    """K3 in plain PyTorch: (n_chunks, 1, chunk) int32 observe counts. They
    depend on the geometry alone, so this is K1's plain walk with zero
    values."""
    return blend_fwd_plain(geom, geom.new_zeros(8, geom.shape[1]), chunk_tile,
                           T=T, grid_x=grid_x, width=width, height=height,
                           tile=tile, chunk=chunk).obs


@functools.cache
def _kernel(name: str):
    """The C entry of csrc/<name>.cu, built and loaded at first use."""
    from gs2m_tpu_torch import _build

    n_ptr, n_int, n_float = {"blend_fwd": (8, 7, 3), "blend_bwd": (10, 7, 2),
                             "blend_obs": (3, 6, 4)}[name]
    fn = getattr(_build.library(name), f"gs2m_{name}")
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_float] * n_float + [ctypes.c_void_p])
    return fn


def kernel_info(name: str, V: int, chunk: int) -> dict:
    """A kernel's launch resources at (V, chunk), from the CUDA runtime:
    registers per thread, local (spill) bytes per thread, dynamic shared
    bytes and resident blocks per SM. K3 ("blend_obs") ignores V."""
    from gs2m_tpu_torch import _build

    fn = getattr(_build.library(name), f"gs2m_{name}_info")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    out = (ctypes.c_int * 4)()
    err = fn(V, chunk, out)
    if err != 0:
        raise RuntimeError(f"{name} info failed: CUDA error {err}")
    return dict(zip(("regs", "local_bytes", "smem_bytes", "blocks_per_sm"),
                    list(out)))


def _check(kernel: str, tile: int, chunk: int, V: int, specs) -> None:
    """Raise on what the CUDA kernels do not take: tile 16, V 8 or 16, a
    chunk that is a multiple of 32 up to 1024, contiguous tensors of the
    stated type and shape on the first tensor's device."""
    if tile != 16 or V not in (8, 16) or chunk > 1024 or chunk % 32:
        raise ValueError(f"{kernel} kernel takes tile 16, V in (8, 16) and a "
                         f"chunk <= 1024 that is a multiple of 32; got tile "
                         f"{tile}, V {V}, chunk {chunk}")
    dev = specs[0][1].device
    for name, x, dt, shape in specs:
        if (x.device != dev or x.dtype != dt or tuple(x.shape) != shape
                or not x.is_contiguous()):
            raise ValueError(f"{kernel}: {name} must be a contiguous {dt} "
                             f"tensor of shape {shape} on {dev}")
        if name in ("geom", "vals") and x.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must be 16-byte aligned "
                             f"(staged with 16-byte cp.async copies)")


def _launch(name: str, *args, V: int = 0) -> None:
    """Call the kernel's C entry on the current stream; raise on a refused
    launch. Pointers are given as tensors; `V` the value width counted."""
    fn = _kernel(name)
    dev = next(a for a in args if isinstance(a, torch.Tensor)).device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
                   for a in args], stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name, V] += 1


def _tile_bounds(chunk_tile: torch.Tensor, T: int) -> torch.Tensor:
    """(T+1,) int32 first chunk of each tile (tile T: the padding chunks)."""
    return torch.searchsorted(
        chunk_tile, torch.arange(T + 1, dtype=torch.int32,
                                 device=chunk_tile.device), out_int32=True)


def _launch_blend_fwd(geom, vals, chunk_tile, *, T, grid_x, width, height,
                      tile, chunk) -> FwdRaw:
    """K1 on the card (csrc/blend_fwd.cu)."""
    V, I = vals.shape[0], geom.shape[1]
    n_chunks, P = I // chunk, tile * tile
    _check("blend_fwd", tile, chunk, V, (
        ("geom", geom, torch.float32, (8, I)),
        ("vals", vals, torch.float32, (V, I)),
        ("chunk_tile", chunk_tile, torch.int32, (n_chunks,))))
    dev = geom.device
    img = torch.empty(T + 1, V, P, device=dev)
    fT = torch.empty(T + 1, 1, P, device=dev)
    clogT = torch.empty(n_chunks, 1, P, device=dev)
    cdone = torch.empty(n_chunks, 1, P, device=dev)
    obs = torch.empty(n_chunks, 1, chunk, dtype=torch.int32, device=dev)
    _launch("blend_fwd", geom, vals, _tile_bounds(chunk_tile, T), img, fT,
            clogT, cdone, obs, T, n_chunks, chunk, V, grid_x, width, height,
            LOG_EPS, LOG_HALF, ALPHA_MIN, V=V)
    return FwdRaw(img=img, fT=fT, clogT=clogT, cdone=cdone, obs=obs)


def _launch_blend_bwd(geom, vals, chunk_tile, clogT, cdone, g_img, gT, fT, *,
                      T, grid_x, width, height, tile, chunk) -> BwdRaw:
    """K2 on the card (csrc/blend_bwd.cu)."""
    V, I = vals.shape[0], geom.shape[1]
    n_chunks, P = I // chunk, tile * tile
    _check("blend_bwd", tile, chunk, V, (
        ("geom", geom, torch.float32, (8, I)),
        ("vals", vals, torch.float32, (V, I)),
        ("chunk_tile", chunk_tile, torch.int32, (n_chunks,)),
        ("clogT", clogT, torch.float32, (n_chunks, 1, P)),
        ("cdone", cdone, torch.float32, (n_chunks, 1, P)),
        ("g_img", g_img, torch.float32, (T + 1, V, P)),
        ("gT", gT, torch.float32, (T + 1, 1, P)),
        ("fT", fT, torch.float32, (T + 1, 1, P))))
    dgeom = torch.empty(8, I, device=geom.device)
    dvals = torch.empty(V, I, device=geom.device)
    _launch("blend_bwd", geom, vals, _tile_bounds(chunk_tile, T), clogT,
            cdone, g_img, gT, fT, dgeom, dvals, T, n_chunks, chunk, V, grid_x,
            width, height, LOG_EPS, ALPHA_MIN, V=V)
    return BwdRaw(dgeom=dgeom, dvals=dvals)


def _launch_blend_obs(geom, chunk_tile, *, T, grid_x, width, height, tile,
                      chunk) -> torch.Tensor:
    """K3 on the card (csrc/blend_obs.cu)."""
    I = geom.shape[1]
    n_chunks = I // chunk
    _check("blend_obs", tile, chunk, 8, (
        ("geom", geom, torch.float32, (8, I)),
        ("chunk_tile", chunk_tile, torch.int32, (n_chunks,))))
    obs = torch.empty(n_chunks, 1, chunk, dtype=torch.int32, device=geom.device)
    _launch("blend_obs", geom, _tile_bounds(chunk_tile, T), obs, T, n_chunks,
            chunk, grid_x, width, height, LOG_EPS, LOG_HALF, LOG_RETIRE,
            ALPHA_MIN)
    return obs


def _dispatch(name: str, kernel, plain, x: torch.Tensor, *args, **kw):
    """A kernel for a CUDA tensor (or an error), the plain version only for
    a CPU tensor."""
    if x.is_cuda:
        return kernel(x, *args, **kw)
    if x.device.type != "cpu":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    return plain(x, *args, **kw)


def blend_fwd(geom: torch.Tensor, vals: torch.Tensor, chunk_tile: torch.Tensor,
              *, T: int, grid_x: int, width: int, height: int, tile: int,
              chunk: int) -> FwdRaw:
    """K1: geom (8, I) rows (mx, my, conic a, b, c, opacity, 0, 0), vals
    (V, I), chunk_tile (n_chunks,) int32 non-decreasing. On a CUDA tensor it
    launches the kernel (or raises); the plain version runs only for tensors
    on the CPU."""
    return _dispatch("blend_fwd", _launch_blend_fwd, blend_fwd_plain, geom,
                     vals, chunk_tile, T=T, grid_x=grid_x, width=width,
                     height=height, tile=tile, chunk=chunk)


def blend_bwd(geom, vals, chunk_tile, clogT, cdone, g_img, gT, fT, *, T: int,
              grid_x: int, width: int, height: int, tile: int,
              chunk: int) -> BwdRaw:
    """K2: K1's inputs and carries (clogT, cdone, fT as K1 returns them) and
    the per-tile cotangents g_img (T+1, V, P), gT (T+1, 1, P) -> per-instance
    dgeom (8, I), dvals (V, I). Kernel on CUDA tensors, plain version on CPU
    tensors."""
    return _dispatch("blend_bwd", _launch_blend_bwd, blend_bwd_plain, geom,
                     vals, chunk_tile, clogT, cdone, g_img, gT, fT, T=T,
                     grid_x=grid_x, width=width, height=height, tile=tile,
                     chunk=chunk)


def blend_obs(geom: torch.Tensor, chunk_tile: torch.Tensor, *, T: int,
              grid_x: int, width: int, height: int, tile: int,
              chunk: int) -> torch.Tensor:
    """K3: geom (8, I) -> per-instance observe counts (n_chunks, 1, chunk)
    int32, equal to K1's obs. Kernel on CUDA tensors, plain version on CPU
    tensors."""
    return _dispatch("blend_obs", _launch_blend_obs, blend_obs_plain, geom,
                     chunk_tile, T=T, grid_x=grid_x, width=width,
                     height=height, tile=tile, chunk=chunk)


def gather_instances(values, means2d, conics, opacities, gid, is_null):
    """Per-instance tables geom (8, I) and vals (V, I) from ONE column
    gather of the (8+V, C) table; null slots get a zero geometry column
    (opacity 0 gates them)."""
    C = values.shape[0]
    src = torch.cat([means2d, conics, opacities[:, None],
                     values.new_zeros(C, 2), values], dim=-1).T.contiguous()
    tab = torch.index_select(src, 1, gid.long())                  # (8+V, I)
    return torch.where(is_null[None, :], 0.0, tab[:8]), tab[8:]


def gather_geom(means2d, conics, opacities, gid, is_null):
    """Geometry-only instance table (8, I) for the observe pass."""
    no_values = means2d.new_zeros(means2d.shape[0], 0)
    return gather_instances(no_values, means2d, conics, opacities, gid,
                            is_null)[0]


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


def retile(g_img, g_fT, grid_y: int, grid_x: int, tile: int):
    """Inverse of untile for the cotangents: (V, Hp, Wp), (Hp, Wp) ->
    contiguous (T+1, V, P), (T+1, 1, P) with a zero row for the dummy
    tile."""
    V = g_img.shape[0]
    T, P = grid_y * grid_x, tile * tile
    gi = g_img.reshape(V, grid_y, tile, grid_x, tile).permute(1, 3, 0, 2, 4)
    gt = g_fT.reshape(grid_y, tile, grid_x, tile).permute(0, 2, 1, 3)
    return (torch.cat([gi.reshape(T, V, P), g_img.new_zeros(1, V, P)]),
            torch.cat([gt.reshape(T, 1, P), g_fT.new_zeros(1, 1, P)]))


def segment_sum(per_inst: torch.Tensor, key: torch.Tensor,
                C: int) -> torch.Tensor:
    """Per-Gaussian sums (K, C) of per-instance rows (K, I), grouped by key
    (I,) int32 in [0, C] (C marks null slots, which are dropped). A stable
    sort on the key, then torch.segment_reduce: each segment is summed on
    its own, in slot order, deterministically."""
    I = key.shape[0]
    # Null slots are most of the layout (~2/3 at the training cell); as one
    # segment they would be summed by one thread of segment_reduce's kernel
    # (0.66 s at 8.9M slots on an H100). Spread them over segments of at
    # most NULL_RUN slots, which are dropped with the rest.
    slot = torch.arange(I, dtype=key.dtype, device=key.device)
    key = torch.where(key >= C, C + slot // NULL_RUN, key)
    n_seg = C + -(-I // NULL_RUN)
    sorted_key, order = torch.sort(key, stable=True)
    starts = torch.searchsorted(sorted_key, torch.arange(
        n_seg, dtype=key.dtype, device=key.device))
    lengths = torch.diff(starts, append=starts.new_full((1,), I))
    rows = per_inst.index_select(1, order).T.contiguous()          # (I, K)
    # unsafe: the lengths sum to I by construction; skipping the check keeps
    # the call free of a host sync.
    return torch.segment_reduce(rows, "sum", lengths=lengths, axis=0,
                                unsafe=True)[:C].T


def _observe_counts(obs: torch.Tensor, binning: Binning, C: int) -> torch.Tensor:
    """Per-instance counts (n_chunks, 1, chunk) -> per-Gaussian (C,) int32.
    Null slots add 0; spreading them over all rows (instead of their gid 0)
    keeps millions of no-op atomics off one address."""
    slot = torch.arange(binning.gid.shape[0], device=obs.device)
    target = torch.where(binning.is_null, slot % C, binning.gid.long())
    return torch.zeros(C, dtype=torch.int32, device=obs.device).index_add_(
        0, target, torch.where(binning.is_null, 0, obs.reshape(-1)))


class _BlendTiles(torch.autograd.Function):
    """gather -> K1 -> untile -> observe scatter; backward retile -> K2 ->
    per-Gaussian segment sums. The outputs are (image, final_T, observe);
    observe is not differentiable and a missing cotangent counts as 0."""

    @staticmethod
    def forward(ctx, values, means2d, conics, opacities, abs_sink,
                binning: Binning, height: int, width: int, tile: int,
                chunk: int):
        grid_y, grid_x = num_tiles(height, width, tile)
        T = grid_y * grid_x
        geom, vals = gather_instances(values, means2d, conics, opacities,
                                      binning.gid, binning.is_null)
        raw = blend_fwd(geom, vals, binning.chunk_tile, T=T, grid_x=grid_x,
                        width=width, height=height, tile=tile, chunk=chunk)
        img, fT = untile(raw.img, raw.fT[:, 0], binning.tile_nonempty,
                         grid_y, grid_x, tile)
        observe = _observe_counts(raw.obs, binning, values.shape[0])
        ctx.mark_non_differentiable(observe)
        ctx.save_for_backward(geom, vals, raw.clogT, raw.cdone, raw.fT)
        ctx.binning = binning
        ctx.C = values.shape[0]
        ctx.dims = dict(T=T, grid_x=grid_x, width=width, height=height,
                        tile=tile, chunk=chunk)
        ctx.grid_y = grid_y
        return img, fT, observe

    @staticmethod
    def backward(ctx, g_img, g_fT, _g_observe):
        geom, vals, clogT, cdone, fT = ctx.saved_tensors
        b, d = ctx.binning, ctx.dims
        V = vals.shape[0]
        Hp, Wp = ctx.grid_y * d["tile"], d["grid_x"] * d["tile"]
        if g_img is None:
            g_img = vals.new_zeros(V, Hp, Wp)
        if g_fT is None:
            g_fT = vals.new_zeros(Hp, Wp)
        g_img_t, g_fT_t = retile(g_img, g_fT, ctx.grid_y, d["grid_x"],
                                 d["tile"])
        raw = blend_bwd(geom, vals, b.chunk_tile, clogT, cdone, g_img_t,
                        g_fT_t, fT, **d)
        C = ctx.C
        key = torch.where(b.is_null, C, b.gid)
        acc = segment_sum(torch.cat([raw.dvals, raw.dgeom]), key, C)  # (V+8, C)
        return (acc[:V].T, acc[V:V + 2].T, acc[V + 2:V + 5].T, acc[V + 5],
                acc[V + 6:V + 8].T, None, None, None, None, None)


def blend_tiles(values, means2d, conics, opacities, binning: Binning,
                height: int, width: int, tile: int, chunk: int,
                m2d_abs_sink: torch.Tensor | None = None) -> BlendOut:
    """The JAX package's blend_tiles_pallas: values (C, V), means2d (C, 2),
    conics (C, 3), opacities (C,) -> image (V, Hp, Wp), final_T (Hp, Wp) and
    per-Gaussian observe counts (C,) int32, differentiable in the four
    inputs. `m2d_abs_sink` is a (C, 2) zero tensor whose gradient receives
    the per-pixel absolute mean2d gradients (AbsGS densification)."""
    if m2d_abs_sink is None:
        m2d_abs_sink = means2d.new_zeros(means2d.shape[0], 2)
    img, fT, observe = _BlendTiles.apply(values, means2d, conics, opacities,
                                         m2d_abs_sink, binning, height, width,
                                         tile, chunk)
    return BlendOut(image=img, final_T=fT, observe=observe)


def observe_tiles(means2d, conics, opacities, binning: Binning, height: int,
                  width: int, tile: int, chunk: int) -> torch.Tensor:
    """The JAX package's observe_tiles_pallas: per-Gaussian observe counts
    (C,) int32, equal to blend_tiles(...).observe, from the geometry alone
    (no values, image or carries). Not differentiable."""
    grid_y, grid_x = num_tiles(height, width, tile)
    with torch.no_grad():
        geom = gather_geom(means2d, conics, opacities, binning.gid,
                           binning.is_null)
        obs = blend_obs(geom, binning.chunk_tile, T=grid_y * grid_x,
                        grid_x=grid_x, width=width, height=height, tile=tile,
                        chunk=chunk)
        return _observe_counts(obs, binning, means2d.shape[0])
