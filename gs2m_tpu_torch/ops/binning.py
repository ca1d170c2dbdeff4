"""Tile binning: Gaussian -> (tile, depth)-sorted, chunk-aligned instance lists.

Port of gs2m_tpu/ops/binning.py, its termination cut (`term_cut`) and split
caps (`expand_cap`) included, that returns the same `Binning` contract,
equal to the JAX package's element for element:

* expansion is gather-based: slot i finds its Gaussian from the exclusive
  cumsum of tiles_touched (scatter-ones + cumsum), each Gaussian's slots
  walk its tile rect row-major
* the ellipse-tile cull drops an instance iff
  lambda_min(conic) * dist(tile, mean)^2 > 2*ln(255*opacity) (+1e-3), a
  bound under which alpha < 1/255 on every pixel of the tile
* the JAX package's stable lexicographic (tile, depth) sort with the
  Gaussian id as payload is ONE stable torch.sort on the packed int64 key
  tile << 32 | float_bits(depth): live depths are > 0.2 (positive floats
  order like their bit patterns) and culled rows all carry tile T, so the
  packed order is the lexicographic one and stability keeps the ties
* per-tile segments are padded to a multiple of `chunk`, so the blend
  kernel sees a regular (n_chunks, chunk) layout with one tile per chunk;
  the aligned layout is built by the shift scatter (per-tile shift diffs at
  the segment starts + one cumsum)
* fixed instance capacity with an overflow counter, `dropped`, which the
  caller must surface (the render app doubles the cap on it)
* `term_cut` cuts each tile's sorted run where termination is guaranteed
  for every pixel of the tile (see `termination_kept`); the cut runs
  between the sort and the aligned scatter, so the expansion and sort side
  has its own cap, `expand_cap`, and its overflow is `dropped_expand`

The backward (ops/blend.py) groups per-instance gradients by a stable sort
on the Gaussian id, so it needs no per-Gaussian instance counts: the cut
changes those counts, and the JAX package's `exact_rank` reduce, which
serves that case there, has no counterpart here. `gauss_present` is
returned as the JAX package returns it (zeros when `with_present` is
False, its default under the cut).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from gs2m_tpu_torch.ops.projection import Projected

I32 = torch.int32

# The termination cut's constants, the JAX package's: bounds per 4x4-pixel
# block; credits quantized in 1e-3 steps (ceil, so conservative) and
# clamped at -16; a block has crossed once its quantized sum is at or
# below floor(log(1e-4) / 1e-3), the blend's termination threshold.
CUT_BLOCK = 4
CUT_SCALE = 1e-3
CUT_Q_EPS = int(math.floor(math.log(1e-4) / CUT_SCALE))   # -9211
CUT_CREDIT_MIN = -16.0
ALPHA_GATE = 1.0 / 255.0
# XLA divides by the constant as a multiply by its float32 reciprocal; the
# cut does the same, so both packages round each credit alike.
_INV_SCALE = float(np.float32(1.0) / np.float32(CUT_SCALE))


class Binning(NamedTuple):
    """Chunk-aligned, depth-sorted instance layout. With I = instance
    capacity (multiple of chunk) and n_chunks = I // chunk:"""
    gid: torch.Tensor            # (I,) int32 Gaussian index per slot; 0 for null
    is_null: torch.Tensor        # (I,) bool — padding slots (alpha forced to 0)
    chunk_tile: torch.Tensor     # (n_chunks,) int32 tile id per chunk (T = dummy)
    tile_nonempty: torch.Tensor  # (T,) bool — tiles with >= 1 instance
    num_instances: torch.Tensor  # () int32 — instance count before alignment
    dropped: torch.Tensor        # () int32 — instances lost to the capacity cap
    gauss_offset: torch.Tensor   # (C,) int32 first expansion slot per Gaussian
    gauss_live: torch.Tensor     # (C,) int32 in-capacity instances per Gaussian
    num_aligned: torch.Tensor    # () int32 — chunk-aligned slots in use
    gauss_present: torch.Tensor  # (C,) int32 instances surviving the cull
    dropped_expand: torch.Tensor  # () int32 — the expansion-cap part of dropped
    # () int32 — instances kept by the cull (and cut); None in a layout made
    # from the JAX package's Binning, which has no such count.
    num_kept: torch.Tensor | None = None


def num_tiles(height: int, width: int, tile: int) -> tuple[int, int]:
    return (height + tile - 1) // tile, (width + tile - 1) // tile


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0, dtype=I32)


def _scatter_add(positions: torch.Tensor, values, size: int) -> torch.Tensor:
    """(size,) int32 scatter-add of `values` at `positions`; positions >= size
    drop (they land in a spill slot, so no host sync is needed)."""
    out = torch.zeros(size + 1, dtype=I32, device=positions.device)
    if isinstance(values, torch.Tensor):
        values = torch.broadcast_to(values.to(I32), positions.shape)
    else:  # a fill, not a host-to-device copy
        values = torch.full_like(positions, values, dtype=I32)
    out.index_add_(0, torch.clamp_max(positions, size).long(), values)
    return out[:size]


def termination_kept(tile_sorted: torch.Tensor, seg_start: torch.Tensor,
                     cut_rows: torch.Tensor, *, T: int, grid_x: int,
                     width: int, height: int, tile: int) -> torch.Tensor:
    """(IE,) bool: the sorted instances the termination cut keeps.

    Per instance and 4x4 block of its tile, alpha anywhere in the block is
    at least amin = min(0.99, op * exp(-0.5 * lmax * d2_far)) (lmax the
    conic's largest eigenvalue, d2_far the squared distance from the mean
    to the block's farthest pixel). The blend composites only alpha >=
    1/255, so the running sum of log1p(-amin) over such instances bounds
    every block pixel's log T from above; once every block of a tile has
    crossed log(1e-4), the blend has terminated every pixel and each deeper
    instance contributes exactly nothing (value, weight and gradient).
    Blocks outside the image count as crossed.

    `cut_rows` (4, IE) carries (mean x, mean y, lmax, opacity) in sorted
    order, `seg_start` (IE,) the sorted position where each slot's tile
    starts. The quantized credits are summed in int64, which cannot wrap,
    so each tile's prefix (global prefix minus the prefix at the tile's
    start) is exact. The 16 blocks are visited one at a time and AND their
    rows into one running mask: memory O(IE), not O(16 IE).
    """
    IE = tile_sorted.shape[0]
    mx, my, lmax, op = cut_rows
    valid = tile_sorted < T
    tpos = torch.clamp_max(tile_sorted, T - 1)
    tox = ((tpos % grid_x) * tile).float()
    toy = ((tpos // grid_x) * tile).float()
    half_lmax = 0.5 * lmax
    inv_scale = torch.full_like(mx, _INV_SCALE)

    def far_sq(m, origin):
        """Per block column (or row): the squared distance from the mean to
        the block's farthest pixel, and the block's first pixel."""
        out = []
        for r in range(tile // CUT_BLOCK):
            b0 = origin + float(r * CUT_BLOCK)
            far = torch.maximum(torch.abs(m - b0),
                                torch.abs(m - (b0 + (CUT_BLOCK - 1))))
            out.append((far * far, b0))
        return out

    cols = far_sq(mx, tox)
    rows = far_sq(my, toy)
    crossed_all = torch.ones(IE, dtype=torch.bool, device=mx.device)
    for dy2, by0 in rows:
        for dx2, bx0 in cols:
            amin = torch.clamp_max(op * torch.exp(-(half_lmax * (dy2 + dx2))),
                                   0.99)
            credit = torch.where(
                valid & (amin >= ALPHA_GATE),
                torch.clamp_min(torch.log1p(-amin), CUT_CREDIT_MIN), 0.0)
            q = torch.ceil(credit * inv_scale).long()          # <= 0
            excl = torch.cumsum(q, 0) - q                      # sum before
            excl_in = excl - excl[seg_start]                   # within tile
            crossed = ((excl_in <= CUT_Q_EPS) | (bx0 >= width)
                       | (by0 >= height))
            crossed_all &= crossed
    return ~crossed_all


def tile_slots_max(chunk_tile: torch.Tensor, tiles: int,
                   chunk: int) -> torch.Tensor:
    """() int32: the most chunk-aligned slots any one tile holds in a
    layout, from its (n_chunks,) tile per chunk (the dummy tile `tiles`
    left out); on the device, with no sync."""
    per_tile = torch.zeros(tiles + 1, dtype=I32, device=chunk_tile.device)
    per_tile.index_add_(0, chunk_tile, torch.full_like(chunk_tile, chunk))
    return per_tile[:tiles].amax()


def bin_gaussians(proj: Projected, height: int, width: int, tile: int,
                  instance_cap: int, chunk: int,
                  opacities: torch.Tensor, with_present: bool = True,
                  term_cut: bool = False,
                  expand_cap: int | None = None) -> Binning:
    """Build the chunk-aligned instance layout from projected Gaussians.

    With `term_cut`, each tile's sorted run is cut after the instance at
    which termination is guaranteed (termination_kept), an exact cut: the
    blend's outputs and gradients are those of the uncut layout. The
    expansion and sort then run at `expand_cap` slots (default
    `instance_cap`), the aligned layout at `instance_cap`."""
    IE = expand_cap or instance_cap
    for name, cap in (("instance_cap", instance_cap), ("expand_cap", IE)):
        if cap % chunk or cap > 2 ** 30:
            raise ValueError(f"{name} {cap} must be a multiple of chunk "
                             f"{chunk} and at most 2^30")
    dev = proj.means2d.device
    grid_y, grid_x = num_tiles(height, width, tile)
    T = grid_y * grid_x
    I = instance_cap
    C = proj.means2d.shape[0]

    tt = proj.tiles_touched
    offsets = _cumsum(tt) - tt          # exclusive: first slot of each Gaussian
    total = offsets[-1] + tt[-1]
    dropped_expand = torch.clamp_min(total - IE, 0)

    # --- expansion: slot -> (gaussian, tile) ------------------------------------
    slots = torch.arange(IE, dtype=I32, device=dev)
    g = torch.clamp(_cumsum(_scatter_add(offsets, 1, IE)) - 1, 0, C - 1)
    live = slots < total

    con = proj.conics
    ca, cb, cc = con[:, 0], con[:, 1], con[:, 2]
    disc = torch.sqrt(0.25 * (ca - cc) ** 2 + cb * cb + 1e-20)
    lmin = torch.clamp_min(0.5 * (ca + cc) - disc, 0.0)
    qmax = 2.0 * torch.log(torch.clamp_min(opacities, 1e-12) * 255.0)
    cols = [proj.rect_min[:, 0].float(),
            proj.rect_min[:, 1].float(),
            torch.clamp_min(proj.rect_max[:, 0] - proj.rect_min[:, 0], 1).float(),
            proj.depths, lmin, qmax, proj.means2d[:, 0], proj.means2d[:, 1]]
    if term_cut:
        cols += [0.5 * (ca + cc) + disc, opacities]  # lmax, opacity
    table = torch.stack(cols)                                  # (8 or 10, C)
    rows = torch.index_select(table, 1, g.long())              # (8 or 10, IE)
    # Rank of each slot within its Gaussian's run (exact in f32: below the
    # Gaussian's tile count).
    j = (slots - offsets[g.long()]).float()
    q = torch.floor(j / rows[2])
    tx = rows[0] + (j - q * rows[2])
    ty = rows[1] + q
    # Ellipse-tile cull: nearest pixel of the tile to the splat center.
    cx = torch.minimum(torch.maximum(rows[6], tx * tile), tx * tile + (tile - 1))
    cy = torch.minimum(torch.maximum(rows[7], ty * tile), ty * tile + (tile - 1))
    d2 = (rows[6] - cx) ** 2 + (rows[7] - cy) ** 2
    keep = live & (rows[4] * d2 <= rows[5] + 1e-3)
    tile_id = torch.where(keep, ty * grid_x + tx, T).to(I32)
    depth = torch.where(keep, rows[3], torch.inf)

    # Per-Gaussian surviving-instance counts (slots of a Gaussian are
    # contiguous in expansion order).
    if with_present:
        kcs = torch.cat([torch.zeros(1, dtype=I32, device=dev),
                         _cumsum(keep.to(I32))])
        seg_lo = torch.clamp(offsets, 0, IE).long()
        seg_hi = torch.clamp(offsets + tt, 0, IE).long()
        gauss_present = kcs[seg_hi] - kcs[seg_lo]
    else:
        gauss_present = torch.zeros(C, dtype=I32, device=dev)

    # --- stable (tile, depth) sort with the Gaussian id as payload ------------
    key = (tile_id.long() << 32) | depth.view(I32).long()
    sorted_key, perm = torch.sort(key, stable=True)
    tile_sorted = (sorted_key >> 32).to(I32)
    gid_sorted = g[perm]

    # --- per-tile ranges: T+1 binary searches over the sorted tiles -------------
    start_fill = torch.searchsorted(
        tile_sorted, torch.arange(T + 1, dtype=I32, device=dev)).to(I32)
    start = start_fill[:T]
    counts = start_fill[1:] - start
    num_kept = start_fill[T]            # the live slots sort first
    live_kept = tile_sorted < T

    if term_cut:
        # The cut's payloads ride the sort's permutation as one packed gather.
        cut_rows = torch.index_select(rows[6:], 1, perm)
        seg_start = start[torch.clamp_max(tile_sorted, T - 1).long()].long()
        kept_raw = termination_kept(tile_sorted, seg_start, cut_rows, T=T,
                                    grid_x=grid_x, width=width, height=height,
                                    tile=tile)
        # The kept set is a prefix of each tile's run by monotonicity; the
        # aligned scatter's ranks rely on it, so it is enforced (as the JAX
        # package does): nothing after a cut slot of the same tile is kept.
        pos = torch.arange(IE, dtype=torch.int64, device=dev)
        bad_pos = torch.where(~kept_raw & live_kept, pos, -1)
        last_bad = torch.cummax(bad_pos, 0).values
        kept = kept_raw & (last_bad < seg_start)
        kcs2 = torch.cat([torch.zeros(1, dtype=I32, device=dev),
                          _cumsum(kept.to(I32))])
        kept_to = kcs2[start_fill.long()]   # kept before each tile's start
        counts = kept_to[1:] - kept_to[:T]
        num_kept = kept_to[T]
        live_kept = live_kept & kept

    # --- chunk alignment ----------------------------------------------------------
    aligned = (counts + chunk - 1) // chunk * chunk
    astart = _cumsum(aligned) - aligned
    atotal = astart[-1] + aligned[-1]
    dropped_align = torch.clamp_min(atotal - I, 0)

    # Aligned chunk -> tile (segments are chunk-aligned, so every slot of a
    # chunk shares one tile; empty tiles' duplicate starts accumulate, so
    # the cumsum still yields the LAST tile with astart <= slot).
    n_chunks = I // chunk
    slots_out = torch.arange(I, dtype=I32, device=dev)
    t_of_c = torch.clamp(_cumsum(_scatter_add(astart // chunk, 1, n_chunks)) - 1,
                         0, T - 1).long()
    astart_c = astart[t_of_c, None].expand(n_chunks, chunk).reshape(-1)
    counts_c = counts[t_of_c, None].expand(n_chunks, chunk).reshape(-1)
    in_tile = (slots_out < atotal) & (slots_out - astart_c < counts_c)

    # Aligned layout via the shift scatter: dst = sorted position +
    # (astart - start)[tile]; the shift is constant over a tile's sorted
    # segment, so scatter its per-tile diffs at the segment starts and carry
    # it forward with one cumsum. Culled and cut rows and dst >= I drop;
    # chunk-padding slots keep gid 0. The cut keeps a prefix of each tile's
    # run, so the kept instances' ranks are unchanged.
    shift = astart - start
    sdiff = torch.cat([shift[:1], shift[1:] - shift[:-1]])
    shift_slot = _cumsum(_scatter_add(start, sdiff, IE))
    dst = torch.where(live_kept, slots + shift_slot, I)
    gid = torch.zeros(I + 1, dtype=I32, device=dev)
    gid[torch.clamp_max(dst, I).long()] = gid_sorted
    gid = torch.where(in_tile, gid[:I], 0)

    chunk_starts = torch.arange(n_chunks, dtype=I32, device=dev) * chunk
    chunk_tile = torch.where(chunk_starts < atotal, t_of_c.to(I32), T)

    # A tile renders only if a chunk carries it (overflow can cut a nonempty
    # tile's chunks entirely; it then composites as background).
    covered = torch.zeros(T + 1, dtype=torch.bool, device=dev).index_fill_(
        0, chunk_tile.long(), True)

    return Binning(
        gid=gid,
        is_null=~in_tile,
        chunk_tile=chunk_tile,
        tile_nonempty=(counts > 0) & covered[:T],
        num_instances=total.to(I32),
        dropped=(dropped_expand + dropped_align).to(I32),
        gauss_offset=torch.clamp(offsets, 0, IE),
        gauss_live=torch.clamp_min(torch.minimum(tt, IE - offsets), 0),
        num_aligned=torch.clamp_max(atotal, I).to(I32),
        gauss_present=gauss_present,
        dropped_expand=dropped_expand.to(I32),
        num_kept=num_kept,
    )
