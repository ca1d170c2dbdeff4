"""Tile binning: Gaussian -> (tile, depth)-sorted, chunk-aligned instance lists.

Port of gs2m_tpu/ops/binning.py (without its term_cut option) that returns
the same `Binning` contract, equal to the JAX package's element for element:

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
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gs2m_tpu_torch.ops.projection import Projected

I32 = torch.int32


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


def bin_gaussians(proj: Projected, height: int, width: int, tile: int,
                  instance_cap: int, chunk: int,
                  opacities: torch.Tensor) -> Binning:
    """Build the chunk-aligned instance layout from projected Gaussians."""
    if instance_cap % chunk or instance_cap > 2 ** 30:
        raise ValueError(f"instance_cap {instance_cap} must be a multiple of "
                         f"chunk {chunk} and at most 2^30")
    dev = proj.means2d.device
    grid_y, grid_x = num_tiles(height, width, tile)
    T = grid_y * grid_x
    I = instance_cap
    C = proj.means2d.shape[0]

    tt = proj.tiles_touched
    offsets = _cumsum(tt) - tt          # exclusive: first slot of each Gaussian
    total = offsets[-1] + tt[-1]
    dropped_expand = torch.clamp_min(total - I, 0)

    # --- expansion: slot -> (gaussian, tile) ------------------------------------
    slots = torch.arange(I, dtype=I32, device=dev)
    g = torch.clamp(_cumsum(_scatter_add(offsets, 1, I)) - 1, 0, C - 1)
    live = slots < total

    con = proj.conics
    ca, cb, cc = con[:, 0], con[:, 1], con[:, 2]
    disc = torch.sqrt(0.25 * (ca - cc) ** 2 + cb * cb + 1e-20)
    lmin = torch.clamp_min(0.5 * (ca + cc) - disc, 0.0)
    qmax = 2.0 * torch.log(torch.clamp_min(opacities, 1e-12) * 255.0)
    table = torch.stack([
        proj.rect_min[:, 0].float(),
        proj.rect_min[:, 1].float(),
        torch.clamp_min(proj.rect_max[:, 0] - proj.rect_min[:, 0], 1).float(),
        proj.depths,
        proj.means2d[:, 0], proj.means2d[:, 1], lmin, qmax])        # (8, C)
    rows = torch.index_select(table, 1, g.long())                   # (8, I)
    # Rank of each slot within its Gaussian's run (exact in f32: below the
    # Gaussian's tile count).
    j = (slots - offsets[g.long()]).float()
    q = torch.floor(j / rows[2])
    tx = rows[0] + (j - q * rows[2])
    ty = rows[1] + q
    # Ellipse-tile cull: nearest pixel of the tile to the splat center.
    cx = torch.minimum(torch.maximum(rows[4], tx * tile), tx * tile + (tile - 1))
    cy = torch.minimum(torch.maximum(rows[5], ty * tile), ty * tile + (tile - 1))
    d2 = (rows[4] - cx) ** 2 + (rows[5] - cy) ** 2
    keep = live & (rows[6] * d2 <= rows[7] + 1e-3)
    tile_id = torch.where(keep, ty * grid_x + tx, T).to(I32)
    depth = torch.where(keep, rows[3], torch.inf)

    # Per-Gaussian surviving-instance counts (slots of a Gaussian are
    # contiguous in expansion order).
    kcs = torch.cat([torch.zeros(1, dtype=I32, device=dev),
                     _cumsum(keep.to(I32))])
    seg_lo = torch.clamp(offsets, 0, I).long()
    seg_hi = torch.clamp(offsets + tt, 0, I).long()
    gauss_present = kcs[seg_hi] - kcs[seg_lo]

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

    # --- chunk alignment ----------------------------------------------------------
    aligned = (counts + chunk - 1) // chunk * chunk
    astart = _cumsum(aligned) - aligned
    atotal = astart[-1] + aligned[-1]
    dropped_align = torch.clamp_min(atotal - I, 0)

    # Aligned chunk -> tile (segments are chunk-aligned, so every slot of a
    # chunk shares one tile; empty tiles' duplicate starts accumulate, so
    # the cumsum still yields the LAST tile with astart <= slot).
    n_chunks = I // chunk
    t_of_c = torch.clamp(_cumsum(_scatter_add(astart // chunk, 1, n_chunks)) - 1,
                         0, T - 1).long()
    astart_c = astart[t_of_c, None].expand(n_chunks, chunk).reshape(-1)
    counts_c = counts[t_of_c, None].expand(n_chunks, chunk).reshape(-1)
    in_tile = (slots < atotal) & (slots - astart_c < counts_c)

    # Aligned layout via the shift scatter: dst = sorted position +
    # (astart - start)[tile]; the shift is constant over a tile's sorted
    # segment, so scatter its per-tile diffs at the segment starts and carry
    # it forward with one cumsum. Culled rows (tile T) and dst >= I drop;
    # chunk-padding slots keep gid 0.
    shift = astart - start
    sdiff = torch.cat([shift[:1], shift[1:] - shift[:-1]])
    shift_slot = _cumsum(_scatter_add(start, sdiff, I))
    dst = torch.where(tile_sorted < T, slots + shift_slot, I)
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
        gauss_offset=torch.clamp(offsets, 0, I),
        gauss_live=torch.clamp_min(torch.minimum(tt, I - offsets), 0),
        num_aligned=torch.clamp_max(atotal, I).to(I32),
        gauss_present=gauss_present,
        dropped_expand=dropped_expand.to(I32),
    )
