"""Tile binning: Gaussian -> (tile, depth)-sorted, chunk-aligned instance lists.

Port of gs2m_tpu/ops/binning.py (its uncut path) that returns the same
layout, equal to the JAX package's element for element:

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
  the segment starts + one cumsum) of the expansion slots, `exp_slot`;
  `gid` is a gather through it and `is_null` its unfilled slots
* fixed instance capacity with an overflow counter, `dropped`, which the
  caller must surface (the render app doubles the cap on it)

The backward (ops/blend.py) sums each Gaussian's per-instance gradients,
so the layout also carries the map from aligned slots back to the
expansion (`exp_slot`, `exp_start`, `exp_kept`; port-only fields). A
Gaussian's expansion slots walk its tile rectangle row-major, so in
ascending tile id; the aligned layout is tile-major and holds a Gaussian at
most once a tile. So a Gaussian's kept instances in expansion order are its
aligned slots in ascending order, the order in which a stable sort on the
Gaussian id (the plain reduction, ops/blend.py::segment_sum) sums them: the
card's reduce walks the expansion and needs no sort. The JAX package's
per-Gaussian counts, which its backward's reduce reads, have no counterpart
here.
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
    num_aligned: torch.Tensor    # () int32 — chunk-aligned slots in use
    # () int32 — instances kept by the cull; None in a layout made from the
    # JAX package's Binning, which has no such count.
    num_kept: torch.Tensor | None = None
    # The expansion map the card's backward reduce reads; None in a layout
    # made from the JAX package's Binning, which has none.
    # (I,) int32 expansion slot of each aligned slot; I for null slots.
    exp_slot: torch.Tensor | None = None
    # (C+1,) int32 each Gaussian's first expansion slot clamped to I, then
    # the total expansion (clamped).
    exp_start: torch.Tensor | None = None
    # (I,) bool expansion slots that hold an aligned slot (not culled, not
    # dropped by either overflow).
    exp_kept: torch.Tensor | None = None


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
    dropped_expansion = torch.clamp_min(total - I, 0)

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
        proj.depths, lmin, qmax, proj.means2d[:, 0], proj.means2d[:, 1]])
    rows = torch.index_select(table, 1, g.long())              # (8, I)
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

    # --- stable (tile, depth) sort; the permutation carries the slot ---------
    key = (tile_id.long() << 32) | depth.view(I32).long()
    sorted_key, perm = torch.sort(key, stable=True)
    tile_sorted = (sorted_key >> 32).to(I32)

    # --- per-tile ranges: T+1 binary searches over the sorted tiles -------------
    start_fill = torch.searchsorted(
        tile_sorted, torch.arange(T + 1, dtype=I32, device=dev)).to(I32)
    start = start_fill[:T]
    counts = start_fill[1:] - start
    num_kept = start_fill[T]            # the live slots sort first

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

    # Aligned layout via the shift scatter: dst = sorted position +
    # (astart - start)[tile]; the shift is constant over a tile's sorted
    # segment, so scatter its per-tile diffs at the segment starts and carry
    # it forward with one cumsum. Culled rows and dst >= I drop. What is
    # scattered is the expansion map: each aligned slot's expansion slot.
    # The rows below a tile's count fill its aligned segment slot for slot,
    # so the slots left at I are exactly the null ones (chunk padding, the
    # cap's tail), which take gid 0. An expansion slot is kept where its
    # sorted row lands in the layout (a permutation's scatter: no
    # duplicates).
    shift = astart - start
    sdiff = torch.cat([shift[:1], shift[1:] - shift[:-1]])
    shift_slot = _cumsum(_scatter_add(start, sdiff, I))
    dst = torch.where(tile_sorted < T, slots + shift_slot, I)
    exp_slot = torch.full((I + 1,), I, dtype=I32, device=dev)
    exp_slot[torch.clamp_max(dst, I).long()] = perm.to(I32)
    exp_slot = exp_slot[:I]
    exp_kept = torch.zeros(I, dtype=torch.bool, device=dev)
    exp_kept[perm] = dst < I
    gid = torch.index_select(torch.cat([g, g.new_zeros(1)]), 0, exp_slot)

    chunk_starts = torch.arange(n_chunks, dtype=I32, device=dev) * chunk
    chunk_tile = torch.where(chunk_starts < atotal, t_of_c.to(I32), T)

    # A tile renders only if a chunk carries it (overflow can cut a nonempty
    # tile's chunks entirely; it then composites as background).
    covered = torch.zeros(T + 1, dtype=torch.bool, device=dev).index_fill_(
        0, chunk_tile.long(), True)

    return Binning(
        gid=gid,
        is_null=exp_slot == I,
        chunk_tile=chunk_tile,
        tile_nonempty=(counts > 0) & covered[:T],
        num_instances=total.to(I32),
        dropped=(dropped_expansion + dropped_align).to(I32),
        num_aligned=torch.clamp_max(atotal, I).to(I32),
        num_kept=num_kept,
        exp_slot=exp_slot,
        exp_start=torch.clamp_max(torch.cat([offsets, total[None]]), I),
        exp_kept=exp_kept,
    )
