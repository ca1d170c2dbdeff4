"""Marching tetrahedra over the block-sparse TSDF (table-free, vectorized).

Port of gs2m_tpu/mesh/marching.py, as torch on the volume's device. Each
voxel cube is split into 6 tetrahedra around its main diagonal; per-tet
surface cases come from the 1/2/3-inside patterns. Cross-block continuity
comes from stitching one-voxel overlaps from the +x/+y/+z neighbor blocks;
the neighbors of all blocks are found at once by one sort of the packed
block keys and a searchsorted, not a Python dictionary. The cubes are
processed in slabs of blocks (the corner arrays of 10^8 voxels would run to
tens of GB), each slab with three host syncs, and the triangles are emitted in
the JAX package's order: tet 0..5, then triangle 0..1 within each tet, then
cube order, which slab order keeps.

Corner positions are float64 (an int64 voxel index + 0.5, times the voxel
size), as numpy promotes them there, and so is the weld key
round(p / (voxel * 1e-4)): in f32, different vertices would weld. The
weld keys are ranked lexicographically like np.unique(axis=0) (three
stable radix sorts, `_unique_rows`), and the welded vertices average in
float64 (each vertex's copies summed in input order, no float atomics), so
`faces` come out equal to the JAX package's.
"""
from __future__ import annotations

import numpy as np
import torch

from gs2m_tpu_torch.mesh.tsdf import (BLOCK_EDGE, TSDFVolume, block_keys,
                                      stage_timer)
from gs2m_tpu_torch.ops.gather import GatherPlan, scatter_rows

# Cube corners numbered by bits: x -> 1, y -> 2, z -> 4.
_CUBE_OFFSETS = np.array([[x, y, z] for z in (0, 1) for y in (0, 1)
                          for x in (0, 1)])[np.argsort(
    [x + 2 * y + 4 * z for z in (0, 1) for y in (0, 1) for x in (0, 1)])]
# 6-tet decomposition around the 0-7 diagonal.
_TETS = np.array([[0, 5, 1, 7], [0, 1, 3, 7], [0, 3, 2, 7],
                  [0, 2, 6, 7], [0, 6, 4, 7], [0, 4, 5, 7]])


def _tet_case_table():
    """For each 4-bit inside pattern: up to 2 triangles, each 3 edges (a, b)
    with a inside, b outside; plus triangle count."""
    edges = np.zeros((16, 2, 3, 2), np.int64)
    counts = np.zeros(16, np.int64)
    for case in range(16):
        inside = [i for i in range(4) if case >> i & 1]
        outside = [i for i in range(4) if not case >> i & 1]
        tris = []
        if len(inside) == 1:
            a = inside[0]
            tris = [[(a, outside[0]), (a, outside[1]), (a, outside[2])]]
        elif len(inside) == 3:
            b = outside[0]
            # Orientation flipped relative to the 1-inside case.
            tris = [[(inside[0], b), (inside[2], b), (inside[1], b)]]
        elif len(inside) == 2:
            a, b = inside
            c, d = outside
            tris = [[(a, c), (b, c), (b, d)], [(a, c), (b, d), (a, d)]]
        counts[case] = len(tris)
        for t, tri in enumerate(tris):
            edges[case, t] = tri
    return edges, counts


_EDGES, _COUNTS = _tet_case_table()


# The 7 neighbors whose first voxel layer closes a block's +1 overlap, in the
# JAX package's loop order (dz, then dy, then dx).
_NEIGHBORS = [(dx, dy, dz) for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)
              if dx or dy or dz]


def _neighbor_table(block_coords: torch.Tensor) -> torch.Tensor:
    """(B, 7) index of each block's +x/+y/+z neighbors (-1 where absent):
    one sort of the packed keys and one searchsorted for all blocks."""
    B = block_coords.shape[0]
    sorted_keys, order = torch.sort(block_keys(block_coords))
    offs = torch.tensor(_NEIGHBORS, device=block_coords.device)
    want = block_keys((block_coords[:, None, :] + offs[None]).reshape(-1, 3))
    pos = torch.searchsorted(sorted_keys, want).clamp_max(B - 1)
    found = sorted_keys[pos] == want
    return torch.where(found, order[pos], -1).reshape(B, len(_NEIGHBORS))


def _stitch_blocks(vol: TSDFVolume, start: int, stop: int, nbr):
    """Blocks [start, stop) as (n, E+1, E+1, E+1) padded sdf/weight/color
    grids (z, y, x order) with the +1 overlap from up to 7 neighbors (zeros
    where a neighbor is absent)."""
    E = BLOCK_EDGE
    B = vol.block_coords.shape[0]
    n = stop - start
    dev = vol.tsdf.device
    grids = [(vol.tsdf.reshape(B, E, E, E),
              torch.zeros(n, E + 1, E + 1, E + 1, device=dev)),
             (vol.weight.reshape(B, E, E, E),
              torch.zeros(n, E + 1, E + 1, E + 1, device=dev)),
             (vol.color.reshape(B, E, E, E, 3),
              torch.zeros(n, E + 1, E + 1, E + 1, 3, device=dev))]
    for src, dst in grids:
        dst[:, :E, :E, :E] = src[start:stop]
    for k, (dx, dy, dz) in enumerate(_NEIGHBORS):
        j = nbr[start:stop, k]
        have = j >= 0
        j = j.clamp_min(0)
        dst_sl = tuple(slice(E, E + 1) if d else slice(0, E)
                       for d in (dz, dy, dx))
        src_sl = tuple(slice(0, 1) if d else slice(0, E) for d in (dz, dy, dx))
        for src, dst in grids:
            part = src[(slice(None),) + src_sl][j]
            mask = have.reshape((-1,) + (1,) * (part.dim() - 1))
            dst[(slice(None),) + dst_sl] = torch.where(mask, part, 0.0)
    return [dst for _, dst in grids]


def _slab_triangles(vol: TSDFVolume, start: int, stop: int, nbr,
                    weight_threshold: float, tables):
    """The surface cubes of blocks [start, stop) -> 12 (points (K, 3, 3)
    f64, colors (K, 3, 3) f32) pieces, one per (tet, triangle) in the JAX
    package's order, each in cube order; None without a surface cube. Three
    host syncs: the surface cubes, the emitted triangles and their counts."""
    E = BLOCK_EDGE
    offsets, tets, edges, counts = tables
    sdf, w, col = _stitch_blocks(vol, start, stop, nbr)

    def corners(a):  # (n, E+1, E+1, E+1, ...) -> (n*E^3, 8, ...)
        out = [a[:, oz:oz + E, oy:oy + E, ox:ox + E]
               for ox, oy, oz in _CUBE_OFFSETS]
        return torch.stack(out, dim=4).reshape(-1, 8, *a.shape[4:])

    c_sdf = corners(sdf)
    c_w = corners(w)
    keep = (c_w > weight_threshold).all(dim=1) & (
        torch.sign(c_sdf.amax(1)) != torch.sign(c_sdf.amin(1)))
    cube = torch.nonzero(keep)[:, 0]
    M = cube.shape[0]
    if M == 0:
        return None
    c_sdf = c_sdf[cube]
    c_col = corners(col)[cube]                                  # (M, 8, 3)
    # World positions of the kept cubes' corners: cube m of the slab is
    # voxel m % E^3 (x fastest) of block start + m // E^3.
    r = torch.arange(E, device=cube.device)
    zz, yy, xx = torch.meshgrid(r, r, r, indexing="ij")
    local = torch.stack([xx, yy, zz], -1).reshape(-1, 3)
    base = (local[cube % E ** 3]
            + vol.block_coords[start:stop][cube // E ** 3] * E)
    c_pos = ((base[:, None, :] + offsets[None]).to(torch.float64) + 0.5
             ) * vol.voxel_size                                 # (M, 8, 3)

    # Every tet's case, and both its possible triangles for every cube.
    bits = torch.tensor([1, 2, 4, 8], device=cube.device)
    case = ((c_sdf[:, tets] < 0.0).to(torch.int64) * bits).sum(-1)  # (M, 6)
    e = tets[torch.arange(len(_TETS), device=cube.device)[:, None, None,
                                                          None],
             edges[case]]                       # (M, 6, 2, 3, 2) cube corners
    valid = counts[case][..., None] > torch.arange(2, device=cube.device)
    a, b = e[..., 0].reshape(M, -1), e[..., 1].reshape(M, -1)
    sa = torch.gather(c_sdf, 1, a)
    sb = torch.gather(c_sdf, 1, b)
    tt = (sa / (sa - sb + 1e-12))[..., None]

    def lerp(c):  # c (M, 8, 3) corner values at the triangle vertices
        ca = torch.gather(c, 1, a[..., None].expand(-1, -1, 3))
        cb = torch.gather(c, 1, b[..., None].expand(-1, -1, 3))
        return (ca + tt * (cb - ca)).reshape(M, len(_TETS), 2, 3, 3)

    # Emit in (tet, triangle, cube) order.
    sel = torch.nonzero(valid.permute(1, 2, 0).reshape(-1))[:, 0]
    n_per = torch.bincount(sel // M, minlength=2 * len(_TETS)).tolist()
    pts = lerp(c_pos).permute(1, 2, 0, 3, 4).reshape(-1, 3, 3)[sel]
    cols = lerp(c_col).permute(1, 2, 0, 3, 4).reshape(-1, 3, 3)[sel]
    return list(zip(pts.split(n_per), cols.split(n_per)))


def _unique_rows(q: torch.Tensor):
    """(N, 3) int64 -> (unique rows in lexicographic order, inverse (N,),
    GatherPlan), the first two as np.unique(q, axis=0, return_inverse=True)
    gives them: stable sorts by the last column, then the middle, then the
    first. The plan is the stable sort that groups each unique row's copies
    in input order, and the group sizes."""
    order = torch.sort(q[:, 2], stable=True).indices
    for c in (1, 0):
        order = order[torch.sort(q[order, c], stable=True).indices]
    s = q[order]
    new = torch.ones(s.shape[0], dtype=torch.bool, device=q.device)
    new[1:] = (s[1:] != s[:-1]).any(1)
    inv = torch.empty_like(order)
    inv[order] = torch.cumsum(new, 0) - 1
    starts = torch.nonzero(new)[:, 0]
    lengths = torch.diff(starts, append=starts.new_full((1,), s.shape[0]))
    return s[new], inv, GatherPlan(idx=inv, shape=tuple(inv.shape),
                                   order=order, lengths=lengths)


def _weld(tri_pts: torch.Tensor, tri_col: torch.Tensor, voxel_size: float):
    """Weld identical vertices (edge intersections are shared exactly) ->
    (vertices f32, faces int64 without degenerate triangles, colors f32)."""
    flat = tri_pts.reshape(-1, 3)
    quantum = torch.tensor(voxel_size * 1e-4, dtype=torch.float64,
                           device=flat.device)
    quant = torch.round(flat / quantum).to(torch.int64)
    uniq, inv, rows = _unique_rows(quant)
    # Each vertex's copies summed in input order (no float atomics, as
    # index_add_ would use on the card): the same bits on every run.
    cnt = rows.lengths.to(torch.float64)[:, None]
    verts = (scatter_rows(flat, rows) / cnt).to(torch.float32)
    cols = (scatter_rows(tri_col.reshape(-1, 3).to(torch.float64), rows)
            / cnt).to(torch.float32)
    faces = inv.reshape(-1, 3)
    good = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
            & (faces[:, 0] != faces[:, 2]))
    return verts, faces[good], cols


def marching_tetrahedra_blocks(vol: TSDFVolume, weight_threshold: float = 0.0,
                               slab_blocks: int = 16384,
                               stages: dict | None = None):
    """-> (vertices (N, 3) f32, faces (M, 3) int64, colors (N, 3) f32) on
    the volume's device; an empty mesh if no surface crossing. `slab_blocks`
    blocks are marched at a time; `stages`, when given, receives the ms of
    "march" (stitch and march) and "weld"."""
    dev = vol.tsdf.device
    B = vol.block_coords.shape[0]
    empty = (torch.zeros(0, 3, device=dev),
             torch.zeros(0, 3, dtype=torch.int64, device=dev),
             torch.zeros(0, 3, device=dev))
    if B == 0:
        return empty
    with stage_timer(stages, "march", dev):
        tables = tuple(torch.as_tensor(a, device=dev) for a in
                       (_CUBE_OFFSETS, _TETS, _EDGES, _COUNTS))
        nbr = _neighbor_table(vol.block_coords)
        pieces = [[] for _ in range(2 * len(_TETS))]
        for s in range(0, B, slab_blocks):
            tris = _slab_triangles(vol, s, min(s + slab_blocks, B), nbr,
                                   weight_threshold, tables)
            for k, piece in enumerate(tris or ()):
                pieces[k].append(piece)
        ordered = [piece for per_key in pieces for piece in per_key]
    if not ordered:
        return empty
    with stage_timer(stages, "weld", dev):
        tri_pts = torch.cat([p for p, _ in ordered], 0)      # (T, 3, 3)
        tri_col = torch.cat([c for _, c in ordered], 0)
        return _weld(tri_pts, tri_col, vol.voxel_size)
