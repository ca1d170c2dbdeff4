"""The kernels' warp cull: the rectangle of ops/blend.py::cull_rects (the
twin of csrc/blend_common.cuh::cull_rect) holds every pixel at which
chunk_walk's gate lets an instance in, so a warp that skips the instances
whose rectangle misses its 8x4 block skips only steps with alpha 0.

Seeded numpy geometry at the edges the cull must survive: opacity at 1/255
and one ulp either side, opacities past the 0.99 clamp, thin conics
(condition number 1e4), means off the tile, null slots, forms that are not
positive definite, and pixel coordinates far from the origin.
"""
import numpy as np
import pytest
import torch

from gs2m_tpu_torch.ops import blend

TILE = 16


def conics(rng, n, sig_lo, sig_hi, cond=None):
    """(n, 3) f32 conics (a, b, c) of random rotated covariances with axis
    sigmas in [sig_lo, sig_hi] px (or a fixed condition number)."""
    s1 = rng.uniform(sig_lo, sig_hi, n)
    s2 = s1 / np.sqrt(cond) if cond else rng.uniform(sig_lo, sig_hi, n)
    th = rng.uniform(0, np.pi, n)
    cs, sn = np.cos(th), np.sin(th)
    ca = cs * cs * s1 ** 2 + sn * sn * s2 ** 2
    cb = cs * sn * (s1 ** 2 - s2 ** 2)
    cc = sn * sn * s1 ** 2 + cs * cs * s2 ** 2
    det = ca * cc - cb * cb
    return np.stack([cc / det, -cb / det, ca / det], -1).astype(np.float32)


def geometry(means, con, op):
    n = len(op)
    return torch.from_numpy(np.concatenate(
        [means.T, con.T, np.asarray(op, np.float32)[None],
         np.zeros((2, n), np.float32)]).astype(np.float32))


def check(geom, tile_xy):
    """Assert every gated (instance, pixel) of the tile at tile_xy lies in
    the instance's rectangle; return the gate (n, P) and the warp hits
    (n, warps)."""
    tx, ty = tile_xy
    grid_x = tx + 2
    tiles = torch.tensor([ty * grid_x + tx])
    px, py = blend.pixel_coords(tiles, TILE, grid_x)
    gc = geom.T[None, :, :, None]                                  # (1, n, 8, 1)
    st = blend.chunk_walk(gc, px, py, torch.zeros(1, TILE * TILE),
                          torch.zeros(1, TILE * TILE, dtype=torch.bool),
                          width=10 ** 5, height=10 ** 5)
    gate = st.alpha[0] > 0                                          # (n, P)
    r = blend.cull_rects(geom)
    inside = ((px >= r[0][:, None]) & (px <= r[1][:, None])
              & (py >= r[2][:, None]) & (py <= r[3][:, None]))
    bad = gate & ~inside
    assert not bool(bad.any()), (
        f"{int(bad.sum())} gated pixels outside their rectangle, instances "
        f"{torch.nonzero(bad.any(1))[:5, 0].tolist()}")
    hits = blend.warp_hits(r.T[None], tiles, grid_x)[0]             # (n, warps)
    # A warp the gate reaches is never culled.
    assert not bool((blend.warp_any(gate) & ~hits).any())
    return gate, hits


@pytest.mark.parametrize("seed", [0, 1])
def test_generic_instances_are_held_and_culled(seed):
    """Splats of 0.5-8 px around a tile: conservative, and the cull is not
    vacuous."""
    rng = np.random.default_rng(seed)
    n = 3000
    means = rng.uniform(-24, 40, (n, 2)) + 16
    op = rng.uniform(0.0, 1.0, n)
    gate, hits = check(geometry(means, conics(rng, n, 0.5, 8.0), op), (1, 1))
    assert bool(gate.any())
    culled = 1.0 - float(hits.float().mean())
    assert culled > 0.3, culled
    # Every warp block is hit by some instance and missed by another.
    assert bool(hits.any(0).all()) and bool((~hits).any(0).all())


def test_opacity_at_one_over_255():
    """op at ALPHA_MIN and one ulp either side, on and off pixel centers:
    below it nothing is gated and the rectangle is empty; at and above it
    the centre pixel is gated and held."""
    a = np.float32(blend.ALPHA_MIN)
    ops = [np.nextafter(a, np.float32(0)), a, np.nextafter(a, np.float32(1)),
           np.nextafter(np.nextafter(a, np.float32(1)), np.float32(1))]
    rng = np.random.default_rng(2)
    n = 64
    op = np.repeat(np.array(ops, np.float32), n // 4)
    means = np.concatenate([np.full((n // 2, 2), 21.0),              # on a pixel
                            rng.uniform(16, 32, (n // 2, 2))]).astype(np.float32)
    means = means[rng.permutation(n)]
    geom = geometry(means, conics(rng, n, 0.3, 3.0), op)
    gate, hits = check(geom, (1, 1))
    low = torch.from_numpy(op < a)
    assert not bool(gate[low].any()) and not bool(hits[low].any())
    r = blend.cull_rects(geom)
    assert bool((r[0][low] == float("inf")).all())
    on_pixel = torch.from_numpy((means == 21.0).all(1) & (op >= a))
    assert bool(gate[on_pixel].any(1).all())


def test_opacity_past_the_clamp():
    """op from 0.99 to 50 (alpha clamps at 0.99 near the mean): the q of
    2 ln(255 op) grows and the rectangle with it."""
    rng = np.random.default_rng(3)
    n = 2000
    op = np.exp(rng.uniform(np.log(0.99), np.log(50.0), n))
    means = rng.uniform(-10, 42, (n, 2)) + 16
    gate, _ = check(geometry(means, conics(rng, n, 0.5, 6.0), op), (1, 1))
    assert bool(gate.any())


@pytest.mark.parametrize("tile_xy", [(1, 1), (95, 70)])
def test_thin_conics(tile_xy):
    """Condition number 1e4, long axes of 2-300 px through the tile, near
    the origin and near pixel (1520, 1120) where f32 means round coarser."""
    rng = np.random.default_rng(4)
    n = 2000
    x0, y0 = tile_xy[0] * TILE, tile_xy[1] * TILE
    means = rng.uniform(-20, 36, (n, 2)) + [x0, y0]
    op = rng.uniform(0.02, 1.5, n)
    gate, hits = check(geometry(means, conics(rng, n, 2.0, 300.0, cond=1e4),
                                op), tile_xy)
    assert bool(gate.any()) and not bool(hits.all())


def test_means_off_the_tile():
    """Large splats whose means sit 20-400 px off the tile still reach it."""
    rng = np.random.default_rng(5)
    n = 2000
    ang = rng.uniform(0, 2 * np.pi, n)
    dist = rng.uniform(20, 400, n)
    means = 24 + np.stack([dist * np.cos(ang), dist * np.sin(ang)], -1)
    gate, _ = check(geometry(means, conics(rng, n, 5.0, 150.0),
                             rng.uniform(0.1, 1.0, n)), (1, 1))
    assert bool(gate.any())


def test_null_slots_and_forms_that_are_not_positive_definite():
    """Null slots (op 0, zero geometry) get an empty rectangle and no gate;
    a det <= 0 conic gets no cull at all, and its gate does open."""
    rng = np.random.default_rng(6)
    null = torch.zeros(8, 32)
    gate, hits = check(null, (1, 1))
    assert not bool(gate.any()) and not bool(hits.any())
    con = np.array([[1.0, 2.0, 1.0], [0.5, 0.0, -0.5], [0.0, 0.0, 0.0],
                    [-1.0, 0.0, -1.0]], np.float32)
    means = rng.uniform(16, 32, (4, 2))
    geom = geometry(means, con, np.full(4, 0.8))
    gate, hits = check(geom, (1, 1))
    r = blend.cull_rects(geom)
    assert bool((r[0] == -float("inf")).all() and (r[1] == float("inf")).all())
    assert bool(hits.all()) and bool(gate[:3].any(1).all())
