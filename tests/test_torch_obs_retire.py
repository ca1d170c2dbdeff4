"""K3's retirement rule: once a pixel's running test = logT0 + cum has
fallen below LOG_HALF - RETIRE_MARGIN (ops/blend.py::LOG_RETIRE, the value
csrc/blend_obs.cu is launched with), no later instance is counted at that
pixel (contributing with logT_excl > LOG_HALF). K3 skips those steps, so the
rule must hold exactly for its counts to equal K1's.

Each case walks one tile's instances chunk by chunk at chunks 32, 256 and
1024: ops/blend.py::chunk_walk gives each step's alpha and log1p(-alpha),
and the running sum, the test, logT_excl and the (logT, done) carries
across chunk boundaries are formed as K3 forms them, one f32 add at a time.
The same stacks go through K3 on the card in
tests/test_torch_cuda.py::test_k3_at_the_half_transmittance_edge. Seeded
numpy geometry:
  - stacks: at each pixel, n identical Gaussians (n = 1 ... 64) centred on
    it, so narrow that no other pixel sees them, with alpha within 3 f32
    ulps of 1 - 2^(-1/n) on either side, so T after the stack sits at 0.5 to
    within a few ulps; then followers, some past the 0.99 clamp. The stacks
    are interleaved in order and shuffled across chunk boundaries;
  - generic: splats of 0.5-8 px around the tile, opacities up to 1.5.

Margin 0 (retiring at test < LOG_HALF) would fail: over stack seeds 0-11,
in order / shuffled, 7 / 4 of 12 at chunk 256 and 7 / 6 of 12 at chunk 1024
(none at chunk 32) had one or two counted steps after the pixel's test fell
an ulp or two below LOG_HALF; the two stack cases here are two of those
seeds (test_margin_zero_would_fail).
The largest rise of a logT_excl over the test before it in these cases is
9.5e-7, so RETIRE_MARGIN = 1e-4 keeps a factor of 100.
"""
import numpy as np
import pytest
import torch

from gs2m_tpu_torch.ops import blend
from test_torch_cull import conics, geometry

TILE, P = 16, 256
TX, TY, GRID_X = 1, 1, 3          # the tile walked, in a 48x48 image
WIDTH = HEIGHT = 48
STACK_N = (1, 2, 3, 5, 7, 10, 16, 31, 33, 64)
ULPS = (-3, -2, -1, 0, 1, 2, 3)


def stacks(seed: int, shuffle: bool) -> torch.Tensor:
    """(8, I) instances: one stack at each pixel of the tile."""
    rng = np.random.default_rng(seed)
    pix, rank, ops = [], [], []
    for p in range(P):
        n = STACK_N[p % len(STACK_N)]
        u = ULPS[(p // len(STACK_N)) % len(ULPS)]
        a = np.float32(1.0 - 2.0 ** (-1.0 / n))
        for _ in range(abs(u)):
            a = np.nextafter(a, np.float32(2.0 if u > 0 else 0.0))
        # A first follower with log1m in (-4, -2): cum + log1m rounds at
        # 2-4 ulps of LOG_HALF, so its logT_excl may land above the test
        # before it.
        follow = np.concatenate([rng.uniform(0.86, 0.98, 1),
                                 rng.uniform(0.02, 0.6, 2),
                                 rng.uniform(0.99, 2.0, 1),
                                 rng.uniform(0.02, 0.6, 2)]).astype(np.float32)
        stack = np.concatenate([np.full(n, a, np.float32), follow])
        pix += [p] * len(stack)
        rank += list(range(len(stack)))
        ops += list(stack)
    pix, rank = np.array(pix), np.array(rank, np.float64)
    # Round-robin over the stacks; the jitter keeps each stack's own order
    # and moves its steps across chunk boundaries.
    key = rank + (rng.uniform(0, 0.99, len(rank)) if shuffle else pix / P)
    order = np.argsort(key, kind="stable")
    means = np.stack([TX * TILE + pix % TILE, TY * TILE + pix // TILE], -1)
    con = np.tile(np.float32([100.0, 0.0, 100.0]), (len(pix), 1))
    return geometry(means[order], con[order], np.array(ops)[order])


def generic(seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    n = 3000
    con = conics(rng, n, 0.5, 8.0)
    means = rng.uniform(-8, 24, (n, 2)) + [TX * TILE, TY * TILE]
    return geometry(means, con, rng.uniform(0.0, 1.5, n))


def walk(geom: torch.Tensor, chunk: int, threshold: float):
    """Walk geom (8, I) at the tile's pixels in chunks of `chunk` (padded
    with null slots); return (counted steps, counted steps that follow, at
    the same pixel, a step whose running test fell below threshold, pixels
    that fell below it, the largest rise of a step's logT_excl over the
    test before it at a pixel that is not done).

    The alphas and log1p(-alpha) come from chunk_walk; the running sum, the
    test, logT_excl and the carries are then formed as K3 forms them, one
    f32 add at a time (torch.cumsum on the CPU adds f32 in double)."""
    pad = -geom.shape[1] % chunk
    geom = torch.cat([geom, geom.new_zeros(8, pad)], dim=1)
    tiles = torch.tensor([TY * GRID_X + TX])
    px, py = blend.pixel_coords(tiles, TILE, GRID_X)
    logT = np.zeros(P, np.float32)
    done = np.zeros(P, bool)
    fell = np.zeros(P, bool)         # below threshold at an earlier step
    counted = late = 0
    rise = -np.inf
    for gc in torch.split(geom.T, chunk):
        st = blend.chunk_walk(gc[None, :, :, None], px, py,
                              torch.from_numpy(logT)[None],
                              torch.from_numpy(done)[None],
                              width=WIDTH, height=HEIGHT)
        alpha, log1m = st.alpha[0].numpy(), st.log1m[0].numpy()
        cum = np.zeros(P, np.float32)
        contributed = np.zeros(P, np.float32)
        last = logT
        for k in range(len(gc)):
            cum = cum + log1m[k]
            test = logT + cum
            done = done | (test < blend.LOG_EPS)
            excl = test - log1m[k]
            if not done.all():
                rise = max(rise, float((excl - last)[~done].max()))
            contribute = (alpha[k] > 0) & ~done
            seen = contribute & (excl > blend.LOG_HALF)
            counted += int(seen.sum())
            late += int((seen & fell).sum())
            fell |= test < threshold
            contributed = contributed + np.where(contribute, log1m[k],
                                                 np.float32(0))
            last = test
        logT = logT + contributed
    return counted, late, int(fell.sum()), rise


CASES = {"stacks": lambda: stacks(4, False),
         "stacks_shuffled": lambda: stacks(11, True),
         "generic": lambda: generic(2)}


@pytest.mark.parametrize("chunk", [32, 256, 1024])
@pytest.mark.parametrize("case", list(CASES))
def test_no_count_after_retirement(case, chunk):
    counted, late, retired, rise = walk(CASES[case](), chunk,
                                        blend.LOG_RETIRE)
    assert late == 0, f"{late} counted steps after retirement"
    # Not vacuous: steps are counted, and pixels retire with steps after.
    assert counted > 0 and retired > P // 2, (counted, retired)
    # The rounding the margin covers, with a factor of 100 to spare.
    assert rise < blend.RETIRE_MARGIN / 100, rise


def test_margin_is_the_kernels():
    """The threshold is LOG_HALF - RETIRE_MARGIN rounded to f32, below
    LOG_HALF and above termination."""
    assert blend.LOG_RETIRE == float(np.float32(blend.LOG_HALF
                                                - blend.RETIRE_MARGIN))
    assert blend.LOG_EPS < blend.LOG_RETIRE < blend.LOG_HALF


def test_margin_zero_would_fail():
    """Retiring at test < LOG_HALF exactly would lose counts: at the stacks
    whose T sits an ulp or two below 0.5, the next step's logT_excl can round
    back above LOG_HALF."""
    late = [walk(CASES[case](), chunk, blend.LOG_HALF)[1]
            for case in ("stacks", "stacks_shuffled") for chunk in (256, 1024)]
    assert sum(late) > 0, late
