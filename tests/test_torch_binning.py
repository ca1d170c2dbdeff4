"""Port vs JAX package: ops/binning.py, the Binning contract exactly equal.

Both packages bin the SAME Projected (the JAX one, carried over), so any
difference is the binning's own.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2m_tpu.ops.binning import bin_gaussians as jbin
from gs2m_tpu.ops.projection import project as jproject
from gs2m_tpu_torch.ops.binning import bin_gaussians as tbin
from gs2m_tpu_torch.ops.projection import Projected as TProjected

from tests.test_torch_core import camera_pair, random_pose_scene

torch.set_num_threads(1)


def projected_pair(seed, n=120, size=(64, 48), boost=4.0):
    g = random_pose_scene(seed, n=n, capacity=128)
    jc, _ = camera_pair(*size)
    op = jnp.minimum(g.get_opacity[:, 0] * boost, 0.995)
    jp = jproject(g, jc, g.max_sh_degree, opacities=op)
    tp = TProjected(*[torch.from_numpy(np.array(x)) for x in jp])
    return jp, tp, op, torch.from_numpy(np.array(op))


def assert_binning_equal(jb, tb):
    for name in jb._fields:
        a, b = np.asarray(getattr(jb, name)), getattr(tb, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("chunk", [64, 128, 256])
@pytest.mark.parametrize("seed,size", [(0, (64, 48)), (1, (80, 72))])
def test_binning_exactly_equal(chunk, seed, size):
    jp, tp, jop, top = projected_pair(seed, size=size)
    H, W = size[1], size[0]
    jb = jbin(jp, H, W, 16, 2 ** 13, chunk, opacities=jop)
    tb = tbin(tp, H, W, 16, 2 ** 13, chunk, top)
    assert_binning_equal(jb, tb)
    assert int(tb.dropped) == 0 and int(tb.num_instances) > 0


@pytest.mark.parametrize("chunk", [64, 128])
def test_binning_overflow_equal(chunk):
    """A cap below the aligned demand: both the expansion and the alignment
    overflow paths, `dropped` and the cut tiles agree."""
    jp, tp, jop, top = projected_pair(2, size=(64, 48), boost=8.0)
    for cap in (2 * chunk, 6 * chunk):
        jb = jbin(jp, 48, 64, 16, cap, chunk, opacities=jop)
        tb = tbin(tp, 48, 64, 16, cap, chunk, top)
        assert_binning_equal(jb, tb)
        assert int(tb.dropped) > 0


def test_binning_empty_scene_equal():
    jp, tp, jop, top = projected_pair(3)
    jp = jp._replace(tiles_touched=jnp.zeros_like(jp.tiles_touched),
                     valid=jnp.zeros_like(jp.valid))
    tp = tp._replace(tiles_touched=torch.zeros_like(tp.tiles_touched),
                     valid=torch.zeros_like(tp.valid))
    jb = jbin(jp, 48, 64, 16, 2 ** 10, 64, opacities=jop)
    tb = tbin(tp, 48, 64, 16, 2 ** 10, 64, top)
    assert_binning_equal(jb, tb)
    assert not bool(tb.tile_nonempty.any()) and bool(tb.is_null.all())
