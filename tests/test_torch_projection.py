"""Port vs JAX package: ops/projection.py, every Projected field."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2m_tpu.ops.projection import compute_cov2d as jcov2d
from gs2m_tpu.ops.projection import project as jproject
from gs2m_tpu_torch.ops.projection import compute_cov2d as tcov2d
from gs2m_tpu_torch.ops.projection import project as tproject

from tests.test_torch_core import camera_pair, port_gaussians, random_pose_scene

torch.set_num_threads(1)

INT_FIELDS = ("radii", "rect_min", "rect_max", "tiles_touched", "valid")


def _compare(jp, tp):
    for name in jp._fields:
        a, b = np.asarray(getattr(jp, name)), getattr(tp, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if name in INT_FIELDS:
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, atol=1e-5, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("seed,sh_degree,size", [(0, 1, (64, 48)),
                                                 (1, 2, (48, 64)),
                                                 (2, 3, (96, 80)),
                                                 (3, 0, (33, 17))])
def test_projected_fields_match(seed, sh_degree, size):
    g = random_pose_scene(seed, n=90, capacity=128, sh_degree=sh_degree)
    tg = port_gaussians(g)
    jc, tc = camera_pair(*size, dist=3.0 + seed)
    # Boosted, clamped opacities exercise the opacity-aware rect.
    op = np.minimum(np.asarray(g.get_opacity[:, 0]) * (2.0 + seed), 0.995)
    jp = jproject(g, jc, g.max_sh_degree, opacities=jnp.asarray(op))
    tp = tproject(tg, tc, tg.max_sh_degree, torch.from_numpy(op))
    _compare(jp, tp)
    assert int(tp.valid.sum()) > 0


def test_behind_camera_probe():
    g = random_pose_scene(4, n=40, capacity=48)
    params = {k: np.asarray(v) for k, v in g.params_dict().items()}
    params["xyz"] = params["xyz"] - np.array([0.0, 0.0, 10.0], np.float32)
    g = dataclasses.replace(g, xyz=jnp.asarray(params["xyz"]))
    tg = port_gaussians(g)
    jc, tc = camera_pair(64, 48)
    op = np.array(g.get_opacity[:, 0])
    jp = jproject(g, jc, 1, opacities=jnp.asarray(op))
    tp = tproject(tg, tc, 1, torch.from_numpy(op))
    _compare(jp, tp)
    assert not bool(tp.valid.any())
    assert bool(torch.isfinite(tp.means2d).all() & torch.isfinite(tp.conics).all())


def test_cov2d_matches():
    g = random_pose_scene(5, n=64, capacity=64)
    tg = port_gaussians(g)
    jc, tc = camera_pair(64, 64)
    a = jcov2d(g.xyz, g.get_covariance(), jc)
    b = tcov2d(tg.xyz, tg.get_covariance(), tc)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5, rtol=1e-5)
