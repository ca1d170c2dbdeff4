"""Port vs JAX package: ops/blend.py — K1's plain version against the Pallas
kernel (interpret mode) on identical inputs, and blend_tiles against
blend_tiles_xla.

Tolerances are the JAX package's own pallas-vs-xla ones
(tests/test_pallas.py): img/fT/clogT atol 1e-5, rtol 1e-4; cdone and the
observe counts exactly equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2m_tpu.core.gaussians import Gaussians as JGaussians
from gs2m_tpu.ops.binning import bin_gaussians as jbin
from gs2m_tpu.ops.blend_pallas import _gather_instances, _run_forward
from gs2m_tpu.ops.blend_xla import blend_tiles_xla
from gs2m_tpu.ops.projection import project as jproject
from gs2m_tpu.ops.rasterize import build_features, pack_values
from gs2m_tpu_torch.ops import blend as tblend
from gs2m_tpu_torch.ops.binning import Binning as TBinning
from gs2m_tpu_torch.ops.binning import num_tiles

from tests.test_torch_core import camera_pair, random_pose_scene

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def occluded_scene():
    """96 stacked near-opaque Gaussians on the optical axis: termination,
    and whole chunks that start terminated."""
    n = 96
    pts = np.zeros((n, 3), np.float32)
    pts[:, 2] = np.linspace(-0.5, 0.5, n)
    cols = np.random.default_rng(10).uniform(0, 1, (n, 3)).astype(np.float32)
    return JGaussians.create(pts, cols, 0, capacity=n,
                             mean_sq_dist=np.full(n, 0.05))


def small_cluster():
    """A few small splats near the center: most tiles stay empty."""
    rng = np.random.default_rng(3)
    pts = (0.1 * rng.normal(size=(4, 3))).astype(np.float32)
    cols = rng.uniform(0, 1, (4, 3)).astype(np.float32)
    return JGaussians.create(pts, cols, 1, capacity=8,
                             mean_sq_dist=np.full(4, 1e-3))


CASES = {
    # name: (scene, (W, H), opacity boost, chunk, instance cap)
    "scene_chunk64": (lambda: random_pose_scene(7, n=80, capacity=128),
                      (64, 48), 8.0, 64, 2 ** 13),
    "scene_chunk256": (lambda: random_pose_scene(12, n=80, capacity=128),
                       (64, 48), 8.0, 256, 2 ** 13),
    "heavy_occlusion": (occluded_scene, (32, 32), 9.9, 64, 2 ** 12),
    # opacity 0.995: alpha reaches the 0.99 clamp near the centers
    "clamp": (occluded_scene, (32, 32), 9.95, 64, 2 ** 12),
    "empty_tiles": (small_cluster, (96, 80), 8.0, 64, 2 ** 11),
    "overflow": (lambda: random_pose_scene(7, n=80, capacity=128),
                 (64, 48), 8.0, 64, 6 * 64),
}


def setup(case):
    make, (W, H), boost, chunk, cap = CASES[case]
    g = make()
    jc, _ = camera_pair(W, H)
    op = jnp.minimum(g.get_opacity[:, 0] * boost, 0.995)
    proj = jproject(g, jc, g.max_sh_degree, opacities=op)
    values = pack_values(proj.colors, build_features(g, jc), 10)
    b = jbin(proj, H, W, 16, cap, chunk, opacities=op)
    return proj, op, values, b, (H, W), chunk


@pytest.mark.parametrize("case", list(CASES))
def test_plain_k1_matches_pallas_kernel(case):
    proj, op, values, b, (H, W), chunk = setup(case)
    grid_y, grid_x = num_tiles(H, W, 16)
    T = grid_y * grid_x
    n_chunks = b.gid.shape[0] // chunk
    geom, vals = _gather_instances(values, proj.means2d, proj.conics, op,
                                   b.gid, b.is_null)
    ref = [np.asarray(x) for x in _run_forward(
        geom, vals, b.chunk_tile, T=T, n_chunks=n_chunks, chunk=chunk, tile=16,
        grid_x=grid_x, width=W, height=H, interpret=True)]
    before = dict(tblend.LAUNCHES)
    got = tblend.blend_fwd(_t(geom), _t(vals), _t(b.chunk_tile), T=T,
                           grid_x=grid_x, width=W, height=H, tile=16,
                           chunk=chunk)
    assert tblend.LAUNCHES == before  # CPU tensors never launch the kernel
    # The Pallas kernel leaves rows of tiles no chunk visits unwritten.
    rows = np.unique(np.asarray(b.chunk_tile))
    for name, a, x in zip(tblend.FwdRaw._fields, ref, got):
        x = x.numpy()
        assert a.shape == x.shape and a.dtype == x.dtype, name
        if name in ("img", "fT"):
            a, x = a[rows], x[rows]
        if name in ("cdone", "obs"):
            np.testing.assert_array_equal(x, a, err_msg=name)
        else:
            np.testing.assert_allclose(x, a, atol=1e-5, rtol=1e-4, err_msg=name)
    if case == "heavy_occlusion":
        assert float(got.fT[:T].min()) < 1e-3 and got.cdone.any()
    if case == "overflow":
        assert int(b.dropped) > 0


@pytest.mark.parametrize("case", ["scene_chunk64", "heavy_occlusion",
                                  "empty_tiles", "overflow"])
def test_blend_tiles_matches_xla(case):
    proj, op, values, b, (H, W), chunk = setup(case)
    ref = blend_tiles_xla(values, proj.means2d, proj.conics, op, b, H, W, 16,
                          chunk)
    tb = TBinning(*[_t(x) for x in b])
    got = tblend.blend_tiles(_t(values), _t(proj.means2d), _t(proj.conics),
                             _t(op), tb, H, W, 16, chunk)
    np.testing.assert_allclose(got.image.numpy(), np.asarray(ref.image),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got.final_T.numpy(), np.asarray(ref.final_T),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_array_equal(got.observe.numpy(), np.asarray(ref.observe))
    if case == "empty_tiles":
        empty = ~np.asarray(b.tile_nonempty)
        assert empty.any()
        fT = got.final_T.numpy().reshape(H // 16, 16, W // 16, 16)
        assert (fT.transpose(0, 2, 1, 3).reshape(-1, 256)[empty] == 1.0).all()


def test_kernel_wrapper_rejects_unsupported_shapes():
    """The CUDA wrapper validates before touching the card."""
    geom = torch.zeros(8, 64)
    with pytest.raises(ValueError, match="tile 16"):
        tblend._launch_blend_fwd(geom, torch.zeros(12, 64),
                                 torch.zeros(1, dtype=torch.int32), T=1,
                                 grid_x=1, width=16, height=16, tile=16,
                                 chunk=64)
    with pytest.raises(ValueError, match="contiguous"):
        tblend._launch_blend_fwd(geom, torch.zeros(8, 64),
                                 torch.zeros(1, dtype=torch.int64), T=1,
                                 grid_x=1, width=16, height=16, tile=16,
                                 chunk=64)
