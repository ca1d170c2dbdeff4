"""Port vs JAX package: the mesh path — TSDF fusion, marching tetrahedra,
cluster cleanup and the mesh PLY helpers.

The scene is tests/test_mesh.py's: analytic ray-sphere depths from a ring
of 12 cameras, here with seeded per-pixel colors. Fusion: `block_coords`
equal; at least 99.9 % of voxels with equal weight (a voxel center that
projects within an ulp of a pixel edge may round to the neighbor pixel:
the JAX package's view transform is a matmul, the port's an elementwise
sum), tsdf and color within 1e-5 there. Marching and cleanup take one JAX
volume through both packages: faces equal, vertices and colors within
1e-6, the cleaned meshes equal.
"""
import numpy as np
import pytest
import torch

from gs2m_tpu.core.camera import Camera as JCamera
from gs2m_tpu.data.ply import fetch_mesh as jfetch_mesh
from gs2m_tpu.data.ply import store_mesh as jstore_mesh
from gs2m_tpu.mesh import fuse_depths as jfuse
from gs2m_tpu.mesh import keep_largest_clusters as jkeep
from gs2m_tpu.mesh import marching_tetrahedra_blocks as jmarch
from gs2m_tpu_torch.core.camera import Camera
from gs2m_tpu_torch.data.ply import fetch_mesh, store_mesh
from gs2m_tpu_torch.mesh import (TSDFVolume, fuse_depths,
                                 keep_largest_clusters,
                                 marching_tetrahedra_blocks)
from gs2m_tpu_torch.mesh.marching import _unique_rows
from gs2m_tpu_torch.mesh.tsdf import block_keys, keys_to_coords

from tests.make_synthetic_scene import ring_camera
from tests.test_mesh import sphere_depth

torch.set_num_threads(1)

W, H = 96, 72
FUSE = dict(voxel_size=0.05, sdf_trunc=0.15, max_depth=8.0)
BOUNDS = np.array([[-2.0, 0.0], [-2.0, 2.0], [-2.0, 2.0]])


@pytest.fixture(scope="module")
def views():
    rng = np.random.default_rng(0)
    jcams, tcams, depths = [], [], []
    for i in range(12):
        R, T = ring_camera(2 * np.pi * i / 12, dist=4.0, height=0.5)
        jcams.append(JCamera.create(R, T, fovx=0.7, fovy=0.55, width=W,
                                    height=H))
        tcams.append(Camera.create(R, T, fovx=0.7, fovy=0.55, width=W,
                                   height=H, device="cpu"))
        depths.append(sphere_depth(jcams[-1]))
    colors = rng.uniform(0, 1, (12, 3, H, W)).astype(np.float32)
    # Alpha masks that cut each view at a different column.
    cut = rng.integers(W // 3, W, 12)
    alpha = (np.arange(W)[None, None, None, :] < cut[:, None, None, None]
             ).astype(np.float32) * np.ones((12, 1, H, 1), np.float32)
    return jcams, tcams, np.stack(depths), colors, alpha


def port_volume(jv) -> TSDFVolume:
    t = lambda x: torch.from_numpy(np.array(x))
    return TSDFVolume(t(jv.block_coords), t(jv.tsdf), t(jv.weight),
                      t(jv.color), jv.voxel_size, jv.sdf_trunc)


@pytest.fixture(scope="module")
def jax_volume(views):
    jcams, _, depths, colors, _ = views
    return jfuse(depths, colors, jcams, **FUSE)


@pytest.mark.parametrize("mode", ["plain", "alpha", "bounds"])
def test_fuse_depths_matches_jax(views, jax_volume, mode):
    jcams, tcams, depths, colors, alpha = views
    kw = dict(FUSE, alpha_masks=alpha if mode == "alpha" else None,
              bounds=BOUNDS if mode == "bounds" else None)
    jv = jax_volume if mode == "plain" else jfuse(depths, colors, jcams, **kw)
    stages = {}
    tv = fuse_depths(depths, colors, tcams, stages=stages, **kw)
    assert set(stages) == {"discover", "integrate"}
    np.testing.assert_array_equal(tv.block_coords.numpy(), jv.block_coords)
    assert tv.block_coords.shape[0] > 100
    eq = tv.weight.numpy() == jv.weight
    assert eq.mean() >= 0.999, eq.mean()
    assert (jv.weight > 0).mean() > 0.05
    np.testing.assert_allclose(tv.tsdf.numpy()[eq], jv.tsdf[eq], atol=1e-5)
    np.testing.assert_allclose(tv.color.numpy()[eq], jv.color[eq], atol=1e-5)
    assert tv.voxel_size == jv.voxel_size and tv.sdf_trunc == jv.sdf_trunc


def test_fusion_does_not_depend_on_the_slab_size(views):
    _, tcams, depths, colors, alpha = views
    a = fuse_depths(depths, colors, tcams, alpha_masks=alpha, **FUSE)
    b = fuse_depths(depths, colors, tcams, alpha_masks=alpha,
                    slab_blocks=37, **FUSE)
    for name in ("block_coords", "tsdf", "weight", "color"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_empty_fusion_gives_an_empty_mesh(views):
    jcams, tcams, depths, colors, _ = views
    jv = jfuse(np.zeros_like(depths), colors, jcams, **FUSE)
    tv = fuse_depths(np.zeros_like(depths), colors, tcams, **FUSE)
    assert tv.block_coords.shape == jv.block_coords.shape == (0, 3)
    assert tv.tsdf.shape == jv.tsdf.shape
    v, f, c = marching_tetrahedra_blocks(tv)
    assert v.shape == f.shape == c.shape == (0, 3)


def test_marching_and_cleanup_match_jax(jax_volume):
    jv = jax_volume
    jvs, jf, jc = jmarch(jv)
    stages = {}
    tvs, tf, tc = marching_tetrahedra_blocks(port_volume(jv), stages=stages)
    assert set(stages) == {"march", "weld"}
    assert tf.dtype == torch.int64 and len(jf) > 1000
    np.testing.assert_array_equal(tf.numpy(), jf)
    np.testing.assert_allclose(tvs.numpy(), jvs, atol=1e-6)
    np.testing.assert_allclose(tc.numpy(), jc, atol=1e-6)

    # A floating triangle island: both cleanups drop it, equally.
    extra_v = np.array([[5, 5, 5], [5.1, 5, 5], [5, 5.1, 5]], np.float32)
    v2 = np.concatenate([jvs, extra_v])
    f2 = np.concatenate([jf, np.array([[0, 1, 2]]) + len(jvs)])
    c2 = np.concatenate([jc, np.zeros((3, 3), np.float32)])
    for got, want in zip(keep_largest_clusters(v2, f2, c2, 1),
                         jkeep(v2, f2, c2, 1)):
        np.testing.assert_array_equal(got, want)
    assert len(keep_largest_clusters(v2, f2, c2, 1)[1]) < len(f2)


def test_marching_does_not_depend_on_the_slab_size(jax_volume):
    vol = port_volume(jax_volume)
    a = marching_tetrahedra_blocks(vol)
    b = marching_tetrahedra_blocks(vol, slab_blocks=13)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_block_keys_and_row_ranks_are_lexicographic():
    rng = np.random.default_rng(1)
    q = rng.integers(-40, 40, (5000, 3))
    q[4000:] = q[:1000]                  # duplicates
    keys = block_keys(torch.from_numpy(q))
    np.testing.assert_array_equal(keys_to_coords(keys).numpy(), q)
    order = np.lexsort((q[:, 2], q[:, 1], q[:, 0]))
    np.testing.assert_array_equal(torch.argsort(keys, stable=True).numpy(),
                                  order)
    uniq, inv, _ = _unique_rows(torch.from_numpy(q))
    ju, jinv = np.unique(q, axis=0, return_inverse=True)
    np.testing.assert_array_equal(uniq.numpy(), ju)
    np.testing.assert_array_equal(inv.numpy(), jinv.reshape(-1))
    with pytest.raises(ValueError, match="block coordinates"):
        block_keys(torch.tensor([[0, 2 ** 20, 0]]))


# --- tests/test_mesh.py's sphere assertions, on the port alone ---------------

@pytest.fixture(scope="module")
def port_sphere(views):
    _, tcams, depths, _, _ = views
    vol = fuse_depths(depths, np.full((12, 3, H, W), 0.5, np.float32), tcams,
                      **FUSE)
    return vol, marching_tetrahedra_blocks(vol)


def test_port_tsdf_volume_sane(port_sphere):
    vol, _ = port_sphere
    assert vol.block_coords.shape[0] > 0
    seen = vol.weight > 0
    assert bool(seen.any())
    vals = vol.tsdf[seen]
    assert float(vals.min()) < -0.1 and float(vals.max()) > 0.1


def test_port_marching_tets_reconstructs_sphere(port_sphere):
    _, (verts, faces, cols) = port_sphere
    verts, faces, cols = verts.numpy(), faces.numpy(), cols.numpy()
    assert len(verts) > 200 and len(faces) > 200
    r = np.linalg.norm(verts, axis=1)
    assert abs(np.median(r) - 1.0) < 0.08
    assert np.quantile(np.abs(r - 1.0), 0.9) < 0.12
    assert np.isfinite(cols).all()
    assert len(verts) < 1.2 * len(faces)


def test_port_cluster_cleanup_removes_floaters(port_sphere):
    _, (verts, faces, cols) = port_sphere
    verts, faces, cols = verts.numpy(), faces.numpy(), cols.numpy()
    extra_v = np.array([[5, 5, 5], [5.1, 5, 5], [5, 5.1, 5]], np.float32)
    v2 = np.concatenate([verts, extra_v])
    f2 = np.concatenate([faces, np.array([[0, 1, 2]]) + len(verts)])
    c2 = np.concatenate([cols, np.zeros((3, 3), np.float32)])
    v3, f3, _ = keep_largest_clusters(v2, f2, c2, clusters_to_keep=1)
    assert 0.95 * len(faces) <= len(f3) <= len(faces)
    assert (np.linalg.norm(v3, axis=1) < 2.0).all()


def test_port_bounds_masking(views):
    _, tcams, depths, colors, _ = views
    vol = fuse_depths(depths, colors, tcams, bounds=BOUNDS, **FUSE)
    verts, _, _ = marching_tetrahedra_blocks(vol)
    assert len(verts) > 50
    assert np.quantile(verts[:, 0].numpy(), 0.95) < 0.15


@pytest.mark.parametrize("with_colors", [True, False])
def test_store_mesh_roundtrips_through_jax_fetch_mesh(tmp_path, with_colors):
    rng = np.random.default_rng(2)
    v = rng.normal(size=(40, 3)).astype(np.float32)
    f = rng.integers(0, 40, (60, 3))
    c = rng.uniform(0, 1, (40, 3)).astype(np.float32) if with_colors else None
    store_mesh(str(tmp_path / "port.ply"), v, f, c)
    jstore_mesh(str(tmp_path / "jax.ply"), v, f, c)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    for fetch in (jfetch_mesh, fetch_mesh):
        v2, f2, c2 = fetch(str(tmp_path / "port.ply"))
        np.testing.assert_array_equal(v2, v)
        np.testing.assert_array_equal(f2, f)
        if with_colors:
            np.testing.assert_array_equal(c2, np.clip(c * 255.0, 0, 255)
                                          .astype(np.uint8) / np.float32(255))
        else:
            assert c2 is None
