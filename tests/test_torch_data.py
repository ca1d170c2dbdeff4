"""Port vs JAX package: PLY snapshots, COLMAP readers, scene cameras."""
import json
import os

import numpy as np
import pytest
import torch

from gs2m_tpu.data import colmap as jcm
from gs2m_tpu.data import ply as jply
from gs2m_tpu.data import readers as jrd
from gs2m_tpu_torch.data import colmap as tcm
from gs2m_tpu_torch.data import ply as tply
from gs2m_tpu_torch.data import readers as trd

torch.set_num_threads(1)


def _raw_params(seed, n=37, sh_degree=2):
    rng = np.random.default_rng(seed)
    K = (sh_degree + 1) ** 2
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(xyz=f(n, 3), f_dc=f(n, 1, 3), f_rest=f(n, K - 1, 3),
                opacity=f(n, 1), scaling=f(n, 3), rotation=f(n, 4),
                albedo=f(n, 3), roughness=f(n, 1), metallic=f(n, 1))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_gaussian_ply_interop(tmp_path, writer):
    raw = _raw_params(1)
    order = ["xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation",
             "albedo", "roughness", "metallic"]
    path = str(tmp_path / f"{writer}.ply")
    (jply if writer == "jax" else tply).save_gaussian_ply(
        path, *[raw[k] for k in order])
    for reader in (jply, tply):
        got = reader.load_gaussian_ply(path)
        assert sorted(got) == sorted(raw)
        for k in order:
            np.testing.assert_array_equal(got[k], raw[k], err_msg=k)


def test_ply_files_byte_identical(tmp_path):
    raw = _raw_params(2, sh_degree=3)
    order = ["xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation",
             "albedo", "roughness", "metallic"]
    jply.save_gaussian_ply(str(tmp_path / "a.ply"), *[raw[k] for k in order])
    tply.save_gaussian_ply(str(tmp_path / "b.ply"), *[raw[k] for k in order])
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
    rng = np.random.default_rng(0)
    xyz, rgb = rng.normal(size=(20, 3)), rng.uniform(0, 255, (20, 3))
    jply.store_point_cloud(str(tmp_path / "c.ply"), xyz, rgb)
    tply.store_point_cloud(str(tmp_path / "d.ply"), xyz, rgb)
    assert (tmp_path / "c.ply").read_bytes() == (tmp_path / "d.ply").read_bytes()
    for a, b in zip(jply.fetch_point_cloud(str(tmp_path / "c.ply")),
                    tply.fetch_point_cloud(str(tmp_path / "d.ply"))):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def synthetic_scene(tmp_path_factory):
    from tests.make_synthetic_scene import build

    return build(str(tmp_path_factory.mktemp("scene")), n_views=4, width=64,
                 height=48, n_points=150)


@pytest.mark.parametrize("eval_split", [False, True])
def test_colmap_scene_reads_identically(synthetic_scene, eval_split):
    js = jrd.detect_and_read_scene(synthetic_scene, eval_split=eval_split)
    ts = trd.detect_and_read_scene(synthetic_scene, eval_split=eval_split)
    for name in ("points", "colors", "normals", "translate"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name))
    assert ts.radius == js.radius and ts.ply_path == js.ply_path
    for split in ("train_cameras", "test_cameras"):
        ja, tb = getattr(js, split), getattr(ts, split)
        assert len(ja) == len(tb)
        for a, b in zip(ja, tb):
            for f in ("uid", "fx", "fy", "width", "height", "image_name",
                      "image_path", "mask_path", "depth_path"):
                assert getattr(a, f) == getattr(b, f), f
            np.testing.assert_array_equal(a.R, b.R)
            np.testing.assert_array_equal(a.T, b.T)
    info = ts.train_cameras[0]
    for res in [(64, 48), (32, 24)]:
        for x, y in zip(jrd.load_view_arrays(info, res),
                        trd.load_view_arrays(info, res)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("args", [(64, 48, -1), (3200, 2400, -1),
                                  (100, 80, 2), (100, 80, 50),
                                  (640, 480, 4)])
def test_pick_resolution(args):
    assert trd.pick_resolution(*args) == jrd.pick_resolution(*args)
    assert trd.pick_resolution(*args, 2.0) == jrd.pick_resolution(*args, 2.0)


def test_colmap_text_readers(tmp_path):
    (tmp_path / "cameras.txt").write_text(
        "# c\n1 PINHOLE 64 48 50.0 51.0 32.0 24.0\n2 SIMPLE_PINHOLE 8 6 5 4 3\n")
    (tmp_path / "images.txt").write_text(
        "# i\n1 1.0 0.0 0.0 0.0 0.1 0.2 4.0 1 a.png\n5 6 -1\n"
        "2 0.9 0.1 0.3 0.2 -1 0 3 2 b.png\n1 2 3\n")
    (tmp_path / "points3D.txt").write_text(
        "# p\n1 0.5 0.25 -1 10 20 30 0.1 1 0\n2 1 2 3 255 0 7 0.5\n")
    for jf, tf, name in ((jcm.read_cameras_text, tcm.read_cameras_text, "cameras"),
                         (jcm.read_images_text, tcm.read_images_text, "images")):
        a, b = jf(str(tmp_path / f"{name}.txt")), tf(str(tmp_path / f"{name}.txt"))
        assert a.keys() == b.keys()
        for k in a:
            for f, v in vars(a[k]).items():
                np.testing.assert_array_equal(getattr(b[k], f), v)
    for x, y in zip(jcm.read_points3d_text(str(tmp_path / "points3D.txt")),
                    tcm.read_points3d_text(str(tmp_path / "points3D.txt"))):
        np.testing.assert_array_equal(x, y)
    R = jcm.qvec_to_rotmat(np.array([0.9, 0.1, 0.3, 0.2]) / np.linalg.norm(
        [0.9, 0.1, 0.3, 0.2]))
    np.testing.assert_array_equal(tcm.rotmat_to_qvec(R), jcm.rotmat_to_qvec(R))


def test_scene_cameras_and_model_files(synthetic_scene, tmp_path):
    from gs2m_tpu.core.config import ModelConfig as JModel
    from gs2m_tpu.data.scene import Scene as JScene
    from gs2m_tpu_torch.core.config import ModelConfig as TModel
    from gs2m_tpu_torch.data.scene import Scene as TScene, search_max_iteration

    js = JScene(JModel(source_path=synthetic_scene,
                       model_path=str(tmp_path / "j"), resolution=2),
                shuffle=True, load_images=False)
    ts = TScene(TModel(source_path=synthetic_scene,
                       model_path=str(tmp_path / "t"), resolution=2),
                shuffle=True, load_images=False, device="cpu")
    assert js.cameras_extent == ts.cameras_extent
    assert len(js.train_cameras) == len(ts.train_cameras) == 4
    for a, b in zip(js.train_cameras, ts.train_cameras):
        assert (a.width, a.height) == (b.width, b.height) == (32, 24)
        np.testing.assert_array_equal(np.asarray(a.full_proj), b.full_proj.numpy())
    for f in ("cameras.json", "input.ply"):
        assert (tmp_path / "j" / f).read_bytes() == (tmp_path / "t" / f).read_bytes()
    assert json.loads((tmp_path / "t" / "cameras.json").read_text())[0]["id"] == 0
    # With the GT stacks (the training side): the same pixels as the JAX
    # package's.
    jl = JScene(JModel(source_path=synthetic_scene, resolution=2))
    tl = TScene(TModel(source_path=synthetic_scene, resolution=2), device="cpu")
    for name in ("gt_images", "alpha_masks"):
        np.testing.assert_array_equal(getattr(tl, name).numpy(),
                                      np.asarray(getattr(jl, name)), name)
    for it in (7, 30):
        os.makedirs(tmp_path / "pc" / f"iteration_{it}")
    assert search_max_iteration(str(tmp_path / "pc")) == 30
