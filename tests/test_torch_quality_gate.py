"""The port's quality gate (apps/quality_gate.py) on the CPU: its scene
builder against tests/make_synthetic_scene.build (the same sparse/0 files,
byte for byte, and images within 1/255: the port's blend against the JAX
package's XLA twin), for the sphere and the composite scene; the composite's
points, colors and chamfer against the JAX package's; and a tiny gate run
through the train, render and metrics apps that writes a finite
quality_gate.json, then its --skip_train rerun on the same model.
"""
import json

import numpy as np
import pytest
import torch
from PIL import Image

from gs2m_tpu_torch.apps import quality_gate as qg

torch.set_num_threads(1)


@pytest.mark.parametrize("texture", ["noise", "smooth"])
def test_scene_builder_matches_make_synthetic_scene(tmp_path, texture):
    from tests.make_synthetic_scene import build

    kw = dict(n_views=4, width=48, height=36, n_points=200,
              opacity_boost=8.0, point_scale=0.06, texture=texture,
              sfm_fraction=0.25)
    ref = build(str(tmp_path / "jax"), scene="sphere", **kw)
    got = qg.build_scene(str(tmp_path / "port"), device="cpu", **kw)
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        a = (tmp_path / "jax" / "sparse/0" / name).read_bytes()
        assert (tmp_path / "port" / "sparse/0" / name).read_bytes() == a, name
    for i in range(4):
        a = np.asarray(Image.open(f"{ref}/images/view_{i:03d}.png"), np.int32)
        b = np.asarray(Image.open(f"{got}/images/view_{i:03d}.png"), np.int32)
        assert a.shape == b.shape and a.max() > 0
        assert np.abs(a - b).max() <= 1


def test_composite_data_matches_jax():
    from tests import make_synthetic_scene as mss

    for n, seed in ((500, 0), (1234, 3)):
        jp, jc = mss.make_composite_data(n, seed=seed)
        tp, tc = qg.make_composite_data(n, seed=seed)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tc, jc)
    pts = np.random.default_rng(2).uniform(-2, 2, (4000, 3))
    np.testing.assert_array_equal(qg.composite_surface_distance(pts),
                                  mss.composite_surface_distance(pts))


def test_composite_scene_matches_make_synthetic_scene(tmp_path):
    from tests.make_synthetic_scene import build

    n = 300
    kw = dict(n_views=4, width=48, height=36, n_points=n, opacity_boost=8.0,
              point_scale=qg.composite_point_scale(n), sfm_fraction=0.25)
    ref = build(str(tmp_path / "jax"), scene="composite", **kw)
    got = qg.build_scene(str(tmp_path / "port"), scene="composite",
                         device="cpu", **kw)
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        a = (tmp_path / "jax" / "sparse/0" / name).read_bytes()
        assert (tmp_path / "port" / "sparse/0" / name).read_bytes() == a, name
    for i in range(4):
        a = np.asarray(Image.open(f"{ref}/images/view_{i:03d}.png"), np.int32)
        b = np.asarray(Image.open(f"{got}/images/view_{i:03d}.png"), np.int32)
        assert a.shape == b.shape and a.max() > 0
        assert np.abs(a - b).max() <= 1


def test_composite_chamfer_matches_the_jax_script(tmp_path):
    """On a synthetic mesh: the composite's visible surface samples, jittered
    off it, as a triangle soup written with the port's PLY writer."""
    from gs2m_tpu_torch.data.ply import store_mesh
    from scripts.run_quality_gate import composite_chamfer

    rng = np.random.default_rng(6)
    pts = qg.sample_composite_surface(900, seed=4)
    verts = (pts + rng.normal(scale=0.01, size=pts.shape)).astype(np.float32)
    faces = rng.permutation(len(verts)).reshape(-1, 3)
    path = str(tmp_path / "mesh.ply")
    store_mesh(path, verts, faces)
    assert qg.composite_chamfer(path) == composite_chamfer(path)


def test_quality_gate_tiny_run(tmp_path, monkeypatch):
    result = qg.main(["--out", str(tmp_path), "--iterations", "4",
                      "--width", "32", "--height", "24", "--views", "4",
                      "--points", "100", "--device", "cpu", "--chunk", "32"])
    saved = json.loads((tmp_path / "quality_gate.json").read_text())
    assert saved["chamfer"] == result["chamfer"]
    ch = saved["chamfer"]
    assert ch["mesh_points"] > 0
    assert all(np.isfinite(ch[k]) for k in ("mesh_to_surface_mean",
                                            "surface_to_mesh_mean",
                                            "chamfer_mean"))
    assert np.isfinite(saved["metrics_test"]["ours_4"]["PSNR"])
    assert saved["test_psnr_trajectory"][0][0] == 4
    assert saved["resolution"] == "32x24" and saved["iterations"] == 4
    assert saved["scene"] == "synthetic_sphere"
    cfg = json.loads((tmp_path / "model" / "cfg_args.json").read_text())
    assert cfg["pipeline"]["chunk"] == 32  # --chunk reached the train stage

    # --skip_train: the same model rendered, meshed and scored again, with
    # no training (the train app must not run).
    from gs2m_tpu_torch.apps import train as train_app

    def no_training(argv=None):
        raise AssertionError("--skip_train ran the train app")

    monkeypatch.setattr(train_app, "main", no_training)
    again = qg.main(["--out", str(tmp_path), "--iterations", "4",
                     "--width", "32", "--height", "24", "--views", "4",
                     "--points", "100", "--device", "cpu", "--skip_train"])
    assert again["chamfer"] == result["chamfer"]
    assert again["test_psnr_trajectory"] == result["test_psnr_trajectory"]
    assert again["metrics_test"] == result["metrics_test"]
