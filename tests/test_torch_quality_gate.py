"""The port's quality gate (apps/quality_gate.py) on the CPU: its scene
builder against tests/make_synthetic_scene.build (the same sparse/0 files,
byte for byte, and images within 1/255: the port's blend against the JAX
package's XLA twin), and a tiny gate run through the train, render and
metrics apps that writes a finite quality_gate.json.
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
    got = qg.build_sphere_scene(str(tmp_path / "port"), device="cpu", **kw)
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        a = (tmp_path / "jax" / "sparse/0" / name).read_bytes()
        assert (tmp_path / "port" / "sparse/0" / name).read_bytes() == a, name
    for i in range(4):
        a = np.asarray(Image.open(f"{ref}/images/view_{i:03d}.png"), np.int32)
        b = np.asarray(Image.open(f"{got}/images/view_{i:03d}.png"), np.int32)
        assert a.shape == b.shape and a.max() > 0
        assert np.abs(a - b).max() <= 1


def test_quality_gate_tiny_run(tmp_path):
    result = qg.main(["--out", str(tmp_path), "--iterations", "4",
                      "--width", "32", "--height", "24", "--views", "4",
                      "--points", "100", "--device", "cpu"])
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
