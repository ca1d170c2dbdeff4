"""Port vs JAX package: the render app end to end, the slice as a whole.

Both apps' `main` render the same tiny trained-snapshot directory (the JAX
app through its XLA twin); the port's outputs must be the same file set,
with PNGs equal within 1 LSB (8-bit quantization absorbs float
reassociation), and the same points.json / cameras.json bookkeeping.
"""
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from gs2m_tpu.apps import render as japp
from gs2m_tpu.core.config import (ModelConfig, OptimConfig, PipelineConfig,
                                  save_cfg_args)
from gs2m_tpu.core.gaussians import Gaussians
from gs2m_tpu.data.ply import save_gaussian_ply
from gs2m_tpu_torch.apps import render as tapp

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    from tests.make_synthetic_scene import build

    root = tmp_path_factory.mktemp("app")
    scene_dir = build(str(root / "scene"), n_views=4, width=64, height=48,
                      n_points=150)
    model = root / "model"
    snap = model / "point_cloud" / "iteration_100"
    os.makedirs(snap)
    save_cfg_args(str(model), ModelConfig(source_path=scene_dir,
                                          model_path=str(model), resolution=1,
                                          sh_degree=2, eval=True),
                  PipelineConfig(chunk=64, use_pallas=False), OptimConfig())
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(150, 3)).astype(np.float32) * 0.6
    cols = ((pts - pts.min(0)) / (pts.max(0) - pts.min(0))).astype(np.float32)
    g = Gaussians.create(pts, cols, max_sh_degree=2, capacity=150)
    p = {k: np.asarray(v) for k, v in g.params_dict().items()}
    p["rotation"] = p["rotation"] + rng.normal(size=(150, 4)).astype(np.float32)
    p["f_rest"] = 0.1 * rng.normal(size=p["f_rest"].shape).astype(np.float32)
    save_gaussian_ply(str(snap / "point_cloud.ply"), p["xyz"], p["f_dc"],
                      p["f_rest"], p["opacity"], p["scaling"], p["rotation"],
                      p["albedo"], p["roughness"], p["metallic"])
    return model


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("chunk,extra", [(64, ["--normal_sobel"]),
                                         (256, ["--white_background"])])
def test_render_app_matches_jax_app(model_dir, chunk, extra):
    """The app's initial cap (8 x capacity) is below this scene's
    chunk-aligned demand, so both apps regrow it on `dropped`."""
    common = ["-m", str(model_dir), "--device", "cpu", "--chunk", str(chunk)]
    japp.main(common + extra + ["--label", f"jax{chunk}"])
    cams_jax = (model_dir / "cameras.json").read_text()
    stats = tapp.main(common + extra + ["--label", f"port{chunk}"])["views"]
    assert (model_dir / "cameras.json").read_text() == cams_jax
    points = json.loads((model_dir / "points.json").read_text())
    assert points[f"jax{chunk}_100"] == points[f"port{chunk}_100"] == 150

    assert [s["dropped"] for s in stats] == [0] * len(stats)
    assert all(s["finite"] for s in stats)
    assert all(0 < s["num_instances"] <= s["instance_cap"] for s in stats)
    first_cap = max(8 * 150 // chunk * chunk, 4 * chunk)
    assert stats[-1]["instance_cap"] > first_cap
    for split in ("train", "test"):
        ja = model_dir / split / f"jax{chunk}_100"
        tp = model_dir / split / f"port{chunk}_100"
        names = _files(ja)
        assert names and names == _files(tp), split
        for n in names:
            a = np.asarray(Image.open(ja / n), np.int32)
            b = np.asarray(Image.open(tp / n), np.int32)
            assert a.shape == b.shape, n
            assert np.abs(a - b).max() <= 1, (split, n)


def test_default_device_raises_without_cuda(model_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        tapp.main(["-m", str(model_dir), "--label", "nodev"])


# --spatial N renders each view in N bands (parallel/sp.py): the same files
# as the full-frame app, PNGs within 1 LSB, as the JAX package holds its own
# app (tests/test_parallel.py:339). 48 rows make 2 bands of 32 (the second
# with 16 rows inside the frame) and 3 bands of 16.
@pytest.mark.parametrize("bands", [2, 3])
def test_spatial_option_matches_full_frame(model_dir, bands):
    common = ["-m", str(model_dir), "--device", "cpu", "--normal_sobel"]
    full = tapp.main(common + ["--label", f"full{bands}"])["views"]
    sp = tapp.main(common + ["--spatial", str(bands), "--label",
                             f"sp{bands}"])["views"]
    assert [s["dropped"] for s in sp] == [0] * len(full)
    assert ([s["num_instances"] for s in sp]
            == [s["num_instances"] for s in full])
    for split in ("train", "test"):
        a = model_dir / split / f"full{bands}_100"
        b = model_dir / split / f"sp{bands}_100"
        names = _files(a)
        assert names and names == _files(b), split
        for n in names:
            x = np.asarray(Image.open(a / n), np.int32)
            y = np.asarray(Image.open(b / n), np.int32)
            assert x.shape == y.shape and np.abs(x - y).max() <= 1, n
