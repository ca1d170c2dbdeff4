"""The material path through the port's apps, on the CPU: the train app with
--material writes lighting.pkl; the render app on it writes the PBR
renders, the five material maps and envmap.png; a JAX-trained material
snapshot (a PLY from gs2m_tpu.data.ply and a pickled light) renders
through the port's app to the JAX render app's PNGs within 1 LSB; and the
material gate at a tiny size writes material_gate.json with every key."""
import json
import os
import pickle

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
MATERIAL_DIRS = ("albedo", "roughness", "metallic", "diffuse", "specular")
WIDE = ["--multi_view_max_angle", "179", "--multi_view_max_dist", "100",
        "--nearby_cam_max_angle", "179", "--nearby_cam_max_dist", "100"]


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    from tests.make_synthetic_scene import build
    return build(str(tmp_path_factory.mktemp("mat_app") / "scene"), n_views=4,
                 width=48, height=32, n_points=120)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_train_then_render_material(scene_dir, tmp_path):
    from gs2m_tpu_torch.apps import train as train_app

    model = tmp_path / "model"
    trainer = train_app.main(
        ["-s", scene_dir, "-m", str(model), "--device", "cpu", "--chunk", "64",
         "--sh_degree", "1", "--eval", "--material", "--iterations", "6",
         "--geometry_from_iter", "3", "--test_iterations", "6",
         "--save_iterations", "6", "--quiet", *WIDE])
    assert trainer.rough_active_count == 3 and trainer.mv_active_count == 3
    assert float(trainer.last_metrics["Lmat"]) > 0
    assert "psnr_pbr" in trainer.last_eval
    snap = model / "point_cloud" / "iteration_6"
    with open(snap / "lighting.pkl", "rb") as f:
        light = pickle.load(f)
    assert light.shape == (6, 512, 512, 3) and light.min() >= 0
    np.testing.assert_array_equal(light, trainer.light_state.numpy())

    out = tapp.main(["-m", str(model), "--device", "cpu"])
    assert out["views"] and all(s["finite"] for s in out["views"])
    for split in ("train", "test"):
        base = model / split / "ours_6"
        assert (base / "envmap.png").is_file()
        assert Image.open(base / "envmap.png").size == (512, 256)
        for d in ("render",) + MATERIAL_DIRS:
            files = sorted((base / d).iterdir())
            assert files and all(Image.open(f).size == (48, 32) for f in files)


@pytest.fixture(scope="module")
def jax_material_model(scene_dir, tmp_path_factory):
    """A material snapshot written by the JAX package's own writers."""
    model = tmp_path_factory.mktemp("jax_mat") / "model"
    snap = model / "point_cloud" / "iteration_50"
    os.makedirs(snap)
    save_cfg_args(str(model), ModelConfig(source_path=scene_dir,
                                          model_path=str(model), resolution=1,
                                          sh_degree=1, eval=True,
                                          material=True),
                  PipelineConfig(chunk=64, use_pallas=False), OptimConfig())
    rng = np.random.default_rng(6)
    pts = rng.normal(size=(120, 3)).astype(np.float32) * 0.6
    cols = rng.uniform(0, 1, (120, 3)).astype(np.float32)
    g = Gaussians.create(pts, cols, max_sh_degree=1, capacity=120)
    p = {k: np.asarray(v) for k, v in g.params_dict().items()}
    p["rotation"] = p["rotation"] + rng.normal(size=(120, 4)).astype(np.float32)
    for k in ("albedo", "roughness", "metallic"):
        p[k] = rng.normal(size=p[k].shape).astype(np.float32)
    save_gaussian_ply(str(snap / "point_cloud.ply"), p["xyz"], p["f_dc"],
                      p["f_rest"], p["opacity"] + 1.0, p["scaling"],
                      p["rotation"], p["albedo"], p["roughness"], p["metallic"])
    with open(snap / "lighting.pkl", "wb") as f:
        pickle.dump(rng.uniform(0.1, 1.5, (6, 32, 32, 3)).astype(np.float32), f)
    return model


def render_like_the_jax_app(model, flags: list, tag: str):
    """Both apps render `model` with `flags`; the port's files are the JAX
    app's, PNGs within 1 LSB."""
    common = ["-m", str(model), "--device", "cpu"] + flags
    japp.main(common + ["--label", f"jax{tag}"])
    stats = tapp.main(common + ["--label", f"port{tag}"])["views"]
    assert all(s["finite"] and s["dropped"] == 0 for s in stats)
    for split in ("train", "test"):
        ja, tp = model / split / f"jax{tag}_50", model / split / f"port{tag}_50"
        names = _files(ja)
        assert "envmap.png" in names and names == _files(tp), split
        assert all(any(n.startswith(d + "/") for n in names)
                   for d in MATERIAL_DIRS)
        for n in names:
            a = np.asarray(Image.open(ja / n), np.int32)
            b = np.asarray(Image.open(tp / n), np.int32)
            assert a.shape == b.shape, n
            assert np.abs(a - b).max() <= 1, (split, n)


def test_jax_material_snapshot_renders_like_the_jax_app(jax_material_model):
    render_like_the_jax_app(jax_material_model, [], "")


def test_jax_material_snapshot_renders_in_bands_like_the_jax_app(
        jax_material_model):
    """--spatial 2 (parallel/sp.py): the gathered bands feed the PBR pass and
    the material maps, against the JAX app's own --spatial 2."""
    render_like_the_jax_app(jax_material_model, ["--spatial", "2"], "sp")


GATE_KEYS = {"scene", "protocol", "resolution", "iterations", "train_minutes",
             "test_psnr_trajectory", "test_psnr_pbr_trajectory", "metrics",
             "envmap_recovery", "roughness_zones", "rough_active_steps",
             "mv_active_steps", "losses_finite", "final_loss", "light", "pass"}


def test_material_gate_writes_every_key(tmp_path):
    from gs2m_tpu_torch.apps import material_gate

    res = material_gate.main(["--out", str(tmp_path), "--device", "cpu",
                              "--width", "48", "--height", "36", "--views",
                              "6", "--points", "300", "--iterations", "10"])
    on_disk = json.loads((tmp_path / "material_gate.json").read_text())
    assert GATE_KEYS <= set(on_disk) and on_disk["pass"] == res["pass"]
    assert res["iterations"] == 10 and res["losses_finite"]
    assert {"luminance_corr", "got_mean", "want_mean"} <= set(
        res["envmap_recovery"])
    assert {"glossy_zone_mean", "rough_zone_mean", "ordering_ok"} <= set(
        res["roughness_zones"])
    assert res["light"]["min"] >= 0 and res["light"]["mean_abs_change"] > 0
    # The material stage starts after iteration 5 (= geometry_from_iter).
    assert [i for i, _ in res["test_psnr_pbr_trajectory"]] == [7, 10]
    assert (tmp_path / "scene" / "masks" / "view_000.png").is_file()
    assert (tmp_path / "model" / "train" / "ours_10" / "envmap.png").is_file()
    np.testing.assert_allclose(
        material_gate.analytic_env(np.array([[0.0, -1.0, 0.0]])),
        [[1.62, 1.42, 1.02]])


@pytest.mark.parametrize("white", [True, False])
def test_pbr_render_under_mask_gt_is_filled_with_the_background(tmp_path, white):
    """With --mask_gt the PBR render keeps the GT mask's pixels and fills
    the rest with the model's background: white under --white_background,
    where the ground truth is composited on white, else black."""
    from gs2m_tpu_torch.core.camera import Camera
    from gs2m_tpu_torch.core.config import ModelConfig as TModelConfig
    from gs2m_tpu_torch.pbr import cubemap as cmod
    from gs2m_tpu_torch.pbr import shade as smod

    H, W = 12, 16
    rng = np.random.default_rng(3)
    cam = Camera.create(np.eye(3), np.array([0.0, 0.0, 4.0]), 0.8, 0.6, W, H,
                        device="cpu")
    t = lambda *s: torch.from_numpy(rng.uniform(0.1, 0.9, s).astype(np.float32))
    normals = torch.nn.functional.normalize(t(3, H, W) - 0.5, dim=0)
    pkg = {"normal_map": normals, "albedo_map": t(3, H, W),
           "roughness_map": t(1, H, W), "metallic_map": t(1, H, W),
           "alpha_map": torch.ones(1, H, W), "normal_mask": torch.ones(1, H, W, dtype=bool)}
    light = torch.from_numpy(rng.uniform(0.2, 0.8, (6, 8, 8, 3)).astype(np.float32))
    mask = np.zeros((1, H, W), np.float32)
    mask[:, 3:9, 4:12] = 1.0
    dirs = {k: tmp_path / k for k in ("render",) + MATERIAL_DIRS}
    for d in dirs.values():
        os.makedirs(d)
    cfg = TModelConfig(material=True, mask_gt=True, white_background=white)
    bg = torch.full((3,), float(white))
    tapp.save_material_maps(cfg, dirs, "v", cam, pkg, light,
                            smod.get_brdf_lut("cpu"), cmod.build_mips(light), bg,
                            [mask], 0)
    img = np.asarray(Image.open(dirs["render"] / "v.png"))
    outside = img[mask[0] == 0]
    assert (outside == (255 if white else 0)).all()
    assert not (img[mask[0] > 0] == 255).all()
