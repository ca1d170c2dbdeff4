"""The port's apps end to end on the CPU, the slice as a whole: the train
app with checkpoints, resume and the profiler window; the render app's mesh
branch and its --dtu/--tnt/--blender presets; the metrics app against the
JAX package's evaluate_dir (the quality gate's are in
tests/test_torch_quality_gate.py).

A resumed train app writes the same snapshot, byte for byte, as the
uninterrupted one. The mesh renders run at -r 8 (8x6 pixels), so the
presets' fine voxels (0.002 at --dtu) stay a few thousand blocks here.
The scene's five views split into four train views and one test view.
PSNR and SSIM agree with evaluate_dir within 1e-5 on the same directories.
"""
import json
import shutil

import pytest
import torch

from gs2m_tpu_torch.apps import metrics as metrics_app
from gs2m_tpu_torch.apps import render as render_app
from gs2m_tpu_torch.apps import train as train_app

torch.set_num_threads(1)

TRAIN = ["--chunk", "64", "--sh_degree", "1", "--eval", "--iterations", "8",
         "--geometry_from_iter", "3", "--densify_from_iter", "2",
         "--densification_interval", "3", "--test_iterations", "8",
         "--save_iterations", "8", "--quiet",
         "--multi_view_max_angle", "179", "--multi_view_max_dist", "100",
         "--nearby_cam_max_angle", "179", "--nearby_cam_max_dist", "100",
         "--multi_view_sample_num", "300", "--device", "cpu"]


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    from tests.make_synthetic_scene import build
    return build(str(tmp_path_factory.mktemp("appmesh") / "scene"),
                 n_views=5, width=48, height=36, n_points=150, surface=True)


@pytest.fixture(scope="module")
def trained(scene_dir, tmp_path_factory):
    """The train app with checkpoints at 4 and 8 and a profile of 2..3."""
    model = tmp_path_factory.mktemp("appmesh") / "model"
    trainer = train_app.main(["-s", scene_dir, "-m", str(model), *TRAIN,
                              "--checkpoint_iterations", "4", "8",
                              "--profile_iterations", "2", "3"])
    assert trainer.iteration == 8 and trainer.last_densify_info is not None
    return model


def test_train_app_checkpoints_resume_and_profile(scene_dir, trained,
                                                  tmp_path):
    for it in (4, 8):
        assert (trained / "checkpoints" / f"ckp{it}.pkl").is_file()
    trace = trained / "profile" / "trace_2_3.json"
    assert json.loads(trace.read_text())["traceEvents"]

    resumed = tmp_path / "resumed"
    trainer = train_app.main(["-s", scene_dir, "-m", str(resumed), *TRAIN,
                              "--start_checkpoint",
                              str(trained / "checkpoints" / "ckp4.pkl")])
    assert trainer.iteration == 8
    snap = "point_cloud/iteration_8/point_cloud.ply"
    assert (resumed / snap).read_bytes() == (trained / snap).read_bytes()


def _mesh_ok(record, mesh_dir):
    assert record["blocks"] > 0 and record["voxels"] == 512 * record["blocks"]
    assert 0 < record["faces"] <= record["raw_faces"] and record["finite"]
    assert set(record["stage_ms"]) == {"discover", "integrate", "march",
                                       "weld", "to_host", "ply_write",
                                       "cluster"}
    for name in ("tsdf_mesh.ply", "tsdf_post.ply", "config.json"):
        assert (mesh_dir / name).is_file(), name


def test_render_app_extracts_a_mesh(trained):
    out = render_app.main(["-m", str(trained), "--device", "cpu", "-r", "8",
                           "--extract_mesh", "--filter_depth",
                           "--label", "mesh"])
    assert set(out["meshes"]) == {"train", "test"}
    cfg = json.loads((trained / "train" / "mesh_8" / "mesh" /
                      "config.json").read_text())
    from gs2m_tpu_torch.core.config import load_cfg_args
    from gs2m_tpu_torch.data.readers import detect_and_read_scene
    extent = detect_and_read_scene(load_cfg_args(str(trained))[0].source_path,
                                   eval_split=True).radius
    assert cfg == {"max_depth": 2.0 * extent,
                   "voxel_size": 2.0 * extent / 1024.0,
                   "sdf_trunc": 4.0 * 2.0 * extent / 1024.0}
    for split, rec in out["meshes"].items():
        _mesh_ok(rec, trained / split / "mesh_8" / "mesh")


@pytest.mark.parametrize("preset,splits,voxel", [
    ("--dtu", {"train"}, 0.002), ("--tnt", {"train"}, 2.4 / 2048),
    ("--blender", {"test"}, 0.004)])
def test_render_app_presets(trained, scene_dir, tmp_path, preset, splits,
                            voxel):
    scene = tmp_path / "scene"
    shutil.copytree(scene_dir, scene)
    (scene / "transforms.json").write_text(json.dumps(
        {"aabb_range": [[-1.2, 1.2]] * 3}))
    label = preset.strip("-")
    out = render_app.main(["-m", str(trained), "-s", str(scene), "--device",
                           "cpu", "-r", "8", preset, "--label", label])
    assert set(out["meshes"]) == splits
    for split in splits:
        mesh_dir = trained / split / f"{label}_8" / "mesh"
        _mesh_ok(out["meshes"][split], mesh_dir)
        cfg = json.loads((mesh_dir / "config.json").read_text())
        assert cfg["voxel_size"] == voxel and cfg["sdf_trunc"] == 4 * voxel


def test_metrics_app_matches_jax_evaluate_dir(trained):
    from gs2m_tpu.apps.metrics import evaluate_dir

    render_app.main(["-m", str(trained), "--device", "cpu",
                     "--label", "metrics"])
    for split in ("train", "test"):
        res = metrics_app.main(["-m", str(trained), "--split", split,
                                "--device", "cpu"])
        saved = json.loads((trained / f"metrics_{split}.json").read_text())
        assert saved == res and "metrics_8" in res
        method = trained / split / "metrics_8"
        want = evaluate_dir(method)
        got = res["metrics_8"]
        assert got["LPIPS"] is None and want["LPIPS"] is None
        assert abs(got["PSNR"] - want["PSNR"]) <= 1e-5
        assert abs(got["SSIM"] - want["SSIM"]) <= 1e-5
        per_view = json.loads((method / "per_view.json").read_text())
        assert set(per_view) == set(want["per_view"])
    assert metrics_app.main(["-m", str(trained), "--split", "none",
                             "--device", "cpu"]) == {}
