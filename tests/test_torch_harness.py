"""The port's benchmark runners and harness apps against the JAX-side
scripts: with subprocess.run recorded on both sides, each runner's app
launches (argv, cwd, PYTHONPATH) equal the script's once `gs2m_tpu.` reads
`gs2m_tpu_torch.` and `scripts/eval_*.py` reads `-m
gs2m_tpu_torch.apps.eval_*`; runtime.json, Truck's rotated mesh,
report_dtu's table and chamfer.json, and convert_json's transforms.json
equal. Then one tiny real run_dtu on the CPU: train, render --dtu,
metrics and eval_dtu as subprocesses, and report_dtu over its output.
"""
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from gs2m_tpu_torch.apps import (convert_json, report_dtu, run_dtu,
                                 run_glossy, run_shiny, run_tnt)
from gs2m_tpu_torch.data.ply import fetch_mesh, store_mesh

ROOT = Path(__file__).resolve().parent.parent
PORTS = {"run_dtu": run_dtu, "run_tnt": run_tnt, "run_shiny": run_shiny,
         "run_glossy": run_glossy, "report_dtu": report_dtu,
         "convert_json": convert_json}


def script(name: str):
    """The JAX-side script as a module of its own name."""
    path = ROOT / "scripts" / ("preprocess/" if name == "convert_json" else "") \
        / f"{name}.py"
    sys.path.insert(0, str(path.parent))
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def record(monkeypatch):
    """Replace subprocess.run by a recorder of (argv, cwd, PYTHONPATH)."""
    calls = []

    def fake(cmd, check=False, cwd=None, env=None, **kw):
        calls.append((list(cmd), str(cwd), (env or {}).get("PYTHONPATH")))
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(subprocess, "run", fake)
    return calls


def as_port(calls):
    """The script's launches as the port names them."""
    out = []
    for cmd, cwd, pp in calls:
        cmd = list(cmd)
        if cmd[1].startswith("scripts/"):
            cmd[1:2] = ["-m", "gs2m_tpu_torch.apps." + Path(cmd[1]).stem]
        cmd[2] = cmd[2].replace("gs2m_tpu.", "gs2m_tpu_torch.", 1)
        out.append((cmd, cwd, pp))
    return out


def run_both(name, argv, monkeypatch, before=None):
    """Run the script's and the port's main on argv with subprocess.run
    recorded; -> (script launches as the port names them, port launches)."""
    results = []
    for main in (lambda m: (m.setattr(sys, "argv", [name, *argv]),
                            script(name).main()),
                 lambda m: PORTS[name].main(argv)):
        if before:
            before()
        with monkeypatch.context() as m:
            calls = record(m)
            main(m)
        results.append(calls)
    return as_port(results[0]), results[1]


def runtime_equal(out: Path, name, argv, monkeypatch, before=None):
    """Both runners' launches and runtime.json (merged into a file that
    already holds another label) equal."""
    texts = []

    def seed():
        if before:
            before()
        out.mkdir(parents=True, exist_ok=True)
        rt = out / "runtime.json"
        if rt.exists():   # the script's, before the port's run
            texts.append(rt.read_text())
        rt.write_text(json.dumps({"other": 1.5}))

    want, got = run_both(name, argv, monkeypatch, seed)
    texts.append((out / "runtime.json").read_text())
    assert got == want
    assert texts[0] == texts[1] and json.loads(texts[1])["other"] == 1.5
    return got


@pytest.mark.parametrize("argv", [
    [],
    ["--material", "--scenes", "24", "37", "--dtu_official", "/official",
     "--iterations", "7000", "--extra", "--densify_until_iter", "5000"],
    ["--scenes", "105", "--dtu_official", "/official"],
], ids=["default", "material-official-extra", "official"])
def test_run_dtu_argv(tmp_path, monkeypatch, argv):
    out = tmp_path / "out"
    got = runtime_equal(out, "run_dtu",
                        ["--data", str(tmp_path / "dtu"), "--out", str(out),
                         *argv], monkeypatch)
    assert all(c[0][2].startswith("gs2m_tpu_torch.apps.") for c in got)
    if "--material" in argv:
        assert "--mask_gt" in got[0][0] and got[0][0][-2:] == [
            "--densify_until_iter", "5000"]


@pytest.mark.parametrize("argv", [
    [], ["--scenes", "Barn", "Truck", "Ignatius", "--iterations", "700",
         "--extra", "--quiet"]], ids=["default", "scenes-extra"])
def test_run_tnt_argv_and_truck_rotation(tmp_path, monkeypatch, argv):
    data, out = tmp_path / "tnt", tmp_path / "out"
    its = argv[argv.index("--iterations") + 1] if argv else "30000"
    # Barn has the whole official kit, Truck only its GT cloud, Ignatius
    # nothing (its F-score is skipped).
    for scene, files in (("Barn", (".ply", "_COLMAP_SfM.log", "_trans.txt",
                                   ".json")), ("Truck", (".ply",))):
        (data / scene).mkdir(parents=True)
        for suffix in files:
            (data / scene / f"{scene}{suffix}").write_text("")
    mesh = out / "Truck" / "train" / f"ours_wo-brdf_{its}" / "mesh" / "tsdf_post.ply"
    mesh.parent.mkdir(parents=True)
    rng = np.random.default_rng(0)
    verts = rng.normal(size=(50, 3)).astype(np.float32)
    faces = rng.integers(0, 50, (40, 3))
    rotated = []

    def fresh_mesh():
        if mesh.exists():   # the script's rotation, before the port's run
            rotated.append(fetch_mesh(str(mesh)))
        store_mesh(str(mesh), verts, faces, np.full((50, 3), 0.5, np.float32))

    runtime_equal(out, "run_tnt", ["--data", str(data), "--out", str(out),
                                   *argv], monkeypatch, fresh_mesh)
    rotated.append(fetch_mesh(str(mesh)))
    a, b = rotated[-2], rotated[-1]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0], verts)


@pytest.mark.parametrize("argv", [
    [], ["--scenes", "ball", "helmet", "--extra", "--iterations", "600"]],
    ids=["default", "ball-extra"])
def test_run_shiny_argv(tmp_path, monkeypatch, argv):
    out = tmp_path / "out"
    got = runtime_equal(out, "run_shiny", ["--data", str(tmp_path / "shiny"),
                                           "--out", str(out), *argv],
                        monkeypatch)
    trains = [c[0] for c in got if c[0][2] == "gs2m_tpu_torch.apps.train"]
    assert ["--mask_gt" in c for c in trains] == [
        s == "ball" for s in (argv[1:3] if argv else run_shiny.SCENES)]


@pytest.mark.parametrize("argv", [
    [], ["--scenes", "cat", "--extra", "--iterations", "500"]],
    ids=["default", "cat-extra"])
def test_run_glossy_argv(tmp_path, monkeypatch, argv):
    out = tmp_path / "out"
    got = runtime_equal(out, "run_glossy", ["--data", str(tmp_path / "glossy"),
                                            "--out", str(out), *argv],
                        monkeypatch)
    renders = [c[0] for c in got if c[0][2] == "gs2m_tpu_torch.apps.render"]
    assert all(r[r.index("--iteration") + 1] == "10000" for r in renders)


def test_report_dtu_matches_script(tmp_path, monkeypatch, capsys):
    out = tmp_path / "dtu"
    rng = np.random.default_rng(1)
    for i, scan in enumerate(run_dtu.SCENES[:6]):
        d = out / f"scan{scan}"
        d.mkdir(parents=True)
        if i != 2:
            d.joinpath("results.json").write_text(json.dumps(dict(zip(
                ("mean_d2s", "mean_s2d", "overall"), rng.uniform(0.3, 1.2, 3)))))
        if i != 4:
            key = "ours_wo-brdf_30000" if i != 5 else "ours_wo-brdf_7000"
            d.joinpath("metrics_train.json").write_text(json.dumps(
                {key: {"PSNR": float(rng.uniform(30, 36)),
                       "SSIM": float(rng.uniform(0.9, 0.99))}}))
    texts = []
    for main in (lambda: (monkeypatch.setattr(sys, "argv", ["r", "--out",
                                                            str(out)]),
                          script("report_dtu").main()),
                 lambda: report_dtu.main(["--out", str(out)])):
        capsys.readouterr()
        main()
        texts.append((capsys.readouterr().out,
                      (out / "chamfer.json").read_text()))
        (out / "chamfer.json").unlink()
    assert texts[0] == texts[1]
    table = json.loads(texts[1][1])
    assert len(table) == 7 and table["mean"]["overall"] > 0


def colmap_model(root: Path):
    from gs2m_tpu_torch.apps.quality_gate import ring_camera
    from gs2m_tpu_torch.data import colmap as cm

    sparse = root / "sparse" / "0"
    sparse.mkdir(parents=True)
    imgs = {}
    for i in range(9):
        R, T = ring_camera(2 * np.pi * i / 9, dist=3.0 + 0.1 * i,
                           height=0.5 * np.sin(i))
        imgs[i + 1] = cm.ColmapImage(i + 1, cm.rotmat_to_qvec(R.T), T, 1,
                                     f"{i:03d}.png")
    cm.write_images_binary(str(sparse / "images.bin"), imgs)
    rng = np.random.default_rng(2)
    cm.write_points3d_binary(str(sparse / "points3D.bin"),
                             rng.normal(size=(300, 3)) * [1.0, 0.5, 2.0],
                             rng.integers(0, 255, (300, 3)))


@pytest.mark.parametrize("by_points", [False, True])
def test_convert_json_matches_script(tmp_path, monkeypatch, capsys, by_points):
    colmap_model(tmp_path)
    argv = ["--data_dir", str(tmp_path)] + (["--by_points"] if by_points else [])
    texts = []
    for main in (lambda: (monkeypatch.setattr(sys, "argv", ["c", *argv]),
                          script("convert_json").main()),
                 lambda: convert_json.main(argv)):
        capsys.readouterr()
        main()
        texts.append((capsys.readouterr().out,
                      (tmp_path / "transforms.json").read_text()))
    assert texts[0] == texts[1]
    box = np.array(json.loads(texts[1][1])["aabb_range"])
    assert box.shape == (3, 2) and (box[:, 1] > box[:, 0]).all()


def test_run_dtu_tiny_real_run(tmp_path):
    """The runner end to end on the CPU: a 32x24 four-view sphere trained
    at -r 2 for 12 iterations, its --dtu mesh, train metrics and
    runtime.json; then the chamfer against a synthetic official directory
    (the analytic sphere) at a density scaled to the scene, and report_dtu.
    (The runner's own eval step, at DTU's millimetre density, collapses a
    mesh in the normalized frame to a point: ROADMAP.md Queue C.)"""
    from scipy.io import savemat

    from gs2m_tpu_torch.apps import eval_dtu
    from gs2m_tpu_torch.apps.quality_gate import build_scene
    from gs2m_tpu_torch.data.ply import store_point_cloud

    data, out, official = tmp_path / "dtu", tmp_path / "out", tmp_path / "off"
    build_scene(str(data / "scan24"), n_views=4, width=32, height=24,
                n_points=300, device="cpu")
    run_dtu.main(["--data", str(data), "--out", str(out), "--scenes", "24",
                  "--iterations", "12", "--device", "cpu", "--extra",
                  "--chunk", "64", "--geometry_from_iter", "6",
                  "--densify_from_iter", "4", "--densification_interval", "5",
                  "--test_iterations", "12", "--quiet"])
    scan = out / "scan24"
    mesh = scan / "train" / "ours_wo-brdf_12" / "mesh" / "tsdf_post.ply"
    verts, faces, _ = fetch_mesh(str(mesh))
    assert len(faces) > 0 and np.isfinite(verts).all()
    psnr = json.loads((scan / "metrics_train.json").read_text())[
        "ours_wo-brdf_12"]["PSNR"]
    assert np.isfinite(psnr)
    assert json.loads((out / "runtime.json").read_text())["ours_wo-brdf"] >= 0

    (official / "ObsMask").mkdir(parents=True)
    (official / "Points" / "stl").mkdir(parents=True)
    savemat(official / "ObsMask" / "ObsMask24_10.mat",
            {"ObsMask": np.ones((9, 9, 9), bool),
             "BB": np.array([[-2.0, -2, -2], [2, 2, 2]]), "Res": 0.5})
    savemat(official / "ObsMask" / "Plane24.mat",
            {"P": np.array([0.0, 0.0, 0.0, 1.0])})
    v = np.random.default_rng(0).normal(size=(5000, 3))
    store_point_cloud(str(official / "Points" / "stl" / "stl024_total.ply"),
                      (v / np.linalg.norm(v, axis=1, keepdims=True)
                       ).astype(np.float32), np.zeros((5000, 3)))
    res = eval_dtu.main(["--data", str(mesh), "--scan", "24", "--dataset_dir",
                         str(official), "--vis_out_dir", str(scan),
                         "--downsample_density", "0.02", "--patch_size", "0.6",
                         "--max_dist", "2.0"])
    assert all(np.isfinite(res[k]) for k in ("mean_d2s", "mean_s2d", "overall"))
    table = report_dtu.main(["--out", str(out), "--iterations", "12"])
    assert table["scan24"]["overall"] == res["overall"]
    assert table["mean"]["PSNR"] == psnr
