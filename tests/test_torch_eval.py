"""The port's evaluators (apps/eval_dtu.py, apps/eval_tnt.py) against the
JAX-side scripts (scripts/eval_dtu.py, scripts/eval_tnt.py) on the same
seeded numpy inputs: surface samples and the radius downsample bit-equal,
results.json equal on a synthetic official DTU directory, and the TnT
protocol (trajectory alignment, three ICP stages, the histogram) with F,
P, R and the transform within 1e-9, in both of its modes.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
from scipy.io import savemat

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))

import eval_dtu as jax_dtu  # noqa: E402
import eval_tnt as jax_tnt  # noqa: E402

from gs2m_tpu_torch.apps import eval_dtu, eval_tnt  # noqa: E402
from gs2m_tpu_torch.data.ply import store_mesh, store_point_cloud  # noqa: E402


def bumpy_grid(n: int = 24, seed: int = 0):
    """A height-field mesh over [-1, 1]^2 with seeded bumps and triangles of
    many shapes (so sample_mesh_surface fills several (n1, n2) buckets)."""
    rng = np.random.default_rng(seed)
    u = np.sort(rng.uniform(-1, 1, n))
    v = np.sort(rng.uniform(-1, 1, n))
    x, z = np.meshgrid(u, v, indexing="ij")
    y = 0.2 * np.sin(3 * x) * np.cos(2 * z) + 0.02 * rng.normal(size=x.shape)
    verts = np.stack([x, y, z], -1).reshape(-1, 3)
    idx = np.arange(n * n).reshape(n, n)
    a, b = idx[:-1, :-1].ravel(), idx[1:, :-1].ravel()
    c, d = idx[:-1, 1:].ravel(), idx[1:, 1:].ravel()
    faces = np.concatenate([np.stack([a, b, c], -1), np.stack([b, d, c], -1)])
    return verts.astype(np.float32), faces.astype(np.int64)


@pytest.mark.parametrize("density", [0.01, 0.05, 0.3])
def test_sample_mesh_surface_bit_equal(density):
    verts, faces = bumpy_grid()
    v = verts.astype(np.float64)
    a = jax_dtu.sample_mesh_surface(v, faces, density)
    b = eval_dtu.sample_mesh_surface(v, faces, density)
    assert a.shape[0] >= len(verts)
    np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("seed", [0, 3])
def test_radius_downsample_bit_equal(seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 1, (6000, 3))
    a = jax_dtu.radius_downsample(pts, 0.05, seed=seed)
    b = eval_dtu.radius_downsample(pts, 0.05, seed=seed)
    assert 100 < len(a) < len(pts)
    np.testing.assert_array_equal(b, a)


def make_dtu_official(root: Path, scan: int, surface: np.ndarray,
                      res: float = 0.05):
    """ObsMask (cells within 2 cells of the surface), the ground plane and
    the STL cloud, in the DTU official layout."""
    (root / "ObsMask").mkdir(parents=True)
    (root / "Points" / "stl").mkdir(parents=True)
    lo, hi = surface.min(0) - 0.2, surface.max(0) + 0.2
    shape = np.ceil((hi - lo) / res).astype(int) + 1
    mask = np.zeros(shape, bool)
    cells = np.around((surface - lo) / res).astype(int)
    for dx in (-2, -1, 0, 1, 2):
        mask[tuple(np.clip(cells + dx, 0, shape - 1).T)] = True
    savemat(root / "ObsMask" / f"ObsMask{scan}_10.mat",
            {"ObsMask": mask, "BB": np.stack([lo, hi]), "Res": res})
    savemat(root / "ObsMask" / f"Plane{scan}.mat",
            {"P": np.array([0.0, 1.0, 0.0, 0.15])})   # keeps y > -0.15
    store_point_cloud(str(root / "Points" / "stl" / f"stl{scan:03}_total.ply"),
                      surface.astype(np.float32),
                      np.zeros_like(surface, np.float32))


def test_evaluate_dtu_results_equal(tmp_path):
    verts, faces = bumpy_grid(32)
    rng = np.random.default_rng(4)
    # The "STL": dense samples of the same height field, off by noise.
    x, z = rng.uniform(-1, 1, (2, 20000))
    stl = np.stack([x, 0.2 * np.sin(3 * x) * np.cos(2 * z)
                    + 0.01 * rng.normal(size=x.shape), z], -1)
    make_dtu_official(tmp_path / "official", 24, stl)
    mesh = tmp_path / "mesh.ply"
    store_mesh(str(mesh), verts, faces)
    kw = dict(downsample_density=0.02, patch_size=0.5, max_dist=0.2)
    a = jax_dtu.evaluate(str(mesh), 24, str(tmp_path / "official"),
                         str(tmp_path / "jax"), **kw)
    stages = {}
    b = eval_dtu.evaluate(str(mesh), 24, str(tmp_path / "official"),
                          str(tmp_path / "port"), stages=stages, **kw)
    assert b == a and np.isfinite(a["overall"])
    assert ((tmp_path / "port" / "results.json").read_text()
            == (tmp_path / "jax" / "results.json").read_text())
    assert set(stages) == {"sample_s", "downsample_s", "obsmask_s", "d2s_s",
                           "s2d_s", "points"}
    assert 0 < stages["points"]["in_obsmask"] <= stages["points"]["downsampled"]


def tnt_case(d: Path, cameras_json: bool):
    """The official protocol's files for a known similarity M between the
    reconstruction's frame and the GT frame: the GT cloud, the recon mesh,
    the estimated trajectory (.log, or a model's cameras.json), the GT
    trajectory under a second similarity Q with its trans file, the crop."""
    rng = np.random.default_rng(7)
    gt_pts = rng.uniform(0.2, 1.8, (4000, 3))
    th = 0.3
    R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                  [-np.sin(th), 0, np.cos(th)]])
    M = np.eye(4)
    M[:3, :3], M[:3, 3] = 1.7 * R, [0.4, -0.2, 0.9]
    inv = np.linalg.inv(M)
    recon = gt_pts @ inv[:3, :3].T + inv[:3, 3]
    recon += 0.003 * rng.normal(size=recon.shape)
    cams = np.tile(np.eye(4), (12, 1, 1))
    cams[:, :3, 3] = np.stack([2 * np.cos(np.linspace(0, 6, 12)),
                               np.linspace(0, 1, 12),
                               2 * np.sin(np.linspace(0, 6, 12))], -1)
    est = cams.copy()
    est[:, :3, 3] = cams[:, :3, 3] @ inv[:3, :3].T + inv[:3, 3]
    Q = np.eye(4)
    Q[:3, :3], Q[:3, 3] = 0.5 * np.eye(3), [1.0, 2.0, 3.0]
    colmap = cams.copy()
    colmap[:, :3, 3] = cams[:, :3, 3] @ Q[:3, :3].T + Q[:3, 3]

    store_point_cloud(str(d / "gt.ply"), gt_pts.astype(np.float32),
                      np.zeros_like(gt_pts, dtype=np.float32))
    # Degenerate faces: their centers are vertices, on the GT surface.
    faces = np.repeat(np.arange(0, len(recon), 2)[:, None], 3, 1)
    store_mesh(str(d / "recon.ply"), recon.astype(np.float32), faces)
    if cameras_json:
        traj = d / "cameras.json"
        traj.write_text(json.dumps([
            {"id": i, "img_name": f"{i:03d}.png", "position": p[:3, 3].tolist(),
             "rotation": p[:3, :3].tolist()} for i, p in enumerate(est)]))
    else:
        traj = d / "est.log"
        eval_tnt.write_trajectory_log(est, str(traj))
    eval_tnt.write_trajectory_log(colmap, str(d / "gt.log"))
    np.savetxt(str(d / "trans.txt"), np.linalg.inv(Q))
    (d / "crop.json").write_text(json.dumps(
        {"orthogonal_axis": "Y", "axis_min": -10.0, "axis_max": 10.0,
         "bounding_polygon": [[-10, 0, -10], [10, 0, -10], [10, 0, 10],
                              [-10, 0, 10]]}))
    return dict(data_ply=str(d / "recon.ply"), gt_ply=str(d / "gt.ply"),
                tau=0.02, crop_json=str(d / "crop.json"), traj=str(traj),
                gt_traj=str(d / "gt.log"), gt_trans=str(d / "trans.txt")), M


@pytest.mark.parametrize("cameras_json", [False, True])
def test_tnt_protocol_matches_script(tmp_path, cameras_json):
    kw, M = tnt_case(tmp_path, cameras_json)
    a = jax_tnt.evaluate(out_dir=str(tmp_path / "jax"), **kw)
    stages = {}
    b = eval_tnt.evaluate(out_dir=str(tmp_path / "port"), stages=stages, **kw)
    for k in ("fscore", "precision", "recall"):
        assert abs(b[k] - a[k]) <= 1e-9, k
    np.testing.assert_allclose(b["transform"], a["transform"], rtol=0,
                               atol=1e-9)
    assert a["fscore"] > 0.9
    np.testing.assert_allclose(np.asarray(b["transform"]), M, atol=2e-3)
    assert {"load_s", "alignment_s", "icp1_s", "icp2_s", "icp3_s",
            "histogram_s"} <= set(stages)


def test_tnt_simple_mode_matches_script(tmp_path):
    kw, _ = tnt_case(tmp_path, False)
    for k in ("traj", "gt_traj", "gt_trans"):
        kw.pop(k)
    a = jax_tnt.evaluate(out_dir=str(tmp_path / "jax"), **kw)
    b = eval_tnt.evaluate(out_dir=str(tmp_path / "port"), **kw)
    for k in ("fscore", "precision", "recall", "mean_d_recon_to_gt",
              "mean_d_gt_to_recon"):
        assert abs(b[k] - a[k]) <= 1e-9, k
