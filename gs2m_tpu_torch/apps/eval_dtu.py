"""DTU chamfer evaluation (the DTUeval-python protocol, numpy + scipy).

Port of scripts/eval_dtu.py, on the host as there: sample the mesh surface
at `downsample_density` (0.2 mm), radius-downsample after a seeded
shuffle, keep the samples inside the official ObsMask grid, take the mean
data -> STL distance; keep the STL points above the ground plane, take the
mean STL -> data distance; chamfer = the mean of both, each distance
clipped at `max_dist` (20 mm). Writes results.json with the script's keys
and values. `evaluate(..., stages=d)` also fills `d` with each stage's
host seconds (sample, downsample, obsmask, d2s, s2d) and the point counts
between them; the CLI prints them.

Usage: python -m gs2m_tpu_torch.apps.eval_dtu --data mesh.ply --scan 24 \\
           --dataset_dir <Official_DTU_Dataset> --vis_out_dir out/
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
from scipy.spatial import cKDTree


def sample_mesh_surface(vertices: np.ndarray, faces: np.ndarray,
                        density: float) -> np.ndarray:
    """Vertices + regular barycentric samples at ~`density` spacing
    (bucketed by (n1, n2) per triangle)."""
    tri = vertices[faces]
    v1 = tri[:, 1] - tri[:, 0]
    v2 = tri[:, 2] - tri[:, 0]
    l1 = np.linalg.norm(v1, axis=-1)
    l2 = np.linalg.norm(v2, axis=-1)
    area2 = np.linalg.norm(np.cross(v1, v2), axis=-1)
    ok = area2 > 0
    v1, v2, base, l1, l2, area2 = v1[ok], v2[ok], tri[ok, 0], l1[ok], l2[ok], area2[ok]
    thr = density * np.sqrt(l1 * l2 / area2)
    n1 = np.floor(l1 / thr).astype(np.int64)
    n2 = np.floor(l2 / thr).astype(np.int64)

    pts = [vertices]
    key = n1 * 100_000 + n2
    for k in np.unique(key):
        sel = key == k
        a, b = int(n1[sel][0]), int(n2[sel][0])
        c = np.mgrid[:a + 1, :b + 1].astype(np.float64) + 0.5
        c[0] /= max(a, 1e-7)
        c[1] /= max(b, 1e-7)
        c = c.transpose(1, 2, 0).reshape(-1, 2)
        k2 = c[c.sum(-1) < 1]                      # (m, 2) barycentric
        if len(k2) == 0:
            continue
        q = (v1[sel][:, None, :] * k2[None, :, :1]
             + v2[sel][:, None, :] * k2[None, :, 1:]
             + base[sel][:, None, :])
        pts.append(q.reshape(-1, 3))
    return np.concatenate(pts, 0)


def radius_downsample(points: np.ndarray, radius: float,
                      seed: int = 0) -> np.ndarray:
    """Greedy radius dedup after a seeded shuffle; the visiting order is the
    script's, so the kept points are the same."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(points))
    points = points[order]
    tree = cKDTree(points)
    mask = np.ones(len(points), bool)
    neighbors = tree.query_ball_point(points, r=radius, workers=-1)
    for i, idxs in enumerate(neighbors):
        if mask[i]:
            mask[idxs] = False
            mask[i] = True
    return points[mask]


def evaluate(data_ply: str, scan: int, dataset_dir: str,
             vis_out_dir: str = ".", downsample_density: float = 0.2,
             patch_size: float = 60.0, max_dist: float = 20.0,
             stages: dict | None = None) -> dict:
    from scipy.io import loadmat

    from gs2m_tpu_torch.data.ply import fetch_mesh, fetch_point_cloud

    st = {} if stages is None else stages
    t = time.perf_counter()

    def lap(name):
        nonlocal t
        now = time.perf_counter()
        st[f"{name}_s"] = now - t
        t = now

    verts, faces, _ = fetch_mesh(data_ply)
    if len(faces) > 0:
        data_pcd = sample_mesh_surface(verts.astype(np.float64), faces,
                                       downsample_density)
    else:
        data_pcd = verts.astype(np.float64)
    lap("sample")
    data_down = radius_downsample(data_pcd, downsample_density)
    lap("downsample")

    obs = loadmat(f"{dataset_dir}/ObsMask/ObsMask{scan}_10.mat")
    ObsMask, BB, Res = obs["ObsMask"], obs["BB"].astype(np.float32), obs["Res"]

    inbound = ((data_down >= BB[:1] - patch_size)
               & (data_down < BB[1:] + patch_size * 2)).sum(-1) == 3
    data_in = data_down[inbound]
    grid = np.around((data_in - BB[:1]) / Res).astype(np.int32)
    grid_in = ((grid >= 0) & (grid < np.expand_dims(ObsMask.shape, 0))).sum(-1) == 3
    gi = grid[grid_in]
    in_obs = ObsMask[gi[:, 0], gi[:, 1], gi[:, 2]].astype(bool)
    data_in_obs = data_in[grid_in][in_obs]
    lap("obsmask")

    stl, _, _ = fetch_point_cloud(
        f"{dataset_dir}/Points/stl/stl{scan:03}_total.ply")
    stl = stl.astype(np.float64)

    # Distances at or beyond max_dist are dropped from both means, so the
    # searches stop there (d = inf): the script's means, and no long
    # searches for points far from the other cloud.
    d2s, _ = cKDTree(stl).query(data_in_obs, k=1,
                                distance_upper_bound=max_dist, workers=-1)
    mean_d2s = float(d2s[d2s < max_dist].mean())
    lap("d2s")

    plane = loadmat(f"{dataset_dir}/ObsMask/Plane{scan}.mat")["P"]
    above = (np.concatenate([stl, np.ones_like(stl[:, :1])], -1)
             @ plane.reshape(4)) > 0
    s2d, _ = cKDTree(data_in).query(stl[above], k=1,
                                    distance_upper_bound=max_dist, workers=-1)
    mean_s2d = float(s2d[s2d < max_dist].mean())
    lap("s2d")
    st["points"] = {"sampled": len(data_pcd), "downsampled": len(data_down),
                    "in_obsmask": len(data_in_obs), "stl": len(stl),
                    "stl_above_plane": int(above.sum())}

    overall = (mean_d2s + mean_s2d) / 2
    os.makedirs(vis_out_dir, exist_ok=True)
    result = {"mean_d2s": mean_d2s, "mean_s2d": mean_s2d, "overall": overall}
    with open(os.path.join(vis_out_dir, "results.json"), "w") as f:
        json.dump(result, f, indent=True)
    print(f"[>] scan{scan} chamfer: d2s {mean_d2s:.3f} s2d {mean_s2d:.3f} "
          f"overall {overall:.3f}")
    return result


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--data", type=str, required=True)
    p.add_argument("--scan", type=int, required=True)
    p.add_argument("--dataset_dir", type=str, required=True)
    p.add_argument("--vis_out_dir", type=str, default=".")
    p.add_argument("--downsample_density", type=float, default=0.2)
    p.add_argument("--patch_size", type=float, default=60)
    p.add_argument("--max_dist", type=float, default=20)
    a = p.parse_args(argv)
    stages = {}
    result = evaluate(a.data, a.scan, a.dataset_dir, a.vis_out_dir,
                      a.downsample_density, a.patch_size, a.max_dist, stages)
    print(f"[>] eval_dtu stages: {json.dumps(stages)}")
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
