"""Tanks and Temples F-score evaluation (the official toolbox's protocol,
numpy + scipy, no Open3D).

Port of scripts/eval_tnt.py, on the host as there:

  1. recon point set = mesh vertices + face centers
  2. initial similarity from the camera trajectories: the estimated
     trajectory against the scene's `<scene>_COLMAP_SfM.log` with the GT
     `<scene>_trans.txt` applied, index-matched positions, point-to-point
     with scaling (Umeyama)
  3. three ICP refinements against the GT cloud cropped to the scene's
     `<scene>.json` polygon volume: voxel tau at threshold 80 tau, voxel
     tau/2 at 20 tau, uniform at 2 tau, point-to-point with scaling,
     20 iterations each
  4. the histogram: crop both, voxel-downsample at tau/2, nearest
     distances both ways, precision / recall / F at tau

Per-scene taus from the toolbox's config. Without trajectory files:
an optional fixed --alignment and raw ICP. `evaluate(..., stages=d)` also
fills `d` with the host seconds of the alignment, each ICP stage and the
histogram; the CLI prints them. Writes evaluation.json with the script's
keys and values.

Usage:
  python -m gs2m_tpu_torch.apps.eval_tnt --data mesh.ply --gt Barn.ply \\
      --traj est_traj.log --gt-traj Barn_COLMAP_SfM.log \\
      --gt-trans Barn_trans.txt --crop Barn.json --scene Barn
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
from scipy.spatial import cKDTree

# The toolbox's per-scene distance thresholds.
SCENES_TAU = {"Barn": 0.01, "Caterpillar": 0.005, "Church": 0.025,
              "Courthouse": 0.025, "Ignatius": 0.003, "Meetingroom": 0.01,
              "Truck": 0.005}


# --- trajectory IO (the TnT .log format) ------------------------------------------

def read_trajectory_log(path: str) -> np.ndarray:
    """Parse a TnT .log file -> (N, 4, 4) camera-to-world poses."""
    poses = []
    with open(path) as f:
        meta = f.readline()
        while meta.strip():
            rows = [np.fromstring(f.readline(), dtype=np.float64, sep=" \t")
                    for _ in range(4)]
            poses.append(np.stack(rows))
            meta = f.readline()
    return np.stack(poses) if poses else np.zeros((0, 4, 4))


def write_trajectory_log(poses: np.ndarray, path: str):
    with open(path, "w") as f:
        for i, p in enumerate(poses):
            f.write(f"{i} {i} 0\n")
            for row in p:
                f.write(" ".join(f"{v:.12f}" for v in row) + "\n")


def trajectory_from_cameras_json(path: str) -> np.ndarray:
    """(N, 4, 4) c2w poses from a model's cameras.json (`rotation` rows +
    `position`), in the order of their `id`."""
    with open(path) as f:
        cams = json.load(f)
    poses = []
    for c in sorted(cams, key=lambda c: c["id"]):
        m = np.eye(4)
        m[:3, :3] = np.asarray(c["rotation"], np.float64)
        m[:3, 3] = np.asarray(c["position"], np.float64)
        poses.append(m)
    return np.stack(poses)


def load_trajectory(path: str) -> np.ndarray:
    if path.endswith(".json"):
        return trajectory_from_cameras_json(path)
    if path.endswith(".npy"):
        return np.load(path).astype(np.float64)
    return read_trajectory_log(path)


# --- crop volumes (Open3D's SelectionPolygonVolume json) ----------------------------

class CropVolume:
    """Polygon volume: points inside the polygon when projected along
    `orthogonal_axis`, with that axis clamped to [axis_min, axis_max]."""

    AXES = {"X": 0, "Y": 1, "Z": 2}

    def __init__(self, axis: int, lo: float, hi: float, poly2d: np.ndarray):
        self.axis, self.lo, self.hi, self.poly = axis, lo, hi, poly2d

    @classmethod
    def load(cls, path: str) -> "CropVolume":
        with open(path) as f:
            d = json.load(f)
        axis = cls.AXES[d["orthogonal_axis"].upper()]
        poly = np.asarray(d["bounding_polygon"], np.float64)
        keep = [i for i in range(3) if i != axis]
        return cls(axis, float(d["axis_min"]), float(d["axis_max"]),
                   poly[:, keep])

    def contains(self, pts: np.ndarray) -> np.ndarray:
        keep = [i for i in range(3) if i != self.axis]
        in_axis = (pts[:, self.axis] >= self.lo) & (pts[:, self.axis] <= self.hi)
        return in_axis & _points_in_polygon(pts[:, keep], self.poly)

    def crop(self, pts: np.ndarray) -> np.ndarray:
        return pts[self.contains(pts)]


def _points_in_polygon(pts2d: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """Vectorized even-odd-rule point-in-polygon."""
    x, y = pts2d[:, 0], pts2d[:, 1]
    inside = np.zeros(len(pts2d), bool)
    n = len(poly)
    for i in range(n):
        x0, y0 = poly[i]
        x1, y1 = poly[(i + 1) % n]
        crosses = (y0 > y) != (y1 > y)
        with np.errstate(divide="ignore", invalid="ignore"):
            xint = x0 + (y - y0) * (x1 - x0) / (y1 - y0)
        inside ^= crosses & (x < xint)
    return inside


class BoxVolume:
    """Axis-aligned {"min": [...], "max": [...]} crop (simple mode)."""

    def __init__(self, lo, hi):
        self.lo, self.hi = np.asarray(lo), np.asarray(hi)

    def crop(self, pts):
        return pts[((pts >= self.lo) & (pts <= self.hi)).all(-1)]


def load_crop(path: str):
    with open(path) as f:
        d = json.load(f)
    if "bounding_polygon" in d:
        return CropVolume.load(path)
    return BoxVolume(d["min"], d["max"])


# --- similarity registration (point-to-point with scaling) -------------------------

def umeyama_similarity(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares similarity (sR | t) mapping src -> dst, 4x4."""
    cs, cd = src.mean(0), dst.mean(0)
    a, b = src - cs, dst - cd
    H = a.T @ b / len(src)
    U, S, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    D = np.diag([1.0, 1.0, d])
    R = Vt.T @ D @ U.T
    var = (a * a).sum() / len(src)
    s = float(np.trace(np.diag(S) @ D) / (var + 1e-30))
    T = np.eye(4)
    T[:3, :3] = s * R
    T[:3, 3] = cd - s * R @ cs
    return T


def apply_T(pts: np.ndarray, T: np.ndarray) -> np.ndarray:
    return pts @ T[:3, :3].T + T[:3, 3]


def icp_similarity(src: np.ndarray, dst: np.ndarray, threshold: float,
                   iters: int = 20) -> np.ndarray:
    """Point-to-point ICP with scale. Returns the 4x4 refinement (applied
    after whatever produced src)."""
    T = np.eye(4)
    cur = src.copy()
    tree = cKDTree(dst)
    for _ in range(iters):
        # Pairs at or beyond the threshold are dropped, so the search stops
        # there (those points get d = inf): the script's pairs, and no long
        # searches for points far from the GT.
        d, j = tree.query(cur, k=1, distance_upper_bound=threshold,
                          workers=-1)
        m = d < threshold
        if m.sum() < 10:
            break
        step = umeyama_similarity(cur[m], dst[j[m]])
        T = step @ T
        cur = apply_T(cur, step)
    return T


def voxel_downsample(points: np.ndarray, voxel: float) -> np.ndarray:
    keys = np.floor(points / voxel).astype(np.int64)
    _, idx = np.unique(keys, axis=0, return_index=True)
    return points[np.sort(idx)]


def uniform_downsample(points: np.ndarray, max_n: float = 4e6) -> np.ndarray:
    if len(points) > max_n:
        rate = int(round(len(points) / max_n))
        return points[::rate]
    return points


def _crop_ds(pts, vol, method, voxel, T):
    """The toolbox's crop_and_downsample."""
    p = apply_T(pts, T)
    if vol is not None:
        p = vol.crop(p)
    if method == "voxel":
        return voxel_downsample(p, voxel)
    return uniform_downsample(p)


def refine_registration(recon, gt, T0, vol, tau, stages: dict | None = None):
    """The toolbox's three-stage refinement; with `stages`, each stage's
    seconds as icp{k}_s."""
    steps = [("voxel", tau, 80 * tau), ("voxel", tau / 2.0, 20 * tau),
             ("uniform", None, 2 * tau)]
    T = T0
    for k, (method, voxel, thr) in enumerate(steps):
        t0 = time.perf_counter()
        s = _crop_ds(recon, vol, method, voxel, T)
        t = _crop_ds(gt, vol, method if method == "voxel" else "uniform",
                     voxel, np.eye(4))
        if len(s) < 10 or len(t) < 10:
            break
        T = icp_similarity(s, t, thr) @ T
        if stages is not None:
            stages[f"icp{k + 1}_s"] = time.perf_counter() - t0
    return T


# --- F-score (the toolbox's EvaluateHisto) -----------------------------------------

def f_score(recon: np.ndarray, gt: np.ndarray, tau: float) -> dict:
    d_r2g, _ = cKDTree(gt).query(recon, k=1, workers=-1)
    d_g2r, _ = cKDTree(recon).query(gt, k=1, workers=-1)
    precision = float((d_r2g < tau).mean())
    recall = float((d_g2r < tau).mean())
    f = (2 * precision * recall / (precision + recall)
         if precision + recall > 0 else 0.0)
    return {"precision": precision, "recall": recall, "fscore": f, "tau": tau,
            "mean_d_recon_to_gt": float(d_r2g.mean()),
            "mean_d_gt_to_recon": float(d_g2r.mean())}


def evaluate_histo(recon, gt, T, vol, tau):
    s = apply_T(recon, T)
    if vol is not None:
        s = vol.crop(s)
        gt = vol.crop(gt)
    s = voxel_downsample(s, tau / 2.0)
    t = voxel_downsample(gt, tau / 2.0)
    return f_score(s, t, tau)


# --- entry points --------------------------------------------------------------------

def load_recon_points(data_ply: str) -> np.ndarray:
    """Mesh vertices + face centers."""
    from gs2m_tpu_torch.data.ply import fetch_mesh

    verts, faces, _ = fetch_mesh(data_ply)
    verts = verts.astype(np.float64)
    if len(faces) > 0:
        centers = verts[faces].mean(axis=1)
        return np.concatenate([verts, centers], axis=0)
    return verts


def evaluate(data_ply: str, gt_ply: str, tau: float = 0.01,
             alignment: str | None = None, crop_json: str | None = None,
             icp: bool = True, out_dir: str = ".",
             traj: str | None = None, gt_traj: str | None = None,
             gt_trans: str | None = None, stages: dict | None = None) -> dict:
    from gs2m_tpu_torch.data.ply import fetch_point_cloud

    st = {} if stages is None else stages
    t0 = time.perf_counter()
    recon = load_recon_points(data_ply)
    gt, _, _ = fetch_point_cloud(gt_ply)
    gt = gt.astype(np.float64)
    vol = load_crop(crop_json) if crop_json and os.path.exists(crop_json) else None
    st["load_s"] = time.perf_counter() - t0
    st["points"] = {"recon": len(recon), "gt": len(gt)}

    if traj and gt_traj:
        # The official protocol: trajectory alignment + staged ICP.
        t0 = time.perf_counter()
        est_pos = load_trajectory(traj)[:, :3, 3]
        gt_pos = load_trajectory(gt_traj)[:, :3, 3]
        if gt_trans and os.path.exists(gt_trans):
            M = np.loadtxt(gt_trans).reshape(4, 4)
            gt_pos = apply_T(gt_pos, M)
        n = min(len(est_pos), len(gt_pos))
        if len(est_pos) != len(gt_pos):
            print(f"[!] trajectory lengths differ ({len(est_pos)} vs "
                  f"{len(gt_pos)}); using the first {n} index-matched pairs")
        T0 = umeyama_similarity(est_pos[:n], gt_pos[:n])
        st["alignment_s"] = time.perf_counter() - t0
        T = refine_registration(recon, gt, T0, vol, tau, st) if icp else T0
        t0 = time.perf_counter()
        result = evaluate_histo(recon, gt, T, vol, tau)
        st["histogram_s"] = time.perf_counter() - t0
        result["transform"] = T.tolist()
    else:
        # Simple mode: an optional fixed alignment + raw ICP.
        T = np.eye(4)
        if alignment and os.path.exists(alignment):
            T = np.loadtxt(alignment).reshape(4, 4)
        if icp and len(recon) > 100:
            T = refine_registration(recon, gt, T, vol, tau, st)
        t0 = time.perf_counter()
        result = evaluate_histo(recon, gt, T, vol, tau)
        st["histogram_s"] = time.perf_counter() - t0

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "evaluation.json"), "w") as f:
        json.dump(result, f, indent=True)
    print(f"[>] F-score@{tau}: {result['fscore']:.4f} "
          f"(P {result['precision']:.4f} R {result['recall']:.4f})")
    return result


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--data", type=str, required=True)
    p.add_argument("--gt", type=str, required=True)
    p.add_argument("--tau", type=float, default=None)
    p.add_argument("--scene", type=str, default=None,
                   help="official scene name -> per-scene tau")
    p.add_argument("--alignment", type=str, default=None)
    p.add_argument("--crop", type=str, default=None,
                   help="official <scene>.json cropfile or {min,max} box")
    p.add_argument("--traj", type=str, default=None,
                   help="estimated trajectory (.log/.npy/cameras.json)")
    p.add_argument("--gt-traj", type=str, default=None,
                   help="<scene>_COLMAP_SfM.log")
    p.add_argument("--gt-trans", type=str, default=None,
                   help="<scene>_trans.txt GT alignment")
    p.add_argument("--no-icp", action="store_true")
    p.add_argument("--out_dir", type=str, default=".")
    a = p.parse_args(argv)
    tau = a.tau if a.tau is not None else SCENES_TAU.get(a.scene or "", 0.01)
    stages = {}
    result = evaluate(a.data, a.gt, tau, a.alignment, a.crop, not a.no_icp,
                      a.out_dir, traj=a.traj, gt_traj=a.gt_traj,
                      gt_trans=a.gt_trans, stages=stages)
    print(f"[>] eval_tnt stages: {json.dumps(stages)}")
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
