"""Write a TnT-style transforms.json with an aabb_range from a COLMAP model.

Port of scripts/preprocess/convert_json.py: the scene's center and radius
from the pairwise closest points of the cameras' look-at rays (concentric
captures) or, with --by_points, from the 3D points' statistics (mean +- 3
sigma box); transforms.json carries the `aabb_range` that the render app's
--tnt preset bounds the TSDF volume with.

Usage: python -m gs2m_tpu_torch.apps.convert_json --data_dir <scene>
"""
from __future__ import annotations

import json
import os
import sys
from argparse import ArgumentParser

import numpy as np

from gs2m_tpu_torch.data import colmap as cm


def closest_point(p1, d1, p2, d2):
    d1 = d1 / np.linalg.norm(d1)
    d2 = d2 / np.linalg.norm(d2)
    A = np.vstack((d1, -d2)).T
    b = p2 - p1
    t1, t2 = np.linalg.lstsq(A, b, rcond=None)[0]
    return 0.5 * ((p1 + d1 * t1) + (p2 + d2 * t2))


def bound_by_pose(images: dict):
    poses = []
    for img in images.values():
        w2c = np.eye(4)
        w2c[:3, :3] = cm.qvec_to_rotmat(img.qvec)
        w2c[:3, 3] = img.tvec
        poses.append(np.linalg.inv(w2c))
    center = np.zeros(3)
    for f in poses:
        for g in poses:
            center += closest_point(f[:3, 3], f[:3, 2], g[:3, 3], g[:3, 2])
    center /= len(poses) ** 2
    radius = float(np.mean([np.linalg.norm(f[:3, 3]) for f in poses]))
    box = [[center[i] - radius, center[i] + radius] for i in range(3)]
    return center, radius, box


def bound_by_points(xyz: np.ndarray):
    center = xyz.mean(0)
    std = xyz.std(0)
    radius = float(std.max() * 2)
    box = [[center[i] - 3 * std[i], center[i] + 3 * std[i]] for i in range(3)]
    return center, radius, box


def main(argv=None) -> dict:
    p = ArgumentParser()
    p.add_argument("--data_dir", required=True)
    p.add_argument("--by_points", action="store_true")
    args = p.parse_args(argv)

    sparse = os.path.join(args.data_dir, "sparse/0")
    if os.path.exists(os.path.join(sparse, "images.bin")):
        images = cm.read_images_binary(os.path.join(sparse, "images.bin"))
    else:
        images = cm.read_images_text(os.path.join(sparse, "images.txt"))

    if args.by_points:
        if os.path.exists(os.path.join(sparse, "points3D.bin")):
            xyz, _, _ = cm.read_points3d_binary(os.path.join(sparse, "points3D.bin"))
        else:
            xyz, _, _ = cm.read_points3d_text(os.path.join(sparse, "points3D.txt"))
        center, radius, box = bound_by_points(xyz)
    else:
        center, radius, box = bound_by_pose(images)

    out = {"aabb_range": box, "center": center.tolist(), "radius": radius}
    path = os.path.join(args.data_dir, "transforms.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(f"[>] Wrote {path}: center {np.round(center, 3).tolist()} "
          f"radius {radius:.3f}")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
