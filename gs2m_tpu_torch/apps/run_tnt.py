"""Tanks and Temples runner: train -> mesh -> F-score.

Port of scripts/run_tnt.py: per scene, the train app with -r 2
--densify_grad_abs_threshold 0.00015 --opacity_prune_threshold 0.05 (and
the --extra tail), the render app's --tnt preset, Truck's mesh turned by
pi/8 about y before the evaluation, and the F-score (apps.eval_tnt) where
the scene's GT cloud <scene>/<scene>.ply exists, with the official
trajectory files (<scene>_COLMAP_SfM.log, <scene>_trans.txt) and the crop
<scene>.json when present; the estimated trajectory is the model's
cameras.json. Apps run as `python -m gs2m_tpu_torch.apps.<app>`
subprocesses on the card (--device cpu passes --device cpu to the train
and render apps); runtime.json as in run_dtu.

Usage: python -m gs2m_tpu_torch.apps.run_tnt --data <tnt_root> \\
           --out output/tnt [--scenes Barn Truck] [--extra <train flags>]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from gs2m_tpu_torch.apps.run_dtu import device_flags, run, write_runtime

SCENES = ["Barn", "Truck"]


def rotate_truck_mesh(mesh_path: str):
    """Truck's alignment fix: the mesh turned by pi/8 about y, in place."""
    from gs2m_tpu_torch.data.ply import fetch_mesh, store_mesh

    v, f, c = fetch_mesh(mesh_path)
    th = np.pi / 8
    R = np.array([[np.cos(th), 0, np.sin(th)],
                  [0, 1, 0],
                  [-np.sin(th), 0, np.cos(th)]])
    store_mesh(mesh_path, (v @ R.T).astype(np.float32), f, c)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data", required=True)
    p.add_argument("--out", default="output/tnt")
    p.add_argument("--scenes", nargs="+", default=SCENES)
    p.add_argument("--iterations", type=int, default=30_000)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--extra", nargs=argparse.REMAINDER, default=[])
    args = p.parse_args(argv)
    dev = device_flags(args.device)

    label = "ours_wo-brdf"
    runtimes = []
    for scene in args.scenes:
        t0 = time.time()
        run([sys.executable, "-m", "gs2m_tpu_torch.apps.train",
             "-s", f"{args.data}/{scene}", "-m", f"{args.out}/{scene}",
             "-r", "2", "--densify_grad_abs_threshold", "0.00015",
             "--opacity_prune_threshold", "0.05",
             "--iterations", str(args.iterations), *dev, *args.extra])
        run([sys.executable, "-m", "gs2m_tpu_torch.apps.render",
             "-m", f"{args.out}/{scene}", "--tnt", "--label", label, *dev])
        runtimes.append(time.time() - t0)

        mesh = (f"{args.out}/{scene}/train/{label}_{args.iterations}"
                "/mesh/tsdf_post.ply")
        if scene == "Truck":
            rotate_truck_mesh(mesh)
        gt = f"{args.data}/{scene}/{scene}.ply"
        if os.path.exists(gt):
            cmd = [sys.executable, "-m", "gs2m_tpu_torch.apps.eval_tnt",
                   "--data", mesh, "--gt", gt, "--scene", scene,
                   "--out_dir", f"{args.out}/{scene}/evaluation"]
            # The official protocol's files, when present: the COLMAP SfM
            # log, the GT alignment and the crop -> trajectory-based
            # registration; the estimate is the model's cameras.json.
            gt_traj = f"{args.data}/{scene}/{scene}_COLMAP_SfM.log"
            gt_trans = f"{args.data}/{scene}/{scene}_trans.txt"
            cropfile = f"{args.data}/{scene}/{scene}.json"
            if os.path.exists(gt_traj):
                cmd += ["--traj", f"{args.out}/{scene}/cameras.json",
                        "--gt-traj", gt_traj]
                if os.path.exists(gt_trans):
                    cmd += ["--gt-trans", gt_trans]
            if os.path.exists(cropfile):
                cmd += ["--crop", cropfile]
            run(cmd)
        else:
            print(f"[!] GT point cloud {gt} not found; skipping F-score")

    write_runtime(args.out, label, runtimes)


if __name__ == "__main__":
    main(sys.argv[1:])
