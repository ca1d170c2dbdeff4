"""Shiny Blender runner: material decomposition runs over six scenes.

Port of scripts/run_shiny.py: per scene its (reflection_threshold,
lambda_smooth, lambda_normal) triple with --material --eval
--white_background (`ball` adds --mask_gt) and the --extra tail, the
render app's --blender preset at the latest snapshot, metrics on the test
split. Apps run as `python -m gs2m_tpu_torch.apps.<app>` subprocesses on
the card (--device cpu passes --device cpu to each); runtime.json as in
run_dtu.

Usage: python -m gs2m_tpu_torch.apps.run_shiny --data <shiny_root> \\
           --out output/shiny [--scenes ball] [--extra <train flags>]
"""
from __future__ import annotations

import argparse
import sys
import time

from gs2m_tpu_torch.apps.run_dtu import device_flags, run, write_runtime

SCENES = ["helmet", "car", "teapot", "ball", "coffee", "toaster"]
REF_THRESHOLDS = [0.2, 0.5, 0.1, 0.4, 0.2, 0.1]
LAMBDA_SMOOTHS = [0.5, 0.0, 0.5, 0.1, 0.5, 0.8]
LAMBDA_NORMALS = [2.5, 0.5, 0.1, 8.0, 0.1, 4.0]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data", required=True)
    p.add_argument("--out", default="output/shiny")
    p.add_argument("--scenes", nargs="+", default=SCENES)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--extra", nargs=argparse.REMAINDER, default=[])
    args = p.parse_args(argv)
    dev = device_flags(args.device)

    label = "ours"
    runtimes = []
    for scene in args.scenes:
        i = SCENES.index(scene)
        t0 = time.time()
        train_args = ["--material", "--eval", "--white_background",
                      "--reflection_threshold", str(REF_THRESHOLDS[i]),
                      "--lambda_smooth", str(LAMBDA_SMOOTHS[i]),
                      "--lambda_normal", str(LAMBDA_NORMALS[i])]
        if scene == "ball":
            train_args.append("--mask_gt")
        run([sys.executable, "-m", "gs2m_tpu_torch.apps.train",
             "-s", f"{args.data}/{scene}", "-m", f"{args.out}/{scene}",
             *train_args, *dev, *args.extra])
        run([sys.executable, "-m", "gs2m_tpu_torch.apps.render",
             "-m", f"{args.out}/{scene}", "--blender", "--label", label, *dev])
        runtimes.append(time.time() - t0)
        run([sys.executable, "-m", "gs2m_tpu_torch.apps.metrics",
             "-m", f"{args.out}/{scene}", "--split", "test", *dev])

    write_runtime(args.out, label, runtimes)


if __name__ == "__main__":
    main(sys.argv[1:])
