"""Glossy Blender (NeRO synthetic) runner: 10k-iteration material runs over
eight scenes.

Port of scripts/run_glossy.py: per scene (<data>/<scene>_blender) the
train app with --mask_gt --material --eval --white_background
--reflection_threshold 0.2 --lambda_smooth 0.5 --lambda_normal 0.5
--iterations 10000 and the --extra tail, then the render app's --blender
preset pinned to --iteration 10000. Apps run as
`python -m gs2m_tpu_torch.apps.<app>` subprocesses on the card (--device
cpu passes --device cpu to both); runtime.json as in run_dtu.

Usage: python -m gs2m_tpu_torch.apps.run_glossy --data <glossy_root> \\
           --out output/glossy [--scenes angel] [--extra <train flags>]
"""
from __future__ import annotations

import argparse
import sys
import time

from gs2m_tpu_torch.apps.run_dtu import device_flags, run, write_runtime

SCENES = ["angel", "bell", "cat", "horse", "luyu", "potion", "tbell", "teapot"]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data", required=True)
    p.add_argument("--out", default="output/glossy")
    p.add_argument("--scenes", nargs="+", default=SCENES)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--extra", nargs=argparse.REMAINDER, default=[])
    args = p.parse_args(argv)
    dev = device_flags(args.device)

    label = "ours"
    runtimes = []
    for scene in args.scenes:
        t0 = time.time()
        run([sys.executable, "-m", "gs2m_tpu_torch.apps.train",
             "-s", f"{args.data}/{scene}_blender", "-m", f"{args.out}/{scene}",
             "--mask_gt", "--material", "--eval", "--white_background",
             "--reflection_threshold", "0.2", "--lambda_smooth", "0.5",
             "--lambda_normal", "0.5", "--iterations", "10000", *dev,
             *args.extra])
        run([sys.executable, "-m", "gs2m_tpu_torch.apps.render",
             "-m", f"{args.out}/{scene}", "--blender", "--iteration", "10000",
             "--label", label, *dev])
        runtimes.append(time.time() - t0)

    write_runtime(args.out, label, runtimes)


if __name__ == "__main__":
    main(sys.argv[1:])
