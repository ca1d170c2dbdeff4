"""DTU benchmark runner: train -> render + mesh -> metrics -> chamfer over
the 15 scans.

Port of scripts/run_dtu.py: the same scan list and flag presets (-r 2
--lambda_depth_normal 0.015; --material adds --material --mask_gt
--reflection_threshold 1.0 --lambda_smooth 0.0 --lambda_normal 0.1), each
app launched as `python -m gs2m_tpu_torch.apps.<app>` in a subprocess with
PYTHONPATH at the repo root, the --extra tail passed to the train app
unchanged, and the mean train + render minutes per scan written to
runtime.json under the run's label. The apps run on the card; --device cpu
passes --device cpu to each of them.

Usage: python -m gs2m_tpu_torch.apps.run_dtu --data <dtu_root> \\
           --out output/dtu [--dtu_official <Official_DTU_Dataset>] \\
           [--material] [--scenes 24 37] [--extra <train flags>]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

SCENES = [24, 37, 40, 55, 63, 65, 69, 83, 97, 105, 106, 110, 114, 118, 122]
ROOT = Path(__file__).resolve().parents[2]


def run(cmd: list[str]):
    print("[>] " + " ".join(cmd), flush=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run(cmd, check=True, cwd=ROOT, env=env)


def device_flags(device: str) -> list[str]:
    """The apps' own default is the card: name the device only otherwise."""
    return [] if device == "cuda" else ["--device", device]


def write_runtime(out: str, label: str, runtimes: list[float]):
    """Merge the mean minutes per scene into <out>/runtime.json."""
    runtime_file = Path(out) / "runtime.json"
    data = json.loads(runtime_file.read_text()) if runtime_file.exists() else {}
    data[label] = round(sum(runtimes) / len(runtimes) / 60, 2)
    runtime_file.write_text(json.dumps(data, indent=2))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data", required=True)
    p.add_argument("--out", default="output/dtu")
    p.add_argument("--dtu_official", default="")
    p.add_argument("--material", action="store_true")
    p.add_argument("--scenes", nargs="+", type=int, default=SCENES)
    p.add_argument("--iterations", type=int, default=30_000)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--extra", nargs=argparse.REMAINDER, default=[])
    args = p.parse_args(argv)
    dev = device_flags(args.device)

    label = "ours" if args.material else "ours_wo-brdf"
    runtimes = []
    for scene in args.scenes:
        t0 = time.time()
        train_args = ["-r", "2", "--lambda_depth_normal", "0.015",
                      "--iterations", str(args.iterations)]
        if args.material:
            train_args += ["--material", "--mask_gt",
                           "--reflection_threshold", "1.0",
                           "--lambda_smooth", "0.0", "--lambda_normal", "0.1"]
        run([sys.executable, "-m", "gs2m_tpu_torch.apps.train",
             "-s", f"{args.data}/scan{scene}", "-m", f"{args.out}/scan{scene}",
             *train_args, *dev, *args.extra])
        run([sys.executable, "-m", "gs2m_tpu_torch.apps.render",
             "-m", f"{args.out}/scan{scene}", "--dtu", "--label", label, *dev])
        runtimes.append(time.time() - t0)

        run([sys.executable, "-m", "gs2m_tpu_torch.apps.metrics",
             "-m", f"{args.out}/scan{scene}", "--split", "train", *dev])
        if args.dtu_official:
            run([sys.executable, "-m", "gs2m_tpu_torch.apps.eval_dtu",
                 "--data", f"{args.out}/scan{scene}/train/"
                           f"{label}_{args.iterations}/mesh/tsdf_post.ply",
                 "--scan", str(scene), "--dataset_dir", args.dtu_official,
                 "--vis_out_dir", f"{args.out}/scan{scene}"])
        print(f"==> Done with scan{scene} <==\n", flush=True)

    write_runtime(args.out, label, runtimes)


if __name__ == "__main__":
    main(sys.argv[1:])
