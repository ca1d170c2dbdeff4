"""DTU report: the per-scan chamfer and PSNR / SSIM table.

Port of scripts/report_dtu.py: collects each scan's results.json (chamfer)
and metrics_train.json (PSNR / SSIM of `<label>_<iterations>`) under
--out, prints the table with its mean row and writes chamfer.json (the
rows and their mean).

Usage: python -m gs2m_tpu_torch.apps.report_dtu --out output/dtu \\
           [--label ours_wo-brdf] [--iterations 30000]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from gs2m_tpu_torch.apps.run_dtu import SCENES


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="output/dtu")
    p.add_argument("--label", default="ours_wo-brdf")
    p.add_argument("--iterations", type=int, default=30_000)
    args = p.parse_args(argv)

    rows = {}
    for scene in SCENES:
        scan_dir = Path(args.out) / f"scan{scene}"
        row = {}
        rj = scan_dir / "results.json"
        if rj.exists():
            row.update(json.loads(rj.read_text()))
        mj = scan_dir / "metrics_train.json"
        if mj.exists():
            m = json.loads(mj.read_text())
            key = f"{args.label}_{args.iterations}"
            if key in m:
                row["PSNR"] = m[key]["PSNR"]
                row["SSIM"] = m[key]["SSIM"]
        if row:
            rows[f"scan{scene}"] = row

    if not rows:
        print("[!] No results found")
        return None

    def mean_of(key):
        vals = [r[key] for r in rows.values() if key in r and r[key] is not None]
        return sum(vals) / len(vals) if vals else None

    summary = {k: mean_of(k) for k in ("mean_d2s", "mean_s2d", "overall",
                                       "PSNR", "SSIM")}
    print(f"{'scan':>8} {'d2s':>7} {'s2d':>7} {'chamfer':>8} {'PSNR':>7} {'SSIM':>7}")
    for name, r in rows.items():
        print(f"{name:>8} {r.get('mean_d2s', float('nan')):7.3f} "
              f"{r.get('mean_s2d', float('nan')):7.3f} "
              f"{r.get('overall', float('nan')):8.3f} "
              f"{r.get('PSNR', float('nan')):7.2f} {r.get('SSIM', float('nan')):7.4f}")
    print(f"{'mean':>8} " + " ".join(
        f"{summary[k]:7.3f}" if summary[k] is not None else "      -"
        for k in ("mean_d2s", "mean_s2d", "overall")) +
        (f" {summary['PSNR']:7.2f}" if summary["PSNR"] else "") +
        (f" {summary['SSIM']:7.4f}" if summary["SSIM"] else ""))

    out = dict(rows)
    out["mean"] = summary
    (Path(args.out) / "chamfer.json").write_text(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
