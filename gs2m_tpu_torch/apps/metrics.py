"""Image-metrics CLI: PSNR / SSIM / LPIPS over render-vs-gt directories.

Port of gs2m_tpu/apps/metrics.py: walks <model>/<split>/<label_iter>/
{render,gt}, averages per-image PSNR (utils.images.psnr) and SSIM (the
training loss's 11x11 Gaussian window, ops.ssim.fused_ssim, on the device)
and LPIPS (utils/lpips.py) and writes per_view.json beside each method's
maps and metrics_<split>.json in the model directory. LPIPS needs
pretrained VGG weights, which the repo does not ship and nothing
downloads: it is computed when GS2M_LPIPS_WEIGHTS names a weights file and
reported as null otherwise, as in the JAX package. A split with no renders
is an empty result, not an error. Runs on CUDA (default) or, when asked,
on the CPU.

Usage: python -m gs2m_tpu_torch.apps.metrics -m <model_dir> [--split test]
"""
from __future__ import annotations

import json
import sys
from argparse import ArgumentParser
from pathlib import Path

import numpy as np
import torch


def evaluate_dir(method_dir: Path, device: torch.device) -> dict:
    from PIL import Image

    from gs2m_tpu_torch.ops.ssim import fused_ssim
    from gs2m_tpu_torch.utils.images import psnr
    from gs2m_tpu_torch.utils.lpips import lpips, weights_file

    try:
        lpips_weights = weights_file()
    except FileNotFoundError:
        lpips_weights = None  # no pretrained weights: LPIPS stays null

    render_dir = method_dir / "render"
    gt_dir = method_dir / "gt"
    names = sorted(p.name for p in render_dir.iterdir() if p.suffix == ".png")
    psnrs, ssims, lpipss = [], [], []
    for name in names:
        r = np.asarray(Image.open(render_dir / name), np.float32)[..., :3] / 255.0
        g = np.asarray(Image.open(gt_dir / name), np.float32)[..., :3] / 255.0
        psnrs.append(psnr(r, g))
        with torch.no_grad():
            ssims.append(float(fused_ssim(
                torch.from_numpy(r.transpose(2, 0, 1).copy())[None].to(device),
                torch.from_numpy(g.transpose(2, 0, 1).copy())[None].to(device))))
        if lpips_weights is not None:
            lpipss.append(float(lpips(r.transpose(2, 0, 1),
                                      g.transpose(2, 0, 1), lpips_weights,
                                      device)))
    return {
        "PSNR": float(np.mean(psnrs)) if psnrs else None,
        "SSIM": float(np.mean(ssims)) if ssims else None,
        "LPIPS": float(np.mean(lpipss)) if lpipss else None,
        "per_view": {n: {"PSNR": p, "SSIM": s}
                     for n, p, s in zip(names, psnrs, ssims)},
    }


def main(argv=None) -> dict:
    """-> {method: {"PSNR", "SSIM", "LPIPS"}} of the split (empty when the
    split has no renders)."""
    from gs2m_tpu_torch import resolve_device

    parser = ArgumentParser(description="gs2m_tpu_torch metrics")
    parser.add_argument("--model_path", "-m", required=True, type=str)
    parser.add_argument("--split", default="train", type=str)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    split_dir = Path(args.model_path) / args.split
    if not split_dir.is_dir():
        # A missing split (e.g. --split test on a run without --eval) is an
        # empty result, not a crash: gates call this unconditionally.
        print(f"[!] No {args.split} renders under {args.model_path}")
        return {}
    results = {}
    for method_dir in sorted(split_dir.iterdir()):
        if not (method_dir / "render").exists():
            continue
        print(f"[>] Evaluating {method_dir.name}")
        res = evaluate_dir(method_dir, device)
        per_view = res.pop("per_view")
        results[method_dir.name] = res
        with open(method_dir / "per_view.json", "w") as f:
            json.dump(per_view, f, indent=2)
        if res["PSNR"] is None:
            print("    no renders found — skipping")
            continue
        print(f"    PSNR {res['PSNR']:.3f}  SSIM {res['SSIM']:.4f}")

    out = Path(args.model_path) / f"metrics_{args.split}.json"
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"[>] Wrote {out}")
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
