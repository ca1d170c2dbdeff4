"""The yardstick's work counts: the float operations and bytes that the
plain math of a training step needs, from its inputs, and the peaks of the
card they are held against.

A render's blend is counted by (Gaussian, pixel) pairs that contribute
(alpha >= 1/255 and the pixel not yet terminated), found by the
reference's own walk on the cell's views: a count of the work the math
needs, not of the slots or chunks an implementation walks. Bytes count
each input byte read once and each output byte written once. The per-pair
and per-item operation counts below are fixed here, so every
implementation is measured against the same numbers.
"""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent.parent / "peaks.json").read_text())

# Float operations per contributing pair. Forward: the pixel offset (2),
# the quadratic form (9), exp (1), alpha and its clamp (2), log1p(1 -
# alpha) (2), the running log-transmittance sum (1), T = exp(test - log1m)
# (2), the weight (1), and 2 per value channel. Backward: the forward again
# (20), u = vals . g (2 per channel), the suffix sum and dalpha (8), dpower
# and the offsets' gradients (10), the conic's (6), opacity's (2), the
# |d mean| sums (4), and 2 per channel for the values' gradients.
K1_OPS_PER_PAIR = 20
K1_OPS_PER_PAIR_CHANNEL = 2
K2_OPS_PER_PAIR = 50
K2_OPS_PER_PAIR_CHANNEL = 4
# Per visible Gaussian and render: the covariance (30), its projection and
# the conic and radius (60), the degree-3 SH colour (16 basis terms, 3
# channels: 130); the backward of a differentiated render twice that.
PROJECT_OPS = 220
# Per pixel of a differentiated view: SSIM (5 separable 11-tap blurs of 3
# channels, 660, and 40 elementwise), L1 and the clips (8), the
# depth-normal term with its normals from depth (60), the multi-view
# reprojection and geometric term (100); the backward twice the forward.
PIXEL_OPS = 868
# Per multi-view (or roughness) sample: a 7x7 patch, bilinear taps (20 per
# tap) and the NCC sums (10 per tap), and its homography (40).
SAMPLE_OPS = 1510
# Per pixel of a PBR-shaded view: the diffuse lookup (30), six specular
# lookups (180), the LUT (30), the mip blend and shading (40), SSIM and L1
# of the PBR image (708), the smoothness and normal TV terms (40).
PBR_PIXEL_OPS = 1028


def f32_bytes(n) -> int:
    return 4 * int(n)


def k1_work(pairs: int, visible: int, pixels: int, channels: int) -> dict:
    """One forward blend: channels = values blended (3 colour + features)."""
    ops = pairs * (K1_OPS_PER_PAIR + K1_OPS_PER_PAIR_CHANNEL * channels)
    # Read: mean (2), conic (3), opacity (1) and values of each visible
    # Gaussian. Written: the image and final transmittance per pixel.
    nbytes = f32_bytes(visible * (6 + channels)) + f32_bytes(pixels * (channels + 1))
    return {"ops": ops, "bytes": nbytes}


def k2_work(pairs: int, visible: int, pixels: int, channels: int) -> dict:
    """One backward blend."""
    ops = pairs * (K2_OPS_PER_PAIR + K2_OPS_PER_PAIR_CHANNEL * channels)
    # Read: the Gaussians' geometry and values, per pixel the image and
    # transmittance cotangents and the final transmittance. Written: per
    # Gaussian the geometry (6), |d mean| (2) and value gradients.
    nbytes = (f32_bytes(visible * (6 + channels)) + f32_bytes(pixels * (channels + 2))
              + f32_bytes(visible * (8 + channels)))
    return {"ops": ops, "bytes": nbytes}


def least_seconds(work: dict) -> tuple[float, str]:
    """max(bytes / bandwidth, ops / float32 peak) and which bound it."""
    t_ops = work["ops"] / PEAKS["float32_flops"]
    t_bytes = work["bytes"] / PEAKS["hbm_bytes_per_s"]
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")


def prefilter_ops(base_res: int, diffuse_res: int, specular_res: list) -> int:
    """The light's prefilter matmuls: (6 R^2)^2 x 3 multiply-adds each."""
    n = 2 * 3 * (6 * diffuse_res ** 2) ** 2
    return n + sum(2 * 3 * (6 * r ** 2) ** 2 for r in specular_res)


def step_ops(renders: list, pixels: int, samples: int, pbr_pixels: int,
             prefilter: int) -> int:
    """A training step's float operations. `renders` holds one record per
    render: pairs, visible, channels and whether it is differentiated."""
    ops = 0
    for r in renders:
        fwd = r["pairs"] * (K1_OPS_PER_PAIR + K1_OPS_PER_PAIR_CHANNEL * r["channels"])
        ops += fwd + PROJECT_OPS * r["visible"]
        if r["grad"]:
            ops += (r["pairs"] * (K2_OPS_PER_PAIR + K2_OPS_PER_PAIR_CHANNEL
                                  * r["channels"]) + 2 * PROJECT_OPS * r["visible"])
    ops += 3 * PIXEL_OPS * pixels + 3 * SAMPLE_OPS * samples
    ops += 3 * PBR_PIXEL_OPS * pbr_pixels + 3 * prefilter
    return int(ops)
