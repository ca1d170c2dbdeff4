"""The frozen work counts, and the reference's count of contributing pairs
against a dense per-pixel compositing written out pixel by pixel."""
import math

import numpy as np
import pytest
import torch

from cellkit import work as WK
from cellkit.reference import raster as RR
from cellkit.reference.camera import Cam


def test_kernel_formulas():
    w1 = WK.k1_work(pairs=10, visible=3, pixels=4, channels=8)
    assert w1 == {"ops": 10 * (20 + 2 * 8), "bytes": 4 * (3 * 14) + 4 * (4 * 9)}
    w2 = WK.k2_work(pairs=10, visible=3, pixels=4, channels=8)
    assert w2 == {"ops": 10 * (50 + 4 * 8),
                  "bytes": 4 * (3 * 14) + 4 * (4 * 10) + 4 * (3 * 16)}
    t, bound = WK.least_seconds({"ops": 67e12, "bytes": 1.0})
    assert bound == "ops" and t == pytest.approx(1.0)
    t, bound = WK.least_seconds({"ops": 1.0, "bytes": 3.35e12})
    assert bound == "bytes" and t == pytest.approx(1.0)


def test_step_and_prefilter_counts():
    r = [{"pairs": 100, "visible": 10, "channels": 8, "grad": True},
         {"pairs": 50, "visible": 5, "channels": 8, "grad": False}]
    expect = (100 * 36 + 220 * 10 + 100 * 82 + 440 * 10 + 50 * 36 + 220 * 5
              + 3 * 868 * 64 + 3 * 1510 * 7)
    assert WK.step_ops(r, pixels=64, samples=7, pbr_pixels=0, prefilter=0) == expect
    assert WK.prefilter_ops(512, 16, [32]) == 6 * 1536 ** 2 + 6 * 6144 ** 2


def _dense(means, conics, ops, depth, H, W):
    """Front-to-back compositing per pixel in float64: returns the alpha
    image and the number of contributing (Gaussian, pixel) pairs."""
    order = np.argsort(depth, kind="stable")
    img = np.zeros((H, W))
    pairs = 0
    for y in range(H):
        for x in range(W):
            T = 1.0
            for g in order:
                dx, dy = means[g, 0] - x, means[g, 1] - y
                a, b, c = conics[g]
                power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
                alpha = min(0.99, ops[g] * math.exp(min(power, 0.0)))
                if power > 0 or alpha < 1 / 255:
                    continue
                if T * (1 - alpha) < 1e-4:
                    break
                img[y, x] += alpha * T
                T *= 1 - alpha
                pairs += 1
    return img, pairs


def test_contributing_pairs_match_dense_compositing():
    rng = np.random.default_rng(3)
    n, H, W = 40, 24, 32
    cam = Cam.create(np.eye(3), np.array([0.0, 0.0, 4.0]), 0.9, 0.75, W, H, "cpu")
    p = {
        "xyz": torch.tensor(rng.uniform([-1.2, -0.9, -0.5], [1.2, 0.9, 0.5], (n, 3)),
                            dtype=torch.float32),
        "f_dc": torch.zeros(n, 1, 3), "f_rest": torch.zeros(n, 15, 3),
        "opacity": torch.logit(torch.tensor(rng.uniform(0.005, 0.05, (n, 1)),
                                            dtype=torch.float32)),
        "scaling": torch.log(torch.full((n, 3), 0.15)),
        "rotation": torch.tensor(rng.normal(size=(n, 4)), dtype=torch.float32),
        "albedo": torch.zeros(n, 3), "roughness": torch.zeros(n, 1),
        "metallic": torch.zeros(n, 1)}
    alive = torch.ones(n, dtype=torch.bool)
    counts = {"pairs": 0, "visible": 0}
    with torch.no_grad():
        pkg = RR.render(p, alive, cam, 0, 5, tile=16, chunk=8, counts=counts)
        s = RR.activate(p, alive)
        pr = RR.project(s, alive, cam, 0, 16)
    keep = pr.valid.numpy()
    img, pairs = _dense(pr.means2d.numpy()[keep], pr.conics.numpy()[keep],
                        s.opacity.numpy()[keep], pr.depths.numpy()[keep], H, W)
    assert counts["visible"] == int(keep.sum())
    assert counts["pairs"] == pairs
    np.testing.assert_allclose(pkg["alpha_map"][0].numpy(), img, atol=2e-6)
