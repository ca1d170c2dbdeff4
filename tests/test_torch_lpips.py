"""Port vs JAX package: utils/lpips.py and the metrics app's LPIPS column.

Synthetic VGG16 + linear-head weights (tests/test_lpips.py's), written to a
temp file; the same numpy images through both packages' lpips at 64x64,
within rtol 1e-5. Without a weights file the metric is gated (raises) and
the metrics app's column stays null; with GS2M_LPIPS_WEIGHTS set it is
within 1e-5 of the JAX package's evaluate_dir.
"""
import json

import numpy as np
import pytest
import torch
from PIL import Image

from gs2m_tpu.utils import lpips as jlp
from gs2m_tpu_torch.utils import lpips as tlp

from tests.test_lpips import make_fake_weights

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lpips") / "w.pkl")
    make_fake_weights(path)
    return path


def test_lpips_gated_without_weights(monkeypatch):
    monkeypatch.delenv("GS2M_LPIPS_WEIGHTS", raising=False)
    img = np.zeros((3, 32, 32), np.float32)
    with pytest.raises(FileNotFoundError):
        tlp.lpips(img, img, weights_path="/nonexistent", device="cpu")
    with pytest.raises(FileNotFoundError):
        tlp.lpips(img, img, device="cpu")


@pytest.mark.parametrize("batch", [False, True])
def test_lpips_matches_jax(weights, batch):
    rng = np.random.default_rng(1)
    shape = (2, 3, 64, 64) if batch else (3, 64, 64)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = rng.uniform(0, 1, shape).astype(np.float32)
    want = float(jlp.lpips(a, b, weights_path=weights))
    got = tlp.lpips(a, b, weights_path=weights, device="cpu")
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    assert abs(float(tlp.lpips(a, a, weights_path=weights,
                               device="cpu"))) < 1e-6


def test_metrics_app_lpips_column(weights, tmp_path, monkeypatch):
    from gs2m_tpu.apps.metrics import evaluate_dir as jeval
    from gs2m_tpu_torch.apps import metrics as tmetrics

    method = tmp_path / "model" / "train" / "ours_1"
    rng = np.random.default_rng(4)
    for kind in ("render", "gt"):
        (method / kind).mkdir(parents=True)
    for i in range(2):
        gt = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
        noise = rng.integers(-20, 21, gt.shape)
        r = np.clip(gt.astype(np.int64) + noise, 0, 255).astype(np.uint8)
        Image.fromarray(gt).save(method / "gt" / f"{i:05d}.png")
        Image.fromarray(r).save(method / "render" / f"{i:05d}.png")

    monkeypatch.delenv("GS2M_LPIPS_WEIGHTS", raising=False)
    res = tmetrics.main(["-m", str(tmp_path / "model"), "--device", "cpu"])
    assert res["ours_1"]["LPIPS"] is None

    monkeypatch.setenv("GS2M_LPIPS_WEIGHTS", weights)
    res = tmetrics.main(["-m", str(tmp_path / "model"), "--device", "cpu"])
    want = jeval(method)["LPIPS"]
    got = res["ours_1"]["LPIPS"]
    assert want is not None and got is not None
    np.testing.assert_allclose(got, want, rtol=1e-5)
    saved = json.loads((tmp_path / "model" / "metrics_train.json").read_text())
    assert saved["ours_1"]["LPIPS"] == got
