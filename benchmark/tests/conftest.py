"""The benchmark's own tests: small shapes on the CPU; tests that need a
CUDA card are marked `cuda` and skip without one (decided in the fixture).

    python -m pytest benchmark/tests -q
"""
import copy
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def tiny_config(name: str, views: int = 6, alive: int = 600) -> dict:
    """A cell's configuration at a size a CPU test can hold: the same flags
    and losses, a few small views, a few hundred Gaussians."""
    from cellkit import cells

    cfg = copy.deepcopy(cells.config(name))
    cfg["scene"].update(views=views, image_width=128, image_height=96,
                        focal_px=140.0, arc_degrees=30.0)
    cfg["state"].update(alive=alive, capacity=1024, scale=0.08)
    cfg["optim"]["multi_view_sample_num"] = 256
    cfg["instance_cap"] = 2 ** 15
    if cfg.get("light"):
        cfg["light"]["base_res"] = 64
    return cfg


@pytest.fixture
def tiny():
    return tiny_config
