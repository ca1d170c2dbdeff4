"""Launch counts of the port's CUDA kernels (csrc/*.cu).

Every wrapper that launches one of them adds one to LAUNCHES per launch, and
nowhere else: ops/blend.py's K1-K3 and the backward's per-Gaussian reduce
pair, ops/preprocess.py's preprocess pair and train/optim.py's Adam.
`launch_counts()` is how a run shows that its path went through the kernels
(ops/blend.py re-exports all three names).
"""
from __future__ import annotations

import atexit
import json
import os
import sys
from collections import Counter

# Keyed by (kernel, value width V): V is the blend kernels' value rows (and
# the reduce pair's, "instance_rows" and "instance_sum", which sum K2's 8+V
# channels), 0 for K3 (which blends none), the preprocess pair
# ("preprocess_fwd", "preprocess_bwd") and "adam".
LAUNCHES: Counter = Counter()

KERNELS = ("blend_fwd", "blend_bwd", "blend_obs", "preprocess_fwd",
           "preprocess_bwd", "adam", "instance_rows", "instance_sum")


def launch_counts() -> dict[str, int]:
    """LAUNCHES summed over the value widths, by kernel (every kernel of
    KERNELS, 0 where it did not launch)."""
    out = dict.fromkeys(KERNELS, 0)
    for (name, _), n in LAUNCHES.items():
        out[name] += n
    return out


# A process started with GS2M_LAUNCH_LOG=<file> in its environment appends,
# at exit, one JSON line of its argv and its LAUNCHES to that file: how the
# launches of apps that the benchmark runners (apps/run_*.py) start as
# subprocesses are counted.
LAUNCH_LOG_ENV = "GS2M_LAUNCH_LOG"


def _append_launch_log(path: str) -> None:
    with open(path, "a") as f:
        f.write(json.dumps({"argv": sys.argv, "launches": [
            [name, V, n] for (name, V), n in sorted(LAUNCHES.items())]})
            + "\n")


if os.environ.get(LAUNCH_LOG_ENV):
    atexit.register(_append_launch_log, os.environ[LAUNCH_LOG_ENV])
