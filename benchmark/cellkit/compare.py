"""The comparison that decides `correct`: the program's first training
steps against the reference's, from the same inputs.

Readings of each side: the loss of each compared step, the norm of each
leaf's gradient as the optimiser got it on the first step (from Adam's
first moment after one step from zero), and the norm of each leaf's change
after the compared steps. Numbers compared:

  loss_gap    the largest relative gap of a step's loss
  grad_gap    the worst leaf's |program norm - reference norm| over the
              larger of that leaf's reference norm and the median leaf's
  change_gap  the same for the parameters' change

Leaves whose reference gradient is under a thousandth of the median
leaf's (nought to rounding, such as the material leaves of a geometry-only
step) are left out of both leaf numbers: under Adam they move by round-off
alone. Each number has its limit in benchmark/limits/<configuration>.json.
"""
from __future__ import annotations

import json
import math
import statistics
from pathlib import Path

NUMBERS = ("loss_gap", "grad_gap", "change_gap")
LIMITS_DIR = Path(__file__).resolve().parent.parent / "limits"


def load_limits(config_name: str) -> dict:
    return json.loads((LIMITS_DIR / f"{config_name}.json").read_text())["limits"]


def leaf_gap(prog: dict, ref: dict, counted: list) -> float:
    med = statistics.median(ref.values())
    worst = 0.0
    for k in counted:
        denom = max(ref[k], med)
        gap = abs(prog[k] - ref[k]) / denom if denom > 0 else 0.0
        worst = max(worst, gap) if math.isfinite(gap) else math.inf
    return worst


def numbers(prog: dict, ref: dict) -> dict:
    """prog, ref: {"loss": [..], "grad": {leaf: norm}, "change": {leaf: norm}}."""
    med = statistics.median(ref["grad"].values())
    counted = [k for k, v in ref["grad"].items() if v >= 1e-3 * med]
    gaps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["loss"], ref["loss"])]
    loss_gap = max(gaps) if all(math.isfinite(g) for g in gaps) else math.inf
    return {"loss_gap": loss_gap,
            "grad_gap": leaf_gap(prog["grad"], ref["grad"], counted),
            "change_gap": leaf_gap(prog["change"], ref["change"], counted),
            "left_out": sorted(set(ref["grad"]) - set(counted))}


def judge(nums: dict, limits: dict) -> tuple[bool, list]:
    """(correct, [[name, number, limit], ...]); a number that is not finite
    fails."""
    rows = [[k, nums[k], limits[k]] for k in NUMBERS]
    ok = all(v == v and v <= lim for _, v, lim in rows)
    return ok, rows
