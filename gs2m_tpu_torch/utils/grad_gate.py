"""The distributional gradient gate of scripts/check_grads_onchip.py.

Per leaf: rows at >= 1e-2 of the reference's max |gradient| are the
well-conditioned set; the p999 of their relative error must stay under the
leaf's tolerance (5e-3; 2e-2 for scaling and rotation, which pass the
covariance -> conic chain twice), and no entry may be off by more than
5e-2 of the max. A one-ulp difference at the alpha >= 1/255 gate or the
T < 1e-4 termination edge flips a whole instance, so the row max is not a
usable criterion; a derivation error shifts every row and trips the p999.
"""
from __future__ import annotations

import numpy as np

WELLCOND_FRAC = 1e-2
REL_TO_MAX_TOL = 5e-2
TOLERANCES = {"scaling": 2e-2, "rotation": 2e-2}
DEFAULT_TOL = 5e-3


def grad_gate(got, ref, tol: float = DEFAULT_TOL) -> dict:
    """Gate `got` against the reference `ref` (arrays of one shape); the
    report's "pass" says whether it holds."""
    a = np.asarray(got, np.float64)
    b = np.asarray(ref, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {a.shape} vs {b.shape}")
    scale = float(np.abs(b).max()) if b.size else 0.0
    finite = bool(np.isfinite(a).all())
    if scale == 0.0:
        return {"p999": 0.0, "rel_to_max": float(np.abs(a).max(initial=0.0)),
                "wellcond_rows": 0, "tol": tol,
                "pass": finite and not np.abs(a).any()}
    wc = np.abs(b) >= WELLCOND_FRAC * scale
    rel = np.abs(a - b)[wc] / np.abs(b)[wc]
    p999 = float(np.quantile(rel, 0.999)) if rel.size else 0.0
    rel_to_max = float(np.abs(a - b).max() / scale)
    return {"p999": p999, "rel_to_max": rel_to_max,
            "wellcond_rows": int(wc.sum()), "tol": tol,
            "pass": finite and p999 <= tol and rel_to_max <= REL_TO_MAX_TOL}
