"""Mean squared distance to the 3 nearest neighbors (Gaussian scale init).

Port of gs2m_tpu/ops/knn.py's host path: an exact scipy cKDTree query on
the CPU, used once when Gaussians are created from a point cloud.
"""
from __future__ import annotations

import numpy as np


def mean_sq_dist_to_3nn(points: np.ndarray) -> np.ndarray:
    """(N,3) -> (N,) mean of squared distances to the 3 nearest neighbors."""
    points = np.asarray(points, np.float32)
    n = points.shape[0]
    if n <= 3:
        # Degenerate tiny clouds: use all available neighbors.
        d2 = ((points[:, None, :] - points[None, :, :]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        k = max(1, n - 1)
        return np.sort(d2, axis=1)[:, :k].mean(axis=1)
    from scipy.spatial import cKDTree
    d, _ = cKDTree(points).query(points, k=4)  # self + 3 NN
    return (d[:, 1:] ** 2).mean(axis=1).astype(np.float32)
