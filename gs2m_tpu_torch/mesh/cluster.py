"""Connected-component mesh cleanup.

Port of gs2m_tpu/mesh/cluster.py (Open3D post_process_mesh semantics: keep
the top-k triangle clusters, floor 50 triangles). Host code on numpy and
scipy's sparse connected components, as in the JAX package: the mesh
arrives on the host for the PLY writer anyway.
"""
from __future__ import annotations

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components


def keep_largest_clusters(vertices: np.ndarray, faces: np.ndarray,
                          colors: np.ndarray | None = None,
                          clusters_to_keep: int = 1, min_triangles: int = 50):
    """Drop all triangle clusters except the `clusters_to_keep` largest
    (and anything below max(kth size, min_triangles))."""
    if len(faces) == 0:
        return vertices, faces, colors
    n = len(vertices)
    # Vertex connectivity through shared triangles.
    rows = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2]])
    cols = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0]])
    adj = coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n))
    _, labels = connected_components(adj, directed=False)

    tri_label = labels[faces[:, 0]]
    sizes = np.bincount(tri_label, minlength=labels.max() + 1)
    order = np.sort(sizes)
    kth = order[-min(clusters_to_keep, len(order))]
    thresh = max(kth, min_triangles)
    keep_tri = sizes[tri_label] >= thresh
    faces = faces[keep_tri]

    used = np.unique(faces)
    remap = -np.ones(n, np.int64)
    remap[used] = np.arange(len(used))
    vertices = vertices[used]
    faces = remap[faces]
    if colors is not None:
        colors = colors[used]
    return vertices, faces, colors
