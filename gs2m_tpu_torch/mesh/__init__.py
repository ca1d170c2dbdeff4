"""Surface extraction: block-sparse TSDF fusion + marching tetrahedra."""
from gs2m_tpu_torch.mesh.tsdf import TSDFVolume, fuse_depths
from gs2m_tpu_torch.mesh.marching import marching_tetrahedra_blocks
from gs2m_tpu_torch.mesh.cluster import keep_largest_clusters

__all__ = ["TSDFVolume", "fuse_depths", "marching_tetrahedra_blocks",
           "keep_largest_clusters"]
