"""PBR subsystem: learned cubemap environment light + split-sum shading.

Port of gs2m_tpu/pbr/: the cubemap lookups and weight-matrix prefilters
(cubemap.py), split-sum shading (shade.py), the point-light BSDF library
(bsdf.py) and the deferred PBR pass with the material-stage losses
(render.py).
"""
from gs2m_tpu_torch.pbr.cubemap import (CubemapConfig, build_mips, cube_dirs,
                                        cube_lookup, cubemap_to_latlong,
                                        init_cubemap, pad_cube)
from gs2m_tpu_torch.pbr.render import make_pbr_fns, pbr_render
from gs2m_tpu_torch.pbr.shade import (aces_film, get_brdf_lut, get_mip,
                                      linear_to_srgb, pbr_shading,
                                      srgb_to_linear)

__all__ = ["CubemapConfig", "build_mips", "cube_dirs", "cube_lookup", "pad_cube",
           "cubemap_to_latlong", "init_cubemap", "aces_film", "get_brdf_lut",
           "get_mip", "linear_to_srgb", "pbr_shading", "srgb_to_linear",
           "make_pbr_fns", "pbr_render"]
