"""Port vs JAX package: models/render.py's 13-map package.

The JAX render runs through its XLA twin (and once through the Pallas
kernels in interpret mode); the port through blend_fwd's plain version,
which is what its wrapper runs for CPU tensors. Maps: atol 1e-5, rtol 1e-4;
radii, observe, visibility, normal_mask and dropped: equal.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2m_tpu.models.render import render as jrender
from gs2m_tpu.ops.binning import bin_gaussians as jbin
from gs2m_tpu.ops.projection import project as jproject
from gs2m_tpu_torch.models.render import feature_count_for
from gs2m_tpu_torch.models.render import render as trender
from gs2m_tpu_torch.ops import blend as tblend

from tests.test_torch_core import camera_pair, port_gaussians, random_pose_scene

torch.set_num_threads(1)

EXACT = ("radii", "visibility_filter", "observe", "normal_mask", "dropped")
MAPS = ("render", "alpha_map", "distance_map", "depth_map", "normal_map",
        "albedo_map", "roughness_map", "metallic_map", "local_normal_map",
        "final_T", "sobel_map")


def compare_pkgs(jp, tp):
    for k in EXACT:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]), err_msg=k)
    for k in MAPS:
        a, b = np.asarray(jp[k]), tp[k].numpy()
        assert a.shape == b.shape, k
        assert np.isfinite(b).all(), k
        np.testing.assert_allclose(b, a, atol=1e-5, rtol=1e-4, err_msg=k)


STAGES = {  # feature_count: (geometry_stage, material_stage, blend_metallic)
    1: (False, False, False),
    5: (True, False, False),
    9: (True, True, False),
    10: (True, True, True),
}


@pytest.mark.parametrize("fc", sorted(STAGES))
def test_render_package_matches_xla(fc):
    geo, mat, metal = STAGES[fc]
    assert feature_count_for(geo, mat, metal) == fc
    g = random_pose_scene(fc, n=70, capacity=96, sh_degree=2)
    jc, tc = camera_pair(64, 48)
    bg = np.array([0.1, 0.5, 0.9], np.float32) if fc == 5 else np.zeros(3, np.float32)
    kw = dict(geometry_stage=geo, material_stage=mat, blend_metallic=metal,
              sobel_normal=True, z_depth=(fc == 10), chunk=64,
              instance_cap=2 ** 12)
    jp = jrender(g, jc, jnp.asarray(bg), g.max_sh_degree, backend="xla", **kw)
    tp = trender(port_gaussians(g), tc, torch.from_numpy(bg), g.max_sh_degree,
                 **kw)
    compare_pkgs(jp, tp)
    assert int(tp["observe"].sum()) > 0
    # The port's package also reports the binned instance count.
    op = g.get_opacity[:, 0]
    jb = jbin(jproject(g, jc, g.max_sh_degree, opacities=op), 48, 64, 16,
              2 ** 12, 64, opacities=op)
    assert int(tp["num_instances"]) == int(jb.num_instances) > 0


def test_render_package_matches_pallas_interpret():
    g = random_pose_scene(11, n=70, capacity=96, sh_degree=3)
    jc, tc = camera_pair(48, 64)
    kw = dict(geometry_stage=True, material_stage=True, sobel_normal=True,
              chunk=128, instance_cap=2 ** 12)
    jp = jrender(g, jc, jnp.zeros(3), 3, backend="pallas", **kw)
    before = dict(tblend.LAUNCHES)
    tp = trender(port_gaussians(g), tc, torch.zeros(3), 3, **kw)
    assert tblend.LAUNCHES == before
    compare_pkgs(jp, tp)


def test_empty_scene_probe():
    g = random_pose_scene(2, n=20, capacity=32)
    g = dataclasses.replace(g, alive=jnp.zeros_like(g.alive))
    jc, tc = camera_pair(64, 48)
    kw = dict(geometry_stage=True, material_stage=True, sobel_normal=True,
              chunk=64, instance_cap=2 ** 10)
    jp = jrender(g, jc, jnp.ones(3), 1, backend="xla", **kw)
    tp = trender(port_gaussians(g), tc, torch.ones(3), 1, **kw)
    compare_pkgs(jp, tp)
    assert float(tp["render"].min()) == 1.0 and float(tp["final_T"].min()) == 1.0
