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


def pair_scene():
    """tests/test_pallas.py::test_pair_term_cut_exact's dense opaque scene:
    3,000 opaque (0.9) splats of scale 0.25 at 64x48, and two cameras, in
    both packages."""
    from gs2m_tpu.core.camera import Camera as JCamera
    from gs2m_tpu.core.gaussians import Gaussians as JGaussians
    from gs2m_tpu_torch.core.camera import Camera as TCamera

    rng = np.random.default_rng(23)
    n = 3000
    pts = np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-0.9, 0.9, n),
                    rng.uniform(-0.6, 0.6, n)], -1).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    g = JGaussians.create(pts, cols, 2, capacity=4096)
    g = dataclasses.replace(
        g, opacity=jnp.full_like(g.opacity, float(np.log(0.9 / 0.1))),
        scaling=jnp.full_like(g.scaling, float(np.log(0.25))))
    h, w = 48, 64
    ja, ta = camera_pair(w, h)
    th = 0.3
    R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                  [-np.sin(th), 0, np.cos(th)]], np.float32)
    kw = dict(fovx=0.9, fovy=0.7, width=w, height=h)
    T = np.array([0.2, 0.0, 4.0])
    return (g, (ja, JCamera.create(R, T, **kw)),
            (ta, TCamera.create(R, T, **kw, device="cpu")))


PAIR_KW = dict(tile=16, chunk=64, instance_cap=2 ** 15)


def test_dense_opaque_render_pair_matches_jax_pair():
    """The geometry step's two renders (main with the sinks and Sobel
    normals, nearest without) of a dense opaque scene through the port's
    render() against the JAX package's fused render_pair (Pallas, interpret
    mode): the maps, observe counts, the loss and every leaf's gradient."""
    from gs2m_tpu.models.render import render_pair
    from gs2m_tpu_torch.utils.grad_gate import (DEFAULT_TOL, TOLERANCES,
                                                grad_gate)

    g, jcams, tcams = pair_scene()
    tg = port_gaussians(g)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in tg.params_dict().items()}
    sink = torch.zeros(tg.capacity, 2, requires_grad=True)
    abs_sink = torch.zeros(tg.capacity, 2, requires_grad=True)
    g2 = tg.with_params(leaves)
    pkg = trender(g2, tcams[0], torch.zeros(3), 2, geometry_stage=True,
                  sobel_normal=True, m2d_sink=sink, m2d_abs_sink=abs_sink,
                  **PAIR_KW)
    npkg = trender(g2, tcams[1], torch.zeros(3), 2, geometry_stage=True,
                   **PAIR_KW)

    def pair_loss(xp, a, b):
        return (xp.sum(a["render"] ** 2) + xp.sum(a["depth_map"] ** 2)
                + 0.3 * xp.sum(b["normal_map"] ** 2)
                + 0.7 * xp.sum(b["depth_map"]))

    loss = pair_loss(torch, pkg, npkg)
    names = list(leaves) + ["sink", "abs_sink"]
    grads = dict(zip(names, torch.autograd.grad(
        loss, list(leaves.values()) + [sink, abs_sink])))

    def jloss(params, sink, abs_sink):
        a, b = render_pair(g.with_params(params), *jcams, jnp.zeros(3), 2,
                           geometry_stage=True, sobel_normal=True,
                           m2d_sink=sink, m2d_abs_sink=abs_sink, **PAIR_KW)
        return pair_loss(jnp, a, b), (a, b)

    import jax
    z = jnp.zeros((g.capacity, 2))
    (lj, (pj, nj)), gj = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(g.params_dict(), z, z)
    gj = dict(gj[0], sink=gj[1], abs_sink=gj[2])

    assert int(pkg["dropped"]) == 0 and int(npkg["dropped"]) == 0
    # Dense: most pixels terminate (T < 1e-3) behind opaque splats.
    assert float((pkg["final_T"] < 1e-3).float().mean()) > 0.5
    np.testing.assert_allclose(float(loss.detach()), float(lj), rtol=1e-5)
    for view, a, b in (("main", pkg, pj), ("nbr", npkg, nj)):
        for key in ("render", "depth_map", "normal_map", "alpha_map",
                    "final_T"):
            np.testing.assert_allclose(a[key].detach().numpy(),
                                       np.asarray(b[key]), atol=1e-5,
                                       rtol=1e-4, err_msg=f"{view}:{key}")
        np.testing.assert_array_equal(a["observe"].numpy(),
                                      np.asarray(b["observe"]))
    for name, got in grads.items():
        rep = grad_gate(got.numpy(), np.asarray(gj[name]),
                        TOLERANCES.get(name, DEFAULT_TOL))
        assert rep["pass"], (name, rep)
