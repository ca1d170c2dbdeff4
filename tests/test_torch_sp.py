"""Port vs JAX package: band-sharded rendering and backward (parallel/sp.py)
and the hooks it needs (crop_projected, normal_from_depth_image's row0).

The JAX side runs on its 8 virtual CPU devices with the XLA backend, as
tests/test_parallel.py does; the port runs its 8 bands on the CPU. The
banded render must equal the port's full frame exactly (colors, buffers,
final T, observe counts, radii) and JAX's banded render at the render
tests' tolerances; the banded gradients must match the port's full-frame
objective at the JAX package's own SP tolerances (loss rtol 1e-5, grads
atol 2e-5 / 3e-5 of the leaf's scale) and JAX's banded gradients at the
distributional gate of utils/grad_gate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from gs2m_tpu.models import losses as JL
from gs2m_tpu.ops.normals import normal_from_depth_image as jnormals
from gs2m_tpu.ops.projection import crop_projected as jcrop
from gs2m_tpu.ops.projection import project as jproject
from gs2m_tpu.parallel import sp as jsp
from gs2m_tpu_torch.models import losses as TL
from gs2m_tpu_torch.models.render import render as trender
from gs2m_tpu_torch.ops.normals import normal_from_depth_image as tnormals
from gs2m_tpu_torch.ops.projection import Projected
from gs2m_tpu_torch.ops.projection import crop_projected as tcrop
from gs2m_tpu_torch.ops.projection import project as tproject
from gs2m_tpu_torch.ops.rasterize import (build_features,
                                          rasterize_from_projected)
from gs2m_tpu_torch.parallel import sp as tsp
from gs2m_tpu_torch.utils.grad_gate import DEFAULT_TOL, TOLERANCES, grad_gate

from tests.test_torch_core import camera_pair, port_gaussians, random_pose_scene

torch.set_num_threads(1)
CPU = [torch.device("cpu")]


def _mesh():
    return Mesh(np.array(jax.devices()[:8]), ("sp",))


@pytest.mark.parametrize("y0,h", [(0, 32), (32, 16), (48, 48)])
def test_crop_projected_matches_jax(y0, h):
    g = random_pose_scene(5, n=80, capacity=96)
    jcam, _ = camera_pair(64, 96)
    jp = jproject(g, jcam, 1, opacities=g.get_opacity[:, 0])
    tp = Projected(*(torch.from_numpy(np.array(x)) for x in jp))
    jc, tc = jcrop(jp, y0, h, 16), tcrop(tp, y0, h, 16)
    for name, a, b in zip(Projected._fields, tc, jc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert 0 < int(tc.valid.sum()) < int(tp.valid.sum())


def test_normals_row0_match_jax():
    rng = np.random.default_rng(3)
    depth = rng.uniform(1.0, 3.0, (12, 20)).astype(np.float32)
    K = np.array([[30.0, 0, 10], [0, 30.0, 20], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.1, -0.2, 0.3]
    for row0 in (0, 7, 27):
        a = tnormals(torch.from_numpy(depth), torch.from_numpy(K),
                     torch.from_numpy(c2w), row0=row0).numpy()
        b = np.asarray(jnormals(jnp.asarray(depth), jnp.asarray(K),
                                jnp.asarray(c2w), row0=row0))
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    # A band of rows equals the full frame's rows, away from the band edge.
    full = tnormals(torch.from_numpy(depth), torch.from_numpy(K))
    band = tnormals(torch.from_numpy(depth[4:9]), torch.from_numpy(K), row0=4)
    torch.testing.assert_close(band[1:-1, 1:-1], full[5:8, 1:-1], rtol=0,
                               atol=0)


def test_halo_extend_edges_and_backward():
    bands = [torch.arange(12.0).reshape(1, 3, 4) + 100 * d for d in range(3)]
    leaves = [b.clone().requires_grad_(True) for b in bands]
    ext = tsp.halo_extend(leaves, 2)
    assert [tuple(e.shape) for e in ext] == [(1, 7, 4)] * 3
    assert torch.equal(ext[0][:, :2], torch.zeros(1, 2, 4))      # top edge
    assert torch.equal(ext[2][:, -2:], torch.zeros(1, 2, 4))     # bottom edge
    assert torch.equal(ext[1][:, :2], bands[0][:, 1:])           # from above
    assert torch.equal(ext[1][:, -2:], bands[2][:, :2])          # from below
    assert torch.equal(ext[0][:, 2:5], bands[0])
    # The copies' backward routes each halo row's gradient to its owner.
    sum(e.sum() for e in ext).backward()
    assert torch.equal(leaves[0].grad[0, :, 0], torch.tensor([1.0, 2.0, 2.0]))
    assert torch.equal(leaves[1].grad[0, :, 0], torch.tensor([2.0, 3.0, 2.0]))
    assert torch.equal(leaves[2].grad[0, :, 0], torch.tensor([2.0, 2.0, 1.0]))


def test_sp_render_matches_full_frame_and_jax():
    """tests/test_parallel.py:396-433's case: 8 bands of a 64x128 frame."""
    rng = np.random.default_rng(17)
    H, W = 128, 64
    from tests.test_golden import make_scene
    g = make_scene(rng, n=120, capacity=128, random_pose=True)
    jcam, tcam = camera_pair(W, H)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    tg = port_gaussians(g)
    op = tg.get_opacity[:, 0]
    full = rasterize_from_projected(
        tproject(tg, tcam, g.max_sh_degree, op), op,
        build_features(tg, tcam), torch.from_numpy(bg), tcam,
        feature_count=10, chunk=128, instance_cap=2 ** 13)
    out = tsp.make_sp_render(CPU, 8, H, active_sh_degree=g.max_sh_degree,
                             chunk=128, instance_cap_per_band=2 ** 11)(
        tg, tcam, torch.from_numpy(bg))
    assert int(out.dropped) == 0
    for name in ("color", "buffer", "final_T", "observe", "radii"):
        assert torch.equal(getattr(out, name), getattr(full, name)), name
    assert int(out.num_instances) == int(full.num_instances)

    jout = jsp.make_sp_render(_mesh(), H, W, active_sh_degree=g.max_sh_degree,
                              chunk=128, instance_cap_per_band=2 ** 11,
                              backend="xla")(g, jcam, jnp.asarray(bg))
    np.testing.assert_allclose(out.color.numpy(), np.asarray(jout["color"]),
                               atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(out.buffer.numpy(), np.asarray(jout["buffer"]),
                               atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(out.final_T.numpy(),
                               np.asarray(jout["final_T"]), atol=1e-5)
    np.testing.assert_array_equal(out.observe.numpy(),
                                  np.asarray(jout["observe"]))
    np.testing.assert_array_equal(out.radii.numpy(), np.asarray(jout["radii"]))


def _assert_grads_close(got: dict, ref: dict, atol_scale: float, rtol: float):
    for k, b in ref.items():
        a, b = got[k].numpy(), np.asarray(b)
        scale = np.abs(b).max() + 1e-12
        np.testing.assert_allclose(a, b, atol=atol_scale * scale, rtol=rtol,
                                   err_msg=k)


def _assert_grads_gate(got: dict, jref: dict):
    for k, b in jref.items():
        rep = grad_gate(got[k].numpy(), np.asarray(b),
                        TOLERANCES.get(k, DEFAULT_TOL))
        assert rep["pass"], (k, rep)


@pytest.mark.parametrize("lam,H,seed", [(0.0, 128, 23), (0.2, 100, 29)],
                         ids=["l1", "ssim_halo"])
def test_sp_grad_matches_full_frame_and_jax(lam, H, seed):
    """tests/test_parallel.py:436-526's cases: L1 on 8 bands of 128 rows;
    L1 + SSIM with the 5-row halo on a 100-row frame padded to 128 (the
    bottom bands partly and wholly masked)."""
    from tests.test_golden import make_scene
    rng = np.random.default_rng(seed)
    W = 64
    g = make_scene(rng, n=100, capacity=128, random_pose=True)
    target = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    jcam, tcam = camera_pair(W, H)
    tg = port_gaussians(g)
    t_target = torch.from_numpy(target)

    def single(params):
        gg = tg.with_params(params)
        op = gg.get_opacity[:, 0]
        out = rasterize_from_projected(
            tproject(gg, tcam, g.max_sh_degree, op), op,
            build_features(gg, tcam), torch.zeros(3), tcam,
            feature_count=10, chunk=128, instance_cap=2 ** 13)
        return TL.rgb_loss(TL.clip(out.color, 0.0, 1.0), t_target, lam)

    leaves = {k: v.clone().requires_grad_(True)
              for k, v in tg.params_dict().items()}
    l_ref = single(leaves)
    g_ref = dict(zip(leaves, torch.autograd.grad(l_ref, list(leaves.values()),
                                                 allow_unused=True)))
    g_ref = {k: torch.zeros_like(leaves[k]) if v is None else v
             for k, v in g_ref.items()}

    l_sp, g_sp = tsp.make_sp_grad(
        CPU, 8, H, W, active_sh_degree=g.max_sh_degree, chunk=128,
        instance_cap_per_band=2 ** 11, lambda_ssim=lam)(
        tg.params_dict(), tg, tcam, torch.zeros(3), t_target)
    np.testing.assert_allclose(float(l_sp), l_ref.item(), rtol=1e-5)
    _assert_grads_close(g_sp, {k: v.numpy() for k, v in g_ref.items()},
                        2e-5, 1e-4)

    jl, jg = jsp.make_sp_grad(
        _mesh(), H, W, active_sh_degree=g.max_sh_degree, chunk=128,
        instance_cap_per_band=2 ** 11, backend="xla", lambda_ssim=lam)(
        g.params_dict(), g, jcam, jnp.zeros(3), jnp.asarray(target))
    np.testing.assert_allclose(float(l_sp), float(jl), rtol=1e-5)
    _assert_grads_gate(g_sp, jg)


def test_sp_geometry_grad_matches_full_frame_and_jax():
    """tests/test_parallel.py:529-580's case: the geometry objective without
    the cross-view term on a 100-row frame padded to 128 (masked tails, the
    true border rows inside a band), a non-zero background."""
    from tests.test_golden import make_scene
    rng = np.random.default_rng(31)
    H, W = 100, 64
    LAM, LDN, LPL, LAL = 0.2, 0.05, 10.0, 0.3
    g = make_scene(rng, n=100, capacity=128, random_pose=True)
    bg = np.array([0.3, 0.5, 0.7], np.float32)
    target = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    gt_alpha = rng.uniform(0, 1, (1, H, W)).astype(np.float32)
    jcam, tcam = camera_pair(W, H)
    tg = port_gaussians(g)
    tbg, ttgt, tga = (torch.from_numpy(x) for x in (bg, target, gt_alpha))

    leaves = {k: v.clone().requires_grad_(True)
              for k, v in tg.params_dict().items()}
    gg = tg.with_params(leaves)
    pkg = trender(gg, tcam, tbg, g.max_sh_degree, geometry_stage=True,
                  sobel_normal=True, chunk=128, instance_cap=2 ** 13)
    l_ref = (TL.rgb_loss(TL.clip(pkg["render"], 0.0, 1.0), ttgt, LAM)
             + LPL * TL.plane_loss(pkg["visibility_filter"], gg.get_scaling)
             + LAL * TL.binary_cross_entropy(pkg["alpha_map"], tga)
             + LDN * TL.depth_normal_loss(pkg["normal_map"], pkg["sobel_map"],
                                          ttgt))
    g_ref = {k: torch.zeros_like(leaves[k]) if v is None else v
             for k, v in zip(leaves, torch.autograd.grad(
                 l_ref, list(leaves.values()), allow_unused=True))}

    kw = dict(active_sh_degree=g.max_sh_degree, chunk=128,
              instance_cap_per_band=2 ** 11, lambda_ssim=LAM,
              lambda_depth_normal=LDN, lambda_plane=LPL, lambda_alpha=LAL)
    l_sp, g_sp = tsp.make_sp_geometry_grad(CPU, 8, H, W, **kw)(
        tg.params_dict(), tg, tcam, tbg, ttgt, tga)
    np.testing.assert_allclose(float(l_sp), l_ref.item(), rtol=1e-5)
    _assert_grads_close(g_sp, {k: v.numpy() for k, v in g_ref.items()},
                        3e-5, 2e-4)

    jl, jg = jsp.make_sp_geometry_grad(_mesh(), H, W, backend="xla", **kw)(
        g.params_dict(), g, jcam, jnp.asarray(bg), jnp.asarray(target),
        jnp.asarray(gt_alpha))
    np.testing.assert_allclose(float(l_sp), float(jl), rtol=1e-5)
    _assert_grads_gate(g_sp, jg)


def test_bce_map_matches_jax():
    rng = np.random.default_rng(2)
    p = rng.uniform(-0.1, 1.1, (1, 9, 7)).astype(np.float32)
    t = rng.uniform(0, 1, (1, 9, 7)).astype(np.float32)
    np.testing.assert_allclose(
        TL.binary_cross_entropy_map(torch.from_numpy(p),
                                    torch.from_numpy(t)).numpy(),
        np.asarray(JL.binary_cross_entropy_map(jnp.asarray(p),
                                               jnp.asarray(t))),
        rtol=1e-6, atol=1e-6)
    assert float(TL.binary_cross_entropy(torch.from_numpy(p),
                                         torch.from_numpy(t))) == float(
        torch.mean(TL.binary_cross_entropy_map(torch.from_numpy(p),
                                               torch.from_numpy(t))))
