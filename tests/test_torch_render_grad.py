"""Port vs JAX package: gradients through the render path — projection,
binning, the blend's autograd Function (K1/K2 through their plain
versions on the CPU) and the derived maps — and the trim's observe pass.

The JAX side renders through its Pallas kernels in interpret mode. Leaf
gradients (and both densification sinks) are held at the distributional
gate of scripts/check_grads_onchip.py; projection gradients at allclose
rtol 1e-4, atol 1e-5 of the largest; observe counts exactly equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2m_tpu.models.render import count_observed as jcount
from gs2m_tpu.models.render import render as jrender
from gs2m_tpu.ops.projection import project as jproject
from gs2m_tpu_torch.core.gaussians import Gaussians as TGaussians
from gs2m_tpu_torch.models.render import count_observed as tcount
from gs2m_tpu_torch.models.render import render as trender
from gs2m_tpu_torch.ops.projection import project as tproject
from gs2m_tpu_torch.utils.grad_gate import DEFAULT_TOL, TOLERANCES, grad_gate

from tests.test_torch_core import camera_pair, port_gaussians, random_pose_scene

torch.set_num_threads(1)


def _leaves(g: TGaussians):
    return {k: v.detach().clone().requires_grad_(True)
            for k, v in g.params_dict().items()}


def _loss(pkg, target, geometry, np_):
    """The same scalar in both packages (np_ is jnp or torch)."""
    loss = np_.mean(np_.abs(pkg["render"] - target))
    if geometry:
        loss = (loss + 0.1 * np_.mean(pkg["depth_map"] ** 2)
                + np_.mean(np_.abs(pkg["sobel_map"] - pkg["normal_map"]))
                + 0.1 * np_.mean(np_.abs(pkg["normal_map"])))
    return loss


@pytest.mark.parametrize("geometry", [False, True], ids=["warmup", "geometry"])
def test_render_leaf_grads_match_jax(geometry):
    g = random_pose_scene(21, n=90, capacity=128, sh_degree=2)
    g = dataclasses.replace(g, opacity=g.opacity + 1.5)
    jc, tc = camera_pair(64, 48)
    target = np.random.default_rng(2).uniform(0, 1, (3, 48, 64)).astype(np.float32)
    kw = dict(geometry_stage=geometry, sobel_normal=geometry, chunk=64,
              instance_cap=2 ** 12)
    C = g.capacity

    def jloss(params, sink, abs_sink):
        pkg = jrender(g.with_params(params), jc, jnp.zeros(3), 2,
                      backend="pallas", m2d_sink=sink, m2d_abs_sink=abs_sink,
                      **kw)
        return _loss(pkg, target, geometry, jnp)

    z = jnp.zeros((C, 2))
    jv, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(g.params_dict(), z, z)

    tg = port_gaussians(g)
    leaves = _leaves(tg)
    sink = torch.zeros(C, 2, requires_grad=True)
    abs_sink = torch.zeros(C, 2, requires_grad=True)
    pkg = trender(tg.with_params(leaves), tc, torch.zeros(3), 2,
                  m2d_sink=sink, m2d_abs_sink=abs_sink, **kw)
    tv = _loss(pkg, torch.from_numpy(target), geometry, torch)
    names = list(leaves) + ["sink", "abs_sink"]
    grads = torch.autograd.grad(tv, list(leaves.values()) + [sink, abs_sink],
                                allow_unused=True)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    refs = dict(jg[0], sink=jg[1], abs_sink=jg[2])
    for name, got in zip(names, grads):
        ref = np.asarray(refs[name])
        got = np.zeros_like(ref) if got is None else got.numpy()
        rep = grad_gate(got, ref, TOLERANCES.get(name, DEFAULT_TOL))
        assert rep["pass"], (name, rep)
    assert float(np.abs(np.asarray(jg[2])).max()) > 0


def test_projection_grads_match_jax():
    """Autograd reaches xyz, scaling, rotation and the SH features through
    the projection."""
    g = random_pose_scene(5, n=60, capacity=64, sh_degree=3)
    jc, tc = camera_pair(64, 48)
    rng = np.random.default_rng(8)
    w = {k: rng.normal(size=s).astype(np.float32)
         for k, s in (("means2d", (64, 2)), ("conics", (64, 3)),
                      ("colors", (64, 3)))}

    def jloss(params):
        p = jproject(g.with_params(params), jc, 3)
        return sum(jnp.sum(getattr(p, k) * w[k]) for k in w)

    jg = jax.grad(jloss)(g.params_dict())
    tg = port_gaussians(g)
    leaves = _leaves(tg)
    gt = tg.with_params(leaves)
    p = tproject(gt, tc, 3, gt.get_opacity[:, 0])
    loss = sum(torch.sum(getattr(p, k) * torch.from_numpy(w[k])) for k in w)
    out = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    for (name, ref), got in zip(leaves.items(), out):
        ref = np.asarray(jg[name])
        got = np.zeros_like(ref) if got is None else got.numpy()
        if name in ("xyz", "scaling", "rotation", "f_dc", "f_rest"):
            assert np.abs(ref).max() > 0, name
        np.testing.assert_allclose(got, ref, rtol=1e-4,
                                   atol=1e-5 * np.abs(ref).max() + 1e-30,
                                   err_msg=name)


def test_grads_finite_with_culled_behind_and_degenerate():
    """Razor-thin splats (indefinite conics), Gaussians behind the camera and
    culled rows must not leak inf/NaN into any gradient."""
    rng = np.random.default_rng(41)
    n, cap = 60, 64
    pts = (rng.normal(size=(n, 3)) * 0.4).astype(np.float32)
    pts[:8, 2] -= 10.0                        # behind the camera
    g = TGaussians.create(pts, rng.uniform(0, 1, (n, 3)).astype(np.float32),
                          1, capacity=cap, device="cpu")
    sc = g.scaling.clone()
    sc[:, 2] = -24.0
    sc[: n // 2, 1] = -24.0
    g = dataclasses.replace(g, scaling=sc)
    _, tc = camera_pair(64, 48)
    leaves = _leaves(g)
    sink = torch.zeros(cap, 2, requires_grad=True)
    pkg = trender(g.with_params(leaves), tc, torch.zeros(3), 1,
                  geometry_stage=True, sobel_normal=True, chunk=64,
                  instance_cap=2 ** 13, m2d_abs_sink=sink)
    loss = pkg["render"].abs().mean() + pkg["normal_map"].abs().mean()
    out = torch.autograd.grad(loss, list(leaves.values()) + [sink],
                              allow_unused=True)
    for name, x in zip(list(leaves) + ["abs_sink"], out):
        assert x is None or bool(torch.isfinite(x).all()), name
    assert int(pkg["radii"][:8].abs().sum()) == 0


def test_count_observed_matches_render_and_jax():
    g = random_pose_scene(13, n=96, capacity=128, sh_degree=1)
    g = dataclasses.replace(g, opacity=g.opacity + 1.0)
    jc, tc = camera_pair(64, 48)
    tg = port_gaussians(g)
    counts, dropped = tcount(tg, tc, chunk=64, instance_cap=2 ** 12)
    pkg = trender(tg, tc, torch.zeros(3), 1, chunk=64, instance_cap=2 ** 12)
    jc_counts, jdrop = jcount(g, jc, backend="pallas", chunk=64,
                              instance_cap=2 ** 12)
    assert int(dropped) == int(jdrop) == 0
    assert torch.equal(counts, pkg["observe"])
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc_counts))
    assert int(counts.sum()) > 0
