"""The per-Gaussian preprocess (ops/preprocess.py) on the CPU: the plain
PyTorch twin of its backward kernel against autograd of the eager chain,
over SH degrees 0-3 and the rows where the chain has ties or culls: rows
behind the near plane, det <= 0 rows, dead slots, equal scales (the
normal's first-minimum tie), a colour channel exactly at 0 and view-space
x and y exactly on the 1.3 tanfov clamp. Gradients at the distributional
gate (utils/grad_gate.py), and the edge rows on their own at allclose.
The kernels themselves run only on a card (tests/test_torch_cuda.py).
"""
import dataclasses

import numpy as np
import pytest
import torch

from gs2m_tpu_torch.core import sh as shlib
from gs2m_tpu_torch.core.camera import Camera
from gs2m_tpu_torch.core.gaussians import Gaussians
from gs2m_tpu_torch.ops import blend
from gs2m_tpu_torch.ops import preprocess as pp
from gs2m_tpu_torch.ops.projection import compute_cov2d
from gs2m_tpu_torch.utils.grad_gate import DEFAULT_TOL, TOLERANCES, grad_gate

torch.set_num_threads(1)

W, H, N, CAP = 64, 48, 240, 256
# Row groups of edge_scene.
BEHIND, THIN, DEAD, TIES, ZERO_RGB, CLAMP = (
    slice(0, 8), slice(8, 24), slice(24, 32), slice(32, 40), 40,
    slice(41, 45))


def cpu_camera():
    return Camera.create(np.eye(3), np.array([0.0, 0.0, 4.0]), 0.9,
                         0.9 * H / W, W, H, device="cpu")


def exact_zero_dc() -> np.float32:
    """An f_dc whose product with float32 C0 rounds to exactly -0.5, so
    the colour C0 f_dc + 0.5 is exactly 0."""
    b0 = np.float32(shlib.C0)
    v = np.float32(-0.5 / float(b0))
    for _ in range(64):
        if b0 * v == np.float32(-0.5):
            return v
        v = np.nextafter(v, np.float32(-np.inf) if b0 * v > -0.5
                         else np.float32(np.inf))
    raise AssertionError("no f_dc gives an exact zero colour")


def edge_scene(seed: int, max_sh_degree: int = 3) -> Gaussians:
    rng = np.random.default_rng(seed)
    K = shlib.num_sh_coeffs(max_sh_degree)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    cam = cpu_camera()
    p = dict(xyz=f(CAP, 3) * np.float32(0.8), f_dc=f(CAP, 1, 3),
             f_rest=0.2 * f(CAP, K - 1, 3),
             scaling=np.float32(np.log(0.05)) + 0.5 * f(CAP, 3),
             rotation=f(CAP, 4), opacity=0.5 + f(CAP, 1),
             albedo=f(CAP, 3), roughness=f(CAP, 1), metallic=f(CAP, 1))
    alive = np.zeros(CAP, bool)
    alive[:N] = True
    # Behind the near plane (view z = 4 + z <= 0.2), some far behind.
    p["xyz"][BEHIND, 2] = np.float32(-3.9) - np.abs(f(8)) * 4
    # Razor-thin splats: two log-scales at -24, so the 2D covariance is
    # rank one up to rounding and det falls on either side of 0.
    p["scaling"][THIN, 1:] = -24.0
    # Dead slots in the middle of the scene.
    alive[DEAD] = False
    # Equal scales: all three (the first minimum is column 0), and the last
    # two below the first (column 1).
    p["scaling"][32:36] = -2.5
    p["scaling"][36:40, 0] = -1.0
    p["scaling"][36:40, 1:] = -2.5
    # Colour channel 0 exactly at 0 (every other band of it zero).
    p["f_dc"][ZERO_RGB, 0, 0] = exact_zero_dc()
    p["f_rest"][ZERO_RGB, :, 0] = 0.0
    # View-space x (then y) / z exactly at +-1.3 tanfov, at view z = 4, with
    # scales large enough that the splat still reaches the image.
    lim_x = float(1.3 * cam.tanfovx)
    lim_y = float(1.3 * cam.tanfovy)
    p["xyz"][CLAMP] = 0.0
    p["xyz"][41, 0] = np.float32(4.0 * lim_x)
    p["xyz"][42, 0] = np.float32(-4.0 * lim_x)
    p["xyz"][43, 1] = np.float32(4.0 * lim_y)
    p["xyz"][44, 1] = np.float32(-4.0 * lim_y)
    p["scaling"][CLAMP] = np.float32(np.log(0.6))
    return Gaussians.from_numpy(p, alive, max_sh_degree, device="cpu")


def leaves_of(g: Gaussians) -> dict:
    return {k: v.detach().clone().requires_grad_(True)
            for k, v in g.params_dict().items()}


def cotangents(seed: int, C: int) -> dict:
    """Random cotangents of the five differentiable outputs. The thin rows
    get none for means2d and conics: their det is rounding noise, so the
    conic (1/det-scaled, gradients ~1e9 here) and whether the row is culled
    at all depend on the order of the roundings, which differs between
    paths; the rows are in the scene for the det <= 0 cull."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    cot = {"opacities": f(C), "features": f(C, 10), "means2d": f(C, 2),
           "conics": f(C, 3), "colors": f(C, 3)}
    cot["means2d"][THIN] = 0.0
    cot["conics"][THIN] = 0.0
    return cot


def autograd_grads(g, cam, deg, cot, **kw) -> dict:
    """Autograd of the eager chain, pulled back along `cot`."""
    leaves = leaves_of(g)
    out = pp.preprocess_plain(g.with_params(leaves), cam, deg, **kw)
    loss = (torch.sum(out.opacities * cot["opacities"])
            + torch.sum(out.features * cot["features"])
            + torch.sum(out.proj.means2d * cot["means2d"])
            + torch.sum(out.proj.conics * cot["conics"])
            + torch.sum(out.proj.colors * cot["colors"]))
    got = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return {k: torch.zeros_like(v) if d is None else d
            for (k, v), d in zip(leaves.items(), got)}


def twin_grads(g, cam, deg, cot, **kw) -> dict:
    return pp.preprocess_bwd_plain(
        g, cam, cot["opacities"], cot["features"], cot["means2d"],
        cot["conics"], cot["colors"], deg=deg, **kw)


def assert_gate(got: dict, ref: dict):
    for k, r in ref.items():
        assert bool(torch.isfinite(got[k]).all()), k
        rep = grad_gate(got[k].numpy(), r.numpy(),
                        tol=TOLERANCES.get(k, DEFAULT_TOL))
        assert rep["pass"], (k, rep)


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_bwd_plain_matches_autograd(deg):
    g, cam = edge_scene(deg), cpu_camera()
    cot = cotangents(10 + deg, CAP)
    ref = autograd_grads(g, cam, deg, cot)
    got = twin_grads(g, cam, deg, cot)
    assert_gate(got, ref)
    # The edge rows on their own, where a tie or a cull decides.
    for rows in (BEHIND, THIN, DEAD, TIES, slice(ZERO_RGB, ZERO_RGB + 1),
                 CLAMP):
        for k in ref:
            scale = float(ref[k].abs().max()) + 1e-30
            torch.testing.assert_close(got[k][rows], ref[k][rows], rtol=1e-3,
                                       atol=1e-5 * scale,
                                       msg=lambda m, k=k: f"{k} {rows}: {m}")


def test_edge_rows_are_what_they_claim():
    """The scene's edge rows: culled behind the camera, det <= 0 among the
    thin ones, dead slots invalid, the clamp rows visible and on the
    bound, a colour exactly 0 and the normals' ties."""
    g, cam = edge_scene(3), cpu_camera()
    out = pp.preprocess_plain(g, cam, 3)
    valid = out.proj.valid
    assert not bool(valid[BEHIND].any())
    cov = compute_cov2d(g.xyz, g.get_covariance(), cam)
    det = cov[:, 0] * cov[:, 2] - cov[:, 1] * cov[:, 1]
    assert bool((det[THIN] <= 0).any()) and bool((det[THIN] > 0).any())
    assert not bool(valid[DEAD].any()) and float(out.opacities[DEAD].abs().sum()) == 0
    assert bool(valid[CLAMP].all())
    t = cam.world_to_cam(g.xyz[CLAMP])
    u = torch.stack([t[:2, 0] / t[:2, 2], t[2:, 1] / t[2:, 2]])
    lim = torch.stack([1.3 * cam.tanfovx, 1.3 * cam.tanfovy])
    assert torch.equal(u.abs(), lim[:, None].expand(2, 2))
    assert float(out.proj.colors[ZERO_RGB, 0]) == 0.0
    s = g.get_scaling[TIES]
    assert bool((s[:4, 0] == s[:4, 1]).all() & (s[4:, 1] == s[4:, 2]).all())


def test_colour_tie_takes_half_the_gradient():
    """torch.maximum(x, 0) at x == 0: autograd and the twin both pass half
    the colour's cotangent to the SH coefficients."""
    g, cam = edge_scene(2), cpu_camera()
    cot = cotangents(5, CAP)
    got = twin_grads(g, cam, 0, cot)
    ref = autograd_grads(g, cam, 0, cot)
    want = 0.5 * float(cot["colors"][ZERO_RGB, 0]) * np.float32(shlib.C0)
    assert float(got["f_dc"][ZERO_RGB, 0, 0]) == pytest.approx(want, rel=1e-6)
    assert float(ref["f_dc"][ZERO_RGB, 0, 0]) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("deg,kw", [(3, dict(z_depth=True)),
                                    (2, dict(with_colors=False)),
                                    (1, dict(tile=8))],
                         ids=["z_depth", "no_colors", "tile8"])
def test_bwd_plain_matches_autograd_variants(deg, kw):
    g, cam = edge_scene(20 + deg), cpu_camera()
    cot = cotangents(30 + deg, CAP)
    assert_gate(twin_grads(g, cam, deg, cot, **kw),
                autograd_grads(g, cam, deg, cot, **kw))


def test_bwd_plain_at_the_active_degree_below_the_stored_one():
    """Degree 1 active over degree-3 coefficients: the higher bands get
    exactly zero gradient; the same scene stored at degree 1 agrees."""
    g3, cam = edge_scene(7, max_sh_degree=3), cpu_camera()
    g1 = dataclasses.replace(g3, features_rest=g3.features_rest[:, :3].clone(),
                             max_sh_degree=1)
    cot = cotangents(8, CAP)
    a, b = twin_grads(g3, cam, 1, cot), twin_grads(g1, cam, 1, cot)
    assert float(a["f_rest"][:, 3:].abs().max()) == 0.0
    for k in a:
        want = b[k] if k != "f_rest" else b[k]
        got = a[k] if k != "f_rest" else a[k][:, :3]
        assert torch.equal(got, want), k


def test_bwd_plain_without_cotangents_is_zero():
    g, cam = edge_scene(4), cpu_camera()
    got = pp.preprocess_bwd_plain(g, cam, None, None, None, None, None, deg=3)
    for k, v in got.items():
        assert v.shape == g.params_dict()[k].shape and not bool(v.any()), k


def test_cpu_preprocess_is_the_eager_chain_and_launches_nothing():
    g, cam = edge_scene(5), cpu_camera()
    before = dict(blend.LAUNCHES)
    a = pp.preprocess(g, cam, 2, z_depth=True)
    b = pp.preprocess_plain(g, cam, 2, z_depth=True)
    assert blend.LAUNCHES == before
    for x, y in zip([a.opacities, a.features, *a.proj],
                    [b.opacities, b.features, *b.proj]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("bad", ["degree", "dtype", "shape"])
def test_card_wrapper_rejects_what_the_kernels_do_not_take(bad):
    g, cam = edge_scene(6, max_sh_degree=2), cpu_camera()
    deg = 3 if bad == "degree" else 2
    if bad == "dtype":
        g = dataclasses.replace(g, xyz=g.xyz.double())
    if bad == "shape":
        g = dataclasses.replace(g, rotation=g.rotation[:, :3])
    with pytest.raises(ValueError):
        pp._check(pp._inputs(g, cam), deg)
    if bad == "degree":
        pp._check(pp._inputs(g, cam), 2)  # the degree it carries is fine

