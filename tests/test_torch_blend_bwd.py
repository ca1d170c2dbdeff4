"""Port vs JAX package: ops/blend.py's backward and observe pass — K2's and
K3's plain versions against the Pallas kernels (interpret mode) on identical
inputs, the autograd Function against jax.grad of blend_tiles_pallas, and
the per-Gaussian segment sums.

Tolerances: K2 dgeom/dvals per channel row atol 1e-5 * max|row|, rtol 1e-4;
K3 counts exactly equal (and equal to K1's); gradients through the Function
at the distributional gate of scripts/check_grads_onchip.py
(gs2m_tpu_torch/utils/grad_gate.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2m_tpu.ops.blend_pallas import (_gather_instances, _run_backward,
                                       _run_forward, blend_tiles_pallas,
                                       observe_tiles_pallas)
from gs2m_tpu_torch.ops import blend as tblend
from gs2m_tpu_torch.ops.binning import Binning as TBinning
from gs2m_tpu_torch.ops.binning import num_tiles
from gs2m_tpu_torch.utils.grad_gate import grad_gate as gate

from tests.test_torch_blend import CASES, setup

torch.set_num_threads(1)


def grad_gate(a, b, tol=5e-3, name=""):
    """Assert the distributional gradient gate for port `a` vs reference `b`."""
    rep = gate(a, b, tol)
    assert rep["pass"], f"{name}: {rep}"


def _t(x):
    return torch.from_numpy(np.array(x))


def forward_inputs(case):
    proj, op, values, b, (H, W), chunk = setup(case)
    grid_y, grid_x = num_tiles(H, W, 16)
    T = grid_y * grid_x
    n_chunks = b.gid.shape[0] // chunk
    geom, vals = _gather_instances(values, proj.means2d, proj.conics, op,
                                   b.gid, b.is_null)
    kw = dict(T=T, n_chunks=n_chunks, chunk=chunk, tile=16, grid_x=grid_x,
              width=W, height=H)
    return proj, op, values, b, geom, vals, kw


@pytest.mark.parametrize("case", list(CASES))
def test_plain_k2_matches_pallas_kernel(case):
    proj, op, values, b, geom, vals, kw = forward_inputs(case)
    T, V = kw["T"], vals.shape[0]
    fwd = _run_forward(geom, vals, b.chunk_tile, interpret=True, **kw)
    _, fT, clogT, cdone, _ = fwd
    # The Pallas kernel leaves rows of tiles no chunk visits unwritten: give
    # both sides K1's plain carries there (never read by either backward).
    rows = np.zeros(T + 1, bool)
    rows[np.unique(np.asarray(b.chunk_tile))] = True
    fT = np.where(rows[:, None, None], np.asarray(fT), 1.0).astype(np.float32)
    rng = np.random.default_rng(5)
    g_img = rng.normal(size=(T + 1, V, 256)).astype(np.float32)
    gT = rng.normal(size=(T + 1, 1, 256)).astype(np.float32)
    g_img[T] = 0.0
    gT[T] = 0.0
    ref = _run_backward(geom, vals, b.chunk_tile, clogT, cdone,
                        jnp.asarray(g_img), jnp.asarray(gT), jnp.asarray(fT),
                        interpret=True, **kw)
    before = dict(tblend.LAUNCHES)
    got = tblend.blend_bwd(_t(geom), _t(vals), _t(b.chunk_tile), _t(clogT),
                           _t(cdone), _t(g_img), _t(gT), _t(fT), T=T,
                           grid_x=kw["grid_x"], width=kw["width"],
                           height=kw["height"], tile=16, chunk=kw["chunk"])
    assert tblend.LAUNCHES == before  # CPU tensors never launch the kernel
    for name, r, x in zip(("dgeom", "dvals"), ref, got):
        r, x = np.asarray(r), x.numpy()
        assert r.shape == x.shape and np.isfinite(x).all(), name
        for i in range(r.shape[0]):
            scale = np.abs(r[i]).max()
            np.testing.assert_allclose(x[i], r[i], atol=1e-5 * scale + 1e-30,
                                       rtol=1e-4, err_msg=f"{name}[{i}]")
    assert np.abs(np.asarray(ref[0])).max() > 0
    if case == "heavy_occlusion":
        # Termination: chunks start with terminated pixels.
        assert np.asarray(cdone).any()
    if case == "clamp":
        assert float(op.max()) > 0.99


@pytest.mark.parametrize("case", list(CASES))
def test_plain_k3_matches_pallas_and_k1(case):
    proj, op, values, b, geom, vals, kw = forward_inputs(case)
    H, W, chunk = kw["height"], kw["width"], kw["chunk"]
    ref = observe_tiles_pallas(proj.means2d, proj.conics, op, b, H, W, 16,
                               chunk, interpret=True)
    tb = TBinning(*[_t(x) for x in b])
    got = tblend.observe_tiles(_t(proj.means2d), _t(proj.conics), _t(op), tb,
                               H, W, 16, chunk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # K3's plain version is K1's observe output, count for count.
    dims = dict(T=kw["T"], grid_x=kw["grid_x"], width=W, height=H, tile=16,
                chunk=chunk)
    obs = tblend.blend_obs(_t(geom), _t(b.chunk_tile), **dims)
    k1 = tblend.blend_fwd(_t(geom), _t(vals), _t(b.chunk_tile), **dims)
    assert torch.equal(obs, k1.obs)
    if case != "overflow":
        assert int(got.sum()) > 0


@pytest.mark.parametrize("case", ["scene_chunk64", "scene_chunk256",
                                  "heavy_occlusion", "clamp", "overflow"])
def test_blend_function_grads_match_jax(case):
    """jax.grad of blend_tiles_pallas vs torch autograd through
    blend_tiles, for values, means2d, conics, opacities and the AbsGS
    sink."""
    proj, op, values, b, (H, W), chunk = setup(case)
    rng = np.random.default_rng(9)
    V = values.shape[1]
    Hp, Wp = -(-H // 16) * 16, -(-W // 16) * 16
    target = rng.uniform(0, 1, (V, H, W)).astype(np.float32)
    wT = rng.uniform(0, 1, (H, W)).astype(np.float32)
    C = values.shape[0]

    def jloss(v, m, c, o, a):
        out = blend_tiles_pallas(v, m, c, o, b, H, W, 16, chunk,
                                 m2d_abs_sink=a, interpret=True)
        return (jnp.sum((out.image[:, :H, :W] - target) ** 2)
                + jnp.sum(out.final_T[:H, :W] * wT))

    jargs = (values, proj.means2d, proj.conics, op, jnp.zeros((C, 2)))
    ref = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*jargs)

    targs = [_t(x).requires_grad_(True) for x in jargs]
    tb = TBinning(*[_t(x) for x in b])
    out = tblend.blend_tiles(*targs[:4], tb, H, W, 16, chunk,
                             m2d_abs_sink=targs[4])
    assert tuple(out.image.shape) == (V, Hp, Wp)
    loss = (torch.sum((out.image[:, :H, :W] - _t(target)) ** 2)
            + torch.sum(out.final_T[:H, :W] * _t(wT)))
    got = torch.autograd.grad(loss, targs)
    for name, r, x in zip(("values", "means2d", "conics", "opacities",
                           "abs_sink"), ref, got):
        grad_gate(x.numpy(), r, name=name)
    assert float(got[4].abs().max()) > 0
    # The AbsGS channel bounds the signed one.
    assert (got[4] >= got[1].abs() - 1e-6).all()


def test_blend_function_observe_only_cotangents():
    """A loss of the image alone leaves final_T's cotangent None: it counts
    as zeros (and observe never takes one)."""
    proj, op, values, b, (H, W), chunk = setup("scene_chunk64")
    tb = TBinning(*[_t(x) for x in b])
    v = _t(values).requires_grad_(True)
    out = tblend.blend_tiles(v, _t(proj.means2d), _t(proj.conics), _t(op), tb,
                             H, W, 16, chunk)
    assert not out.observe.requires_grad
    (g,) = torch.autograd.grad(out.image.sum(), [v])
    ref = jax.grad(lambda x: jnp.sum(blend_tiles_pallas(
        x, proj.means2d, proj.conics, op, b, H, W, 16, chunk,
        interpret=True).image))(values)
    grad_gate(g.numpy(), ref, name="values")


def test_segment_sum_deterministic_and_conditioned_at_scale():
    """Same-sign channels over many instances (the distilled form of the
    JAX package's r4 reduce breach, tests/test_pallas.py:342): every segment
    is summed on its own, so its error stays at its own ULP; two runs are
    bit-equal; null slots (key C) are dropped."""
    rng = np.random.default_rng(3)
    I, seg = 2 ** 18, 4
    C = I // seg - 8
    key = np.repeat(np.arange(I // seg, dtype=np.int32), seg)
    key[key >= C] = C                                   # null slots
    perm = rng.permutation(I)                           # unsorted, like slots
    vals = rng.uniform(0.5, 1.5, I).astype(np.float32)
    alt = (vals * np.where(np.arange(I) % 2 == 0, 1, -1)).astype(np.float32)
    per_inst = torch.from_numpy(np.stack([vals, alt])[:, perm].copy())
    k = torch.from_numpy(key[perm].copy())
    out = tblend.segment_sum(per_inst, k, C)
    again = tblend.segment_sum(per_inst, k, C)
    assert torch.equal(out, again)
    assert tuple(out.shape) == (2, C)
    exact = vals.astype(np.float64)[:C * seg].reshape(C, seg).sum(1)
    rel = np.abs(out[0].numpy() - exact) / exact
    assert rel.max() < 1e-6, rel.max()
    exact_alt = alt.astype(np.float64)[:C * seg].reshape(C, seg).sum(1)
    assert np.abs(out[1].numpy() - exact_alt).max() < 1e-6 * np.abs(vals).max()


@pytest.mark.parametrize("which", ["blend_bwd", "blend_obs"])
def test_kernel_wrappers_reject_unsupported_shapes(which):
    """The CUDA wrappers validate before touching the card."""
    z = torch.zeros
    if which == "blend_bwd":
        call = lambda chunk, ct: tblend._launch_blend_bwd(
            z(8, 96), z(8, 96), ct, z(96 // chunk, 1, 256),
            z(96 // chunk, 1, 256), z(2, 8, 256), z(2, 1, 256), z(2, 1, 256),
            T=1, grid_x=1, width=16, height=16, tile=16, chunk=chunk)
    else:
        call = lambda chunk, ct: tblend._launch_blend_obs(
            z(8, 96), ct, T=1, grid_x=1, width=16, height=16, tile=16,
            chunk=chunk)
    with pytest.raises(ValueError, match="multiple of 32"):
        call(48, z(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        call(32, z(3, dtype=torch.int64))
