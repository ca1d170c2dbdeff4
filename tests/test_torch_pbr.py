"""Port vs JAX package: the PBR stack (pbr/cubemap.py, pbr/shade.py).

The numpy-built tables (cube directions, solid angles, pad indices, the
prefilter weight matrices, the BRDF LUT at a reduced size) are equal bit
for bit. Forward maps on the same seeded inputs are allclose at rtol 1e-5,
atol 1e-6; the vector-Jacobian products of build_mips and pbr_shading (into
the light, and into the albedo / metallic maps) against jax.vjp at rtol
1e-4, atol 1e-6. The semantic checks of tests/test_pbr.py (seamless
lookups, constant-light prefilters, smoothing with roughness) run on the
port, and the light's gradient is the same bits on two runs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2m_tpu.pbr import cubemap as jcm
from gs2m_tpu.pbr import shade as jsh
from gs2m_tpu_torch.pbr import cubemap as tcm
from gs2m_tpu_torch.pbr import shade as tsh

torch.set_num_threads(1)
FWD = dict(rtol=1e-5, atol=1e-6)
VJP = dict(rtol=1e-4, atol=1e-6)


def _t(x, grad=False):
    return torch.from_numpy(np.array(x, np.float32)).requires_grad_(grad)


def _unit(rng, shape):
    d = rng.normal(size=shape + (3,))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("res", [8, 16])
def test_static_tables_equal(res):
    np.testing.assert_array_equal(tcm.cube_dirs(res), jcm.cube_dirs(res))
    np.testing.assert_array_equal(tcm.texel_solid_angle(res),
                                  jcm.texel_solid_angle(res))
    for a, b in zip(tcm._pad_gather_indices(res), jcm._pad_gather_indices(res)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tcm._texel_face_uv(res), jcm._texel_face_uv(res)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tcm._diffuse_weights(res),
                                  jcm._diffuse_weights(res))
    for r in (0.155, 0.5, 1.0):
        np.testing.assert_array_equal(tcm._specular_weights(res, r),
                                      jcm._specular_weights(res, r))
        assert tcm.ndf_cutoff_angle(r) == jcm.ndf_cutoff_angle(r)
    for a, b in zip(tcm._latlong_face_uv(8, 16), jcm._latlong_face_uv(8, 16)):
        np.testing.assert_array_equal(a, b)
    for base in (16, 64, 512):
        n = tcm.num_levels(base)
        assert n == jcm.num_levels(base)
        assert tcm.level_roughness(n) == jcm.level_roughness(n)
        for r in tcm.level_roughness(n):
            assert tcm._prefilter_res(base, r) == jcm._prefilter_res(base, r)


def test_brdf_lut_equal_and_sane():
    np.testing.assert_array_equal(tsh.compute_brdf_lut(32, 64),
                                  jsh.compute_brdf_lut(32, 64))
    np.testing.assert_array_equal(tsh._hammersley(64), jsh._hammersley(64))
    lut = tsh.get_brdf_lut("cpu").numpy()
    assert lut.shape == (256, 256, 2) and np.isfinite(lut).all()
    assert lut[-1, 0, 0] > 0.9 and lut[-1, 0, 1] < 0.1


def test_lookups_match_jax():
    rng = np.random.default_rng(0)
    cmap = rng.uniform(0, 1, (6, 8, 8, 3)).astype(np.float32)
    dirs = rng.normal(size=(7, 9, 3)).astype(np.float32)
    # Exact face-edge and corner directions too.
    dirs[0, :4] = [[1, 1, 0.2], [1, 1, 1], [0, -1, 1], [-1, 0.3, -1]]
    jf, ju, jv = jcm.dir_to_face_uv(jnp.asarray(dirs))
    tf, tu, tv = tcm.dir_to_face_uv(_t(dirs))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **FWD)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **FWD)
    np.testing.assert_array_equal(tcm.pad_cube(_t(cmap)).numpy(),
                                  np.asarray(jcm.pad_cube(jnp.asarray(cmap))))
    for seamless in (True, False):
        np.testing.assert_allclose(
            tcm.cube_lookup(_t(cmap), _t(dirs), seamless).numpy(),
            np.asarray(jcm.cube_lookup(jnp.asarray(cmap), jnp.asarray(dirs),
                                       seamless)), **FWD)
    np.testing.assert_allclose(
        tcm.upsample_cube(_t(cmap), 16).numpy(),
        np.asarray(jcm.upsample_cube(jnp.asarray(cmap), 16)), **FWD)
    np.testing.assert_allclose(
        tcm.cubemap_to_latlong(_t(cmap), (8, 16)).numpy(),
        np.asarray(jcm.cubemap_to_latlong(jnp.asarray(cmap), (8, 16))), **FWD)


def test_lookup_vjp_matches_jax_and_is_deterministic():
    rng = np.random.default_rng(1)
    cmap = rng.uniform(0, 1, (6, 8, 8, 3)).astype(np.float32)
    dirs = rng.normal(size=(300, 3)).astype(np.float32)
    ct = rng.normal(size=(300, 3)).astype(np.float32)
    _, vjp = jax.vjp(lambda c: jcm.cube_lookup(c, jnp.asarray(dirs)),
                     jnp.asarray(cmap))
    (jg,) = vjp(jnp.asarray(ct))
    grads = []
    for _ in range(2):
        c = _t(cmap, True)
        (g,) = torch.autograd.grad(tcm.cube_lookup(c, _t(dirs)), [c], _t(ct))
        grads.append(g)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jg), **VJP)
    assert torch.equal(grads[0], grads[1])
    # The gradient mass is the number of samples (bilinear weights sum to 1).
    c = torch.full((6, 8, 8, 3), 0.7, requires_grad=True)
    out = tcm.cube_lookup(c, _t(dirs))
    np.testing.assert_allclose(out.detach().numpy(), 0.7, atol=1e-6)
    (g,) = torch.autograd.grad(out.sum(), [c])
    np.testing.assert_allclose(float(g.sum()), 300 * 3, rtol=1e-5)


@pytest.mark.parametrize("res", [32, 64])
def test_build_mips_value_and_vjp(res):
    rng = np.random.default_rng(res)
    base = rng.uniform(0.1, 1.0, (6, res, res, 3)).astype(np.float32)
    jd, js = jcm.build_mips(jnp.asarray(base))
    b = _t(base, True)
    td, ts = tcm.build_mips(b)
    assert len(ts) == len(js) == tcm.num_levels(res)
    np.testing.assert_allclose(td.detach().numpy(), np.asarray(jd), **FWD)
    for a, c in zip(ts, js):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(c), **FWD)
    cts = [rng.normal(size=np.shape(x)).astype(np.float32) for x in [jd, *js]]
    _, vjp = jax.vjp(lambda x: jcm.build_mips(x), jnp.asarray(base))
    (jg,) = vjp((jnp.asarray(cts[0]), [jnp.asarray(c) for c in cts[1:]]))
    (tg,) = torch.autograd.grad([td, *ts], [b], [_t(c) for c in cts])
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **VJP)


def _shading_inputs(rng, H=6, W=8):
    n = _unit(rng, (H, W))
    v = _unit(rng, (H, W))
    v = np.where(np.sum(n * v, -1, keepdims=True) < 0, -v, v)
    return dict(normals=n, view_dirs=v,
                albedo=rng.uniform(0, 1, (H, W, 3)).astype(np.float32),
                roughness=rng.uniform(0.04, 1, (H, W, 1)).astype(np.float32),
                metallic=rng.uniform(0, 1, (H, W, 1)).astype(np.float32))


@pytest.mark.parametrize("gamma,metallic", [(False, True), (True, False)])
def test_pbr_shading_value_and_vjp(gamma, metallic):
    rng = np.random.default_rng(7)
    base = rng.uniform(0.1, 1.0, (6, 32, 32, 3)).astype(np.float32)
    x = _shading_inputs(rng)
    keys = ("render_rgb", "diffuse_rgb", "specular_rgb")
    cts = {k: rng.normal(size=(6, 8, 3)).astype(np.float32) for k in keys}
    jlut = jsh.get_brdf_lut()

    def jf(light, albedo, met):
        d, s = jcm.build_mips(light)
        out = jsh.pbr_shading(d, s, jnp.asarray(x["normals"]),
                              jnp.asarray(x["view_dirs"]), albedo,
                              jnp.asarray(x["roughness"]), jlut,
                              metallic=met if metallic else None, gamma=gamma)
        return tuple(out[k] for k in keys)

    jout, vjp = jax.vjp(jf, jnp.asarray(base), jnp.asarray(x["albedo"]),
                        jnp.asarray(x["metallic"]))
    jgrads = vjp(tuple(jnp.asarray(cts[k]) for k in keys))

    light, albedo, met = (_t(base, True), _t(x["albedo"], True),
                          _t(x["metallic"], True))
    d, s = tcm.build_mips(light)
    out = tsh.pbr_shading(d, s, _t(x["normals"]), _t(x["view_dirs"]), albedo,
                          _t(x["roughness"]), tsh.get_brdf_lut("cpu"),
                          metallic=met if metallic else None, gamma=gamma)
    for k, j in zip(keys, jout):
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(j),
                                   **FWD, err_msg=k)
    leaves = [light, albedo] + ([met] if metallic else [])
    tgrads = torch.autograd.grad([out[k] for k in keys], leaves,
                                 [_t(cts[k]) for k in keys])
    for name, a, b in zip(("light", "albedo", "metallic"), tgrads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **VJP,
                                   err_msg=name)


def test_curves_and_mip_match_jax():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.uniform(-0.2, 1.5, 200), [0.0, 1.0, 0.0031308,
                                                      0.04045, 0.5]]).astype(np.float32)
    for name in ("aces_film", "linear_to_srgb", "srgb_to_linear"):
        np.testing.assert_allclose(getattr(tsh, name)(_t(x)).numpy(),
                                   np.asarray(getattr(jsh, name)(jnp.asarray(x))),
                                   **FWD, err_msg=name)
    r = np.concatenate([rng.uniform(0, 1, 100),
                        [0.04, 0.5, 1.0, 0.0]]).astype(np.float32)[:, None]
    for n in (3, 6):
        np.testing.assert_allclose(tsh.get_mip(_t(r), n).numpy(),
                                   np.asarray(jsh.get_mip(jnp.asarray(r), n)),
                                   **FWD)
    assert float(tsh.get_mip(torch.tensor(tcm.MIN_ROUGHNESS), 6)) == 0.0
    np.testing.assert_allclose(float(tsh.get_mip(torch.tensor(1.0), 6)), 5)
    a, b = _unit(rng, (50,)), _unit(rng, (50,))
    np.testing.assert_allclose(tsh.saturate_dot(_t(a), _t(b)).numpy(),
                               np.asarray(jsh.saturate_dot(a, b)), **FWD)
    uv = rng.uniform(-0.1, 1.1, (40, 2)).astype(np.float32)
    lut = jsh.compute_brdf_lut(16, 32)
    np.testing.assert_allclose(tsh.sample_lut(_t(lut), _t(uv)).numpy(),
                               np.asarray(jsh.sample_lut(jnp.asarray(lut),
                                                         jnp.asarray(uv))),
                               **FWD)
    srgb = tsh.linear_to_srgb(torch.linspace(0, 1, 64))
    np.testing.assert_allclose(tsh.srgb_to_linear(srgb).numpy(),
                               np.linspace(0, 1, 64), atol=1e-3)


def _smooth_field(d):
    return np.stack([0.5 + 0.5 * d[..., 0], 0.5 + 0.5 * d[..., 1] * d[..., 2],
                     0.5 + 0.3 * d[..., 2]], -1).astype(np.float32)


def test_lookup_is_seamless_across_edges():
    cmap = _t(_smooth_field(tcm.cube_dirs(16)))
    t = np.linspace(-0.3, 0.3, 801)
    walk = np.stack([np.cos(np.pi / 4 + t), np.full_like(t, 0.1),
                     np.sin(np.pi / 4 + t)], -1)
    walk /= np.linalg.norm(walk, axis=-1, keepdims=True)
    out = tcm.cube_lookup(cmap, _t(walk)).numpy()
    out_clamp = tcm.cube_lookup(cmap, _t(walk), seamless=False).numpy()
    step = np.abs(np.diff(out, axis=0)).max()
    assert step < 1e-3 and step < np.abs(np.diff(out_clamp, axis=0)).max() / 10
    assert np.abs(out - _smooth_field(walk)).max() < 3e-3


def test_prefilters_keep_constant_light_and_smooth_with_roughness():
    diffuse, _ = tcm.build_mips(torch.full((6, 16, 16, 3), 0.5))
    np.testing.assert_allclose(diffuse.numpy(), 0.5, rtol=2e-2)
    _, specular = tcm.build_mips(torch.full((6, 64, 64, 3), 0.8))
    assert len(specular) == 3
    for lvl in specular:
        np.testing.assert_allclose(lvl.numpy(), 0.8, rtol=3e-2)
    base = torch.zeros(6, 64, 64, 3)
    base[4, 32, 32] = 50.0
    peaks = [float(lvl.max()) for lvl in tcm.build_mips(base)[1]]
    assert peaks[0] > peaks[1] > peaks[2]


def test_device_weights_are_built_once():
    a = tcm._device_weights("specular", 16, 0.5, 0.99, torch.device("cpu"))
    b = tcm._device_weights("specular", 16, 0.5, 0.99, torch.device("cpu"))
    assert a is b
