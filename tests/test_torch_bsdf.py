"""Port vs JAX package: the point-light BSDF library and the HDR image
losses (pbr/bsdf.py). Each function on the same seeded inputs: values at
rtol 1e-5, gradients (jax.vjp against autograd, seeded cotangents) at rtol
1e-4; and the semantic checks of tests/test_bsdf.py on the port."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2m_tpu.pbr import bsdf as JB
from gs2m_tpu_torch.pbr import bsdf as TB

torch.set_num_threads(1)


def _unit(rng, n):
    d = rng.normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _inputs(seed, n=96):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    nrm = pos / np.linalg.norm(pos, axis=-1, keepdims=True)
    return dict(
        pos=pos, nrm=nrm,
        view=(pos + nrm * 2.0 + rng.normal(scale=0.4, size=(n, 3))).astype(np.float32),
        light=(pos + nrm * 3.0 + rng.normal(scale=0.8, size=(n, 3))).astype(np.float32),
        kd=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        arm=rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32),
        wi=_unit(rng, n), wo=_unit(rng, n), tng=_unit(rng, n),
        pert=rng.normal(size=(n, 3)).astype(np.float32),
        a2=(rng.uniform(0.001, 0.8, (n, 1))).astype(np.float32),
        ct=rng.uniform(-0.2, 1.1, (n, 1)).astype(np.float32),
        ct2=rng.uniform(-0.2, 1.1, (n, 1)).astype(np.float32),
        col=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        rough=rng.uniform(0, 1, (n, 1)).astype(np.float32),
        mat=rng.normal(size=(4, 4)).astype(np.float32),
        img=rng.uniform(0, 3, (n, 3)).astype(np.float32),
        target=rng.uniform(0, 3, (n, 3)).astype(np.float32))


CASES = {
    "dot": (("wi", "wo"), {}),
    "reflect": (("wi", "nrm"), {}),
    "safe_normalize": (("pert",), {}),
    "bend_normal": (("wo", "tng", "nrm"), {"two_sided_shading": True}),
    "perturb_normal": (("pert", "nrm", "tng"), {"opengl": True}),
    "prepare_shading_normal": (("pos", "view", "pert", "nrm", "tng", "wi"),
                               {"two_sided_shading": True, "opengl": False}),
    "bsdf_lambert": (("nrm", "wi"), {}),
    "bsdf_fresnel_shlick": (("col", "rough", "ct"), {}),
    "bsdf_frostbite": (("nrm", "wi", "wo", "rough"), {}),
    "bsdf_phong": (("nrm", "wo", "wi"), {"N": 8.0}),
    "bsdf_ndf_ggx": (("a2", "ct"), {}),
    "bsdf_lambda_ggx": (("a2", "ct"), {}),
    "bsdf_masking_smith_ggx_correlated": (("a2", "ct", "ct2"), {}),
    "bsdf_pbr_specular": (("col", "nrm", "wo", "wi", "a2"), {}),
    "xfm_points": (("pos", "mat"), {}),
    "xfm_vectors": (("wi", "mat"), {}),
    "smape": (("img", "target"), {}),
    "relmse": (("img", "target"), {}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_value_and_grad_match_jax(name):
    keys, kw = CASES[name]
    x = _inputs(sorted(CASES).index(name))
    args = [x[k] for k in keys]
    jout, vjp = jax.vjp(lambda *a: getattr(JB, name)(*a, **kw),
                        *map(jnp.asarray, args))
    ct = np.random.default_rng(5).normal(size=np.shape(jout)).astype(np.float32)
    jg = vjp(jnp.asarray(ct))
    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    tout = getattr(TB, name)(*targs, **kw)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
    tg = torch.autograd.grad(tout, targs, torch.from_numpy(ct),
                             allow_unused=True)
    for k, a, b in zip(keys, tg, jg):
        a = np.zeros_like(np.asarray(b)) if a is None else a.numpy()
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4,
                                   atol=1e-5 * (1 + np.abs(np.asarray(b)).max()),
                                   err_msg=k)


@pytest.mark.parametrize("bsdf", [0, 1])
def test_bsdf_pbr_matches_jax_and_is_sane(bsdf):
    x = _inputs(11)
    keys = ("kd", "arm", "pos", "nrm", "view", "light")
    jout, vjp = jax.vjp(lambda *a: JB.bsdf_pbr(*a, bsdf=bsdf),
                        *(jnp.asarray(x[k]) for k in keys))
    t = [torch.from_numpy(x[k]).requires_grad_(True) for k in keys]
    tout = TB.bsdf_pbr(*t, bsdf=bsdf)
    o = tout.detach().numpy()
    np.testing.assert_allclose(o, np.asarray(jout), rtol=1e-5, atol=1e-6)
    assert np.isfinite(o).all() and (o >= 0).all()
    ct = np.ones_like(o)
    jg = vjp(jnp.asarray(ct))
    tg = torch.autograd.grad(tout, t, torch.from_numpy(ct))
    for k, a, b in zip(keys, tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5 * (1 + np.abs(np.asarray(b)).max()),
                                   err_msg=k)
    assert float(tg[0].abs().sum()) > 0


@pytest.mark.parametrize("loss", ["l1", "mse", "smape", "relmse"])
@pytest.mark.parametrize("tonemapper", ["none", "log_srgb"])
def test_image_losses_match_jax(loss, tonemapper):
    x = _inputs(13)
    j = JB.image_loss(jnp.asarray(x["img"]), jnp.asarray(x["target"]),
                      loss=loss, tonemapper=tonemapper)
    t = TB.image_loss(torch.from_numpy(x["img"]), torch.from_numpy(x["target"]),
                      loss=loss, tonemapper=tonemapper)
    np.testing.assert_allclose(float(t), float(j), rtol=1e-5)


def test_lambert_and_ggx_formulas():
    x = _inputs(17)
    np.testing.assert_allclose(
        TB.bsdf_lambert(torch.from_numpy(x["nrm"]), torch.from_numpy(x["wi"])).numpy(),
        np.clip(np.sum(x["nrm"] * x["wi"], -1, keepdims=True), 0, None) / math.pi,
        atol=1e-6)
    c = np.clip(x["ct"], 1e-4, 1 - 1e-4)
    dd = (c * x["a2"] - c) * c + 1
    np.testing.assert_allclose(
        TB.bsdf_ndf_ggx(torch.from_numpy(x["a2"]), torch.from_numpy(x["ct"])).numpy(),
        x["a2"] / (dd * dd * math.pi), rtol=1e-5)


def test_two_sided_shading_flips_toward_viewer():
    z = np.array([[0, 0, 1]] * 4, np.float32)
    out = TB.prepare_shading_normal(
        torch.zeros(4, 3), torch.from_numpy(z), torch.from_numpy(z),
        torch.from_numpy(-z), torch.from_numpy(np.array([[1, 0, 0]] * 4, np.float32)),
        torch.from_numpy(-z), two_sided_shading=True, opengl=False)
    assert float(out[0, 2]) > 0.9
