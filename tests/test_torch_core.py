"""Port vs JAX package: config, camera, SH, Gaussian activations, carry-over.

Inputs are made with numpy from a seed and fed to both packages; the
shared helpers here (`port_gaussians`, `camera_pair`) are reused by the
other test_torch_* files.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs2m_tpu.core import config as jcfg
from gs2m_tpu.core import sh as jsh
from gs2m_tpu.core.camera import Camera as JCamera
from gs2m_tpu.core.gaussians import Gaussians as JGaussians
from gs2m_tpu_torch.core import config as tcfg
from gs2m_tpu_torch.core import sh as tsh
from gs2m_tpu_torch.core.camera import Camera as TCamera
from gs2m_tpu_torch.core.gaussians import Gaussians as TGaussians

from tests.test_golden import make_scene

torch.set_num_threads(1)


def port_gaussians(g: JGaussians) -> TGaussians:
    """The JAX Gaussians' leaves carried over to the port (CPU)."""
    return TGaussians.from_numpy(
        {k: np.asarray(v) for k, v in g.params_dict().items()},
        np.asarray(g.alive), g.max_sh_degree, device="cpu")


def camera_pair(width=64, height=64, dist=4.0, R=None, T=None, fov=0.9):
    """The same camera in both packages (tests.test_golden.make_camera's
    defaults)."""
    R = np.eye(3) if R is None else R
    T = np.array([0.0, 0.0, dist]) if T is None else T
    kw = dict(fovx=fov, fovy=fov, width=width, height=height)
    return (JCamera.create(R, T, **kw),
            TCamera.create(R, T, **kw, device="cpu"))


def random_pose_scene(seed, n=60, capacity=64, sh_degree=1):
    return make_scene(np.random.default_rng(seed), n=n, capacity=capacity,
                      sh_degree=sh_degree, random_pose=True)


@pytest.mark.parametrize("group", ["ModelConfig", "PipelineConfig",
                                   "OptimConfig"])
def test_config_fields_and_defaults_match(group):
    ja = [(f.name, f.default, f.type) for f in
          dataclasses.fields(getattr(jcfg, group))]
    tp = [(f.name, f.default, f.type) for f in
          dataclasses.fields(getattr(tcfg, group))]
    assert ja == tp


def test_config_file_interop(tmp_path):
    """cfg_args.json written by the JAX package is read by the port and
    merged under CLI overrides the same way."""
    from argparse import ArgumentParser

    model = jcfg.ModelConfig(source_path=str(tmp_path), model_path=str(tmp_path),
                             sh_degree=2, white_background=True)
    jcfg.save_cfg_args(str(tmp_path), model, jcfg.PipelineConfig(chunk=64),
                       jcfg.OptimConfig(iterations=7))
    argv = ["-m", str(tmp_path), "--resolution", "2", "--no-use_pallas"]
    merged = []
    for mod in (jcfg, tcfg):
        p = ArgumentParser()
        for cls in (mod.ModelConfig, mod.PipelineConfig, mod.OptimConfig):
            mod.add_group_args(p, cls, fill_none=True)
        _, m, pi, o = mod.combine_args(p, argv)
        merged.append([dataclasses.asdict(x) for x in (m, pi, o)])
    assert merged[0] == merged[1]
    assert merged[1][0]["resolution"] == 2 and merged[1][1]["chunk"] == 64


@pytest.mark.parametrize("case", range(4))
def test_camera_matrices_bit_equal(case):
    from tests.make_synthetic_scene import ring_camera

    R, T = ring_camera(2 * np.pi * case / 4, dist=3.0 + case)
    trans = None if case < 2 else np.array([0.1, -0.2, 0.3])
    scale = 1.0 if case % 2 == 0 else 1.3
    kw = dict(fovx=0.7 + 0.1 * case, fovy=0.6, width=48 + 16 * case,
              height=40, trans=trans, scale=scale)
    jc = JCamera.create(R, T, **kw)
    tc = TCamera.create(R, T, **kw, device="cpu")
    for name in ("world_view", "full_proj", "cam_center", "fx", "fy", "cx",
                 "cy", "tanfovx", "tanfovy"):
        a, b = np.asarray(getattr(jc, name)), getattr(tc, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(np.asarray(jc.get_K()), tc.get_K().numpy())
    np.testing.assert_allclose(np.asarray(jc.get_rays()), tc.get_rays().numpy(),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_sh_eval_matches(deg):
    rng = np.random.default_rng(deg)
    sh = rng.normal(size=(50, 16, 3)).astype(np.float32)
    d = rng.normal(size=(50, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_allclose(
        tsh.eval_sh(deg, torch.from_numpy(sh), torch.from_numpy(d)).numpy(),
        np.asarray(jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(d))),
        atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        tsh.sh_to_rgb(deg, torch.from_numpy(sh), torch.from_numpy(d)).numpy(),
        np.asarray(jsh.sh_to_rgb(deg, jnp.asarray(sh), jnp.asarray(d))),
        atol=1e-6, rtol=0)
    rgb = rng.uniform(0, 1, (10, 3)).astype(np.float32)
    np.testing.assert_array_equal(tsh.rgb_to_sh_dc(rgb),
                                  np.asarray(jsh.rgb_to_sh_dc(rgb)))


@pytest.mark.parametrize("seed", [0, 1])
def test_gaussian_activations_covariance_normals(seed):
    g = random_pose_scene(seed, sh_degree=2)
    tg = port_gaussians(g)
    center = np.array([0.3, -0.2, -4.0], np.float32)
    pairs = {
        "scaling": (g.get_scaling, tg.get_scaling),
        "rotation": (g.get_rotation, tg.get_rotation),
        "opacity": (g.get_opacity, tg.get_opacity),
        "albedo": (g.get_albedo, tg.get_albedo),
        "roughness": (g.get_roughness, tg.get_roughness),
        "metallic": (g.get_metallic, tg.get_metallic),
        "features": (g.get_features, tg.get_features),
        "covariance": (g.get_covariance(1.5), tg.get_covariance(1.5)),
        "normals": (g.get_normals(jnp.asarray(center)),
                    tg.get_normals(torch.from_numpy(center))),
    }
    # atol 1e-6 plus 1e-6 relative: covariance entries reach ~5, where a
    # float32 ulp is 4.8e-7 and XLA and torch may differ by a few.
    for name, (a, b) in pairs.items():
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6,
                                   rtol=1e-6, err_msg=name)
    assert tg.capacity == g.capacity and tg.num_alive == int(g.num_alive)


def test_from_numpy_and_from_raw_carry_over():
    g = random_pose_scene(3, n=40, capacity=40)
    tg = port_gaussians(g)
    for k, v in g.params_dict().items():
        np.testing.assert_array_equal(tg.params_dict()[k].numpy(), np.asarray(v))
    np.testing.assert_array_equal(tg.alive.numpy(), np.asarray(g.alive))
    # from_raw pads to a larger capacity exactly as the JAX package does.
    raw = {k: np.asarray(v) for k, v in g.params_dict().items()}
    jg = JGaussians.from_raw(raw, 1, capacity=64)
    tg2 = TGaussians.from_raw(raw, 1, capacity=64, device="cpu")
    for k, v in jg.params_dict().items():
        np.testing.assert_array_equal(tg2.params_dict()[k].numpy(),
                                      np.asarray(v), err_msg=k)
    np.testing.assert_array_equal(tg2.alive.numpy(), np.asarray(jg.alive))


@pytest.mark.parametrize("ctor", ["from_numpy", "from_raw", "camera", "scene"])
def test_constructors_default_to_cuda_and_raise_without_it(monkeypatch, ctor):
    """With no device named, the port's constructors resolve to the CUDA
    card; with none present they raise instead of carrying on on the CPU."""
    from gs2m_tpu_torch.core.config import ModelConfig
    from gs2m_tpu_torch.data.scene import Scene

    g = random_pose_scene(4, n=8, capacity=8)
    params = {k: np.asarray(v) for k, v in g.params_dict().items()}
    build = {
        "from_numpy": lambda: TGaussians.from_numpy(params, np.asarray(g.alive),
                                                    1),
        "from_raw": lambda: TGaussians.from_raw(params, 1),
        "camera": lambda: TCamera.create(np.eye(3), np.zeros(3), 0.9, 0.9,
                                         16, 16),
        "scene": lambda: Scene(ModelConfig(source_path="unread")),
    }[ctor]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build()
