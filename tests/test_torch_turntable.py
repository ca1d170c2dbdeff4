"""The port's turntable (apps/vis_turntable.py) against scripts/
vis_turntable.py: `_rotmat_to_quat` and `mesh_to_surfels` equal, frame 0 of
the mesh mode and of the model mode (render map) against the script's
render_jit(..., backend="xla") on the same camera within the render
tests' tolerance (atol 1e-5, rtol 1e-4), and the app end to end writing
an animated WebP with each frame's binning overflow.
"""
import dataclasses
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))

import vis_turntable as jax_vis  # noqa: E402

from gs2m_tpu_torch.apps import vis_turntable as vis  # noqa: E402
from gs2m_tpu_torch.data.ply import save_gaussian_ply, store_mesh  # noqa: E402

SIZE = 64


def random_rotations(n: int, seed: int = 0) -> np.ndarray:
    q = np.random.default_rng(seed).normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    r, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], -1),
        np.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], -1),
        np.stack([2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], -1),
    ], 1)


def test_rotmat_to_quat_equal():
    R = random_rotations(500)
    t = np.trace(R, axis1=1, axis2=2)
    assert (t <= 0).sum() > 50 and (t > 0).sum() > 50
    np.testing.assert_array_equal(vis._rotmat_to_quat(R),
                                  jax_vis._rotmat_to_quat(R))


def dome_mesh(path: Path, n: int = 24):
    """A closed-ish bumpy dome (a height field over a disc) as a PLY mesh."""
    u, v = np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n),
                       indexing="ij")
    h = 0.6 * np.exp(-2 * (u * u + v * v)) + 0.05 * np.sin(5 * u)
    verts = np.stack([u, -h, v], -1).reshape(-1, 3).astype(np.float32)
    idx = np.arange(n * n).reshape(n, n)
    a, b = idx[:-1, :-1].ravel(), idx[1:, :-1].ravel()
    c, d = idx[:-1, 1:].ravel(), idx[1:, 1:].ravel()
    faces = np.concatenate([np.stack([a, b, c], -1), np.stack([b, d, c], -1)])
    store_mesh(str(path), verts, faces)


def test_mesh_to_surfels_equal(tmp_path):
    dome_mesh(tmp_path / "mesh.ply")
    for a, b in zip(vis.mesh_to_surfels(str(tmp_path / "mesh.ply")),
                    jax_vis.mesh_to_surfels(str(tmp_path / "mesh.ply"))):
        np.testing.assert_array_equal(a, b)


def jax_camera(i, frames, center, dist, elevation=0.35):
    """The script's orbit camera for frame i."""
    from gs2m_tpu.core.camera import Camera
    from tests.make_synthetic_scene import ring_camera

    R, T = ring_camera(2 * np.pi * i / frames, dist=dist,
                       height=elevation * dist)
    T = T - (R.T @ center)
    return Camera.create(R, T, fovx=0.8, fovy=0.8, width=SIZE, height=SIZE)


def test_mesh_frame_matches_script(tmp_path):
    from gs2m_tpu.core.gaussians import Gaussians, inverse_sigmoid
    from gs2m_tpu.core.sh import C0
    from gs2m_tpu.models.render import render_jit

    dome_mesh(tmp_path / "mesh.ply")
    centers, quats, log_scales, normals = vis.mesh_to_surfels(
        str(tmp_path / "mesh.ply"))
    center, dist = vis.orbit_distance(centers, -1.0)
    cam = vis.orbit_camera(0, 60, center, dist, 0.35, SIZE, "cpu")
    g = vis.surfel_gaussians(centers, quats, log_scales, "cpu")
    got, dropped = vis.mesh_frame(g, torch.as_tensor(centers),
                                  torch.as_tensor(normals), cam)

    F = len(centers)
    jg = Gaussians.create(centers, np.full((F, 3), 0.8, np.float32),
                          max_sh_degree=0, capacity=F)
    jg = dataclasses.replace(
        jg, rotation=jnp.asarray(quats), scaling=jnp.asarray(log_scales),
        opacity=jnp.full((F, 1), float(inverse_sigmoid(jnp.float32(0.97)))))
    jcam = jax_camera(0, 60, center, dist)
    view = np.asarray(jcam.cam_center) - centers
    view /= np.linalg.norm(view, axis=1, keepdims=True) + 1e-12
    lam = np.abs((normals * view).sum(1, keepdims=True))
    col = np.clip(vis.MESH_BASE_COLOR[None] * (0.25 + 0.75 * lam), 0, 1)
    dc = ((col - 0.5) / C0).astype(np.float32)
    jg = dataclasses.replace(jg, features_dc=jnp.asarray(dc[:, None, :]))
    pkg = render_jit(jg, jcam, jnp.ones(3), 0, backend="xla", chunk=256,
                     instance_cap=2 ** 21)
    want = np.clip(np.asarray(pkg["render"]).transpose(1, 2, 0), 0, 1)
    assert dropped == int(pkg["dropped"]) == 0
    assert want.std() > 0.05
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


def gaussian_snapshot(model: Path, n: int = 400, seed: int = 1):
    rng = np.random.default_rng(seed)
    snap = model / "point_cloud" / "iteration_7"
    snap.mkdir(parents=True)
    save_gaussian_ply(
        str(snap / "point_cloud.ply"),
        rng.normal(size=(n, 3)).astype(np.float32) * 0.5,
        rng.normal(size=(n, 1, 3)).astype(np.float32),
        0.1 * rng.normal(size=(n, 15, 3)).astype(np.float32),
        rng.normal(size=(n, 1)).astype(np.float32),
        np.log(rng.uniform(0.03, 0.1, (n, 3))).astype(np.float32),
        rng.normal(size=(n, 4)).astype(np.float32),
        rng.normal(size=(n, 3)).astype(np.float32),
        rng.normal(size=(n, 1)).astype(np.float32),
        rng.normal(size=(n, 1)).astype(np.float32))
    return snap / "point_cloud.ply"


def test_model_frame_matches_script(tmp_path):
    from gs2m_tpu.core.gaussians import Gaussians
    from gs2m_tpu.data.ply import load_gaussian_ply
    from gs2m_tpu.models.render import render_jit

    from gs2m_tpu_torch.core.gaussians import Gaussians as TorchGaussians
    from gs2m_tpu_torch.data.ply import load_gaussian_ply as torch_load

    ply = gaussian_snapshot(tmp_path)
    raw = torch_load(str(ply))
    center, dist = vis.orbit_distance(raw["xyz"], -1.0)
    cam = vis.orbit_camera(0, 60, center, dist, 0.35, SIZE, "cpu")
    got, dropped = vis.model_frame(TorchGaussians.from_raw(raw, 3,
                                                           device="cpu"),
                                   cam, "render", 3)
    jg = Gaussians.from_raw(load_gaussian_ply(str(ply)), 3)
    pkg = render_jit(jg, jax_camera(0, 60, center, dist), jnp.zeros(3), 3,
                     backend="xla", chunk=256, instance_cap=2 ** 20)
    want = np.clip(np.asarray(pkg["render"]).transpose(1, 2, 0), 0, 1)
    assert dropped == int(pkg["dropped"]) == 0
    assert want.std() > 0.02
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("mode", ["mesh", "depth"])
def test_app_writes_animated_webp(tmp_path, mode):
    gaussian_snapshot(tmp_path)
    dome_mesh(tmp_path / "mesh.ply")
    out = tmp_path / "t.webp"
    argv = ["-m", str(tmp_path), "--frames", "3", "--size", "32", "--out",
            str(out), "--device", "cpu"]
    argv += ["--mesh", str(tmp_path / "mesh.ply")] if mode == "mesh" else [
        "--map", "depth"]
    res = vis.main(argv)
    assert res["dropped"] == [0, 0, 0] and len(res["ms_per_frame"]) == 3
    with Image.open(out) as im:
        assert im.format == "WEBP" and im.n_frames == 3
        assert im.size == (32, 32)
