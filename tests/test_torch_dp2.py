"""Two data-parallel ranks of the port on the CPU (gloo), against the JAX
package's make_dp_train_step on a 2-device CPU mesh and against one
process.

Each run spawns two tests/torch_dp_worker.py ranks (a free localhost port,
a timeout on the group and on every wait, logs in files). Checked:
- one DP step in warmup, in geometry (lambda_multi_view = 0; each rank's
  nearest view drawn as the JAX step draws it, from split(keys[d], 3)[0])
  and in the material stage (the pixel draws made the same seeded top-k in
  both packages, as tests/test_torch_material_train.py does): the loss at
  rtol 1e-5, Adam's first moments and the light's reduced gradient at the
  distributional gate of utils/grad_gate, denom and max radii equal
  (tests/test_torch_train.py's tolerances);
- the reduced gradients bit-equal to the one-process mean of the two
  views' gradients, and both ranks' states bit-equal.
The material stage's case is tests/test_torch_dp2_material.py's, the
trainer's and the train app's runs tests/test_torch_dp2_trainer.py's.
"""
import json
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "torch_dp_worker.py"
TIMEOUT = 240
# Each view's neighbors are the views two ring steps away (4 to 6 units, 90
# degrees), so a rank's closure of images misses one of the eight views.
OPT_KW = dict(multi_view_min_dist=4.0, multi_view_max_dist=6.0,
              multi_view_max_angle=100.0, nearby_cam_min_dist=4.0,
              nearby_cam_max_dist=6.0, nearby_cam_max_angle=100.0,
              multi_view_sample_num=300)

torch.set_num_threads(1)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(argv_of, out: Path, env_of=None):
    """Run two ranks to their end; returns their logs. Logs go to files:
    a pipe left unread could block a rank inside a collective."""
    logs = [open(out / f"rank{r}.log", "w+") for r in (0, 1)]
    procs = [subprocess.Popen(argv_of(r), cwd=ROOT, stdout=logs[r],
                              stderr=subprocess.STDOUT, text=True,
                              env=None if env_of is None else env_of(r))
             for r in (0, 1)]
    try:
        for p in procs:
            p.wait(timeout=TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for f in logs:
        f.seek(0)
        texts.append(f.read())
        f.close()
    for r, (p, text) in enumerate(zip(procs, texts)):
        assert p.returncode == 0, f"rank {r} failed:\n{text[-4000:]}"
    return texts


def build_scene(root: Path) -> str:
    """Eight views on a ring around a textured sphere (well-conditioned NCC
    patches for the material stage's roughness term)."""
    from tests.make_synthetic_scene import build
    return build(str(root / "scene"), n_views=8, width=48, height=32,
                 n_points=200, surface=True, texture="noise")


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return build_scene(tmp_path_factory.mktemp("dp2"))


def run_workers(mode: str, spec: dict, out: Path):
    out.mkdir(parents=True, exist_ok=True)
    spec_path = out / "spec.json"
    spec_path.write_text(json.dumps(spec))
    port = free_port()
    texts = spawn(lambda r: [sys.executable, str(WORKER), mode, str(r),
                             str(port), str(spec_path), str(out)], out)
    for r, text in enumerate(texts):
        assert f"RANK{r} OK" in text


# --- one step against JAX --------------------------------------------------

# name: (geometry stage, material stage, the two ranks' views, key seed)
CASES = {"warmup": (False, False, [1, 6], 3),
         "geometry": (True, False, [0, 5], 9),
         "material": (True, True, [2, 7], 11)}


def dp_step_runs(scene_dir: str, out: Path, names):
    """The JAX package's DP steps of the cases `names` and the port's two
    ranks on the same Gaussians, views, neighbors and light."""
    import jax
    import jax.numpy as jnp

    from gs2m_tpu.core.config import ModelConfig as JModel
    from gs2m_tpu.core.config import OptimConfig as JOpt
    from gs2m_tpu.core.config import PipelineConfig as JPipe
    from gs2m_tpu.core.gaussians import Gaussians as JGaussians
    from gs2m_tpu.data.scene import Scene as JScene
    from gs2m_tpu.models import losses as JL
    from gs2m_tpu.parallel.dp import make_dp_train_step
    from gs2m_tpu.pbr import render as JR
    from gs2m_tpu.train import densify as JD
    from gs2m_tpu.train import optim as JO
    from gs2m_tpu.train import trainer as JT
    from jax.sharding import Mesh

    opt_kw = dict(OPT_KW, lambda_multi_view=0.0, lambda_smooth=0.5,
                  lambda_normal=0.5, reflection_threshold=0.2,
                  lambda_rough=2.0, nearby_cam_min_angle=10.0)
    jopt = JOpt(**opt_kw)
    js = JScene(JModel(source_path=scene_dir, model_path=str(out / "j"),
                       resolution=1, sh_degree=1), jopt)
    g = JGaussians.create(js.info.points, js.info.colors, 1, capacity=256)
    rng = np.random.default_rng(12)
    n = int(np.asarray(g.alive).sum())
    p = {k: np.array(v) for k, v in g.params_dict().items()}
    p["opacity"] = p["opacity"] + 2.0
    # Anisotropic scales: an isotropic Gaussian's rotation moves nothing,
    # and its gradient would be round-off.
    for k, s in (("rotation", 0.5), ("scaling", 0.3), ("albedo", 1.0),
                 ("roughness", 1.0), ("metallic", 1.0)):
        p[k][:n] += s * rng.normal(size=p[k][:n].shape).astype(np.float32)
    g = g.with_params({k: jnp.asarray(v) for k, v in p.items()})
    np.savez(out / "gaussians.npz", alive=np.asarray(g.alive), **p)
    jfns = JR.make_pbr_fns(base_res=16)
    light0 = np.asarray(jfns["init_light"]())
    np.save(out / "light.npy", light0)

    # The JAX package's pixel draws, made the worker's seeded top-k.
    n_pix = int(np.prod(js.gray_images.shape[-2:]))
    u = np.random.default_rng(99).permutation(n_pix).astype(np.float32)
    u = (u + 1.0) / (n_pix + 1.0)

    def jdraw(key, valid, k):
        _, idx = jax.lax.top_k(jnp.where(valid, u, -u), k)
        return idx, valid[idx]

    saved = JL._sample_valid_indices
    JL._sample_valid_indices = jdraw
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    cases, jax_out = {}, {}
    try:
        for name in names:
            geometry, material, views, seed = CASES[name]
            keys = jax.random.split(jax.random.PRNGKey(seed), 2)
            case = {"geometry": geometry, "material": material,
                    "views": views, "nearest": [], "has": [], "nearby": [],
                    "has_nearby": []}
            for d, v in enumerate(views):
                k_nb, _, k_rough = jax.random.split(keys[d], 3)
                nb, has = JT._choose_neighbor(k_nb, js.nearest_table[v],
                                              js.nearest_mask[v], v)
                nby, has_nby = JT._choose_neighbor(
                    jax.random.split(k_rough)[0], js.nearby_table[v],
                    js.nearby_mask[v], 0)
                case["nearest"].append(int(nb))
                case["has"].append(bool(has))
                case["nearby"].append(int(nby))
                case["has_nearby"].append(bool(has_nby))
            assert all(case["has"]) and all(case["has_nearby"])
            cases[name] = case
            step = make_dp_train_step(
                JModel(sh_degree=1, material=material), JPipe(chunk=64), jopt,
                js, 2 ** 13, geometry, material, mesh, backend="xla",
                pbr_fns=jfns if material else None)
            jg, jstate, jstats, jlg, jm = step(
                g, JO.adam_init(g.params_dict()), JD.DensifyStats.zeros(256),
                js.gt_images, js.alpha_masks, js.gray_images,
                jnp.asarray(light0) if material else jnp.zeros((1,)),
                jnp.asarray(views, jnp.int32), keys, jnp.int32(1), 1)
            jax_out[name] = {"state": jstate, "stats": jstats,
                             "light_grad": np.asarray(jlg),
                             "metrics": {k: float(v) for k, v in jm.items()}}
    finally:
        JL._sample_valid_indices = saved

    spec = {"scene_dir": scene_dir, "opt_kw": opt_kw, "cases": cases,
            "gaussians": str(out / "gaussians.npz"),
            "light": str(out / "light.npy")}
    run_workers("steps", spec, out)
    ranks = {name: [dict(np.load(out / f"steps_{name}_rank{r}.npz"))
                    for r in (0, 1)] for name in cases}
    return spec, jax_out, ranks


@pytest.fixture(scope="module")
def step_runs(scene_dir, tmp_path_factory):
    return dp_step_runs(scene_dir, tmp_path_factory.mktemp("steps"),
                        ("warmup", "geometry"))


@pytest.mark.parametrize("case", ["warmup", "geometry"])
def test_dp_step_matches_jax(step_runs, case):
    check_step_matches_jax(step_runs, case)


def test_dp_step_is_the_one_process_mean(step_runs):
    """Two ranks' reduced gradients equal, bit for bit, the mean of the two
    views' gradients computed one after the other in this process."""
    check_one_process_mean(step_runs, "geometry")


def check_step_matches_jax(step_runs, case: str):
    from gs2m_tpu_torch.utils.grad_gate import (DEFAULT_TOL, TOLERANCES,
                                                grad_gate)

    _, jax_out, ranks = step_runs
    r0, r1 = ranks[case]
    assert r0.keys() == r1.keys()
    for k in r0:                     # the replicas are the same bits
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    j = jax_out[case]
    m = j["metrics"]
    np.testing.assert_allclose(float(r0["metric/loss"]), m["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(r0["metric/Lrgb"]), m["Lrgb"], rtol=1e-5)
    if case != "warmup":
        np.testing.assert_allclose(float(r0["metric/Lgeo"]), m["Lgeo"],
                                   rtol=1e-4)
    if case == "material":
        assert m["Lmat"] != 0.0
        np.testing.assert_allclose(float(r0["metric/Lmat"]), m["Lmat"],
                                   rtol=1e-5)
        rep = grad_gate(r0["light_grad"], j["light_grad"])
        assert rep["pass"], ("light", rep)
    assert int(r0["metric/dropped"]) == int(m["dropped"]) == 0
    for k, jmu in j["state"].mu.items():
        rep = grad_gate(r0[f"mu/{k}"] / 0.1, np.asarray(jmu) / 0.1,
                        TOLERANCES.get(k, DEFAULT_TOL))
        assert rep["pass"], (k, rep)
    np.testing.assert_array_equal(r0["stats/denom"], np.asarray(j["stats"].denom))
    np.testing.assert_array_equal(r0["stats/max_radii2d"],
                                  np.asarray(j["stats"].max_radii2d))
    assert float(r0["stats/denom"].max()) == 2.0


def check_one_process_mean(step_runs, case: str):
    from gs2m_tpu_torch.core.config import ModelConfig, OptimConfig
    from gs2m_tpu_torch.core.config import PipelineConfig
    from gs2m_tpu_torch.core.gaussians import Gaussians
    from gs2m_tpu_torch.data.scene import Scene
    from gs2m_tpu_torch.models import losses as TL
    from gs2m_tpu_torch.pbr.render import make_pbr_fns
    from gs2m_tpu_torch.train import densify as D
    from gs2m_tpu_torch.train.optim import adam_init
    from gs2m_tpu_torch.train.trainer import make_train_step

    spec, _, ranks = step_runs
    c = spec["cases"][case]
    opt = OptimConfig(**spec["opt_kw"])
    scene = Scene(ModelConfig(source_path=spec["scene_dir"], resolution=1,
                              sh_degree=1), opt, device="cpu")
    n_pix = int(np.prod(scene.gray_images.shape[-2:]))
    u = np.random.default_rng(99).permutation(n_pix).astype(np.float32)
    u = torch.from_numpy((u + 1.0) / (n_pix + 1.0))
    saved = TL.sample_valid_indices
    TL.sample_valid_indices = lambda gen, valid, k: torch.topk(
        torch.where(valid, u, -u), k).indices
    g0 = np.load(spec["gaussians"])
    light0 = np.load(spec["light"])
    per_view = []
    try:
        for d in (0, 1):
            g = Gaussians.from_numpy({k: g0[k] for k in g0.files
                                      if k != "alive"}, g0["alive"], 1,
                                     device="cpu")
            fns = (make_pbr_fns(base_res=16, light=light0, device="cpu")
                   if c["material"] else None)
            kept = {}

            def keep(grads, light_grad, contrib, metrics):
                kept["grads"], kept["light"] = grads, light_grad
                return grads, light_grad, contrib, metrics

            step = make_train_step(
                ModelConfig(sh_degree=1, material=c["material"]),
                PipelineConfig(chunk=64), opt, scene, 2 ** 13, c["geometry"],
                c["material"], fns, reduce=keep)
            light = fns["init_light"]() if fns else None
            step(g, adam_init(g.params_dict()),
                 D.DensifyStats.zeros(g.capacity, "cpu"), c["views"][d],
                 c["nearest"][d], c["has"][d], 1, 1,
                 torch.Generator().manual_seed(0), light=light,
                 light_opt_state=fns["init_light_opt"](light) if fns else None,
                 nearby_idx=c["nearby"][d], has_nearby=c["has_nearby"][d])
            per_view.append(kept)
    finally:
        TL.sample_valid_indices = saved
    r0 = ranks[case][0]
    for k in per_view[0]["grads"]:
        mean = (per_view[0]["grads"][k] + per_view[1]["grads"][k]) / 2
        np.testing.assert_array_equal(r0[f"grad/{k}"], mean.numpy(),
                                      err_msg=k)
    if c["material"]:
        mean = (per_view[0]["light"] + per_view[1]["light"]) / 2
        np.testing.assert_array_equal(r0["light_grad"], mean.numpy())
