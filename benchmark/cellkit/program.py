"""Driving the program under test: gs2m_tpu_torch's trainer, built on the
benchmark's inputs and stepped as apps/train.py's loop steps it.

Nothing here changes the program. The trainer is constructed on a tiny
point cloud and then handed the cell's state (the Gaussians at the cell's
capacity, their Adam moments, zeroed densification statistics, the light)
and the cell's instance cap, so every buffer size comes from the cell's
file. The timed loop calls Trainer.train_step and, every 100 iterations,
reads what the app's loop reads there (loss, leaf finiteness, the alive
count, the step metrics).
"""
from __future__ import annotations

import numpy as np
import torch

# Adam's b1: the first moment after one step from zero is (1 - b1) g.
ADAM_B1 = 0.9


def build(cfg: dict, scene, state, seed: int, device):
    """The program's Trainer at the cell's state."""
    from gs2m_tpu_torch.core.config import ModelConfig, OptimConfig, PipelineConfig
    from gs2m_tpu_torch.core.gaussians import Gaussians
    from gs2m_tpu_torch.data.readers import CameraInfo, SceneInfo
    from gs2m_tpu_torch.data.scene import Scene
    from gs2m_tpu_torch.train import densify as D
    from gs2m_tpu_torch.train.optim import AdamState
    from gs2m_tpu_torch.train.trainer import Trainer

    model = ModelConfig(**cfg["model"])
    opt = OptimConfig(**cfg["optim"])
    pipe = PipelineConfig(**cfg["pipeline"])
    infos = [CameraInfo(uid=i, R=R, T=T, fx=scene.fx, fy=scene.fy,
                        width=scene.width, height=scene.height,
                        image_name=f"view{i:03d}", image_path="")
             for i, (R, T) in enumerate(zip(scene.Rs, scene.Ts))]
    # The constructor's own point cloud is replaced by the cell's state.
    pts = np.random.default_rng(0).uniform(-1, 1, (64, 3)).astype(np.float32)
    info = SceneInfo(points=pts, colors=np.full_like(pts, 0.5),
                     normals=np.zeros_like(pts), train_cameras=infos,
                     test_cameras=[], translate=np.zeros(3), radius=scene.extent)
    sc = Scene(model, None, shuffle=False, load_images=False, scene_info=info,
               device=device)
    sc.training_setup(opt)
    sc.gt_images, sc.alpha_masks, sc.gray_images = scene.gt, scene.alpha, scene.gray
    pbr_fns = None
    if model.material:
        from gs2m_tpu_torch.pbr import make_pbr_fns
        pbr_fns = make_pbr_fns(base_res=cfg["light"]["base_res"], device=device)
    tr = Trainer(model, pipe, opt, sc, seed=seed, pbr_fns=pbr_fns)

    # The state's tensors become the program's (no copy is kept beside them).
    p = state.params
    tr.gaussians = Gaussians(
        xyz=p["xyz"], features_dc=p["f_dc"], features_rest=p["f_rest"],
        scaling=p["scaling"], rotation=p["rotation"], opacity=p["opacity"],
        albedo=p["albedo"], roughness=p["roughness"], metallic=p["metallic"],
        alive=state.alive, max_sh_degree=model.sh_degree)
    tr.opt_state = AdamState(
        mu={k: torch.zeros_like(v) for k, v in p.items()},
        nu={k: state.nu0[k].expand_as(v).clone() for k, v in p.items()},
        count=state.iteration)
    tr.stats = D.DensifyStats.zeros(cfg["state"]["capacity"], device)
    tr.iteration = state.iteration
    tr.active_sh_degree = model.sh_degree
    tr.instance_cap = int(cfg["instance_cap"])
    tr._steps.clear()
    if model.material:
        tr.light_state = state.light
        tr.light_opt_state = AdamState(
            mu={"light": torch.zeros_like(state.light)},
            nu={"light": state.light_nu0.expand_as(state.light).clone()},
            count=state.iteration)
    return tr


def leaves(tr) -> dict:
    out = dict(tr.gaussians.params_dict())
    if tr.light_state is not None:
        out["light"] = tr.light_state
    return out


def first_moments(tr) -> dict:
    out = dict(tr.opt_state.mu)
    if tr.light_opt_state is not None:
        out["light"] = tr.light_opt_state.mu["light"]
    return out


def grad_norms(mu: dict) -> dict:
    """The first step's gradient norms as the optimiser got them, from the
    first moments after one step from zero."""
    return {k: float(torch.linalg.vector_norm(v.double())) / (1 - ADAM_B1)
            for k, v in mu.items()}


def change_norms(now: dict, start: dict) -> dict:
    return {k: float(torch.linalg.vector_norm((now[k] - start[k]).double()))
            for k in now}


def caps(tr) -> tuple:
    return (tr.gaussians.capacity, tr.instance_cap, tr.expand_cap)


def app_checks(tr, metrics: dict) -> None:
    """What apps/train.py's loop reads every 100 iterations: the loss, each
    leaf's finiteness (up to the first that is not), the alive count and
    every step metric."""
    float(metrics["loss"])
    for leaf in tr.gaussians.params_dict().values():
        if not bool(torch.isfinite(leaf).all()):
            break
    tr.gaussians.num_alive
    for v in metrics.values():
        float(v)
