"""One rank of a two-rank data-parallel run of the port on the CPU (gloo),
spawned by tests/test_torch_dp2.py. Imports no JAX.

    python tests/torch_dp_worker.py <mode> <rank> <port> <spec.json> <out_dir>

mode "steps": one data-parallel step per case of the spec (a given view,
nearest and nearby view per rank), written with the step's reduced
gradients; mode "trainer": the Trainer over the spec's schedule, once with
every image (--data_parallel) and once with only the rank's closure of
images (--distributed), written after each run.
"""
import datetime
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from gs2m_tpu_torch.core.config import (ModelConfig, OptimConfig,  # noqa: E402
                                        PipelineConfig)
from gs2m_tpu_torch.core.gaussians import Gaussians  # noqa: E402
from gs2m_tpu_torch.train import densify as D  # noqa: E402
from gs2m_tpu_torch.train.optim import adam_init  # noqa: E402

torch.set_num_threads(1)


def fixed_draws(n_pixels: int):
    """The pixel draws of tests/test_torch_material_train.py::_fixed_draws:
    a seeded top-k, the invalid pixels below every valid one."""
    from gs2m_tpu_torch.models import losses as L
    u = np.random.default_rng(99).permutation(n_pixels).astype(np.float32)
    u = (u + 1.0) / (n_pixels + 1.0)

    def draw(generator, valid, k):
        s = torch.from_numpy(u).to(valid.device)
        return torch.topk(torch.where(valid, s, -s), k).indices

    L.sample_valid_indices = draw


def state_arrays(gaussians, opt_state, stats) -> dict:
    out = {f"param/{k}": v.detach().numpy()
           for k, v in gaussians.params_dict().items()}
    out["alive"] = gaussians.alive.numpy()
    for k in opt_state.mu:
        out[f"mu/{k}"] = opt_state.mu[k].numpy()
        out[f"nu/{k}"] = opt_state.nu[k].numpy()
    for k in ("accum", "accum_abs", "denom", "max_radii2d"):
        out[f"stats/{k}"] = getattr(stats, k).numpy()
    return out


def run_steps(rank: int, spec: dict, out: Path):
    from gs2m_tpu_torch.data.scene import Scene
    from gs2m_tpu_torch.parallel.dp import make_reducer
    from gs2m_tpu_torch.pbr.render import make_pbr_fns
    from gs2m_tpu_torch.train.trainer import make_train_step

    opt = OptimConfig(**spec["opt_kw"])
    scene = Scene(ModelConfig(source_path=spec["scene_dir"], resolution=1,
                              sh_degree=1), opt, device="cpu")
    fixed_draws(scene.gray_images.shape[-1] * scene.gray_images.shape[-2])
    g0 = np.load(spec["gaussians"])
    light0 = np.load(spec["light"])
    for name, case in spec["cases"].items():
        g = Gaussians.from_numpy({k: g0[k] for k in g0.files if k != "alive"},
                                 g0["alive"], 1, device="cpu")
        material = case["material"]
        pbr_fns = (make_pbr_fns(base_res=16, light=light0, device="cpu")
                   if material else None)
        reducer = make_reducer()
        kept = {}

        def reduce(grads, light_grad, contrib, metrics):
            out_ = reducer(grads, light_grad, contrib, metrics)
            kept["grads"], kept["light"] = out_[0], out_[1]
            return out_

        step = make_train_step(ModelConfig(sh_degree=1, material=material),
                               PipelineConfig(chunk=64), opt, scene, 2 ** 13,
                               case["geometry"], material, pbr_fns,
                               reduce=reduce)
        state = adam_init(g.params_dict())
        light = pbr_fns["init_light"]() if material else None
        light_state = pbr_fns["init_light_opt"](light) if material else None
        g, state, stats, m = step(
            g, state, D.DensifyStats.zeros(g.capacity, "cpu"),
            case["views"][rank], case["nearest"][rank], case["has"][rank], 1,
            1, torch.Generator().manual_seed(0), light=light,
            light_opt_state=light_state, nearby_idx=case["nearby"][rank],
            has_nearby=case["has_nearby"][rank])
        arrays = state_arrays(g, state, stats)
        arrays.update({f"grad/{k}": v.numpy()
                       for k, v in kept["grads"].items()})
        if material:
            arrays["light_grad"] = kept["light"].numpy()
        arrays.update({f"metric/{k}": np.asarray(v) for k, v in m.items()})
        np.savez(out / f"steps_{name}_rank{rank}.npz", **arrays)


def run_trainer(rank: int, spec: dict, out: Path):
    from gs2m_tpu_torch.apps.train import load_scene
    from gs2m_tpu_torch.parallel.dp import Process
    from gs2m_tpu_torch.train.trainer import Trainer

    opt = OptimConfig(**spec["opt_kw"])
    mc = ModelConfig(source_path=spec["scene_dir"], resolution=1, sh_degree=1)
    proc = Process(rank, 2, torch.device("cpu"), "gloo", False)
    sched = spec["schedule"]
    for mode in ("data_parallel", "distributed"):
        scene = load_scene(mc, opt, "cpu", proc, mode == "distributed")
        tr = Trainer(mc, PipelineConfig(chunk=64), opt, scene, seed=0,
                     data_parallel=True, distributed=mode == "distributed")
        tr.draw_batch = lambda material: tuple(
            sched[tr.iteration - 1][rank])
        losses, infos = [], []
        for _ in range(len(sched)):
            losses.append(float(tr.train_step()["loss"]))
            infos.append(tr.last_densify_info)
        arrays = state_arrays(tr.gaussians, tr.opt_state, tr.stats)
        arrays["losses"] = np.array(losses)
        arrays["loaded"] = np.array(sorted(scene.loaded_views or []))
        arrays["gt_row_zero"] = np.array([
            not bool(scene.gt_images[v].any())
            for v in range(len(scene.train_cameras))])
        arrays["mv_active"] = np.array(tr.mv_active_count)
        np.savez(out / f"trainer_{mode}_rank{rank}.npz", **arrays)
        with open(out / f"trainer_{mode}_rank{rank}.json", "w") as f:
            json.dump({"densify": infos}, f)


def main():
    mode, rank, port, spec_path, out = sys.argv[1:6]
    rank = int(rank)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=120))
    try:
        spec = json.loads(Path(spec_path).read_text())
        {"steps": run_steps, "trainer": run_trainer}[mode](
            rank, spec, Path(out))
    finally:
        dist.destroy_process_group()
    print(f"RANK{rank} OK", flush=True)


if __name__ == "__main__":
    main()
