"""Two data-parallel ranks of the port on the CPU (gloo), driven by the
trainer and by the train app (tests/test_torch_dp2.py's workers):
- a trainer-driven run across two densifications: the two ranks' replicas
  bit-equal, and the --distributed run (each rank loaded only its closure
  of images; the other rows are zeros) bit-equal to the --data_parallel run
  with every image, on the same global batches;
- the train app under two ranks with --data_parallel --distributed, joined
  from torchrun's environment.
"""
import json
import os
import sys

import numpy as np
import pytest

from tests.test_torch_dp2 import (OPT_KW, ROOT, build_scene, free_port,
                                  run_workers, spawn)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return build_scene(tmp_path_factory.mktemp("dp2_trainer"))


def test_trainer_distributed_equals_data_parallel(scene_dir, tmp_path):
    from gs2m_tpu_torch.core.config import ModelConfig, OptimConfig
    from gs2m_tpu_torch.data.scene import Scene
    from gs2m_tpu_torch.parallel.dp import host_view_closure, partition_views
    from gs2m_tpu_torch.train.trainer import choose_neighbor

    opt_kw = dict(OPT_KW, geometry_from_iter=2, densify_from_iter=2,
                  densification_interval=3, opacity_reset_interval=10_000)
    scene = Scene(ModelConfig(source_path=scene_dir, resolution=1,
                              sh_degree=1), OptimConfig(**opt_kw),
                  load_images=False, device="cpu")
    V = len(scene.train_cameras)
    rng = np.random.default_rng(5)
    parts = [partition_views(V, r, 2) for r in (0, 1)]
    sched = []
    for t in range(6):
        row = []
        for r in (0, 1):
            v = int(parts[r][t % len(parts[r])])
            nb, has = choose_neighbor(rng, scene.nearest_table[v],
                                      scene.nearest_mask[v], v)
            row.append([v, nb, has, 0, False])
        sched.append(row)
    closures = [host_view_closure(p, scene.nearest_table, scene.nearest_mask,
                                  scene.nearby_table, scene.nearby_mask)
                for p in parts]
    assert all(len(c) < V for c in closures)

    spec = {"scene_dir": scene_dir, "opt_kw": opt_kw, "schedule": sched}
    run_workers("trainer", spec, tmp_path)
    runs = {(m, r): dict(np.load(tmp_path / f"trainer_{m}_rank{r}.npz"))
            for m in ("data_parallel", "distributed") for r in (0, 1)}
    infos = json.loads((tmp_path / "trainer_distributed_rank0.json")
                       .read_text())["densify"]
    assert infos[2] is not None and infos[5] is not None
    assert infos[2]["cloned"] + infos[2]["split"] > 0
    for r in (0, 1):
        dist_run = runs["distributed", r]
        np.testing.assert_array_equal(dist_run["loaded"], closures[r])
        assert dist_run["gt_row_zero"].sum() == V - len(closures[r])
        assert not runs["data_parallel", r]["gt_row_zero"].any()
    ref = runs["data_parallel", 0]
    assert np.isfinite(ref["losses"]).all() and int(ref["mv_active"]) > 0
    state_keys = [k for k in ref if k.split("/")[0] in
                  ("param", "mu", "nu", "stats")] + ["alive", "losses",
                                                     "mv_active"]
    for key, run in runs.items():
        for k in state_keys:
            np.testing.assert_array_equal(run[k], ref[k], err_msg=f"{key} {k}")


def test_train_app_two_ranks_distributed(scene_dir, tmp_path):
    """`torchrun --nproc_per_node 2 -m gs2m_tpu_torch.apps.train ...
    --data_parallel --distributed`, with torchrun's environment set by
    hand: both ranks run to the end, rank 0 alone evaluates and writes, and
    the checkpoint carries both ranks' own state."""
    import pickle

    port = free_port()
    model = tmp_path / "model"
    argv = [sys.executable, "-m", "gs2m_tpu_torch.apps.train", "-s",
            scene_dir, "-m", str(model), "--device", "cpu", "--chunk", "64",
            "--sh_degree", "1", "--iterations", "4", "--geometry_from_iter",
            "2", "--densify_from_iter", "1", "--densification_interval", "3",
            "--test_iterations", "4", "--save_iterations", "4",
            "--checkpoint_iterations", "3", "--data_parallel",
            "--distributed"]
    for k, v in OPT_KW.items():
        argv += [f"--{k}", str(v)]

    def env_of(r):
        return dict(os.environ, WORLD_SIZE="2", RANK=str(r),
                    LOCAL_RANK=str(r), LOCAL_WORLD_SIZE="2",
                    MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                    PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")

    texts = spawn(lambda r: argv, tmp_path, env_of)
    assert "Data-parallel over 2 ranks" in texts[0]
    for r in (0, 1):
        assert f"rank {r} of 2: backend gloo, device cpu" in texts[r]
        assert f"rank {r} of 2: 4 local views, 7 images loaded" in texts[r]
    assert "[ITER      4] train PSNR" in texts[0]
    assert "PSNR" not in texts[1]
    assert (model / "point_cloud" / "iteration_4" / "point_cloud.ply").exists()
    state = pickle.loads((model / "checkpoints" / "ckp3.pkl").read_bytes())
    assert state["iteration"] == 3 and len(state["ranks"]) == 2
    # Each rank draws from its own partition (even views, odd views).
    for r in (0, 1):
        (left,) = state["ranks"][r]["view_pool"]
        assert left % 2 == r
