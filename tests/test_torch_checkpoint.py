"""Checkpoints of the port's trainer (train/trainer.py save_checkpoint /
load_checkpoint).

On the CPU a run resumed from a checkpoint repeats the uninterrupted run bit
for bit: parameters, alive mask, Adam moments and count, densification
statistics, instance cap and both random streams, through the geometry
stage, two densifications and an opacity reset after the checkpoint. A
newer version and a capacity that does not match the arrays are refused.
The layout keeps the JAX package's version-2 top-level keys.
"""
import pickle

import numpy as np
import pytest
import torch

from gs2m_tpu.core.config import ModelConfig as JModel
from gs2m_tpu.core.config import OptimConfig as JOpt
from gs2m_tpu.core.config import PipelineConfig as JPipe
from gs2m_tpu.data.scene import Scene as JScene
from gs2m_tpu.train.trainer import Trainer as JTrainer
from gs2m_tpu_torch.core.config import ModelConfig, OptimConfig, PipelineConfig
from gs2m_tpu_torch.data.scene import Scene
from gs2m_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

OPT = dict(multi_view_max_angle=179.0, multi_view_max_dist=100.0,
           nearby_cam_max_angle=179.0, nearby_cam_max_dist=100.0,
           multi_view_sample_num=300, geometry_from_iter=3,
           densify_from_iter=2, densification_interval=3,
           opacity_reset_interval=7)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    from tests.make_synthetic_scene import build
    return build(str(tmp_path_factory.mktemp("ckpt") / "scene"), n_views=5,
                 width=48, height=32, n_points=120)


def make_trainer(scene_dir, model_path):
    mc = ModelConfig(source_path=scene_dir, model_path=str(model_path),
                     resolution=1, sh_degree=1)
    opt = OptimConfig(**OPT)
    return Trainer(mc, PipelineConfig(chunk=64), opt,
                   Scene(mc, opt, device="cpu"), seed=3)


def state_of(tr):
    g = tr.gaussians
    out = {f"param/{k}": v for k, v in g.params_dict().items()}
    out["alive"] = g.alive
    for k in tr.opt_state.mu:
        out[f"mu/{k}"] = tr.opt_state.mu[k]
        out[f"nu/{k}"] = tr.opt_state.nu[k]
    for k in ("accum", "accum_abs", "denom", "max_radii2d"):
        out[f"stats/{k}"] = getattr(tr.stats, k)
    out["generator"] = tr.generator.get_state()
    out["loss"] = tr.last_metrics["loss"]
    return out


def test_resume_repeats_the_uninterrupted_run(scene_dir, tmp_path):
    a = make_trainer(scene_dir, tmp_path / "a")
    for _ in range(4):
        a.train_step()
    ckpt = str(tmp_path / "ckp4.pkl")
    a.save_checkpoint(ckpt)
    for _ in range(6):
        a.train_step()

    b = make_trainer(scene_dir, tmp_path / "b")
    b.load_checkpoint(ckpt)
    assert b.iteration == 4
    for _ in range(6):
        b.train_step()
    assert a.last_densify_info is not None and a.mv_active_count > 0
    sa, sb = state_of(a), state_of(b)
    for k, v in sa.items():
        assert torch.equal(v, sb[k]), k
    assert a.opt_state.count == b.opt_state.count == 10
    assert (a.iteration, a.instance_cap, a.active_sh_degree,
            a.mv_active_count) == (b.iteration, b.instance_cap,
                                   b.active_sh_degree, b.mv_active_count)
    assert a.rng.bit_generator.state == b.rng.bit_generator.state
    assert a._view_pool == b._view_pool


def test_checkpoint_with_split_cap_keys_resumes(scene_dir, tmp_path):
    """A checkpoint written under the termination cut (with expand_cap and
    the split caps' two windows) still resumes: those keys are ignored and
    the run repeats the uninterrupted one. The port writes expand_cap as
    None and no windows."""
    a = make_trainer(scene_dir, tmp_path / "a")
    for _ in range(4):
        a.train_step()
    ckpt = tmp_path / "ckp4.pkl"
    a.save_checkpoint(str(ckpt))
    state = pickle.loads(ckpt.read_bytes())
    assert state["expand_cap"] is None
    assert "aligned_window" not in state and "expand_drop_window" not in state
    state.update(expand_cap=a.instance_cap + 2 ** 17, aligned_window=1234,
                 expand_drop_window=56)
    ckpt.write_bytes(pickle.dumps(state))
    for _ in range(6):
        a.train_step()

    b = make_trainer(scene_dir, tmp_path / "b")
    b.load_checkpoint(str(ckpt))
    assert (b.iteration, b.expand_cap) == (4, None)
    for _ in range(6):
        b.train_step()
    sa, sb = state_of(a), state_of(b)
    for k, v in sa.items():
        assert torch.equal(v, sb[k]), k
    assert (a.instance_cap, a.expand_cap) == (b.instance_cap, b.expand_cap)
    assert torch.equal(a._dropped_window, b._dropped_window)


@pytest.mark.parametrize("field,value,match", [("version", 3, "version 3"),
                                               ("capacity", 7, "capacity 7")])
def test_bad_checkpoints_are_refused(scene_dir, tmp_path, field, value, match):
    tr = make_trainer(scene_dir, tmp_path / "m")
    ckpt = tmp_path / "ckp.pkl"
    tr.save_checkpoint(str(ckpt))
    state = pickle.loads(ckpt.read_bytes())
    state[field] = value
    ckpt.write_bytes(pickle.dumps(state))
    with pytest.raises(ValueError, match=match):
        make_trainer(scene_dir, tmp_path / "m").load_checkpoint(str(ckpt))


def test_layout_keeps_the_jax_top_level_keys(scene_dir, tmp_path):
    mk = lambda M, sub: M(source_path=scene_dir, model_path=str(tmp_path / sub),
                          resolution=1, sh_degree=1)
    jt = JTrainer(mk(JModel, "j"), JPipe(chunk=64, use_pallas=False),
                  JOpt(**OPT), JScene(mk(JModel, "j"), JOpt(**OPT)))
    jt.save_checkpoint(str(tmp_path / "j.pkl"))
    tr = make_trainer(scene_dir, tmp_path / "t")
    tr.save_checkpoint(str(tmp_path / "t.pkl"))
    js = pickle.loads((tmp_path / "j.pkl").read_bytes())
    ts = pickle.loads((tmp_path / "t.pkl").read_bytes())
    assert set(js) <= set(ts)
    for k in ("version", "iteration", "active_sh_degree", "capacity",
              "instance_cap", "mv_active_count"):
        assert ts[k] == int(js[k]), k
    for k, v in ts["gaussians"].items():
        np.testing.assert_array_equal(v, np.asarray(getattr(js["gaussians"], k)),
                                      err_msg=k)
