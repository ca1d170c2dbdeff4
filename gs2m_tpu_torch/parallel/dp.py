"""Data-parallel training over torch.distributed: one rank per replica.

Port of gs2m_tpu/parallel/dp.py. The JAX package shard_maps a D-device
mesh, one view per device; here each device's shard is a rank of a
torch.distributed group (PyTorch's own idiom: one process per card), and
the step is the single-view step of train/trainer.py with a reduction
between the backward and the update:

* parameter and light gradients: the SUM over the ranks, then / D (the
  JAX package's psum / n, so two ranks give the one-process mean of the
  same two views bit for bit);
* densification statistics: the SUM of each view's own NDC-norm x
  visibility contributions and of the visibility counts, the MAX of the
  observed radii (the norm is taken per view, before the reduction);
* metrics: loss, Lrgb, Lgeo and Lmat as means; dropped, mv_active and
  rough_active as sums.

Gaussians, Adam state, statistics and the light are replicated: Adam (and
the light's Adam) run on every rank on the same reduced values, so every
rank holds the same bits. One collective per step carries everything
that sums (the parameter and light gradients, the three summed statistics
and the metrics, flattened into one float32 buffer); a second one takes
the radii's max. Sums of counts are exact in float32 below 2^24.

Backends: gloo on the CPU; on CUDA, NCCL when each rank owns a card
(cuda:LOCAL_RANK) and gloo when ranks share one (NCCL refuses two ranks on
one device). Under gloo a CUDA buffer is staged through pinned host memory
explicitly (one copy each way per collective), so such a step syncs with
the host. Every group is created with a timeout, so a hung collective
fails instead of stalling.

`partition_views` and `host_view_closure` are the multi-process input
pipeline (the JAX package's multi-host one): each rank draws its views
from its own partition and loads only their closure of images.
"""
from __future__ import annotations

import datetime
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from gs2m_tpu_torch.core.config import ModelConfig, OptimConfig, PipelineConfig
from gs2m_tpu_torch.data.scene import Scene
from gs2m_tpu_torch.train.densify import DensifyStats
from gs2m_tpu_torch.train.trainer import make_train_step


def partition_views(n_views: int, process_index: int,
                    process_count: int) -> np.ndarray:
    """The views rank `process_index` of `process_count` trains on: strided
    (rank r gets r, r+P, r+2P, ...), balanced to within one view and spread
    over the whole camera ring rather than one arc."""
    assert 0 <= process_index < process_count
    return np.arange(process_index, n_views, process_count, dtype=np.int64)


def host_view_closure(local_views, nearest_table, nearest_mask,
                      nearby_table, nearby_mask) -> np.ndarray:
    """Every view whose images a rank must load: its own views and each
    valid neighbor they can sample (the multi-view loss reads the nearest
    neighbor's gray image, the roughness loss a nearby one)."""
    local_views = np.asarray(local_views)
    need = set(int(v) for v in local_views)
    for v in local_views:
        need.update(int(x) for x in np.asarray(nearest_table)[v][
            np.asarray(nearest_mask)[v]])
        need.update(int(x) for x in np.asarray(nearby_table)[v][
            np.asarray(nearby_mask)[v]])
    return np.array(sorted(need), dtype=np.int64)


class Process(NamedTuple):
    """This process's place in the data-parallel group."""
    rank: int
    world: int
    device: torch.device
    backend: str | None    # None: a world of one without a group
    created: bool          # join_process_group created the group


def rank_and_world(group=None) -> tuple[int, int]:
    """(rank, world size) in `group`; (0, 1) without an initialized group."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def join_process_group(device: str = "cuda",
                       timeout_s: float = 900.0) -> Process:
    """Join the default group from torchrun's environment (WORLD_SIZE,
    RANK, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR/PORT), or use the one
    already initialized. A launch without that environment is a world of
    one and creates no group. On CUDA, rank r works on card LOCAL_RANK
    modulo the local card count (made current); the backend is NCCL when
    every local rank owns a card, else gloo; on the CPU, gloo."""
    env = os.environ
    created = False
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        backend = dist.get_backend()
    elif int(env.get("WORLD_SIZE", "1")) == 1 and "MASTER_ADDR" not in env:
        rank, world, backend = 0, 1, None
    else:
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        backend = "gloo"
    local = int(env.get("LOCAL_RANK", rank))
    if str(device) == "cpu":
        dev = torch.device("cpu")
    else:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device is available; pass --device "
                               "cpu to train on the CPU")
        dev = torch.device("cuda", local % n)
        torch.cuda.set_device(dev)
        if backend == "gloo" and not dist.is_initialized():
            local_world = int(env.get("LOCAL_WORLD_SIZE", world))
            backend = "nccl" if local_world <= n else "gloo"
    if backend is not None and not dist.is_initialized():
        dist.init_process_group(
            backend, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        created = True
    return Process(rank, world, dev, backend, created)


_PINNED: dict = {}


def all_reduce_(buf: torch.Tensor, op=dist.ReduceOp.SUM, group=None):
    """In-place all-reduce of `buf` over `group`. A CUDA buffer under gloo
    goes through a pinned host buffer (kept per dtype, regrown as needed)."""
    if buf.is_cuda and dist.get_backend(group) == "gloo":
        host = _PINNED.get(buf.dtype)
        if host is None or host.numel() < buf.numel():
            host = torch.empty(buf.numel(), dtype=buf.dtype, pin_memory=True)
            _PINNED[buf.dtype] = host
        host = host[:buf.numel()]
        host.copy_(buf.reshape(-1))
        dist.all_reduce(host, op, group)
        buf.reshape(-1).copy_(host)
    else:
        dist.all_reduce(buf, op, group)
    return buf


_MEANS = ("loss", "Lrgb", "Lgeo", "Lmat")
_SUMS = ("dropped", "mv_active", "rough_active")


def make_reducer(group=None):
    """The step's reduction over `group` (see the module docstring), as
    make_train_step's `reduce`; None without an initialized group (a world
    of one: the sums and maxima of one view are that view's)."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    n = dist.get_world_size(group)

    def reduce(grads: dict, light_grad, contrib: DensifyStats, metrics: dict):
        leaves = (list(grads.values())
                  + ([] if light_grad is None else [light_grad])
                  + [contrib.accum, contrib.accum_abs, contrib.denom])
        loss = metrics["loss"]
        # The host-side counters go in as fills, not copies (no sync).
        scalars = torch.stack(
            [metrics[k].float() for k in _MEANS]
            + [metrics[k].float() if torch.is_tensor(metrics[k])
               else loss.new_full((), float(metrics[k])) for k in _SUMS])
        flat = torch.cat([x.reshape(-1) for x in leaves] + [scalars])
        all_reduce_(flat, dist.ReduceOp.SUM, group)
        radii = all_reduce_(contrib.max_radii2d.clone(), dist.ReduceOp.MAX,
                            group)
        parts = iter(torch.split(flat, [x.numel() for x in leaves]
                                 + [scalars.numel()]))
        grads = {k: next(parts).view_as(v) / n for k, v in grads.items()}
        if light_grad is not None:
            light_grad = next(parts).view_as(light_grad) / n
        contrib = DensifyStats(accum=next(parts), accum_abs=next(parts),
                               denom=next(parts), max_radii2d=radii)
        s = next(parts)
        metrics = {k: s[i] / n for i, k in enumerate(_MEANS)}
        metrics.update({k: s[len(_MEANS) + i].to(torch.int32)
                        for i, k in enumerate(_SUMS)})
        return grads, light_grad, contrib, metrics

    return reduce


def make_dp_train_step(model_cfg: ModelConfig, pipe: PipelineConfig,
                       opt: OptimConfig, scene: Scene, instance_cap: int,
                       geometry_stage: bool, material_stage: bool = False,
                       pbr_fns: dict | None = None, group=None):
    """The data-parallel step of one stage: train/trainer.py's step, called
    on every rank of `group` with that rank's view, its gradients,
    statistics and metrics reduced over the group before the update. The
    same signature and returns as make_train_step's step; metrics are the
    batch's (device tensors)."""
    return make_train_step(model_cfg, pipe, opt, scene, instance_cap,
                           geometry_stage, material_stage, pbr_fns,
                           reduce=make_reducer(group))
