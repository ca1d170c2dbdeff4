"""Adaptive densification on fixed-capacity buffers: clone + AbsGS split + prune.

Port of gs2m_tpu/train/densify.py with the same rules: clone when the mean
view-space grad >= densify_grad_threshold and the Gaussian is small (max
scale <= percent_dense * extent); AbsGS split (N=2) when the ABS grad >=
densify_grad_abs_threshold and it is large, children sampled from the
Gaussian itself with scales / 1.6; prune transparent (opacity < thr),
oversized world-space (> 0.1 * extent) and oversized view-space points;
accumulators reset afterwards.

Capacity stays fixed between growths: dead rows are a mask, children go
into free slots (searchsorted child -> source, stable argsort free-slot
order), and the Adam moments of touched rows are zeroed. Children that do
not fit are dropped and counted. The split noise comes from a
torch.Generator or is passed in (`noise`), since the JAX package's random
stream cannot be reproduced.
"""
from __future__ import annotations

import dataclasses

import torch

from gs2m_tpu_torch.core.gaussians import (Gaussians, inverse_sigmoid,
                                           quat_to_rotmat)
from gs2m_tpu_torch.train.optim import (AdamState, zero_state_param,
                                        zero_state_rows)


@dataclasses.dataclass
class DensifyStats:
    accum: torch.Tensor       # (C,) sum of |grad_ndc_mean2d| norms
    accum_abs: torch.Tensor   # (C,) sum of abs-grad norms (AbsGS channel)
    denom: torch.Tensor       # (C,) visible-step counts
    max_radii2d: torch.Tensor  # (C,) float32

    @staticmethod
    def zeros(capacity: int, device) -> "DensifyStats":
        def z():
            return torch.zeros(capacity, device=device)
        return DensifyStats(accum=z(), accum_abs=z(), denom=z(), max_radii2d=z())


@torch.no_grad()
def stats_contribution(sink_grad: torch.Tensor, abs_sink_grad: torch.Tensor,
                       visibility: torch.Tensor, radii: torch.Tensor,
                       observe: torch.Tensor, width: int,
                       height: int) -> DensifyStats:
    """One view's contribution to the statistics: the NDC-space (x 0.5*W,
    0.5*H) norms of the sink gradients (d/d pixel mean2d) and the
    visibility, and the radii of the observed, visible Gaussians. A
    data-parallel step reduces these over its views (sums; a max for the
    radii) before accumulate_stats, as the JAX package's DP step does."""
    def ndc_norm(x):
        return torch.sqrt((x[:, 0] * (0.5 * width)) ** 2
                          + (x[:, 1] * (0.5 * height)) ** 2)

    vis = visibility.float()
    radmask = ((observe > 0) & visibility).float()
    return DensifyStats(accum=ndc_norm(sink_grad) * vis,
                        accum_abs=ndc_norm(abs_sink_grad) * vis, denom=vis,
                        max_radii2d=radii.float() * radmask)


@torch.no_grad()
def accumulate_stats(stats: DensifyStats, step: DensifyStats) -> DensifyStats:
    """Add a step's (possibly reduced) contribution to the statistics."""
    return DensifyStats(
        accum=stats.accum + step.accum,
        accum_abs=stats.accum_abs + step.accum_abs,
        denom=stats.denom + step.denom,
        max_radii2d=torch.maximum(stats.max_radii2d, step.max_radii2d))


def update_stats(stats: DensifyStats, sink_grad: torch.Tensor,
                 abs_sink_grad: torch.Tensor, visibility: torch.Tensor,
                 radii: torch.Tensor, observe: torch.Tensor,
                 width: int, height: int) -> DensifyStats:
    """Per-step accumulation of one view (the single-view step)."""
    return accumulate_stats(stats, stats_contribution(
        sink_grad, abs_sink_grad, visibility, radii, observe, width, height))


@torch.no_grad()
def densify_and_prune(gaussians: Gaussians, opt_state: AdamState,
                      stats: DensifyStats, grad_threshold: float,
                      grad_abs_threshold: float, min_opacity: float,
                      extent: float, percent_dense: float,
                      radii2d_threshold: float,
                      use_radii_threshold: bool = False,
                      generator: torch.Generator | None = None,
                      noise: torch.Tensor | None = None):
    """One clone/split/prune pass. Returns (gaussians, opt_state, stats,
    info); `info` holds 0-d int tensors. `noise` (C, 3) replaces the
    standard-normal split offsets drawn from `generator`."""
    C = gaussians.capacity
    dev = gaussians.device
    alive = gaussians.alive

    denom = torch.clamp_min(stats.denom, 1e-12)
    grads = torch.where(stats.denom > 0, stats.accum / denom, 0.0)
    grads_abs = torch.where(stats.denom > 0, stats.accum_abs / denom, 0.0)

    scales = gaussians.get_scaling
    max_scale = torch.max(scales, dim=-1).values
    small = max_scale <= percent_dense * extent

    clone = alive & small & (grads >= grad_threshold)
    split = alive & ~small & (grads_abs >= grad_abs_threshold)

    prune = torch.sigmoid(gaussians.opacity[:, 0]) < min_opacity
    if use_radii_threshold:
        prune = (prune | (stats.max_radii2d > radii2d_threshold)
                 | (max_scale > 0.1 * extent))
    prune = prune & alive

    # --- free-slot allocation -------------------------------------------------
    alive_after = alive & ~split & ~prune
    free = ~alive_after
    # Free slots in index order, children in source order (deterministic).
    slot_order = torch.sort((~free).to(torch.int32), stable=True).indices
    num_free = torch.sum(free, dtype=torch.int32)

    k = clone.to(torch.int32) + 2 * split.to(torch.int32)
    offsets = torch.cumsum(k, 0, dtype=torch.int32) - k
    total_children = offsets[-1] + k[-1]
    n_fit = torch.minimum(total_children, num_free)
    dropped = total_children - n_fit

    child_ids = torch.arange(C, dtype=torch.int32, device=dev)
    src = torch.searchsorted(offsets, child_ids, right=True).to(torch.int32) - 1
    src = torch.clamp(src, 0, C - 1).long()
    valid_child = child_ids < n_fit
    target = slot_order                     # a permutation of the rows

    # --- child parameters -----------------------------------------------------
    is_split_child = split[src]
    if noise is None:
        noise = torch.randn(C, 3, generator=generator, device=dev)
    R = quat_to_rotmat(gaussians.get_rotation[src])
    offset = torch.einsum("nij,nj->ni", R, noise * scales[src])
    child_xyz = torch.where(is_split_child[:, None],
                            gaussians.xyz[src] + offset, gaussians.xyz[src])
    child_scaling = torch.where(is_split_child[:, None],
                                torch.log(scales[src] / 1.6),
                                gaussians.scaling[src])

    def scatter_children(p, child_vals=None):
        vals = p[src] if child_vals is None else child_vals
        m = valid_child.reshape((-1,) + (1,) * (p.dim() - 1))
        out = p.clone()
        out[target] = torch.where(m, vals, p[target])
        return out

    params = gaussians.params_dict()
    new_params = {name: scatter_children(p) for name, p in params.items()}
    new_params["xyz"] = scatter_children(params["xyz"], child_xyz)
    new_params["scaling"] = scatter_children(params["scaling"], child_scaling)

    new_alive = alive_after.clone()
    new_alive[target] = torch.where(valid_child, True, alive_after[target])

    # Zero Adam moments on every re-allocated or dead row.
    touched = torch.zeros(C, dtype=torch.bool, device=dev)
    touched[target] = valid_child
    zero_state_rows(opt_state, touched | ~new_alive)

    g = dataclasses.replace(gaussians.with_params(new_params), alive=new_alive)
    info = {"cloned": clone.sum(), "split": split.sum(), "pruned": prune.sum(),
            "dropped_children": dropped, "alive": new_alive.sum()}
    return g, opt_state, DensifyStats.zeros(C, dev), info


@torch.no_grad()
def reset_opacity(gaussians: Gaussians, opt_state: AdamState,
                  cap: float = 0.01):
    """Clamp activated opacity to <= cap and zero its Adam state; cap=0.8 is
    the reduce-opacity variant."""
    new_op = inverse_sigmoid(torch.clamp_max(torch.sigmoid(gaussians.opacity),
                                             cap))
    return (dataclasses.replace(gaussians, opacity=new_op),
            zero_state_param(opt_state, "opacity"))


@torch.no_grad()
def prune_rows(gaussians: Gaussians, opt_state: AdamState,
               stats: DensifyStats, mask: torch.Tensor):
    """Kill rows where mask (the observe trim, non-finite healing)."""
    alive = gaussians.alive & ~mask
    return (dataclasses.replace(gaussians, alive=alive),
            zero_state_rows(opt_state, ~alive), stats)


@torch.no_grad()
def prune_init_points(gaussians: Gaussians) -> Gaussians:
    """Drop oversized SfM init points: max scale above BOTH the mean of all
    alive scales and their 99.9th percentile."""
    scales = gaussians.get_scaling
    flat = torch.where(gaussians.alive[:, None], scales, torch.nan).reshape(-1)
    mean_s = torch.nanmean(flat)
    q999 = torch.nanquantile(flat, 0.999)
    mx = torch.max(scales, dim=-1).values
    drop = (mx > mean_s) & (mx > q999) & gaussians.alive
    return dataclasses.replace(gaussians, alive=gaussians.alive & ~drop)


@torch.no_grad()
def grow_capacity(gaussians: Gaussians, opt_state: AdamState,
                  stats: DensifyStats, new_capacity: int):
    """Re-pad every capacity-sized tensor with zero rows (new rows are dead;
    their quaternions are (1, 0, 0, 0))."""
    C = gaussians.capacity
    assert new_capacity > C

    def pad(x):
        out = x.new_zeros((new_capacity,) + tuple(x.shape[1:]))
        out[:C] = x
        return out

    fields = {f.name: pad(getattr(gaussians, f.name))
              for f in dataclasses.fields(gaussians) if f.name != "max_sh_degree"}
    fields["rotation"][C:, 0] = 1.0
    g = dataclasses.replace(gaussians, **fields)
    state = AdamState(mu={k: pad(v) for k, v in opt_state.mu.items()},
                      nu={k: pad(v) for k, v in opt_state.nu.items()},
                      count=opt_state.count)
    stats = DensifyStats(**{f.name: pad(getattr(stats, f.name))
                            for f in dataclasses.fields(stats)})
    return g, state, stats
