"""Adam with per-parameter-group LRs and row-level state surgery.

Port of gs2m_tpu/train/optim.py: group LRs (xyz scaled by the scene
extent, f_rest = feature_lr/20, materials share opacity_lr; eps 1e-15),
the log-linear xyz schedule with the delayed sine ramp, and one shared step
count for bias correction (appended rows keep the global correction with
zeroed moments). The moments are dictionaries of tensors keyed like
Gaussians.params_dict(); `adam_update` updates parameters and moments IN
PLACE under no_grad (one read-modify-write per leaf instead of new
capacity-sized copies), so rows stay aligned with the padded capacity.
The step count lives on the host: bias corrections are float32 scalars.
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial

import numpy as np
import torch


@dataclasses.dataclass
class AdamState:
    mu: dict       # name -> tensor like the param
    nu: dict       # name -> tensor like the param
    count: int     # steps taken


def adam_init(params: dict) -> AdamState:
    return AdamState(mu={k: torch.zeros_like(v) for k, v in params.items()},
                     nu={k: torch.zeros_like(v) for k, v in params.items()},
                     count=0)


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


@torch.no_grad()
def adam_update(params: dict, grads: dict, state: AdamState, lrs: dict,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-15):
    """One Adam step, in place: params and state.mu/nu are overwritten,
    state.count advances. `lrs` maps each param to a float LR. A missing or
    None gradient counts as zeros."""
    state.count += 1
    t = _f32(state.count)
    c1 = float(1.0 - _f32(b1) ** t)
    c2 = float(1.0 - _f32(b2) ** t)
    for k, p in params.items():
        g = grads.get(k)
        if g is None:
            g = torch.zeros_like(p)
        m, v = state.mu[k], state.nu[k]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        p.sub_(float(lrs[k]) * (m / c1) / (torch.sqrt(v / c2) + eps))
    return params, state


@torch.no_grad()
def zero_state_rows(state: AdamState, row_mask: torch.Tensor) -> AdamState:
    """Zero the moments of rows where row_mask (C,) is True, in place."""
    for d in (state.mu, state.nu):
        for x in d.values():
            x.masked_fill_(row_mask.reshape((-1,) + (1,) * (x.dim() - 1)), 0.0)
    return state


@torch.no_grad()
def zero_state_param(state: AdamState, name: str) -> AdamState:
    """Zero the full moments of one named param, in place."""
    state.mu[name].zero_()
    state.nu[name].zero_()
    return state


def group_lrs(opt, spatial_lr_scale: float, xyz_lr: float) -> dict:
    """Per-group LRs keyed like Gaussians.params_dict(). xyz_lr is the
    scheduled value."""
    return {
        "xyz": xyz_lr,
        "f_dc": opt.feature_lr,
        "f_rest": opt.feature_lr / 20.0,
        "opacity": opt.opacity_lr,
        "scaling": opt.scaling_lr,
        "rotation": opt.rotation_lr,
        "albedo": opt.opacity_lr,
        "roughness": opt.opacity_lr,
        "metallic": opt.opacity_lr,
    }


def expon_lr(step, lr_init: float, lr_final: float, lr_delay_steps: int = 0,
             lr_delay_mult: float = 1.0, max_steps: int = 1_000_000) -> float:
    """Log-linear LR interpolation with optional sine delay ramp, in float32
    like the JAX package's traced schedule."""
    if lr_init == 0.0 and lr_final == 0.0:
        return 0.0
    step = _f32(step)
    if lr_delay_steps > 0:
        delay = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0, 1))
    else:
        delay = 1.0
    t = torch.clamp(step / max_steps, 0.0, 1.0)
    log_lerp = torch.exp(_f32(np.log(lr_init)) * (1 - t)
                         + _f32(np.log(lr_final)) * t)
    return float(delay * log_lerp * (step >= 0))


def xyz_lr_schedule(opt, spatial_lr_scale: float):
    """The position schedule: step -> LR."""
    return partial(expon_lr,
                   lr_init=opt.position_lr_init * spatial_lr_scale,
                   lr_final=opt.position_lr_final * spatial_lr_scale,
                   lr_delay_mult=opt.position_lr_delay_mult,
                   max_steps=opt.position_lr_max_steps)
