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

On CUDA tensors `adam_update` is one launch of csrc/adam.cu over every group
(the operator gs2m::adam_), bit-equal to the eager loop `adam_update_plain` on
the same tensors (the kernel's note gives its design and bound); on CPU
tensors it runs that loop.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from functools import cache, partial
from typing import NamedTuple

import numpy as np
import torch

from gs2m_tpu_torch.launches import LAUNCHES

# csrc/adam.cu's kMaxGroups (the table it takes by value) and kBlockElems
# (elements a block: 256 threads x 4).
ADAM_MAX_GROUPS = 16
ADAM_BLOCK = 1024


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


def _corrections(count: int, b1: float, b2: float) -> tuple[float, float]:
    """The bias corrections 1 - b^t of step `count`, in float32."""
    t = _f32(count)
    return float(1.0 - _f32(b1) ** t), float(1.0 - _f32(b2) ** t)


@torch.no_grad()
def adam_update(params: dict, grads: dict, state: AdamState, lrs: dict,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-15):
    """One Adam step, in place: params and state.mu/nu are overwritten,
    state.count advances. `lrs` maps each param to a float LR. A missing or
    None gradient counts as zeros. One kernel launch on CUDA tensors (or an
    error), the eager loop on CPU tensors."""
    x = next(iter(params.values()))
    if x.is_cuda:
        return _adam_card(params, grads, state, lrs, b1, b2, eps)
    if x.device.type != "cpu":
        raise ValueError(f"adam_update runs on cuda or cpu, not {x.device}")
    return adam_update_plain(params, grads, state, lrs, b1, b2, eps)


@torch.no_grad()
def adam_update_plain(params: dict, grads: dict, state: AdamState, lrs: dict,
                      b1: float = 0.9, b2: float = 0.999, eps: float = 1e-15):
    """adam_update as eager PyTorch: 14 elementwise ops a group."""
    state.count += 1
    c1, c2 = _corrections(state.count, b1, b2)
    for k, p in params.items():
        g = grads.get(k)
        if g is None:
            g = torch.zeros_like(p)
        m, v = state.mu[k], state.nu[k]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        p.sub_(float(lrs[k]) * (m / c1) / (torch.sqrt(v / c2) + eps))
    return params, state


class AdamTable(NamedTuple):
    """What csrc/adam.cu takes, one entry a group in the params' order."""
    tensors: list       # (p, g or None, m, v), held through the launch
    lr: list            # np.float32


def adam_table(params: dict, grads: dict, state: AdamState,
               lrs: dict) -> AdamTable:
    """The kernel's group table. Raises on what it does not take: more than
    ADAM_MAX_GROUPS groups, or a parameter, moment or gradient that is not a
    float32 tensor of the parameter's shape on its device; parameters and
    moments, written in place, must be contiguous and start on a 16-byte
    boundary (the kernel's loads are 16 bytes wide). A gradient that is not
    both is copied to one that is."""
    if not 0 < len(params) <= ADAM_MAX_GROUPS:
        raise ValueError(f"adam kernel takes 1 to {ADAM_MAX_GROUPS} groups, "
                         f"got {len(params)}")
    dev = next(iter(params.values())).device
    out = AdamTable([], [])
    for k, p in params.items():
        g, m, v = grads.get(k), state.mu[k], state.nu[k]
        for what, x in (("param", p), ("gradient", g), ("first moment", m),
                        ("second moment", v)):
            if x is None:
                continue
            if (x.device != dev or x.dtype != torch.float32
                    or x.shape != p.shape):
                raise ValueError(f"adam: the {what} of {k} must be a float32 "
                                 f"tensor of shape {tuple(p.shape)} on {dev}")
            if x is not g and not (x.is_contiguous()
                                   and x.data_ptr() % 16 == 0):
                raise ValueError(f"adam: the {what} of {k}, updated in place, "
                                 f"must be contiguous and 16-byte aligned")
        if g is not None and not (g.is_contiguous() and g.data_ptr() % 16 == 0):
            g = g.clone(memory_format=torch.contiguous_format)
        out.tensors.append((p, g, m, v))
        out.lr.append(np.float32(lrs[k]))
    return out


def adam_blocks(n: list) -> list:
    """Each group's first block of the kernel's grid, then the grid's size:
    group k of n[k] elements takes blocks [first[k], first[k+1]), ADAM_BLOCK
    elements a block."""
    first = [0]
    for k in n:
        first.append(first[-1] - (-k // ADAM_BLOCK))
    return first


def adam_scalars(count: int, b1: float, b2: float, eps: float) -> tuple:
    """(b1, b2, 1-b1, 1-b2, 1/c1, 1/c2, eps) of step `count` in float32, as
    eager CUDA PyTorch rounds the loop's scalars: each Python float to
    float32, and a tensor divided by a host scalar c as a multiply by the
    float32 reciprocal of float32 c."""
    c1, c2 = _corrections(count, b1, b2)
    one = np.float32(1.0)
    return (np.float32(b1), np.float32(b2), np.float32(1 - b1),
            np.float32(1 - b2), one / np.float32(c1), one / np.float32(c2),
            np.float32(eps))


@cache
def _entry():
    """The C entry gs2m_adam of csrc/adam.cu, built at first use."""
    from gs2m_tpu_torch import _build

    fn = _build.library("adam").gs2m_adam
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int]
                   + [ctypes.c_float] * 7 + [ctypes.c_void_p])
    return fn


def _launch(params: list, grads: list, mu: list, nu: list, lrs: list,
            coef: list) -> None:
    """The CUDA kernel of the operator gs2m::adam_: one launch of
    csrc/adam.cu over the groups (each list in group order; lrs and coef as
    adam_table and adam_scalars round them, so their float32 values are
    exact)."""
    G = len(params)
    ptrs = (ctypes.c_void_p * (4 * G))(*[
        0 if x is None else x.data_ptr()
        for row in zip(params, grads, mu, nu) for x in row])
    n = [p.numel() for p in params]
    dev = params[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry()(ptrs, (ctypes.c_longlong * G)(*n),
                       (ctypes.c_float * G)(*lrs),
                       (ctypes.c_int * (G + 1))(*adam_blocks(n)), G, *coef,
                       stream)
    if err != 0:
        raise RuntimeError(f"adam kernel launch failed: CUDA error {err}")
    LAUNCHES["adam", 0] += 1


# The launch is an operator of PyTorch's dispatcher, so that its profiler
# records it as an op (gs2m::adam_) and ties the kernel's device time to it,
# and so to the step/update range around it; a kernel launched through ctypes
# outside any op is tied to no range. Registered for CUDA tensors only.
_LIB = torch.library.Library("gs2m", "DEF")
_LIB.define("adam_(Tensor(a!)[] params, Tensor?[] grads, Tensor(b!)[] mu, "
            "Tensor(c!)[] nu, float[] lrs, float[] coef) -> ()")
_LIB.impl("adam_", _launch, "CUDA")


def _adam_card(params, grads, state, lrs, b1, b2, eps):
    """adam_update on the card: one launch of csrc/adam.cu."""
    table = adam_table(params, grads, state, lrs)
    state.count += 1
    p, g, m, v = (list(x) for x in zip(*table.tensors))
    torch.ops.gs2m.adam_(p, g, m, v, [float(x) for x in table.lr],
                         [float(x) for x in adam_scalars(state.count, b1, b2,
                                                         eps)])
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
