"""Row gathers whose backward is deterministic.

`x[idx]` on a CUDA tensor is differentiated by an indexed accumulate, and
torch.gather / index_select by scatter_add / index_add: float atomics,
whose summation order (and so the last bits of the sum) changes from run
to run wherever two indices collide. Bilinear taps collide by design (four
neighbours share a texel), so every gather that carries gradient into an
image or a cubemap goes through `gather_rows`. Its backward is the JAX
package's sort-based segment sum (gs2m_tpu/ops/grid_sample.py:77-120): a
stable sort of the indices, then each row's cotangents summed in slot
order by torch.segment_reduce. Static index tables (the cubemap's pad
ring, upsampling, lat-long export) precompute their sort once
(`GatherPlan`).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class GatherPlan:
    """An index tensor of shape `shape`, flattened (`idx`, int64), with its
    stable sort: `order` (M,) and the segment lengths (N,) of the sorted
    indices, one per source row."""

    idx: torch.Tensor
    shape: tuple
    order: torch.Tensor
    lengths: torch.Tensor


def plan(idx: torch.Tensor, n_rows: int) -> GatherPlan:
    """Sort `idx` (values in [0, n_rows)) once, for a gather that is
    repeated with the same indices. No host sync."""
    flat = idx.reshape(-1).long()
    sorted_idx, order = torch.sort(flat, stable=True)
    starts = torch.searchsorted(sorted_idx, torch.arange(
        n_rows, dtype=flat.dtype, device=flat.device))
    lengths = torch.diff(starts, append=starts.new_full((1,), flat.numel()))
    return GatherPlan(idx=flat, shape=tuple(idx.shape), order=order,
                      lengths=lengths)


def scatter_rows(rows: torch.Tensor, p: GatherPlan) -> torch.Tensor:
    """Adjoint of a gather: sum the rows (M, C) into (N, C) by p.idx, each
    output row summed in slot order, the same bits on every run."""
    return torch.segment_reduce(rows.index_select(0, p.order), "sum",
                                lengths=p.lengths, axis=0, unsafe=True)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, p: GatherPlan):
        ctx.p = p
        return src.index_select(0, p.idx)

    @staticmethod
    def backward(ctx, g):
        return scatter_rows(g.contiguous(), ctx.p), None


def gather_rows(src: torch.Tensor, idx) -> torch.Tensor:
    """src (N, C) rows at idx (...) -> (..., C). The backward sums the
    cotangents of each source row deterministically. `idx` is an index
    tensor or a GatherPlan (its sort reused); a gather that carries no
    gradient sorts nothing."""
    C = src.shape[1]
    if isinstance(idx, GatherPlan):
        p = idx
    elif src.requires_grad and torch.is_grad_enabled():
        p = plan(idx, src.shape[0])
    else:
        return src.index_select(0, idx.reshape(-1).long()).reshape(
            *idx.shape, C)
    return _GatherRows.apply(src, p).reshape(*p.shape, C)
