"""Public fused gather-aggregate op with its gradient
(`repro/kernels/gather_agg/ops.py`).

`gather_agg(x, idx, w)` computes `out[i] = sum_j w[i,j] * x[idx[i,j]]`
without materialising the (n_dst, r, F) gather on CUDA, in either
direction: the forward is the gather-reduce kernel, the backward the
deterministic scatter-add kernel for dx and the gather-dot kernel for dw
(see `kernel.py`). Each gradient is computed only when its input needs
it: dx not when x is the global feature matrix (SAGE's and GCN's layer
0), dw only when the weights carry gradient (GAT's attention weights).
Each kernel wrapper takes its plain version for CPU tensors only.

`gather_rows(x, idx)` is the plain row gather `x[idx]` whose backward is
the same deterministic scatter-add kernel at fanout 1 with unit weights
(as `gather_cached`'s backward calls it), in place of PyTorch's index
backward, which walks each run of equal indices serially.
`gather_sorted_rows(x, idx)` is the same for an index the caller states is
non-decreasing (a level's self rows): its backward needs no sort.

`segment_sum_sorted(x, seg, w, n)` is the transpose of
`gather_sorted_rows`: rows of x weighted and summed into n rows by a
non-decreasing index, its forward the sort-free scatter-add kernel, its
backward a row gather.

A `DxPlan` of an index is the backward's sort of it, made at the first
backward on the card that needs it and shared by every op handed the same
`DxPlan`: a layer's aggregate, its row gather over the same index, and
(`folded`) GAT's head-folded aggregate.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.gather_agg import kernel
from repro_torch.kernels.gather_agg.kernel import (gather_agg_bwd_dw,
                                                   gather_agg_bwd_dx,
                                                   gather_agg_bwd_dx_sorted,
                                                   gather_agg_fwd)


class DxPlan:
    """The bwd_dx plan of `idx` over `n_src` rows, built lazily (one sort,
    no host sync) the first time a backward on the card asks for it, then
    reused; never built for a CPU index, whose plain versions need none.
    `folded(H)` is the same plan serving the head-folded index
    `idx * H + h` over n_src * H rows."""

    def __init__(self, idx: torch.Tensor, n_src: int):
        self.idx, self.n_src, self.heads = idx, n_src, 1
        self._built = [None]            # shared with every folded view

    def folded(self, heads: int) -> "DxPlan":
        view = DxPlan.__new__(DxPlan)
        view.idx, view.n_src, view.heads = self.idx, self.n_src, heads
        view._built = self._built
        return view

    def get(self) -> Optional[kernel.BwdDxPlan]:
        if self.idx.device.type == "cpu":
            return None
        if self._built[0] is None:
            idx = torch.clamp(self.idx.to(torch.int32), 0, self.n_src - 1)
            self._built[0] = kernel.bwd_dx_plan(idx.contiguous(),
                                                self.n_src)
        plan = self._built[0]
        return plan if self.heads == 1 else plan.folded(self.heads)


def _plan_of(plan: Optional[DxPlan]) -> Optional[kernel.BwdDxPlan]:
    return None if plan is None else plan.get()


class _GatherAgg(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx, w, plan):
        ctx.save_for_backward(x, idx, w)
        ctx.n_src = x.shape[0]
        ctx.plan = plan
        return gather_agg_fwd(x, idx, w)

    @staticmethod
    def backward(ctx, g):
        x, idx, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = gather_agg_bwd_dx(idx, w, g, ctx.n_src,
                                   _plan_of(ctx.plan)).to(x.dtype)
        if ctx.needs_input_grad[2]:
            dw = gather_agg_bwd_dw(x, idx, g).to(w.dtype)
        return dx, None, dw, None


def gather_agg(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
               plan: Optional[DxPlan] = None) -> torch.Tensor:
    """Fused `out[i] = sum_j w[i,j] * x[idx[i,j]]`; differentiable in x, w.

    x: (n_src, F) float32; idx: (n_dst, r) int (clipped to [0, n_src));
    w: (n_dst, r) float. Returns (n_dst, F) float32. `plan`: the `DxPlan`
    of idx (or one `folded` to it), shared with other ops over the same
    index; without one, dx's backward sorts idx itself.
    """
    idx = torch.clamp(idx.to(torch.int32), 0, x.shape[0] - 1).contiguous()
    return _GatherAgg.apply(x.contiguous(), idx,
                            w.to(torch.float32).contiguous(), plan)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx, plan, nondecreasing):
        ctx.save_for_backward(idx)
        ctx.x_shape = x.shape
        ctx.plan, ctx.nondecreasing = plan, nondecreasing
        flat = x.reshape(x.shape[0], -1).index_select(0, idx.reshape(-1))
        return flat.reshape(*idx.shape, *x.shape[1:])

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        M = idx.numel()
        dtype = g.dtype
        g = g.reshape(M, ctx.x_shape[1:].numel()).to(torch.float32) \
            .contiguous()
        if ctx.nondecreasing:
            dx = gather_agg_bwd_dx_sorted(idx.reshape(M, 1), None, g,
                                          ctx.x_shape[0])
        else:
            dx = gather_agg_bwd_dx(idx.reshape(M, 1), None, g,
                                   ctx.x_shape[0], _plan_of(ctx.plan))
        return dx.reshape(ctx.x_shape).to(dtype), None, None, None


def gather_rows(x: torch.Tensor, idx: torch.Tensor,
                plan: Optional[DxPlan] = None) -> torch.Tensor:
    """`x[idx]` along the first axis, differentiable in x through the
    deterministic fanout-1 scatter-add (`gather_agg_bwd_dx`, fixed order,
    no atomics) on CUDA and its plain version on the CPU.

    x: (n_src, ...) float32; idx: int of any shape, clipped to
    [0, n_src) as `gather_agg` clips. Returns idx.shape + x.shape[1:].
    `plan`: the `DxPlan` of idx, shared with other ops over the same
    index; without one the backward sorts idx itself."""
    idx = torch.clamp(idx.to(torch.int32), 0, x.shape[0] - 1).contiguous()
    return _GatherRows.apply(x.contiguous(), idx, plan, False)


def gather_sorted_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`gather_rows` for an index whose flat values are non-decreasing (a
    level's self rows: `_positions` maps a sorted level into its sorted
    superset). Its backward sorts nothing (`gather_agg_bwd_dx_sorted`);
    an index that breaks the promise fails in the backward, on the card
    with a launch error and on the CPU with ValueError."""
    idx = torch.clamp(idx.to(torch.int32), 0, x.shape[0] - 1).contiguous()
    return _GatherRows.apply(x.contiguous(), idx, None, True)


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seg, w, n):
        ctx.save_for_backward(seg, w)
        return gather_agg_bwd_dx_sorted(seg, w, x, n)

    @staticmethod
    def backward(ctx, g):
        seg, w = ctx.saved_tensors
        dx = g.index_select(0, seg.reshape(-1).long()) * w
        return dx, None, None, None


def segment_sum_sorted(x: torch.Tensor, seg: torch.Tensor, w: torch.Tensor,
                       n: int) -> torch.Tensor:
    """out[s] = sum over m with seg[m] = s of w[m] * x[m] -> (n, F)
    float32, each row summed in m order: deterministic, no atomics.
    Differentiable in x (its backward gathers `w * g[seg]`).

    x: (M, F) float32; seg: (M,) int, non-decreasing, in [0, n) (on the
    card the kernel traps on a violation, on the CPU ValueError); w: (M,)
    float32."""
    if x.shape[0] == 0:
        return torch.zeros((n, x.shape[1]), dtype=torch.float32,
                           device=x.device)
    return _SegmentSum.apply(
        x.contiguous(), seg.to(torch.int32).reshape(-1, 1).contiguous(),
        w.to(torch.float32).reshape(-1, 1).contiguous(), n)
