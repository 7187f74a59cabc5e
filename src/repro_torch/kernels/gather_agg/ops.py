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
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gather_agg.kernel import (gather_agg_bwd_dw,
                                                   gather_agg_bwd_dx,
                                                   gather_agg_fwd)


class _GatherAgg(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx, w):
        ctx.save_for_backward(x, idx, w)
        ctx.n_src = x.shape[0]
        return gather_agg_fwd(x, idx, w)

    @staticmethod
    def backward(ctx, g):
        x, idx, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = gather_agg_bwd_dx(idx, w, g, ctx.n_src).to(x.dtype)
        if ctx.needs_input_grad[2]:
            dw = gather_agg_bwd_dw(x, idx, g).to(w.dtype)
        return dx, None, dw


def gather_agg(x: torch.Tensor, idx: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """Fused `out[i] = sum_j w[i,j] * x[idx[i,j]]`; differentiable in x, w.

    x: (n_src, F) float32; idx: (n_dst, r) int (clipped to [0, n_src));
    w: (n_dst, r) float. Returns (n_dst, F) float32.
    """
    idx = torch.clamp(idx.to(torch.int32), 0, x.shape[0] - 1).contiguous()
    return _GatherAgg.apply(x.contiguous(), idx,
                            w.to(torch.float32).contiguous())


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.x_shape = x.shape
        flat = x.reshape(x.shape[0], -1).index_select(0, idx.reshape(-1))
        return flat.reshape(*idx.shape, *x.shape[1:])

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        M = idx.numel()
        dx = gather_agg_bwd_dx(
            idx.reshape(M, 1),
            torch.ones((M, 1), dtype=torch.float32, device=g.device),
            g.reshape(M, ctx.x_shape[1:].numel()).to(torch.float32)
            .contiguous(), ctx.x_shape[0])
        return dx.reshape(ctx.x_shape).to(g.dtype), None


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`x[idx]` along the first axis, differentiable in x through the
    deterministic fanout-1 scatter-add (`gather_agg_bwd_dx`, fixed order,
    no atomics) on CUDA and its plain version on the CPU.

    x: (n_src, ...) float32; idx: int of any shape, clipped to
    [0, n_src) as `gather_agg` clips. Returns idx.shape + x.shape[1:]."""
    idx = torch.clamp(idx.to(torch.int32), 0, x.shape[0] - 1).contiguous()
    return _GatherRows.apply(x.contiguous(), idx)
