"""Public fused gather-aggregate op with its gradient
(`repro/kernels/gather_agg/ops.py`).

`gather_agg(x, idx, w)` computes `out[i] = sum_j w[i,j] * x[idx[i,j]]`
without materialising the (n_dst, r, F) gather on CUDA, in either
direction: the forward is the gather-reduce kernel, the backward the
deterministic scatter-add kernel for dx (see `kernel.py`). dx is computed
only when x needs it — layer 0 reads the global feature matrix, whose
gradient nobody wants. dw (GAT's attention weights) has no CUDA kernel
yet, so asking for it on CUDA raises; on the CPU the plain version gives
it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gather_agg.kernel import (gather_agg_bwd_dx,
                                                   gather_agg_fwd)
from repro_torch.kernels.gather_agg.ref import gather_agg_bwd_dw_ref


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
            if g.is_cuda:
                raise NotImplementedError(
                    "gather_agg: the dw kernel (gather_agg_bwd_dw_pallas) "
                    "is not ported to CUDA yet")
            dw = gather_agg_bwd_dw_ref(x, idx, g).to(w.dtype)
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
