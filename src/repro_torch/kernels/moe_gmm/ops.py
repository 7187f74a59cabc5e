"""Public grouped expert matmul ops (`repro/kernels/moe_gmm/ops.py`): the
hand-written CUDA kernels on CUDA tensors, the plain versions on CPU
tensors (`kernel.py`). The reference's TPU tile sizes `bc` / `bf` / `bd`
have no counterpart.

Each op is a `torch.autograd.Function` whose backward is the backward
kernels of `csrc/moe_gmm_bwd.cu` (on the CPU their plain versions): the
down product's gradient is `moe_gmm_bwd_dx` (dh) and `moe_gmm_bwd_dw`
(dwd); the gated one's is `moe_gmm_gated_bwd` (dg, du), then
`moe_gmm_bwd_dx` over both pairs (dx) and `moe_gmm_bwd_dw` over both (dwg,
dwu): five launches per MoE layer. `rows` passes to every one of them, so
the backward treats the rows it names as empty as zero. Under
`torch.no_grad()` (serving) an op is the forward kernel alone.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.moe_gmm import kernel


def _grad_in(g: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The output's gradient in the inputs' dtype (a float32 output's
    gradient is rounded to it), contiguous, as the kernels take it."""
    return g.to(dtype).contiguous()


class _Gmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, rows, out_dtype):
        ctx.save_for_backward(x, w, rows)
        return kernel.moe_gmm_fwd(x, w, rows=rows, out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, dout):
        x, w, rows = ctx.saved_tensors
        dout = _grad_in(dout, x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = kernel.moe_gmm_bwd_dx(dout, w, rows=rows)
        if ctx.needs_input_grad[1]:
            dw = kernel.moe_gmm_bwd_dw(x, dout, rows=rows)
        return dx, dw, None, None


class _GmmGated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wg, wu, rows):
        ctx.save_for_backward(x, wg, wu, rows)
        return kernel.moe_gmm_gated_fwd(x, wg, wu, rows=rows)

    @staticmethod
    def backward(ctx, dh):
        x, wg, wu, rows = ctx.saved_tensors
        dg, du = kernel.moe_gmm_gated_bwd(x, wg, wu, _grad_in(dh, x.dtype),
                                          rows=rows)
        dx = dwg = dwu = None
        if ctx.needs_input_grad[0]:
            dx = kernel.moe_gmm_bwd_dx(dg, wg, du, wu, rows=rows)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dwg, dwu = kernel.moe_gmm_bwd_dw(x, dg, du, rows=rows)
        return dx, dwg, dwu, None


def moe_gmm(x, w, rows=None, out_dtype=torch.float32):
    """x: (E, C, d); w: (E, d, f) -> (E, C, f) in `out_dtype`."""
    return _Gmm.apply(x, w, rows, out_dtype)


def moe_gmm_gated(x, wg, wu, rows=None):
    """x: (E, C, d); wg, wu: (E, d, f) -> silu(x wg) * (x wu), (E, C, f)
    in x's dtype."""
    return _GmmGated.apply(x, wg, wu, rows)
