"""Public flash-attention op (`repro/kernels/flash_attention/ops.py`): the
hand-written CUDA kernels on CUDA tensors, the plain versions on CPU
tensors (`kernel.py`). The reference's TPU tile sizes `bq` / `bk` have no
counterpart.

Differentiable in q, k and v, as the reference's `flash_attention` is
through its custom VJP: with grad mode on and an input that requires grad,
the forward also writes the rows' log-sum-exp, which `_FlashAttention`
saves with q, k, v and the output, and the backward is
`kernel.flash_attention_bwd` (the reference's `_flash_bwd`). Otherwise (the
serving path, under `torch.no_grad()`) it is the forward alone, as
before."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import (flash_attention_bwd,
                                                        flash_attention_fwd)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, is_global, q_offset):
        ctx.kw = dict(causal=causal, window=window, is_global=is_global,
                      q_offset=q_offset)
        out, lse = flash_attention_fwd(q, k, v, return_lse=True, **ctx.kw)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(), **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention_op(q, k, v, *, causal=True, window=1 << 30,
                       is_global=True, q_offset=0):
    """q: (B, Sq, H, D); k/v: (B, Skv, KH, D) with H % KH == 0."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                     v.contiguous(), causal, window,
                                     is_global, q_offset)
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               is_global=is_global, q_offset=q_offset)
