"""Public flash-attention forward op (`repro/kernels/flash_attention/ops.py`):
the hand-written CUDA kernel on CUDA tensors, the plain version on CPU
tensors (`kernel.py`). The reference's TPU tile sizes `bq` / `bk` have no
counterpart. Forward only: the kernel has no backward yet, so an input
that requires grad while grad mode is on raises rather than returning an
output that silently drops its gradient."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd


def flash_attention_op(q, k, v, *, causal=True, window=1 << 30,
                       is_global=True, q_offset=0):
    """q: (B, Sq, H, D); k/v: (B, Skv, KH, D) with H % KH == 0."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention_op is forward only (serving); its backward is "
            "not ported: call it under torch.no_grad()")
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               is_global=is_global, q_offset=q_offset)
