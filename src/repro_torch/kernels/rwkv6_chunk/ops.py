"""Public WKV6 chunk op (`repro/kernels/rwkv6_chunk/ops.py`): the
hand-written CUDA kernel on CUDA tensors, the plain chunked form on CPU
tensors (`kernel.py`). The reference's `chunk` argument has no
counterpart: the kernel's chunk is 16. Forward only: the kernel has no
backward yet, so an input that requires grad while grad mode is on raises
rather than returning an output that silently drops its gradient."""
from __future__ import annotations

import torch

from repro_torch.kernels.rwkv6_chunk.kernel import wkv6_fwd


def wkv6(r, k, v, logw, u, s0=None):
    """r/k/v/logw: (B, T, H, N); u: (H, N); s0: (B, H, N, N) or None for
    zeros. Returns (out (B, T, H, N) float32, final state float32)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (r, k, v, logw, u,
                                                        s0)):
        raise RuntimeError(
            "wkv6 is forward only (serving); its backward is not ported: "
            "call it under torch.no_grad()")
    return wkv6_fwd(r, k, v, logw, u, s0)
