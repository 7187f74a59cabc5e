"""Public grouped expert matmul op (`repro/kernels/moe_gmm/ops.py`): the
hand-written CUDA kernel on CUDA tensors, the plain version on CPU tensors
(`kernel.py`). The reference's TPU tile sizes `bc` / `bf` / `bd` have no
counterpart. Forward only: the kernel has no backward yet, so an input
that requires grad while grad mode is on raises rather than returning an
output that silently drops its gradient."""
from __future__ import annotations

import torch

from repro_torch.kernels.moe_gmm.kernel import moe_gmm_fwd


def moe_gmm(x, w):
    """x: (E, C, d); w: (E, d, f) -> (E, C, f) float32."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError(
            "moe_gmm is forward only (serving); its backward is not ported: "
            "call it under torch.no_grad()")
    return moe_gmm_fwd(x, w)
