"""Public grouped expert matmul ops (`repro/kernels/moe_gmm/ops.py`): the
hand-written CUDA kernels on CUDA tensors, the plain versions on CPU
tensors (`kernel.py`). The reference's TPU tile sizes `bc` / `bf` / `bd`
have no counterpart. Forward only: the kernels have no backward yet, so
an input that requires grad while grad mode is on raises rather than
returning an output that silently drops its gradient."""
from __future__ import annotations

import torch

from repro_torch.kernels.moe_gmm.kernel import moe_gmm_fwd, moe_gmm_gated_fwd


def _forward_only(*ts) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(
            "moe_gmm is forward only (serving); its backward is not ported: "
            "call it under torch.no_grad()")


def moe_gmm(x, w, rows=None, out_dtype=torch.float32):
    """x: (E, C, d); w: (E, d, f) -> (E, C, f) in `out_dtype`."""
    _forward_only(x, w)
    return moe_gmm_fwd(x, w, rows=rows, out_dtype=out_dtype)


def moe_gmm_gated(x, wg, wu, rows=None):
    """x: (E, C, d); wg, wu: (E, d, f) -> silu(x wg) * (x wu), (E, C, f)
    in x's dtype."""
    _forward_only(x, wg, wu)
    return moe_gmm_gated_fwd(x, wg, wu, rows=rows)
