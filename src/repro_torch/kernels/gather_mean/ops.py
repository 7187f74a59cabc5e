"""The masked-mean gather (`repro/kernels/gather_mean/ops.py`): a shim over
the `gather_agg` kernels, not a kernel of its own. A masked mean is the
weighted sum with w = mask / count, the counts taken outside the kernel,
so its forward is one `gather_agg_fwd` launch and its backward for x one
`gather_agg_bwd_dx` launch; the launches are counted as `gather_agg`'s."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.gather_agg.ops import DxPlan, gather_agg


def gather_mean(x: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor,
                plan: Optional[DxPlan] = None) -> torch.Tensor:
    """x: (N, F) float32; idx: (D, r) int (rows of x); mask: (D, r) bool.

    Returns (D, F) float32 masked means (all-masked rows are zero),
    differentiable in x. `plan`: the `DxPlan` of idx, shared with other
    ops over the same index."""
    m = mask.to(torch.float32)
    w = m / torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)
    return gather_agg(x, idx, w, plan)
