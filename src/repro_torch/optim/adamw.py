"""AdamW over a list of tensors (`repro/optim/adamw.py`): the same
decoupled-decay formula (`adamw.py:43`), float32 state, and a float32
`b ** count` bias correction."""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch


def init(params: Sequence[torch.Tensor]) -> Dict:
    """m, v: float32 zeros like each parameter; count: int32 scalar."""
    zeros = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in params]
    device = params[0].device if params else None
    return {"m": zeros, "v": [z.clone() for z in zeros],
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def update(grads: Sequence[torch.Tensor], state: Dict,
           params: Sequence[torch.Tensor], *, lr, b1=0.9, b2=0.999,
           eps=1e-8, weight_decay=0.0):
    """Returns (new params, new state) as new tensors; nothing is updated
    in place, so a caller can still select the old values."""
    count = state["count"] + 1
    c = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=c.device), c)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=c.device), c)
    new_p: List[torch.Tensor] = []
    new_m: List[torch.Tensor] = []
    new_v: List[torch.Tensor] = []
    for g, m, v, p in zip(grads, state["m"], state["v"], params):
        g = g.to(torch.float32)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        mhat = m / bc1
        vhat = v / bc2
        step = mhat / (torch.sqrt(vhat) + eps) \
            + weight_decay * p.to(torch.float32)
        new_p.append((p - lr * step).to(p.dtype))
        new_m.append(m)
        new_v.append(v)
    return new_p, {"m": new_m, "v": new_v, "count": count}
