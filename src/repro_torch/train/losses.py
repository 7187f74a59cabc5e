"""Node-classification losses (`repro/train/losses.py:49-61`)."""
from __future__ import annotations

import torch


def gnn_softmax_ce(logits, labels, mask):
    """Node-classification CE over root nodes. logits (N, C).

    The label's logit is taken by a masked row sum (one value and zeros:
    exactly the value), not by `gather`, whose backward on CUDA is an
    atomic scatter-add; this backward is elementwise."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    cls = torch.arange(lf.shape[-1], device=lf.device)
    picked = torch.where(labels.long()[:, None] == cls, lf, 0.0).sum(-1)
    nll = (lse - picked) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


def accuracy(logits, labels, mask):
    pred = torch.argmax(logits, dim=-1)
    correct = (pred == labels.long()).to(torch.float32) * mask
    return correct.sum() / torch.clamp(mask.sum(), min=1.0)
