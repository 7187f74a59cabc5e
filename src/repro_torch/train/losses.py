"""Node-classification losses (`repro/train/losses.py:49-61`)."""
from __future__ import annotations

import torch


def gnn_softmax_ce(logits, labels, mask):
    """Node-classification CE over root nodes. logits (N, C)."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    picked = torch.gather(lf, -1, labels.long()[:, None])[:, 0]
    nll = (lse - picked) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


def accuracy(logits, labels, mask):
    pred = torch.argmax(logits, dim=-1)
    correct = (pred == labels.long()).to(torch.float32) * mask
    return correct.sum() / torch.clamp(mask.sum(), min=1.0)
