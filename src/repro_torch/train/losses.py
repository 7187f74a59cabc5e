"""Losses (`repro/train/losses.py`). The LM loss is a sequence-chunked,
rematerialised softmax cross-entropy: the (B, S, V) logits never exist at
once (at V 262,144 and 16,384 tokens they would take 17 GB in float32).
The node-classification loss is the GNN trainer's.

Both take the label's logit by a masked row sum (one value and zeros:
exactly the value), not by `gather`, whose backward on CUDA is an atomic
scatter-add; their backward is elementwise."""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def _picked(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits[..., labels] by a masked row sum over the last axis."""
    cls = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(labels.long()[..., None] == cls, logits, 0.0).sum(-1)


def _ce_chunk(hidden, head, labels, mask):
    """hidden (B, C, d); head (d, V); labels (B, C). Float32 logits."""
    logits = (hidden @ head).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    nll = (lse - _picked(logits, labels)) * mask
    return nll.sum(), mask.sum()


def chunked_cross_entropy(hidden, head, labels, mask=None, chunk=512):
    """Mean next-token NLL over the sequence in `chunk` slices (one slice
    when `chunk` does not divide S), each under
    `torch.utils.checkpoint`: its logits are recomputed in the backward.
    hidden (B, S, d); head (d, V) in hidden's dtype; labels (B, S) int;
    mask (B, S) float32 or None (all ones)."""
    B, S, _ = hidden.shape
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=hidden.device)
    if S % chunk != 0:
        chunk = S
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, S, chunk):
        s, c = checkpoint(_ce_chunk, hidden[:, c0:c0 + chunk], head,
                          labels[:, c0:c0 + chunk], mask[:, c0:c0 + chunk],
                          use_reentrant=False)
        tot = tot + s
        cnt = cnt + c
    return tot / torch.clamp(cnt, min=1.0)


def gnn_softmax_ce(logits, labels, mask):
    """Node-classification CE over root nodes. logits (N, C)."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    nll = (lse - _picked(lf, labels)) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


def accuracy(logits, labels, mask):
    pred = torch.argmax(logits, dim=-1)
    correct = (pred == labels.long()).to(torch.float32) * mask
    return correct.sum() / torch.clamp(mask.sum(), min=1.0)
