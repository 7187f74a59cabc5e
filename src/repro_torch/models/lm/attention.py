"""Attention for the LM path (`repro/models/lm/attention.py:152-187`): the
train / prefill flash attention, which goes through the hand-written CUDA
kernels on the card (`kernels/flash_attention`), and the decode step's
single-token attention over the KV cache, plain PyTorch (the reference
computes it outside any kernel too).

`flash_attention` is differentiable, as the reference's custom-VJP jnp
twin is (`_flash_bwd`, `repro/models/lm/attention.py:107`): the forward
saves the rows' log-sum-exp and the backward is the CUDA backward kernel
on the card, its plain version on the CPU. Under `torch.no_grad()`
(serving) it is the forward kernel alone.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.kernels.flash_attention.ref import NEG_INF


def flash_attention(q, k, v, *, causal=True, window=1 << 30, is_global=True,
                    q_offset=0):
    """q (B, Sq, H, D), k/v (B, Skv, KH, D) -> (B, Sq, H, D), any lengths
    (the reference's jnp twin falls back to one chunk for ragged ones)."""
    return flash_attention_op(q, k, v, causal=causal, window=window,
                              is_global=is_global, q_offset=q_offset)


def decode_attention(q, k_cache, v_cache, pos, *, window=1 << 30,
                     is_global=True):
    """Single-token attention over a KV cache.

    q: (B, 1, H, D); caches: (B, S, KH, D); pos: int (current index).
    Keys after `pos` are masked; the window applies only when the layer is
    not global."""
    B, _, H, D = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    G = H // KH
    qf = q.to(torch.float32).reshape(B, KH, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.to(torch.float32))
    s = s / math.sqrt(D)
    kv_pos = torch.arange(S, device=q.device)
    ok = kv_pos <= pos
    if not is_global:
        ok = ok & ((pos - kv_pos) < window)
    s = s.masked_fill(~ok, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", p / denom,
                       v_cache.to(torch.float32))
    return out.reshape(B, 1, H, D).to(q.dtype)
