"""Plain PyTorch version of the flash-attention forward
(`repro/kernels/flash_attention/ref.py`, which re-exports
`repro/models/lm/attention.py:23-51`: `_mask` and `attention_ref`). The
CPU path runs it, and `chip_smoke.py` holds the CUDA kernel against it on
the card. It materialises the whole (Sq, Skv) score matrix per head."""
import math

import torch

NEG_INF = -1e30


def _mask(q_pos, kv_pos, *, causal, window, is_global):
    """(Sq, Skv) boolean mask: causal `kv_pos <= q_pos`, and the window
    `q_pos - kv_pos < window` unless the layer is global."""
    ok = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok = ok & (kv_pos[None, :] <= q_pos[:, None])
    if not is_global:
        ok = ok & ((q_pos[:, None] - kv_pos[None, :]) < window)
    return ok


def attention_ref(q, k, v, *, causal=True, window=1 << 30, is_global=True,
                  q_offset=0):
    """Naive O(S^2) oracle. q (B,Sq,H,D); k/v (B,Skv,KH,D); head h reads
    KV head h // (H / KH). Scores, softmax and the weighted sum in
    float32; the output in q's dtype."""
    B, Sq, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    qr = q.reshape(B, Sq, KH, G, D)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qr.to(torch.float32),
                          k.to(torch.float32)) / math.sqrt(D)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    kv_pos = torch.arange(k.shape[1], device=q.device)
    m = _mask(q_pos, kv_pos, causal=causal, window=window,
              is_global=is_global)
    scores = scores.masked_fill(~m[None, None, None], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(torch.float32))
    return out.reshape(B, Sq, H, D).to(q.dtype)
