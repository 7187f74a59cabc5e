"""Plain PyTorch version of the flash-attention forward
(`repro/kernels/flash_attention/ref.py`, which re-exports
`repro/models/lm/attention.py:23-51`: `_mask` and `attention_ref`). The
CPU path runs it, and `chip_smoke.py` holds the CUDA kernel against it on
the card. It materialises the whole (Sq, Skv) score matrix per head.
With `p_bf16` it emulates the rounding points of the tensor-core kernel
instead."""
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
                  q_offset=0, p_bf16=False, kv_tile=None):
    """Naive O(S^2) oracle. q (B,Sq,H,D); k/v (B,Skv,KH,D); head h reads
    KV head h // (H / KH). Scores, softmax and the weighted sum in
    float32; the output in q's dtype.

    `p_bf16`: the tensor-core kernel's rounding points instead. The
    weights p = exp(s - m) are rounded to bf16 before the P V product
    (float32 sums), the row sum l adds the unrounded p, and
    out = P V / max(l, 1e-30). m is the row max of the keys so far at
    the end of each tile of `kv_tile` keys (the kernel's running max; all
    keys at once when None): a weight rounded at its tile's max is then
    rescaled by exp(m_tile - m_row) in float32, as the kernel rescales
    its accumulator."""
    if kv_tile is not None and not p_bf16:
        raise ValueError("kv_tile only applies with p_bf16")
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
    if not p_bf16:
        p = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(torch.float32))
        return out.reshape(B, Sq, H, D).to(q.dtype)
    Skv = scores.shape[-1]
    tile = Skv if kv_tile is None else kv_tile
    n = -(-Skv // tile)
    padded = torch.nn.functional.pad(scores, (0, n * tile - Skv),
                                     value=NEG_INF)
    run = torch.cummax(padded.unflatten(-1, (n, tile)).amax(-1), -1).values
    m_tile = run.repeat_interleave(tile, dim=-1)[..., :Skv]
    p = torch.exp(scores - m_tile)              # the kernel's p, unrounded
    rescale = torch.exp(m_tile - run[..., -1:])
    l = (p * rescale).sum(-1)
    pv = torch.einsum("bkgqs,bskd->bkgqd",
                      p.to(torch.bfloat16).to(torch.float32) * rescale,
                      v.to(torch.float32))
    out = (pv / l.clamp_min(1e-30)[..., None]).permute(0, 3, 1, 2, 4)
    return out.reshape(B, Sq, H, D).to(q.dtype)
