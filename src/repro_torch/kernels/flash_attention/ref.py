"""Plain PyTorch versions of the flash-attention forward
(`repro/kernels/flash_attention/ref.py`, which re-exports
`repro/models/lm/attention.py:23-51`: `_mask` and `attention_ref`) and
backward (`flash_attention_bwd_ref`, the reference's custom-VJP backward
`_flash_bwd`, `repro/models/lm/attention.py:107-146`). The CPU path runs
them, and `chip_smoke.py` holds the CUDA kernels against them on the
card. The forward materialises the whole (Sq, Skv) score matrix per head;
with `p_bf16` it emulates the rounding points of the tensor-core kernel
instead. The backward walks the keys in chunks, as the reference does;
with `pds_bf16` it emulates the tensor-core backward's rounding points."""
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


def _scores(q, k, *, causal, window, is_global, q_offset):
    """The masked float32 scores (B, KH, G, Sq, Skv): q k^T / sqrt(D),
    -1e30 where masked."""
    B, Sq, H, D = q.shape
    KH = k.shape[2]
    qr = q.reshape(B, Sq, KH, H // KH, D)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qr.to(torch.float32),
                          k.to(torch.float32)) / math.sqrt(D)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    kv_pos = torch.arange(k.shape[1], device=q.device)
    m = _mask(q_pos, kv_pos, causal=causal, window=window,
              is_global=is_global)
    return scores.masked_fill(~m[None, None, None], NEG_INF)


def attention_lse_ref(q, k, *, causal=True, window=1 << 30, is_global=True,
                      q_offset=0):
    """The row log-sum-exp of the masked scores, (B, H, Sq) float32: the
    `lse` the reference's `_fwd_scan` keeps for its backward (m + log l; a
    row that sees no key gets -1e30 + log Skv, as there)."""
    B, Sq, H, _ = q.shape
    s = _scores(q, k, causal=causal, window=window, is_global=is_global,
                q_offset=q_offset)
    return torch.logsumexp(s, dim=-1).reshape(B, H, Sq)


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
    scores = _scores(q, k, causal=causal, window=window,
                     is_global=is_global, q_offset=q_offset)
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


def flash_attention_bwd_ref(q, k, v, out, lse, dout, *, causal=True,
                            window=1 << 30, is_global=True, q_offset=0,
                            chunk=512, pds_bf16=False):
    """The reference's `_flash_bwd`: (dq, dk, dv) in the dtypes of q, k,
    v, from the forward's `out` (B, Sq, H, D) and `lse` (B, H, Sq) and the
    output's gradient `dout`. Float32 throughout, over key chunks of
    `chunk` (all keys at once when it does not divide Skv):
    p = exp(s - lse), delta = rowsum(dout out), ds = p (dp - delta) /
    sqrt(D); dk and dv summed over the query heads of each KV head. `out`
    is the forward's output as returned (the reference keeps its float32
    copy; the same values in float32).

    `pds_bf16`: the tensor-core kernel's rounding points. p and ds are
    computed in float32 as above (ds from the unrounded p and dp) and
    rounded to bf16 only as operands of the dv, dk and dq products, whose
    sums stay float32 (what the TPU's MXU does to the reference's float32
    einsums at DEFAULT precision)."""
    B, Sq, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    G = H // KH
    if Skv % chunk != 0:
        chunk = Skv
    scale = 1.0 / math.sqrt(D)
    f32 = torch.float32

    def operand(t):
        return t.to(torch.bfloat16).to(f32) if pds_bf16 else t

    qf = q.to(f32).reshape(B, Sq, KH, G, D)
    do = dout.to(f32).reshape(B, Sq, KH, G, D).permute(0, 2, 3, 1, 4)
    of = out.to(f32).reshape(B, Sq, KH, G, D).permute(0, 2, 3, 1, 4)
    delta = torch.sum(do * of, dim=-1)                  # (B,KH,G,Sq)
    lse = lse.to(f32).reshape(B, KH, G, Sq)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    dq = torch.zeros((B, KH, G, Sq, D), dtype=f32, device=q.device)
    dks, dvs = [], []
    for c0 in range(0, Skv, chunk):
        kc = k[:, c0:c0 + chunk].to(f32)
        vc = v[:, c0:c0 + chunk].to(f32)
        kv_pos = torch.arange(c0, c0 + chunk, device=q.device)
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, kc) * scale
        msk = _mask(q_pos, kv_pos, causal=causal, window=window,
                    is_global=is_global)
        s = s.masked_fill(~msk[None, None, None], NEG_INF)
        p = torch.exp(s - lse[..., None])               # (B,KH,G,Sq,C)
        dvs.append(torch.einsum("bkgqs,bkgqd->bskd", operand(p), do))
        dp = torch.einsum("bkgqd,bskd->bkgqs", do, vc)
        ds = operand(p * (dp - delta[..., None]) * scale)
        dq = dq + torch.einsum("bkgqs,bskd->bkgqd", ds, kc)
        dks.append(torch.einsum("bkgqs,bqkgd->bskd", ds, qf))
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)
    return (dq.to(q.dtype), torch.cat(dks, dim=1).to(k.dtype),
            torch.cat(dvs, dim=1).to(v.dtype))
