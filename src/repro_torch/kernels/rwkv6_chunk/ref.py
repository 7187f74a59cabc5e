"""Plain PyTorch versions of the WKV6 recurrence
(`repro/models/lm/rwkv6.py:68-122` and `repro/kernels/rwkv6_chunk/ref.py`):
the exact per-step scan (the oracle and the decode step), the chunked
matmul form that the prefill runs and the CUDA kernel mirrors, and the
zero-state oracle. The CPU path runs them, and `chip_smoke.py` holds the
CUDA kernel against `wkv6_fwd_ref` on the card.

Shapes: r/k/v/logw (B, T, H, N), u (H, N), s0 (B, H, N, N), float32 math
throughout. The state update is S_t = diag(w_t) S_{t-1} + k_t v_t^T and
the output out_t = r_t (S_{t-1} + diag(u) k_t v_t^T), w_t = exp(logw_t).
"""
import torch

CHUNK = 16


def wkv6_scan(r, k, v, logw, u, s0):
    """Exact recurrence. Returns (out (B, T, H, N) in r's dtype, the final
    state (B, H, N, N) float32)."""
    w = torch.exp(logw.to(torch.float32))
    rf, kf, vf = (a.to(torch.float32) for a in (r, k, v))
    u = u.to(torch.float32)[..., None]
    s = s0.to(torch.float32)
    outs = []
    for t in range(r.shape[1]):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]        # (B,H,N,N)
        outs.append(torch.einsum("bhn,bhnm->bhm", rf[:, t], s + u * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(outs, dim=1).to(r.dtype), s


def wkv6_chunked(r, k, v, logw, u, s0, chunk=CHUNK):
    """Chunked matmul form, same signature and result as `wkv6_scan`: per
    chunk of `chunk` steps a decayed causal score matrix plus the `u` bonus
    on its diagonal, then the state's decay and update. The decayed
    factors r e^{cum_prev} and k e^{-cum} stay inside float32 while
    |logw| * chunk < 88. Falls back to the scan when chunk does not
    divide T, as the reference does."""
    B, T, H, N = r.shape
    if T % chunk != 0:
        return wkv6_scan(r, k, v, logw, u, s0)
    nc = T // chunk
    rc, kc, vc, wc = (a.to(torch.float32).reshape(B, nc, chunk, H, N)
                      for a in (r, k, v, logw))
    u = u.to(torch.float32)
    dev = r.device
    tri = torch.tril(torch.ones((chunk, chunk), device=dev), -1)
    eye = torch.eye(chunk, device=dev)
    s = s0.to(torch.float32)
    outs = []
    for c in range(nc):
        rt, kt, vt, lw = rc[:, c], kc[:, c], vc[:, c], wc[:, c]  # (B,C,H,N)
        cum = torch.cumsum(lw, dim=1)                            # inclusive
        cum_prev = cum - lw
        q_dec = rt * torch.exp(cum_prev)                         # <= |r|
        k_dec = kt * torch.exp(-cum)
        scores = torch.einsum("bihn,bjhn->bhij", q_dec, k_dec) * tri
        diag = torch.einsum("bihn,hn,bihn->bhi", rt, u, kt)
        scores = scores + diag[..., :, None] * eye
        out = torch.einsum("bhij,bjhn->bihn", scores, vt)
        out = out + torch.einsum("bihn,bhnm->bihm", q_dec, s)
        last = cum[:, -1]                                        # (B,H,N)
        k_rem = kt * torch.exp(last[:, None] - cum)              # <= |k|
        s = torch.exp(last)[..., None] * s + \
            torch.einsum("bjhn,bjhm->bhnm", k_rem, vt)
        outs.append(out)
    out = torch.stack(outs, dim=1).reshape(B, T, H, N)
    return out.to(r.dtype), s


def wkv6_ref(r, k, v, logw, u):
    """Zero-state oracle: the scan's output in float32."""
    B, T, H, N = r.shape
    s0 = torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
    out, _ = wkv6_scan(r, k, v, logw, u, s0)
    return out.to(torch.float32)


def wkv6_fwd_ref(r, k, v, logw, u, s0=None):
    """The function of the CUDA kernel `wkv6_fwd`: `wkv6_chunked` on
    float32 casts of r/k/v from `s0` (zeros when None). Returns (out
    (B, T, H, N) float32, final state (B, H, N, N) float32)."""
    B, T, H, N = r.shape
    if s0 is None:
        s0 = torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
    return wkv6_chunked(r.to(torch.float32), k.to(torch.float32),
                        v.to(torch.float32), logw, u, s0)
