"""RWKV6 "Finch" token mixing (`repro/models/lm/rwkv6.py`): data-dependent
decay linear attention (time mix) and the relu² channel mix.

`time_mix` runs the WKV recurrence in one of two equal forms (`ref.py` of
`kernels/rwkv6_chunk`): chunked, for the prefill, through `wkv6` — the
hand-written CUDA kernel on the card, the plain chunked form on the CPU —
or the exact per-step scan, for the decode step, in plain PyTorch, as the
reference runs it. Decay logits are clamped to [LOGW_MIN, LOGW_MAX] so the
chunked form's exp(cum_prev - cum) factors stay inside float32.

Dtypes follow the reference: the mix coefficients and the projection
weights are cast to the compute dtype at use; the decay LoRA (`w0`,
`wa_decay`, `wb_decay`), the bonus `u` and the per-head norm `ln_x` are
used in float32. The kernel returns float32, which is cast to the compute
dtype before the head norm, where the reference's `wkv6_chunked` rounds.
The reference's simplification is kept: the r/k/v/g mix coefficients are
static per channel (v5-style) while the decay keeps the v6 LoRA.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6_chunk.ops import wkv6
from repro_torch.kernels.rwkv6_chunk.ref import wkv6_scan
from repro_torch.models.lm.common import dense_init

LOGW_MIN = -5.0
LOGW_MAX = -1e-4
LORA = 64

Draw = Callable[[torch.Generator, Tuple[int, ...]], torch.Tensor]


def _uniform(g, shape):
    return torch.rand(shape, generator=g, device=g.device)


def _normal(scale):
    return lambda g, shape: torch.randn(shape, generator=g,
                                        device=g.device).mul_(scale)


def _lecun(scale=1.0):
    return lambda g, shape: dense_init(g, shape).mul_(scale)


def _const(value):
    return lambda g, shape: torch.full(shape, value, device=g.device)


def time_mix_init(cfg) -> Dict[str, Tuple[Tuple[int, ...], Draw]]:
    """One layer's time-mix leaves, name -> (shape, draw), as the
    reference's `init_time_mix` draws them (`rwkv6.py:29-45`)."""
    d, H, N = cfg.d_model, cfg.num_heads, cfg.head_dim
    return {
        "mu": ((5, d), _uniform),                 # r, k, v, g, w lerp
        "w0": ((d,), _const(-0.6)),               # base decay logit
        "wa_decay": ((d, LORA), _lecun(0.1)),
        "wb_decay": ((LORA, d), _lecun(0.1)),
        "wr_t": ((d, H * N), _lecun()),
        "wk_t": ((d, H * N), _lecun()),
        "wv_t": ((d, H * N), _lecun()),
        "wg_t": ((d, H * N), _lecun()),
        "u": ((H, N), _normal(0.1)),              # bonus
        "ln_x": ((H, N), _const(1.0)),            # per-head norm
        "wo": ((H * N, d), _lecun()),
    }


def channel_mix_init(cfg) -> Dict[str, Tuple[Tuple[int, ...], Draw]]:
    """One layer's channel-mix leaves (`rwkv6.py:48-56`)."""
    d, ff = cfg.d_model, cfg.d_ff
    return {"mu_c": ((2, d), _uniform),          # k, r lerp
            "wck": ((d, ff), _lecun()),
            "wcv": ((ff, d), _lecun()),
            "wcr": ((d, d), _lecun())}


def init_time_mix(gen: torch.Generator, cfg) -> Dict[str, torch.Tensor]:
    """One layer's time-mix parameters in float32, drawn from `gen`."""
    return {k: draw(gen, s) for k, (s, draw) in time_mix_init(cfg).items()}


def init_channel_mix(gen: torch.Generator, cfg) -> Dict[str, torch.Tensor]:
    return {k: draw(gen, s) for k, (s, draw) in channel_mix_init(cfg).items()}


def token_shift(x, prev):
    """x: (B, T, d); prev: (B, 1, d), the last token of the previous
    segment -> x shifted one step later."""
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def _project(x, p, cfg, shift_prev):
    B, T, _ = x.shape
    H, N = cfg.num_heads, cfg.head_dim
    dt = x.dtype
    xs = token_shift(x, shift_prev)
    mu = p["mu"].to(dt)

    def mix(i):
        return x * mu[i] + xs * (1.0 - mu[i])

    r = (mix(0) @ p["wr_t"].to(dt)).reshape(B, T, H, N)
    k = (mix(1) @ p["wk_t"].to(dt)).reshape(B, T, H, N)
    v = (mix(2) @ p["wv_t"].to(dt)).reshape(B, T, H, N)
    g = F.silu(mix(3) @ p["wg_t"].to(dt))
    xw = mix(4).to(torch.float32)
    lora = torch.tanh(xw @ p["wa_decay"].to(torch.float32)) \
        @ p["wb_decay"].to(torch.float32)
    logw = -torch.exp(p["w0"].to(torch.float32) + lora)        # < 0
    logw = torch.clamp(logw, LOGW_MIN, LOGW_MAX).reshape(B, T, H, N)
    return r, k, v, g, logw


def _head_norm(out, p, cfg):
    B, T, H, N = out.shape
    o32 = out.to(torch.float32)
    var = torch.mean(o32 * o32, dim=-1, keepdim=True)
    o32 = o32 * torch.rsqrt(var + 64e-5) * p["ln_x"].to(torch.float32)
    return o32.reshape(B, T, H * N)


def time_mix(x, p, cfg, state=None, chunked=True):
    """x: (B, T, d), the normed input. state: None (zeros) or
    {"shift": (B, 1, d), "s": (B, H, N, N) float32}. Returns (y (B, T, d),
    {"shift": x's last token, "s": the final state})."""
    B, T, d = x.shape
    shift_prev = state["shift"] if state else torch.zeros(
        (B, 1, d), dtype=x.dtype, device=x.device)
    s0 = state["s"] if state else None
    r, k, v, g, logw = _project(x, p, cfg, shift_prev)
    u = p["u"].to(torch.float32)
    if chunked:
        out, s_f = wkv6(r, k, v, logw, u, s0)
        out = out.to(r.dtype)
    else:
        if s0 is None:
            s0 = torch.zeros((B, cfg.num_heads, cfg.head_dim, cfg.head_dim),
                             dtype=torch.float32, device=x.device)
        out, s_f = wkv6_scan(r, k, v, logw, u, s0)
    out = _head_norm(out, p, cfg).to(x.dtype) * g
    y = out @ p["wo"].to(x.dtype)
    return y, {"shift": x[:, -1:], "s": s_f}


def channel_mix(x, p, cfg, state=None):
    """x: (B, T, d), the normed input; state: the previous segment's last
    normed token (B, 1, d) or None. Returns (y, x's last token)."""
    B, T, d = x.shape
    shift_prev = state if state is not None else torch.zeros(
        (B, 1, d), dtype=x.dtype, device=x.device)
    xs = token_shift(x, shift_prev)
    dt = x.dtype
    mu = p["mu_c"].to(dt)
    xk = x * mu[0] + xs * (1.0 - mu[0])
    xr = x * mu[1] + xs * (1.0 - mu[1])
    kk = torch.square(F.relu(xk @ p["wck"].to(dt)))
    rr = torch.sigmoid(xr @ p["wcr"].to(dt))
    return rr * (kk @ p["wcv"].to(dt)), x[:, -1:]
