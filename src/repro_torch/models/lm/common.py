"""Shared LM building blocks (`repro/models/lm/common.py`): norms,
activations, RoPE, init. Init draws from an explicit `torch.Generator`, on
the generator's own device (the numbers differ from JAX's threefry stream;
parity tests hand both sides the same numpy parameters)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape, in_axis: int = -2,
               dtype=torch.float32) -> torch.Tensor:
    """LeCun-normal in float32 (params are stored float32, computed in the
    config's dtype), drawn from `gen` on its device."""
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=gen.device).mul_(1.0 / math.sqrt(fan_in))


def embed_init(gen: torch.Generator, shape,
               dtype=torch.float32) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=gen.device).mul_(0.02)


# ---------------------------------------------------------------------------
# norms / activations
# ---------------------------------------------------------------------------
def rmsnorm(x, scale, eps=1e-6):
    """The scale is stored as (scale - 1): float32 math, x's dtype out."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return ((1.0 + scale.to(torch.float32)) * out).to(x.dtype)


def layernorm(x, scale, bias, eps=1e-5):
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * scale + bias).to(x.dtype)


def norm_apply(cfg, x, p):
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rmsnorm(x, p["scale"], cfg.norm_eps)


def norm_init(cfg, d):
    if cfg.norm == "layernorm":
        return {"scale": torch.ones((d,)), "bias": torch.zeros((d,))}
    return {"scale": torch.zeros((d,))}   # rmsnorm stores (scale-1)


def activation(name):
    if name == "silu":
        return F.silu
    if name == "gelu":               # jax.nn.gelu(approximate=True)
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(name)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(head_dim, theta, device=None):
    half = head_dim // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def apply_rope(x, positions, theta, mrope_sections=None):
    """x: (B, S, H, D); positions: (B, S). The two halves of the head dim
    rotate against each other (not interleaved), in float32. M-RoPE's
    (B, 3, S) positions (qwen2-vl) are not ported yet."""
    if positions.dim() == 3:
        raise NotImplementedError("M-RoPE (qwen2-vl) is not ported yet")
    freqs = rope_freqs(x.shape[-1], theta, x.device)       # (half,)
    angles = positions.to(torch.float32)[..., None] * freqs  # (B,S,half)
    cos = torch.cos(angles)[:, :, None, :]                 # (B,S,1,half)
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
