"""Wrapper of the hand-written CUDA flash-attention forward
(`csrc/flash_attention.cu`), the counterpart of `flash_attention_pallas`
in `repro/kernels/flash_attention/kernel.py`.

Dispatch goes by the tensors' device: CPU tensors take the plain PyTorch
version (`ref.py`), CUDA tensors launch the kernel — or raise. There is no
fallback from a failed launch. The wrapper counts its launches in
`LAUNCHES` (kernel launches only, never the plain path).
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.gather_agg.kernel import (_check, _device_of,
                                                   _raise_on)

LAUNCHES: Dict[str, int] = {"flash_attention_fwd": 0}
MAX_HEAD_DIM = 256

_P = ctypes.c_void_p
_I64 = ctypes.c_int64


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        lib.flash_attention_fwd.argtypes = [_P] * 4 + [_I64] * 10 + [
            ctypes.c_float, _I64, _P]
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib._typed = True
    return lib


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 1 << 30,
                        is_global: bool = True,
                        q_offset: int = 0) -> torch.Tensor:
    """softmax(q k^T / sqrt(D) + mask) v -> (B, Sq, H, D) in q's dtype.

    q: (B, Sq, H, D); k, v: (B, Skv, KH, D) with H % KH == 0 (head h reads
    KV head h // (H / KH)); float32 or bfloat16, all three alike; any Sq
    and Skv >= 1, D <= 256. Query row i sits at position q_offset + i;
    masked: kv_pos > q_pos when `causal`, q_pos - kv_pos >= window unless
    `is_global`. Replaces `flash_attention_pallas` (without its tile
    sizes, and without its divisibility assert)."""
    dev = _device_of(q)
    if dev.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             is_global=is_global, q_offset=q_offset)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    _check("q", q, q.dtype, 4, dev)
    _check("k", k, q.dtype, 4, dev)
    _check("v", v, q.dtype, 4, dev)
    B, Sq, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    if k.shape != (B, Skv, KH, D) or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} disagree")
    if KH == 0 or H % KH != 0:
        raise ValueError(f"{H} query heads do not group over {KH} KV heads")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} outside [1, {MAX_HEAD_DIM}]")
    if Skv == 0 or q_offset < 0:
        raise ValueError(f"needs Skv >= 1 and q_offset >= 0, got {Skv}, "
                         f"{q_offset}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
        Skv, H, KH, D, int(bool(causal)), int(window), int(bool(is_global)),
        int(q_offset), 1.0 / math.sqrt(D), int(q.dtype == torch.bfloat16),
        stream)
    _raise_on(rc, "flash_attention_fwd")
    LAUNCHES["flash_attention_fwd"] += 1
    return out
