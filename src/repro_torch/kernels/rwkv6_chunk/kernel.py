"""Wrapper of the hand-written CUDA WKV6 chunk kernel (`csrc/wkv6.cu`), the
counterpart of `wkv6_pallas` in `repro/kernels/rwkv6_chunk/kernel.py`.

Dispatch goes by the tensors' device: CPU tensors take the plain PyTorch
version (`ref.py`), CUDA tensors launch the kernel — or raise. There is no
fallback from a failed launch. The wrapper counts its launches in
`LAUNCHES` (kernel launches only, never the plain path).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gather_agg.kernel import (_check, _device_of,
                                                   _raise_on)
from repro_torch.kernels.rwkv6_chunk.ref import wkv6_fwd_ref

LAUNCHES: Dict[str, int] = {"wkv6_fwd": 0}
MAX_HEAD_DIM = 64

_P = ctypes.c_void_p
_I64 = ctypes.c_int64


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("wkv6")
    if not getattr(lib, "_typed", False):
        lib.wkv6_fwd.argtypes = [_P] * 8 + [_I64] * 5 + [_P]
        lib.wkv6_fwd.restype = ctypes.c_int
        lib._typed = True
    return lib


def wkv6_fwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             logw: torch.Tensor, u: torch.Tensor,
             s0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The WKV6 recurrence from state `s0` (zeros when None) in chunks of
    16 steps -> (out (B, T, H, N) float32, final state (B, H, N, N)
    float32).

    r, k, v: (B, T, H, N), float32 or bfloat16, all three alike; logw:
    (B, T, H, N) float32; u: (H, N) float32; s0: (B, H, N, N) float32;
    all contiguous. Any T >= 1 and N <= 64. Replaces `wkv6_pallas`, which
    starts from zero, drops the final state and asserts `T % 16 == 0`."""
    dev = _device_of(r)
    if dev.type == "cpu":
        return wkv6_fwd_ref(r, k, v, logw, u, s0)
    if r.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"r must be float32 or bfloat16, got {r.dtype}")
    _check("r", r, r.dtype, 4, dev)
    _check("k", k, r.dtype, 4, dev)
    _check("v", v, r.dtype, 4, dev)
    _check("logw", logw, torch.float32, 4, dev)
    _check("u", u, torch.float32, 2, dev)
    B, T, H, N = r.shape
    for name, t in (("k", k), ("v", v), ("logw", logw)):
        if t.shape != r.shape:
            raise ValueError(f"{name} {tuple(t.shape)} and r "
                             f"{tuple(r.shape)} disagree")
    if tuple(u.shape) != (H, N):
        raise ValueError(f"u {tuple(u.shape)} is not {(H, N)}")
    if s0 is not None:
        _check("s0", s0, torch.float32, 4, dev)
        if tuple(s0.shape) != (B, H, N, N):
            raise ValueError(f"s0 {tuple(s0.shape)} is not {(B, H, N, N)}")
    if T < 1 or not 1 <= N <= MAX_HEAD_DIM:
        raise ValueError(f"T {T} must be >= 1 and N {N} in 1..{MAX_HEAD_DIM}")
    out = torch.empty((B, T, H, N), dtype=torch.float32, device=dev)
    s_final = torch.empty((B, H, N, N), dtype=torch.float32, device=dev)
    if B * H == 0:
        return out, s_final
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib().wkv6_fwd(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                         logw.data_ptr(), u.data_ptr(),
                         None if s0 is None else s0.data_ptr(),
                         out.data_ptr(), s_final.data_ptr(), B, T, H, N,
                         int(r.dtype == torch.bfloat16), stream)
    _raise_on(rc, "wkv6_fwd")
    LAUNCHES["wkv6_fwd"] += 1
    return out, s_final
