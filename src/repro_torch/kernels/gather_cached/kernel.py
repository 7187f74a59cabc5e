"""Wrapper of the hand-written CUDA two-level gather
(`csrc/gather_cached.cu`), the counterpart of `gather_cached_fwd_pallas`
in `repro/kernels/gather_cached/kernel.py`.

Dispatch goes by the tensors' device: CPU tensors take the plain PyTorch
version (`ref.py`), CUDA tensors launch the kernel — or raise. There is no
fallback from a failed launch. The wrapper counts its launches in
`LAUNCHES` (kernel launches only, never the plain path).
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gather_agg.kernel import (_check, _device_of,
                                                   _raise_on)
from repro_torch.kernels.gather_cached.ref import gather_cached_ref

LAUNCHES: Dict[str, int] = {"gather_cached_fwd": 0}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("gather_cached")
    if not getattr(lib, "_typed", False):
        lib.gather_cached_fwd.argtypes = [_P] * 5 + [_I64] * 3 + [_P]
        lib.gather_cached_fwd.restype = ctypes.c_int
        lib._typed = True
    return lib


def gather_cached_fwd(cache: torch.Tensor, feats: torch.Tensor,
                      pos: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """out[k] = cache[pos[g]] if 0 <= ids[k] < N and pos[g] >= 0, else
    feats[g], with g = clip(ids[k], 0, N - 1) -> (M, F) float32.

    cache: (C, F) float32; feats: (N, F) float32; pos: (N,) int32 with
    every value in [-1, C); ids: (M,) int32. Replaces
    `gather_cached_fwd_pallas`."""
    dev = _device_of(feats)
    if dev.type == "cpu":
        return gather_cached_ref(cache, feats, pos, ids)
    _check("cache", cache, torch.float32, 2, dev)
    _check("feats", feats, torch.float32, 2, dev)
    _check("pos", pos, torch.int32, 1, dev)
    _check("ids", ids, torch.int32, 1, dev)
    N, F = feats.shape
    if cache.shape[1] != F or pos.shape[0] != N:
        raise ValueError(f"shapes cache {tuple(cache.shape)}, feats "
                         f"{tuple(feats.shape)}, pos {tuple(pos.shape)} "
                         f"disagree")
    M = ids.shape[0]
    out = torch.empty((M, F), dtype=torch.float32, device=dev)
    if M == 0 or F == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib().gather_cached_fwd(cache.data_ptr(), feats.data_ptr(),
                                  pos.data_ptr(), ids.data_ptr(),
                                  out.data_ptr(), M, N, F, stream)
    _raise_on(rc, "gather_cached_fwd")
    LAUNCHES["gather_cached_fwd"] += 1
    return out
