"""Wrapper of the hand-written CUDA grouped expert matmul
(`csrc/moe_gmm.cu`), the counterpart of `moe_gmm_pallas` in
`repro/kernels/moe_gmm/kernel.py`.

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
from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref

LAUNCHES: Dict[str, int] = {"moe_gmm_fwd": 0}
MAX_GRID = 65535               # the kernel's grid: E in grid.z, C / 16
#                                row tiles in grid.y

_P = ctypes.c_void_p
_I64 = ctypes.c_int64


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("moe_gmm")
    if not getattr(lib, "_typed", False):
        lib.moe_gmm_fwd.argtypes = [_P] * 3 + [_I64] * 5 + [_P]
        lib.moe_gmm_fwd.restype = ctypes.c_int
        lib._typed = True
    return lib


def moe_gmm_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """out[e] = x[e] @ w[e] -> (E, C, f) float32, products and sums in
    float32.

    x: (E, C, d); w: (E, d, f); both float32 or both bfloat16, contiguous;
    E up to 65535, C up to 16 * 65535, any d and f. Replaces
    `moe_gmm_pallas` (without its tile sizes, and without its
    divisibility assert)."""
    dev = _device_of(x)
    if dev.type == "cpu":
        return moe_gmm_ref(x, w)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    _check("x", x, x.dtype, 3, dev)
    _check("w", w, x.dtype, 3, dev)
    E, C, d = x.shape
    f = w.shape[2]
    if w.shape[:2] != (E, d):
        raise ValueError(f"shapes x {tuple(x.shape)} and w {tuple(w.shape)} "
                         f"disagree")
    if E > MAX_GRID or -(-C // 16) > MAX_GRID or max(d, f) > 1 << 30:
        raise ValueError(f"shape {(E, C, d, f)} beyond the kernel's grid")
    out = torch.empty((E, C, f), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib().moe_gmm_fwd(x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C,
                            d, f, int(x.dtype == torch.bfloat16), stream)
    _raise_on(rc, "moe_gmm_fwd")
    LAUNCHES["moe_gmm_fwd"] += 1
    return out
