"""Wrappers of the hand-written CUDA flash-attention kernels: the forward
(`csrc/flash_attention.cu`), the counterpart of `flash_attention_pallas`
in `repro/kernels/flash_attention/kernel.py`, and the backward
(`csrc/flash_attention_bwd.cu`), the counterpart of the reference's jnp
custom-VJP backward `_flash_bwd` (`repro/models/lm/attention.py:107`),
which has no Pallas kernel.

Dispatch goes by the tensors' device: CPU tensors take the plain PyTorch
version (`ref.py`), CUDA tensors launch a kernel — or raise. On the card
`route` picks the kernel explicitly, each with its own C entry point: the
tensor-core kernel (`flash_attention_fwd_tc`: wgmma fed by TMA) for bf16
q, k, v at D 64, 128 or 256 with 16-byte aligned pointers and row
strides; the exact SIMT kernel (`flash_attention_fwd`) for float32 and
for bf16 at any other D or alignment. There is no fallback from a failed
launch to the other kernel or to the plain version. The forward writes
the rows' log-sum-exp too when asked (`return_lse`, the training
forward), which the backward takes. The backward has the same two routes
(`bwd_route`): `flash_attention_bwd_tc` (wgmma fed by TMA, P and dS
rounded to bf16 as operands of the dV, dK and dQ products) and the exact
SIMT `flash_attention_bwd`. The wrappers count their launches in
`LAUNCHES` (kernel launches only, never the plain path), which kernel
each forward took in `ROUTES` and each backward in `BWD_ROUTES`.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import (attention_lse_ref,
                                                     attention_ref,
                                                     flash_attention_bwd_ref)
from repro_torch.kernels.gather_agg.kernel import (_check, _device_of,
                                                   _raise_on)

LAUNCHES: Dict[str, int] = {"flash_attention_fwd": 0,
                            "flash_attention_bwd": 0}
ROUTES: Dict[str, int] = {"tensor_core": 0, "simt": 0}
BWD_ROUTES: Dict[str, int] = {"tensor_core": 0, "simt": 0}
MAX_HEAD_DIM = 256
TC_HEAD_DIMS = (64, 128, 256)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTES, BWD_ROUTES):
        for k in counts:
            counts[k] = 0


def tc_kv_tile(head_dim: int) -> int:
    """Keys per KV tile of the tensor-core kernel (`Cfg::kBK` in the
    source): the tiles over which its running row max, and so its bf16
    rounding of p, proceeds."""
    return 64 if head_dim >= 256 else 128


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel a CUDA call takes: "tensor_core" for bf16 at D 64, 128
    or 256 with every pointer 16-byte aligned and the row strides H D 2
    and KH D 2 bytes multiples of 16 (what TMA reads), else "simt"."""
    D, H, KH = q.shape[3], q.shape[2], k.shape[2]
    if (q.dtype == torch.bfloat16 and D in TC_HEAD_DIMS
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v))
            and H * D * 2 % 16 == 0 and KH * D * 2 % 16 == 0):
        return "tensor_core"
    return "simt"


def bwd_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              out: torch.Tensor, dout: torch.Tensor) -> str:
    """The backward kernel a CUDA call takes: `route`'s rule, with out and
    dout 16-byte aligned too."""
    if route(q, k, v) == "tensor_core" \
            and out.data_ptr() % 16 == 0 and dout.data_ptr() % 16 == 0:
        return "tensor_core"
    return "simt"


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        lib.flash_attention_fwd.argtypes = [_P] * 4 + [_I64] * 10 + [
            ctypes.c_float, _I64, _P, _P]
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib.flash_attention_fwd_tc.argtypes = [_P] * 4 + [_I64] * 10 + [
            ctypes.c_float, _P, _P]
        lib.flash_attention_fwd_tc.restype = ctypes.c_int
        lib._typed = True
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("flash_attention_bwd")
    if not getattr(lib, "_typed", False):
        lib.flash_attention_bwd.argtypes = [_P] * 10 + [_I64] * 10 + [
            ctypes.c_float, _I64, _P]
        lib.flash_attention_bwd.restype = ctypes.c_int
        lib.flash_attention_bwd_tc.argtypes = [_P] * 10 + [_I64] * 10 + [
            ctypes.c_float, _P]
        lib.flash_attention_bwd_tc.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check_qkv(q, k, v, dev):
    """Dtype, layout and shape checks of a CUDA call; returns (B, Sq, H,
    D, Skv, KH)."""
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
    return B, Sq, H, D, Skv, KH


def _c_ints(causal, window, is_global, q_offset) -> tuple:
    """The C calls' flag and integer arguments (causal, window, is_global,
    q_offset)."""
    # analysis: allow[no-host-sync-in-hot-path] -- host values for the C call's arguments, no device operand
    causal, is_global = int(bool(causal)), int(bool(is_global))
    # analysis: allow[no-host-sync-in-hot-path] -- host values for the C call's arguments, no device operand
    return causal, int(window), is_global, int(q_offset)


def _bf16_flag(t: torch.Tensor) -> int:
    # analysis: allow[no-host-sync-in-hot-path] -- host values for the C call's arguments, no device operand
    return int(t.dtype == torch.bfloat16)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 1 << 30,
                        is_global: bool = True, q_offset: int = 0,
                        return_lse: bool = False):
    """softmax(q k^T / sqrt(D) + mask) v -> (B, Sq, H, D) in q's dtype;
    with `return_lse`, (out, lse): lse (B, H, Sq) float32, each query
    row's log-sum-exp of its masked scores (`ref.attention_lse_ref`), which
    the backward takes.

    q: (B, Sq, H, D); k, v: (B, Skv, KH, D) with H % KH == 0 (head h reads
    KV head h // (H / KH)); float32 or bfloat16, all three alike; any Sq
    and Skv >= 1, D <= 256. Query row i sits at position q_offset + i;
    masked: kv_pos > q_pos when `causal`, q_pos - kv_pos >= window unless
    `is_global`. Replaces `flash_attention_pallas` (without its tile
    sizes, and without its divisibility assert). The tensor-core route
    rounds p to bf16 for its P V product, as the TPU's MXU does at
    DEFAULT precision: `ref.attention_ref(..., p_bf16=True,
    kv_tile=tc_kv_tile(D))` emulates it."""
    dev = _device_of(q)
    kw = dict(causal=causal, window=window, is_global=is_global,
              q_offset=q_offset)
    if dev.type == "cpu":
        out = attention_ref(q, k, v, **kw)
        return (out, attention_lse_ref(q, k, **kw)) if return_lse else out
    B, Sq, H, D, Skv, KH = _check_qkv(q, k, v, dev)
    if Skv == 0 or q_offset < 0:
        raise ValueError(f"needs Skv >= 1 and q_offset >= 0, got {Skv}, "
                         f"{q_offset}")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev) \
        if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Skv, H, KH, D, *_c_ints(causal, window, is_global, q_offset),
            1.0 / math.sqrt(D))
    lse_ptr = None if lse is None else lse.data_ptr()
    kind = route(q, k, v)
    if kind == "tensor_core":
        rc = _lib().flash_attention_fwd_tc(*args, lse_ptr, stream)
    else:
        rc = _lib().flash_attention_fwd(*args, _bf16_flag(q), lse_ptr,
                                        stream)
    _raise_on(rc, f"flash_attention_fwd ({kind})")
    LAUNCHES["flash_attention_fwd"] += 1
    ROUTES[kind] += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: int = 1 << 30, is_global: bool = True,
                        q_offset: int = 0):
    """(dq, dk, dv) of `flash_attention_fwd` at (q, k, v), in their dtype:
    the counterpart of the reference's `_flash_bwd`. out and dout: (B, Sq,
    H, D) like q; lse: (B, H, Sq) float32 from the same forward. dk and
    dv sum over the query heads of each KV head. On the card one C call
    launches the delta pass and the dk / dv and dq kernels (float32 sums,
    no atomics: a relaunch is bit-identical) on the route `bwd_route`
    picks. The tensor-core route rounds P and dS to bf16 as operands of
    the dV, dK and dQ products: `ref.flash_attention_bwd_ref(...,
    pds_bf16=True)` emulates it. CPU tensors take
    `ref.flash_attention_bwd_ref`."""
    dev = _device_of(q)
    kw = dict(causal=causal, window=window, is_global=is_global,
              q_offset=q_offset)
    if dev.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    B, Sq, H, D, Skv, KH = _check_qkv(q, k, v, dev)
    _check("out", out, q.dtype, 4, dev)
    _check("dout", dout, q.dtype, 4, dev)
    _check("lse", lse, torch.float32, 3, dev)
    if out.shape != q.shape or dout.shape != q.shape \
            or lse.shape != (B, H, Sq):
        raise ValueError(f"out {tuple(out.shape)}, dout "
                         f"{tuple(dout.shape)}, lse {tuple(lse.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if q_offset < 0:
        raise ValueError(f"needs q_offset >= 0, got {q_offset}")
    return _launch_bwd(bwd_route(q, k, v, out, dout), q, k, v, out, lse,
                       dout, **kw)


def _launch_bwd(kind, q, k, v, out, lse, dout, *, causal, window,
                is_global, q_offset):
    """One C call of the backward on route `kind`, on inputs
    `flash_attention_bwd` has checked. "simt" also takes bf16, so
    `chip_smoke.py` times the SIMT parent on the tensor-core route's
    inputs through it."""
    B, Sq, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, Sq, Skv, H, KH, D,
            *_c_ints(causal, window, is_global, q_offset),
            1.0 / math.sqrt(D))
    if kind == "tensor_core":
        rc = _bwd_lib().flash_attention_bwd_tc(*args, stream)
    else:
        rc = _bwd_lib().flash_attention_bwd(*args, _bf16_flag(q), stream)
    _raise_on(rc, f"flash_attention_bwd ({kind})")
    LAUNCHES["flash_attention_bwd"] += 1
    BWD_ROUTES[kind] += 1
    return dq, dk, dv
