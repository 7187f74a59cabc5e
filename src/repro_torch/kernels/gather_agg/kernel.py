"""Wrappers of the hand-written CUDA gather-aggregate kernels
(`csrc/gather_agg.cu`), counterparts of the Pallas kernels in
`repro/kernels/gather_agg/kernel.py`.

Dispatch goes by the tensors' device: CPU tensors take the plain PyTorch
version (`ref.py`), CUDA tensors launch the kernel — or raise. There is no
fallback from a failed launch. Each wrapper counts its launches in
`LAUNCHES` (kernel launches only, never the plain path), so a run can show
that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gather_agg.ref import (gather_agg_bwd_dw_ref,
                                                gather_agg_bwd_dx_ref,
                                                gather_agg_ref)

LAUNCHES: Dict[str, int] = {"gather_agg_fwd": 0, "gather_agg_bwd_dx": 0,
                            "gather_agg_bwd_dw": 0}
# longest run of edges one block of the backward sums (see csrc/gather_agg.cu)
BWD_CHUNK = 64

_P = ctypes.c_void_p
_I64 = ctypes.c_int64


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("gather_agg")
    if not getattr(lib, "_typed", False):
        lib.gather_agg_fwd.argtypes = [_P, _P, _P, _P, _I64, _I64, _I64, _P]
        lib.gather_agg_fwd.restype = ctypes.c_int
        lib.gather_agg_bwd_dx.argtypes = [_P] * 9 + [_I64] * 4 + [_P]
        lib.gather_agg_bwd_dx.restype = ctypes.c_int
        lib.gather_agg_bwd_dw.argtypes = [_P, _P, _P, _P, _I64, _I64, _I64,
                                          _P]
        lib.gather_agg_bwd_dw.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _device_of(t: torch.Tensor) -> torch.device:
    dev = t.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def gather_agg_fwd(x: torch.Tensor, idx: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """out[i] = sum_j w[i, j] * x[idx[i, j]] -> (n_dst, F) float32.

    x: (n_src, F) float32; idx: (n_dst, r) int32 with every value in
    [0, n_src) (the caller clips, as `ops.gather_agg` does); w: (n_dst, r)
    float32. Replaces `gather_agg_fwd_pallas`."""
    dev = _device_of(x)
    if dev.type == "cpu":
        return gather_agg_ref(x, idx, w)
    _check("x", x, torch.float32, 2, dev)
    _check("idx", idx, torch.int32, 2, dev)
    _check("w", w, torch.float32, 2, dev)
    n_dst, r = idx.shape
    if w.shape != idx.shape:
        raise ValueError(f"w {tuple(w.shape)} != idx {tuple(idx.shape)}")
    F = x.shape[1]
    out = torch.empty((n_dst, F), dtype=torch.float32, device=dev)
    if n_dst == 0 or F == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib().gather_agg_fwd(x.data_ptr(), idx.data_ptr(), w.data_ptr(),
                               out.data_ptr(), n_dst, r, F, stream)
    _raise_on(rc, "gather_agg_fwd")
    LAUNCHES["gather_agg_fwd"] += 1
    return out


@dataclass
class BwdDxPlan:
    """The backward's glue, computed outside the kernel as the reference
    argsorts outside its Pallas body: edges stably sorted by source row,
    each row's [start, end) run, and the cut of every run into chunks of
    at most `chunk` edges. All shapes are static, so there is no host
    sync."""
    dst_sorted: torch.Tensor    # (E,) int32 destination row of each edge
    w_sorted: torch.Tensor      # (E,) float32
    row_start: torch.Tensor     # (n_src,) int32
    row_end: torch.Tensor       # (n_src,) int32
    chunk_first: torch.Tensor   # (n_src,) int32 first chunk id of each row
    multi_first: torch.Tensor   # (n_src,) int32 first scratch row (multi-
    #                             chunk rows only)
    chunk: int
    n_chunks_max: int           # bound on the chunk count: the grid size
    n_partial_max: int          # bound on the scratch rows


def bwd_dx_plan(idx: torch.Tensor, w: torch.Tensor, n_src: int,
                chunk: int = BWD_CHUNK) -> BwdDxPlan:
    r = idx.shape[1]
    E = idx.numel()
    src_sorted, order = torch.sort(idx.reshape(-1), stable=True)
    rows = torch.arange(n_src, dtype=src_sorted.dtype, device=idx.device)
    row_start = torch.searchsorted(src_sorted, rows, out_int32=True)
    row_end = torch.searchsorted(src_sorted, rows, right=True,
                                 out_int32=True)
    count = row_end - row_start
    nch = torch.where(count > chunk, (count + chunk - 1) // chunk, 1)
    multi = torch.where(nch > 1, nch, 0)
    per_run = -(-E // chunk)
    return BwdDxPlan(
        dst_sorted=torch.div(order, r, rounding_mode="floor").to(torch.int32),
        w_sorted=w.reshape(-1)[order].contiguous(),
        row_start=row_start, row_end=row_end,
        chunk_first=(torch.cumsum(nch, 0) - nch).to(torch.int32),
        multi_first=(torch.cumsum(multi, 0) - multi).to(torch.int32),
        chunk=chunk,
        # sum of max(1, ceil(count / chunk)) <= n_src + E / chunk; a row of
        # more than `chunk` edges has fewer than 2 * count / chunk chunks
        n_chunks_max=n_src + per_run,
        n_partial_max=max(1, 2 * per_run))


def gather_agg_bwd_dx(idx: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                      n_src: int) -> torch.Tensor:
    """dx[idx[i, j]] += w[i, j] * g[i] -> (n_src, F) float32, each row
    summed in a fixed order (sorted edges, in chunks of `BWD_CHUNK`):
    deterministic, no atomics. Replaces `gather_agg_bwd_dx_pallas`."""
    dev = _device_of(g)
    if dev.type == "cpu":
        return gather_agg_bwd_dx_ref(idx, w, g, n_src)
    _check("idx", idx, torch.int32, 2, dev)
    _check("w", w, torch.float32, 2, dev)
    _check("g", g, torch.float32, 2, dev)
    if w.shape != idx.shape or g.shape[0] != idx.shape[0]:
        raise ValueError(f"shapes idx {tuple(idx.shape)}, w "
                         f"{tuple(w.shape)}, g {tuple(g.shape)} disagree")
    F = g.shape[1]
    dx = torch.empty((n_src, F), dtype=torch.float32, device=dev)
    if n_src == 0 or F == 0:
        return dx
    plan = bwd_dx_plan(idx, w, n_src)
    partial = torch.empty((plan.n_partial_max, F), dtype=torch.float32,
                          device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib().gather_agg_bwd_dx(
        g.data_ptr(), plan.dst_sorted.data_ptr(), plan.w_sorted.data_ptr(),
        plan.row_start.data_ptr(), plan.row_end.data_ptr(),
        plan.chunk_first.data_ptr(), plan.multi_first.data_ptr(),
        dx.data_ptr(), partial.data_ptr(), n_src, F, plan.chunk,
        plan.n_chunks_max, stream)
    _raise_on(rc, "gather_agg_bwd_dx")
    LAUNCHES["gather_agg_bwd_dx"] += 1
    return dx


def gather_agg_bwd_dw(x: torch.Tensor, idx: torch.Tensor,
                      g: torch.Tensor) -> torch.Tensor:
    """dw[i, j] = <g[i], x[idx[i, j]]> -> (n_dst, r) float32, each dot
    summed in a fixed order: deterministic, no atomics. Replaces
    `gather_agg_bwd_dw_pallas` (without its 128-lane padding of r).

    x: (n_src, F) float32; idx: (n_dst, r) int32 in [0, n_src);
    g: (n_dst, F) float32."""
    dev = _device_of(g)
    if dev.type == "cpu":
        return gather_agg_bwd_dw_ref(x, idx, g)
    _check("x", x, torch.float32, 2, dev)
    _check("idx", idx, torch.int32, 2, dev)
    _check("g", g, torch.float32, 2, dev)
    if g.shape != (idx.shape[0], x.shape[1]):
        raise ValueError(f"shapes x {tuple(x.shape)}, idx "
                         f"{tuple(idx.shape)}, g {tuple(g.shape)} disagree")
    n_dst, r = idx.shape
    dw = torch.empty((n_dst, r), dtype=torch.float32, device=dev)
    if n_dst == 0 or r == 0:
        return dw
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib().gather_agg_bwd_dw(x.data_ptr(), idx.data_ptr(), g.data_ptr(),
                                  dw.data_ptr(), n_dst, r, x.shape[1],
                                  stream)
    _raise_on(rc, "gather_agg_bwd_dw")
    LAUNCHES["gather_agg_bwd_dw"] += 1
    return dw
