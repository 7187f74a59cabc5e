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
from dataclasses import dataclass, replace
from typing import Dict, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gather_agg.ref import (gather_agg_bwd_dw_ref,
                                                gather_agg_bwd_dx_ref,
                                                gather_agg_ref)

LAUNCHES: Dict[str, int] = {"gather_agg_fwd": 0, "gather_agg_bwd_dx": 0,
                            "gather_agg_bwd_dw": 0}
# backward plans built on the card (each one sort of an index)
PLANS: Dict[str, int] = {"gather_agg_bwd_dx": 0}
# longest run of edges the backward sums whole, and the width of the
# windows it cuts longer runs at (kChunk in csrc/gather_agg.cu)
BWD_CHUNK = 64
# scratch bytes of the plan's sort, by edge count
_PLAN_BYTES: Dict[int, int] = {}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64


def reset_launches() -> None:
    for counts in (LAUNCHES, PLANS):
        for k in counts:
            counts[k] = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("gather_agg")
    if not getattr(lib, "_typed", False):
        lib.gather_agg_fwd.argtypes = [_P, _P, _P, _P, _I64, _I64, _I64, _P]
        lib.gather_agg_fwd.restype = ctypes.c_int
        lib.gather_agg_bwd_dx_plan_bytes.argtypes = [_I64]
        lib.gather_agg_bwd_dx_plan_bytes.restype = _I64
        lib.gather_agg_bwd_dx_plan.argtypes = [_P] * 6 + [_I64] * 4 + [_P]
        lib.gather_agg_bwd_dx_plan.restype = ctypes.c_int
        lib.gather_agg_bwd_dx.argtypes = [_P] * 7 + [_I64] * 5 + [_P]
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


def _stream(dev: torch.device) -> int:
    """The raw handle of the current stream on `dev`, read with
    `_cuda_getCurrentRawStream`: `torch.cuda.current_stream(dev)` builds a
    Stream object, which costs more host time than a launch."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def gather_agg_fwd(x: torch.Tensor, idx: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """out[i] = sum_j w[i, j] * x[idx[i, j]] -> (n_dst, F) float32, each
    row summed from 0 in j order, multiply then add: on the card equal to
    `ref.gather_agg_ref_ordered` bit for bit.

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
    stream = _stream(dev)
    rc = _lib().gather_agg_fwd(x.data_ptr(), idx.data_ptr(), w.data_ptr(),
                               out.data_ptr(), n_dst, r, F, stream)
    _raise_on(rc, "gather_agg_fwd")
    LAUNCHES["gather_agg_fwd"] += 1
    return out


@dataclass(frozen=True)
class BwdDxPlan:
    """What the backward needs of an index, and nothing of its weights: the
    keys stably sorted (the reference's by-source order; it argsorts
    outside its Pallas body too), the flat edge id of each sorted
    position and each source row's run offsets. Built once per index
    (`bwd_dx_plan`: one sort and the offsets, no host sync) and
    shared by every launch over that index, whatever its weights.

    `heads` H > 1 makes the plan of `idx` serve the head-folded index
    `idx * H + h` of shape (n_dst * H, r) over n_src * H rows (GAT): row
    s * H + h walks s's run with destination i * H + h, which is the order
    a stable sort of the folded index gives."""
    keys: torch.Tensor          # (E,) int32 sorted source rows
    order: torch.Tensor         # (E,) int32 flat edge id per position
    row_ptr: torch.Tensor       # (n_src + 1,) int32: row s's run is
    #                             [row_ptr[s], row_ptr[s + 1])
    n_src: int
    r: int                      # edges per destination row of the index
    heads: int = 1

    def folded(self, heads: int) -> "BwdDxPlan":
        return replace(self, heads=heads)


def bwd_dx_plan(idx: torch.Tensor, n_src: int) -> BwdDxPlan:
    """The plan of `idx` (int32, every value in [0, n_src)), no host sync.
    On the card one C call sorts the keys (CUB's stable radix sort over the
    bits [0, n_src) needs) and finds the run offsets, trapping on a value
    out of range; the plan is counted in `PLANS`. On the CPU: `torch.sort`
    and `searchsorted`."""
    r = idx.shape[1] if idx.dim() == 2 else 1
    flat = idx.reshape(-1)
    if flat.device.type == "cpu":
        keys, order = torch.sort(flat, stable=True)
        bounds = torch.arange(n_src + 1, dtype=keys.dtype)
        return BwdDxPlan(keys, order.to(torch.int32), torch.searchsorted(
            keys, bounds, out_int32=True), n_src, r)
    dev = flat.device
    _check("idx", flat, torch.int32, 1, dev)
    E = flat.numel()
    if E >= 2 ** 31:
        raise ValueError(f"{E} edges: the kernel takes < 2^31")
    lib = _lib()
    temp = _PLAN_BYTES.get(E)
    if temp is None:
        # analysis: allow[no-host-sync-in-hot-path] -- a host integer from the C side's size query, no device operand
        temp = _PLAN_BYTES[E] = int(lib.gather_agg_bwd_dx_plan_bytes(E))
    # one buffer: the sort's scratch (256-byte aligned), keys, order, the
    # edge ids it sorts, row_ptr
    t = -(-temp // 256) * 64
    buf = torch.empty((t + 3 * E + n_src + 1,), dtype=torch.int32,
                      device=dev)
    _, keys, order, ids, row_ptr = buf.split_with_sizes(
        (t, E, E, E, n_src + 1))
    stream = _stream(dev)
    rc = lib.gather_agg_bwd_dx_plan(
        flat.data_ptr(), keys.data_ptr(), order.data_ptr(),
        row_ptr.data_ptr(), ids.data_ptr(), buf.data_ptr(), temp, E, n_src,
        max(1, (n_src - 1).bit_length()), stream)
    _raise_on(rc, "gather_agg_bwd_dx_plan")
    PLANS["gather_agg_bwd_dx"] += 1
    return BwdDxPlan(keys, order, row_ptr, n_src, r)


def _check_dx_args(idx, w, g, dev) -> None:
    _check("idx", idx, torch.int32, 2, dev)
    _check("g", g, torch.float32, 2, dev)
    if w is not None:
        _check("w", w, torch.float32, 2, dev)
    if (w is not None and w.shape != idx.shape) or g.shape[0] != \
            idx.shape[0]:
        raise ValueError(f"shapes idx {tuple(idx.shape)}, w "
                         f"{None if w is None else tuple(w.shape)}, g "
                         f"{tuple(g.shape)} disagree")
    if idx.numel() >= 2 ** 31:
        raise ValueError(f"{idx.numel()} edges: the kernel takes < 2^31")


def _launch_dx(keys, order, row_ptr, w, g, n: int, r: int, heads: int,
               dev) -> torch.Tensor:
    """One bwd_dx call, counted as one launch: rows and the pieces of
    long runs, then the two levels of the pieces' sum (one cooperative
    kernel when its tasks fit on the card at once, else three kernels)."""
    F = g.shape[1]
    E = keys.numel()
    n_out = n * heads
    # scratch: two slots per window of BWD_CHUNK sorted edges and head,
    # allocated with dx in one buffer
    n_part = 2 * (-(-E // BWD_CHUNK)) * heads
    buf = torch.empty((n_out + n_part, F), dtype=torch.float32, device=dev)
    dx = buf[:n_out]
    if n_out == 0 or F == 0:
        return dx
    stream = _stream(dev)
    rc = _lib().gather_agg_bwd_dx(
        g.data_ptr(), keys.data_ptr(),
        None if order is None else order.data_ptr(),
        None if row_ptr is None else row_ptr.data_ptr(),
        None if w is None else w.data_ptr(), dx.data_ptr(),
        dx.data_ptr() + n_out * F * 4, n, E, r, heads, F, stream)
    _raise_on(rc, "gather_agg_bwd_dx")
    LAUNCHES["gather_agg_bwd_dx"] += 1
    return dx


def gather_agg_bwd_dx(idx: torch.Tensor, w: Optional[torch.Tensor],
                      g: torch.Tensor, n_src: int,
                      plan: Optional[BwdDxPlan] = None) -> torch.Tensor:
    """dx[idx[i, j]] += w[i, j] * g[i] -> (n_src, F) float32, each row
    summed from 0 in the stable by-source order (rows of more than
    `BWD_CHUNK` edges in chunks, combined in order): deterministic, no
    atomics. Replaces `gather_agg_bwd_dx_pallas`.

    idx: (n_dst, r) int32 in [0, n_src); w: (n_dst, r) float32, or None
    for unit weights; g: (n_dst, F) float32. `plan`: the plan of this
    index (`bwd_dx_plan`, or a plan of the base index `folded` to its
    heads); without one the call builds its own, one sort."""
    dev = _device_of(g)
    if dev.type == "cpu":
        return gather_agg_bwd_dx_ref(idx, w, g, n_src)
    _check_dx_args(idx, w, g, dev)
    if plan is None:
        plan = bwd_dx_plan(idx, n_src)
    H = plan.heads
    n_dst, r = idx.shape
    # any view of the plan's flat edges serves unfolded (a fanout-1 call
    # over a (n_dst, r) index, as `gather_rows` makes); a folded call has
    # the index's own r
    if plan.keys.device != dev or plan.n_src * H != n_src or \
            plan.keys.numel() * H != idx.numel() or \
            (H > 1 and r != plan.r):
        raise ValueError(
            f"plan of {plan.keys.numel()} edges over {plan.n_src} rows x "
            f"{H} heads does not describe idx {tuple(idx.shape)} over "
            f"{n_src} rows")
    return _launch_dx(plan.keys, plan.order, plan.row_ptr, w, g,
                      plan.n_src, r, H, dev)


def gather_agg_bwd_dx_sorted(idx: torch.Tensor, w: Optional[torch.Tensor],
                             g: torch.Tensor, n_src: int) -> torch.Tensor:
    """`gather_agg_bwd_dx` for an index whose flat values are
    non-decreasing (a level's self rows): no plan and no sort; each row
    finds its run by binary search in idx. The kernel checks the order and
    the range of idx and traps on a violation (a launch error, never a
    wrong dx); on the CPU a violation raises ValueError."""
    dev = _device_of(g)
    flat = idx.reshape(-1)
    if dev.type == "cpu":
        # the order check reads the CPU tensor's memory in place (the
        # card's kernel traps instead)
        # analysis: allow[no-host-sync-in-hot-path] -- a CPU tensor viewed as numpy: host memory, no device involved
        a = flat.numpy()
        if a.size > 1 and (a[1:] < a[:-1]).any():
            raise ValueError("gather_agg_bwd_dx_sorted: idx is not "
                             "non-decreasing")
        return gather_agg_bwd_dx_ref(idx, w, g, n_src)
    _check_dx_args(idx, w, g, dev)
    return _launch_dx(flat, None, None, w, g, n_src, idx.shape[1], 1, dev)


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
    stream = _stream(dev)
    rc = _lib().gather_agg_bwd_dw(x.data_ptr(), idx.data_ptr(), g.data_ptr(),
                                  dw.data_ptr(), n_dst, r, x.shape[1],
                                  stream)
    _raise_on(rc, "gather_agg_bwd_dw")
    LAUNCHES["gather_agg_bwd_dw"] += 1
    return dw
