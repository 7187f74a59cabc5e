"""Wrappers of the hand-written CUDA grouped expert matmul
(`csrc/moe_gmm.cu`), the counterpart of `moe_gmm_pallas` in
`repro/kernels/moe_gmm/kernel.py`, with the epilogues the MoE layer uses,
and of its backward (`csrc/moe_gmm_bwd.cu`: `moe_gmm_bwd_dx`,
`moe_gmm_bwd_dw`, `moe_gmm_gated_bwd`), which has no TPU kernel: the
reference differentiates the layer's einsums (`repro/models/lm/moe.py:
125-127`) with JAX.

Dispatch goes by the tensors' device: CPU tensors take the plain PyTorch
versions (`ref.py`), CUDA tensors launch a kernel — or raise. On the card
`route` picks the forward's kernel: "tensor_core" (wgmma fed by TMA) for
bf16 with 16 < C <= 4096, E <= 256, d and f multiples of 8 and 16-byte
aligned pointers; "mma_sync" for bf16 otherwise (decode, odd widths);
"simt" for float32. `bwd_route` picks the backward's: "tensor_core" for
bf16 dx, dw and the gated backward within the same limits, "mma_sync"
for other bf16 calls (that kernel takes d and f that are multiples of 8
and 16-byte aligned tensors; a call with others raises ValueError),
"simt" for float32. There is no fallback from a
failed launch to another route or to the plain version. Each entry point
counts its launches in its key of `LAUNCHES` (kernel launches only, never
the plain path) and the kernel each took in `ROUTES`.

`rows` (optional, int32 (E, G) on x's device): group g of expert e holds
C / G rows of x, and its rows past rows[e, g] are zero. The kernels skip
the tiles and experts that hold no such row and write zeros there, so the
output is the one without `rows`; the plain versions ignore it. The
backward treats those rows as zero whatever they hold: dx and the gated
backward write zeros there, dw does not sum them; so do their plain
versions.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gather_agg.kernel import (_check, _device_of,
                                                   _raise_on)
from repro_torch.kernels.moe_gmm.ref import (moe_gmm_bwd_dw_ref,
                                             moe_gmm_bwd_dx_ref,
                                             moe_gmm_gated_bwd_ref,
                                             moe_gmm_gated_ref, moe_gmm_ref)

LAUNCHES: Dict[str, int] = {"moe_gmm_fwd": 0, "moe_gmm_bwd_dx": 0,
                            "moe_gmm_bwd_dw": 0, "moe_gmm_gated_bwd": 0}
ROUTES: Dict[str, int] = {"tensor_core": 0, "mma_sync": 0, "simt": 0}
MAX_GRID = 65535               # the kernels' grid: E in grid.z, C / 16
#                                row tiles in grid.y
# the tensor-core route's limits (one 32-bit row-tile mask per expert)
TC_MAX_EXPERTS, TC_MAX_ROWS = 256, 32 * 128
_ROUTE_CODE = {"tensor_core": 0, "mma_sync": 1, "simt": 2}
_BWD_ENTRIES = ("moe_gmm_bwd_dx", "moe_gmm_bwd_dw", "moe_gmm_gated_bwd")
_F32_OUT, _IN_DTYPE_OUT, _GATED = 0, 1, 2      # the epilogue codes

_P = ctypes.c_void_p
_I64 = ctypes.c_int64


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTES):
        for k in counts:
            counts[k] = 0


def route(x: torch.Tensor, *ws: torch.Tensor) -> str:
    """The kernel a CUDA call takes: "simt" for float32; for bf16
    "tensor_core" when 16 < C <= TC_MAX_ROWS, E <= TC_MAX_EXPERTS (its
    tile walk keeps a row-tile mask per expert in shared memory), d and f
    are multiples of 8 (TMA's 16-byte strides) and x and every weight
    start 16-byte aligned, else "mma_sync"."""
    if x.dtype == torch.float32:
        return "simt"
    E, C, d = x.shape
    f = ws[0].shape[2]
    if (16 < C <= TC_MAX_ROWS and E <= TC_MAX_EXPERTS and d > 0
            and d % 8 == 0 and f % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in (x, *ws))):
        return "tensor_core"
    return "mma_sync"


def bwd_route(name: str, *ts: Optional[torch.Tensor]) -> str:
    """The kernel a CUDA call of the backward entry point `name` takes,
    read from the shapes and pointers of its tensor arguments `ts` in the
    entry point's order (dx: dy, w[, dy2, w2]; dw: x, dy[, dy2]; gated: x,
    wg, wu, dh; None for an absent one): "simt" for float32; for bf16
    "tensor_core" when 16 < C <= TC_MAX_ROWS, E <= TC_MAX_EXPERTS, every
    width (each tensor's last, and dx's output width) is a positive
    multiple of 8 and every tensor starts 16-byte aligned, else
    "mma_sync"."""
    if name not in _BWD_ENTRIES:
        raise ValueError(f"no backward entry point {name!r}")
    x = ts[0]
    if x.dtype == torch.float32:
        return "simt"
    present = [t for t in ts if t is not None]
    E, C = x.shape[:2]
    widths = [t.shape[-1] for t in present]
    if name == "moe_gmm_bwd_dx":
        widths.append(ts[1].shape[1])
    if (16 < C <= TC_MAX_ROWS and E <= TC_MAX_EXPERTS
            and all(w > 0 and w % 8 == 0 for w in widths)
            and all(t.data_ptr() % 16 == 0 for t in present)):
        return "tensor_core"
    return "mma_sync"


def _lib() -> ctypes.CDLL:
    lib = build.load("moe_gmm")
    if not getattr(lib, "_typed", False):
        lib.moe_gmm_fwd.argtypes = [_P] * 5 + [_I64] * 7 + [_P]
        lib.moe_gmm_fwd.restype = ctypes.c_int
        lib._typed = True
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("moe_gmm_bwd")
    if not getattr(lib, "_typed", False):
        for name, n_ptr in (("moe_gmm_bwd_dx", 6), ("moe_gmm_bwd_dw", 6),
                            ("moe_gmm_gated_bwd", 7)):
            fn = getattr(lib, name)
            fn.argtypes = [_P] * n_ptr + [_I64] * 6 + [_P]
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check_inputs(x: torch.Tensor, *ws: torch.Tensor) -> torch.device:
    dev = _device_of(x)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    _check("x", x, x.dtype, 3, dev)
    E, C, d = x.shape
    for i, w in enumerate(ws):
        _check(f"w{i}", w, x.dtype, 3, dev)
        if w.shape[:2] != (E, d) or w.shape != ws[0].shape:
            raise ValueError(f"shapes x {tuple(x.shape)} and w "
                             f"{tuple(w.shape)} disagree")
    f = ws[0].shape[2]
    if E > MAX_GRID or -(-C // 16) > MAX_GRID or max(d, f) > 1 << 30:
        raise ValueError(f"shape {(E, C, d, f)} beyond the kernel's grid")
    return dev


def _groups(rows: Optional[torch.Tensor], x: torch.Tensor) -> int:
    """G of a valid `rows` (1 without it); raises on any other."""
    if rows is None:
        return 1
    E, C, _ = x.shape
    if rows.device != x.device:
        raise ValueError(f"rows is on {rows.device}, expected {x.device}")
    if rows.dtype != torch.int32:
        raise TypeError(f"rows must be torch.int32, got {rows.dtype}")
    if rows.dim() != 2 or rows.shape[0] != E or rows.shape[1] < 1:
        raise ValueError(f"rows must be ({E}, G), got {tuple(rows.shape)}")
    if not rows.is_contiguous():
        raise ValueError("rows must be contiguous")
    G = rows.shape[1]
    if C % G != 0:
        raise ValueError(f"G = {G} groups do not divide C = {C}")
    return G


def _launch(x, w, w2, rows, G, out, epi) -> None:
    kind = route(x, w) if w2 is None else route(x, w, w2)
    E, C, d = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _lib().moe_gmm_fwd(
        x.data_ptr(), w.data_ptr(), None if w2 is None else w2.data_ptr(),
        out.data_ptr(), None if rows is None else rows.data_ptr(), E, C, d,
        out.shape[2], G, _ROUTE_CODE[kind], epi, stream)
    _raise_on(rc, f"moe_gmm_fwd ({kind})")
    LAUNCHES["moe_gmm_fwd"] += 1
    ROUTES[kind] += 1


def moe_gmm_fwd(x: torch.Tensor, w: torch.Tensor,
                rows: Optional[torch.Tensor] = None,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """out[e] = x[e] @ w[e] -> (E, C, f) in `out_dtype` (float32, the
    TPU function, or x's dtype: the float32 result rounded to it once),
    products and sums in float32.

    x: (E, C, d); w: (E, d, f); both float32 or both bfloat16, contiguous;
    E up to 65535, C up to 16 * 65535, any d and f. Replaces
    `moe_gmm_pallas` (without its tile sizes, and without its
    divisibility assert)."""
    if out_dtype not in (torch.float32, x.dtype):
        raise TypeError(f"out_dtype must be float32 or x's {x.dtype}, got "
                        f"{out_dtype}")
    G = _groups(rows, x)
    if _device_of(x).type == "cpu":
        return moe_gmm_ref(x, w, out_dtype)
    dev = _check_inputs(x, w)
    out = torch.empty((*x.shape[:2], w.shape[2]), dtype=out_dtype,
                      device=dev)
    if out.numel() == 0:
        return out
    epi = _F32_OUT if out_dtype == torch.float32 else _IN_DTYPE_OUT
    _launch(x, w, None, rows, G, out, epi)
    return out


def moe_gmm_gated_fwd(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                      rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h[e] = silu(x[e] @ wg[e]) * (x[e] @ wu[e]) -> (E, C, f) in x's
    dtype: one launch, two float32 accumulators over the same x tile. bf16
    rounds as `moe_gmm_gated_ref` (each product to bf16, then silu's and
    the multiply's result); float32 is silu(g) * u in float32. Shapes as
    `moe_gmm_fwd`, wg and wu alike."""
    G = _groups(rows, x)
    if _device_of(x).type == "cpu":
        return moe_gmm_gated_ref(x, wg, wu)
    dev = _check_inputs(x, wg, wu)
    out = torch.empty((*x.shape[:2], wg.shape[2]), dtype=x.dtype, device=dev)
    if out.numel() == 0:
        return out
    _launch(x, wg, wu, rows, G, out, _GATED)
    return out


def _check_same(dev: torch.device, dtype: torch.dtype, **ts) -> None:
    """Every tensor 3-D, contiguous, on `dev` in `dtype` (float32 or
    bfloat16)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"inputs must be float32 or bfloat16, got {dtype}")
    for name, t in ts.items():
        _check(name, t, dtype, 3, dev)


def _launch_bwd(kind: str, name: str, *ts: Optional[torch.Tensor],
                rows: Optional[torch.Tensor] = None):
    """One C call of the backward entry point `name` on route `kind`, on
    inputs that entry point has checked (`ts` in its order, None for an
    absent one); returns what it returns. "mma_sync" takes every bf16
    call, so `chip_smoke.py` times the parent kernel on the tensor-core
    route's inputs through it. The mma_sync kernel's 16-byte loads need d
    and f multiples of 8 and every tensor 16-byte aligned: ValueError
    otherwise."""
    x = ts[0]
    dev, dt = x.device, x.dtype
    G = 1 if rows is None else rows.shape[1]
    if name == "moe_gmm_bwd_dx":
        dy, w, dy2, w2 = (*ts, None, None)[:4]
        E, C, n = dy.shape
        m = w.shape[1]
        outs = [torch.empty((E, C, m), dtype=dt, device=dev)]
        widths = (n, m)
        args = (dy.data_ptr(), w.data_ptr(), _ptr(dy2), _ptr(w2),
                outs[0].data_ptr(), _ptr(rows), E, C, n, m, G)
    elif name == "moe_gmm_bwd_dw":
        x, dy, dy2 = (*ts, None)[:3]
        E, C, m = x.shape
        n = dy.shape[2]
        outs = [torch.empty((E, m, n), dtype=dt, device=dev)
                for _ in range(1 if dy2 is None else 2)]
        widths = (m, n)
        args = (x.data_ptr(), dy.data_ptr(), _ptr(dy2), outs[0].data_ptr(),
                _ptr(outs[1]) if dy2 is not None else None, _ptr(rows), E, C,
                m, n, G)
    else:
        x, wg, wu, dh = ts
        E, C, d = x.shape
        f = wg.shape[2]
        outs = [torch.empty((E, C, f), dtype=dt, device=dev)
                for _ in range(2)]
        widths = (d, f)
        args = (x.data_ptr(), wg.data_ptr(), wu.data_ptr(), dh.data_ptr(),
                outs[0].data_ptr(), outs[1].data_ptr(), _ptr(rows), E, C, d,
                f, G)
    if outs[0].numel():
        if kind == "mma_sync" and (any(w % 8 for w in widths) or any(
                t.data_ptr() % 16 for t in ts if t is not None)):
            raise ValueError(f"{name}: the bf16 kernel takes widths {widths} "
                             f"that are multiples of 8 and 16-byte aligned "
                             f"tensors")
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(_bwd_lib(), name)(*args, _ROUTE_CODE[kind], stream)
        _raise_on(rc, f"{name} ({kind})")
        LAUNCHES[name] += 1
        ROUTES[kind] += 1
    return outs[0] if len(outs) == 1 else tuple(outs)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _grid_ok(E: int, M: int, *widths: int) -> None:
    if E > MAX_GRID or -(-M // 16) > MAX_GRID or max(widths) > 1 << 30:
        raise ValueError(f"shape {(E, M, *widths)} beyond the kernel's grid")


def moe_gmm_bwd_dx(dy: torch.Tensor, w: torch.Tensor,
                   dy2: Optional[torch.Tensor] = None,
                   w2: Optional[torch.Tensor] = None,
                   rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dx[e] = dy[e] @ w[e]^T (+ dy2[e] @ w2[e]^T) -> (E, C, m) in dy's
    dtype: one float32 accumulator over both pairs, rounded once; the rows
    past `rows` are zero. dy, dy2: (E, C, n); w, w2: (E, m, n), read as
    stored (no transposed copy). The input gradient of `moe_gmm_fwd`
    (w = wd) and, with both pairs, of the gated one's buffer."""
    if (dy2 is None) != (w2 is None):
        raise ValueError("dy2 and w2 come together")
    _groups(rows, dy)
    if _device_of(dy).type == "cpu":
        return moe_gmm_bwd_dx_ref(dy, w, dy2, w2, rows)
    dev = dy.device
    two = {} if dy2 is None else {"dy2": dy2, "w2": w2}
    _check_same(dev, dy.dtype, dy=dy, w=w, **two)
    E, C, n = dy.shape
    m = w.shape[1]
    if w.shape != (E, m, n) or any(
            t.shape != s.shape for t, s in ((dy2, dy), (w2, w)) if
            t is not None):
        raise ValueError(f"shapes dy {tuple(dy.shape)} and w "
                         f"{tuple(w.shape)} (and the second pair) disagree")
    _grid_ok(E, C, n, m)
    ts = (dy, w, dy2, w2)
    return _launch_bwd(bwd_route("moe_gmm_bwd_dx", *ts), "moe_gmm_bwd_dx",
                       *ts, rows=rows)


def moe_gmm_bwd_dw(x: torch.Tensor, dy: torch.Tensor,
                   dy2: Optional[torch.Tensor] = None,
                   rows: Optional[torch.Tensor] = None):
    """dw[e] = x[e]^T @ dy[e] -> (E, m, n) in x's dtype, summed in float32
    over the rows `rows` names as occupied, in one fixed order (no split
    over C, no atomics), rounded once; with dy2, (dw, dw2) from one launch
    over the same x tile. x: (E, C, m); dy, dy2: (E, C, n). The weight
    gradient of `moe_gmm_fwd` (x = h, dy = the output's gradient) and of
    the gated one (x, dg, du)."""
    _groups(rows, x)
    if _device_of(x).type == "cpu":
        dw = moe_gmm_bwd_dw_ref(x, dy, rows)
        return dw if dy2 is None else (dw, moe_gmm_bwd_dw_ref(x, dy2, rows))
    dev = x.device
    _check_same(dev, x.dtype, x=x, dy=dy,
                **({} if dy2 is None else {"dy2": dy2}))
    E, C, m = x.shape
    n = dy.shape[2]
    if dy.shape[:2] != (E, C) or (dy2 is not None and dy2.shape != dy.shape):
        raise ValueError(f"shapes x {tuple(x.shape)} and dy "
                         f"{tuple(dy.shape)} disagree")
    _grid_ok(E, m, n, C)
    ts = (x, dy, dy2)
    return _launch_bwd(bwd_route("moe_gmm_bwd_dw", *ts), "moe_gmm_bwd_dw",
                       *ts, rows=rows)


def moe_gmm_gated_bwd(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                      dh: torch.Tensor, rows: Optional[torch.Tensor] = None):
    """(dg, du) of h = silu(x wg) * (x wu) (`moe_gmm_gated_fwd`) for the
    gradient dh, each (E, C, f) in x's dtype: g and u recomputed in two
    float32 accumulators and rounded as the forward rounds them (bf16), du
    = dh silu(g) and dg = dh u silu'(g) each rounded once (the formulas of
    `moe_gmm_gated_bwd_ref`); the rows past `rows` are zero. Shapes as
    `moe_gmm_gated_fwd`, dh as its output."""
    _groups(rows, x)
    if _device_of(x).type == "cpu":
        return moe_gmm_gated_bwd_ref(x, wg, wu, dh, rows)
    dev = _check_inputs(x, wg, wu)
    E, C, d = x.shape
    f = wg.shape[2]
    _check("dh", dh, x.dtype, 3, dev)
    if dh.shape != (E, C, f):
        raise ValueError(f"dh {tuple(dh.shape)} != {(E, C, f)}")
    ts = (x, wg, wu, dh)
    return _launch_bwd(bwd_route("moe_gmm_gated_bwd", *ts),
                       "moe_gmm_gated_bwd", *ts, rows=rows)
