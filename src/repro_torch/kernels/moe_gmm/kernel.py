"""Wrapper of the hand-written CUDA grouped expert matmul
(`csrc/moe_gmm.cu`), the counterpart of `moe_gmm_pallas` in
`repro/kernels/moe_gmm/kernel.py`, with the epilogues the MoE layer uses.

Dispatch goes by the tensors' device: CPU tensors take the plain PyTorch
versions (`ref.py`), CUDA tensors launch a kernel — or raise. On the card
`route` picks the kernel: "tensor_core" (wgmma fed by TMA) for bf16 with
16 < C <= 4096, E <= 256, d and f multiples of 8 and 16-byte aligned
pointers; "mma_sync" for bf16 otherwise (decode, odd widths); "simt" for
float32. There is no
fallback from a failed launch to another route or to the plain version.
Both ops count their launches in the one key of `LAUNCHES` (kernel
launches only, never the plain path) and which kernel each took in
`ROUTES`.

`rows` (optional, int32 (E, G) on x's device): group g of expert e holds
C / G rows of x, and its rows past rows[e, g] are zero. The kernels skip
the tiles and experts that hold no such row and write zeros there, so the
output is the one without `rows`; the plain versions ignore it.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gather_agg.kernel import (_check, _device_of,
                                                   _raise_on)
from repro_torch.kernels.moe_gmm.ref import moe_gmm_gated_ref, moe_gmm_ref

LAUNCHES: Dict[str, int] = {"moe_gmm_fwd": 0}
ROUTES: Dict[str, int] = {"tensor_core": 0, "mma_sync": 0, "simt": 0}
MAX_GRID = 65535               # the kernels' grid: E in grid.z, C / 16
#                                row tiles in grid.y
# the tensor-core route's limits (one 32-bit row-tile mask per expert)
TC_MAX_EXPERTS, TC_MAX_ROWS = 256, 32 * 128
_ROUTE_CODE = {"tensor_core": 0, "mma_sync": 1, "simt": 2}
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


def _lib() -> ctypes.CDLL:
    lib = build.load("moe_gmm")
    if not getattr(lib, "_typed", False):
        lib.moe_gmm_fwd.argtypes = [_P] * 5 + [_I64] * 7 + [_P]
        lib.moe_gmm_fwd.restype = ctypes.c_int
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
