"""Wrapper of the hand-written CUDA CLOCK walk (`csrc/clock_refill.cu`).
It replaces no Pallas kernel: its counterpart is the reference's jitted
device scan `_refill_jit` (`repro/featcache/dynamic.py:184`).

Dispatch goes by the tensors' device: CPU tensors take the plain PyTorch
version (`ref.py`), CUDA tensors launch the kernel — or raise. There is no
fallback from a failed launch. The wrapper counts its launches in
`LAUNCHES` (one a walk, though the C call launches five kernels: prepare,
walk, apply; never the plain path), and `SMEM` counts where the walk kept
the ring's words: "resident" when the C words fit in a block's opt-in
shared memory (`home`), else "streamed" through a small shared ring.
`home` and `window` ask the C side, which holds the one definition of
each. Candidate frequencies must be sorted high to low (the card traps,
the CPU raises ValueError).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.clock_refill.ref import (ClockWalk, clock_refill_ref,
                                                  clock_runs)
from repro_torch.kernels.gather_agg.kernel import (_check, _device_of,
                                                   _raise_on, _stream)

LAUNCHES: Dict[str, int] = {"clock_refill": 0}
SMEM: Dict[str, int] = {"resident": 0, "streamed": 0}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64


def reset_launches() -> None:
    for d in (LAUNCHES, SMEM):
        for k in d:
            d[k] = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("clock_refill")
    if not getattr(lib, "_typed", False):
        lib.clock_refill_walk.argtypes = [_P] * 7 + [_I64] + [_P] * 5 + \
            [_I64, _P, ctypes.POINTER(ctypes.c_int), _P]
        lib.clock_refill_walk.restype = ctypes.c_int
        lib.clock_refill_scratch.argtypes = [_I64, _I64]
        lib.clock_refill_scratch.restype = _I64
        lib.clock_refill_home.argtypes = [_I64, _I64]
        lib.clock_refill_home.restype = ctypes.c_int
        lib.clock_refill_window.argtypes = []
        lib.clock_refill_window.restype = ctypes.c_int
        lib._typed = True
    return lib


def home(capacity: int, optin: int) -> str:
    """Where the walk keeps C = `capacity` words on a card whose blocks may
    opt into `optin` bytes of shared memory: the C side's own test."""
    return "resident" if _lib().clock_refill_home(capacity, optin) \
        else "streamed"


def window() -> int:
    """The visits one round of the walk's warp decides at most (min(it,
    C) for C slots): the kernel's window."""
    return _lib().clock_refill_window()


def clock_refill(pos: torch.Tensor, slot_ids: torch.Tensor,
                 refbit: torch.Tensor, slot_freq: torch.Tensor,
                 hand: torch.Tensor, cand_ids: torch.Tensor,
                 cand_fs: torch.Tensor,
                 rounds: Optional[torch.Tensor] = None) -> ClockWalk:
    """The frequency-gated CLOCK walk over candidates `cand_ids` with miss
    frequencies `cand_fs` (K <= C of each, int32, sorted high to low,
    distinct non-resident nodes, as `ops.refill_candidates` gives them) from
    pos (N,), slot_ids / refbit / slot_freq (C,) int32 and hand (0-d
    int32). Returns a `ClockWalk` of new tensors; the inputs are not
    modified. `rounds`, a (1,) int64 tensor on the card, receives the
    windows the kernel's warp decided (the CPU path has no windows and
    raises ValueError for it)."""
    dev = _device_of(pos)
    if dev.type == "cpu":
        if rounds is not None:
            raise ValueError("rounds: only the card's kernel decides "
                             "windows")
        clock_runs(cand_fs.numpy())         # raises on unsorted frequencies
        return clock_refill_ref(pos, slot_ids, refbit, slot_freq, hand,
                                cand_ids, cand_fs)
    for name, t in (("pos", pos), ("slot_ids", slot_ids),
                    ("refbit", refbit), ("slot_freq", slot_freq),
                    ("cand_ids", cand_ids), ("cand_fs", cand_fs)):
        _check(name, t, torch.int32, 1, dev)
    _check("hand", hand.reshape(1), torch.int32, 1, dev)
    if rounds is not None:
        _check("rounds", rounds, torch.int64, 1, dev)
        if rounds.shape[0] != 1:
            raise ValueError(f"rounds must hold 1 value, got "
                             f"{tuple(rounds.shape)}")
    C, K = slot_ids.shape[0], cand_ids.shape[0]
    if refbit.shape[0] != C or slot_freq.shape[0] != C or \
            cand_fs.shape[0] != K or K > C:
        raise ValueError(f"shapes slot_ids {C}, refbit "
                         f"{tuple(refbit.shape)}, slot_freq "
                         f"{tuple(slot_freq.shape)}, candidates "
                         f"{tuple(cand_ids.shape)} / "
                         f"{tuple(cand_fs.shape)} disagree")
    out = ClockWalk(
        pos.clone(), slot_ids.clone(), refbit.clone(), slot_freq.clone(),
        hand.reshape(()).clone(),
        torch.empty(K, dtype=torch.int32, device=dev),
        torch.empty(K, dtype=torch.int32, device=dev),
        torch.empty(1, dtype=torch.int32, device=dev),
        torch.empty(1, dtype=torch.int64, device=dev))
    lib = _lib()
    scratch = torch.empty(lib.clock_refill_scratch(C, K), dtype=torch.int32,
                          device=dev)
    resident = ctypes.c_int(0)
    rc = lib.clock_refill_walk(
        out.pos.data_ptr(), out.slot_ids.data_ptr(), out.refbit.data_ptr(),
        out.slot_freq.data_ptr(), out.hand.data_ptr(), cand_ids.data_ptr(),
        cand_fs.data_ptr(), K, out.adm_slots.data_ptr(),
        out.adm_nodes.data_ptr(), out.n_admitted.data_ptr(),
        out.steps.data_ptr(), scratch.data_ptr(), C,
        None if rounds is None else rounds.data_ptr(),
        ctypes.byref(resident), _stream(dev))
    _raise_on(rc, "clock_refill")
    LAUNCHES["clock_refill"] += 1
    SMEM["resident" if resident.value else "streamed"] += 1
    return out
