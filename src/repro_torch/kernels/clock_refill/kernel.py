"""Wrapper of the hand-written CUDA CLOCK walk (`csrc/clock_refill.cu`).
It replaces no Pallas kernel: its counterpart is the reference's jitted
device scan `_refill_jit` (`repro/featcache/dynamic.py:184`).

Dispatch goes by the tensors' device: CPU tensors take the plain PyTorch
version (`ref.py`), CUDA tensors launch the kernel — or raise. There is no
fallback from a failed launch. The wrapper counts its launches in
`LAUNCHES` (kernel launches only, never the plain path), and `SMEM`
counts where the kernel kept the ring's words: "shared" when the C words
fit in a block's opt-in shared memory, else "global".
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import build
from repro_torch.kernels.clock_refill.ref import ClockWalk, clock_refill_ref
from repro_torch.kernels.gather_agg.kernel import (_check, _device_of,
                                                   _raise_on, _stream)

LAUNCHES: Dict[str, int] = {"clock_refill": 0}
SMEM: Dict[str, int] = {"shared": 0, "global": 0}

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
            [_I64, ctypes.POINTER(ctypes.c_int), _P]
        lib.clock_refill_walk.restype = ctypes.c_int
        lib._typed = True
    return lib


def clock_refill(pos: torch.Tensor, slot_ids: torch.Tensor,
                 refbit: torch.Tensor, slot_freq: torch.Tensor,
                 hand: torch.Tensor, cand_ids: torch.Tensor,
                 cand_fs: torch.Tensor) -> ClockWalk:
    """The frequency-gated CLOCK walk over candidates `cand_ids` with miss
    frequencies `cand_fs` (K <= C of each, int32, sorted high to low) from
    pos (N,), slot_ids / refbit / slot_freq (C,) int32 and hand (0-d
    int32). Returns a `ClockWalk` of new tensors; the inputs are not
    modified."""
    dev = _device_of(pos)
    if dev.type == "cpu":
        return clock_refill_ref(pos, slot_ids, refbit, slot_freq, hand,
                                cand_ids, cand_fs)
    for name, t in (("pos", pos), ("slot_ids", slot_ids),
                    ("refbit", refbit), ("slot_freq", slot_freq),
                    ("cand_ids", cand_ids), ("cand_fs", cand_fs)):
        _check(name, t, torch.int32, 1, dev)
    _check("hand", hand.reshape(1), torch.int32, 1, dev)
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
    words = torch.empty(C, dtype=torch.int32, device=dev)
    used = ctypes.c_int(0)
    rc = _lib().clock_refill_walk(
        out.pos.data_ptr(), out.slot_ids.data_ptr(), out.refbit.data_ptr(),
        out.slot_freq.data_ptr(), out.hand.data_ptr(), cand_ids.data_ptr(),
        cand_fs.data_ptr(), K, out.adm_slots.data_ptr(),
        out.adm_nodes.data_ptr(), out.n_admitted.data_ptr(),
        out.steps.data_ptr(), words.data_ptr(), C, ctypes.byref(used),
        _stream(dev))
    _raise_on(rc, "clock_refill")
    LAUNCHES["clock_refill"] += 1
    SMEM["shared" if used.value else "global"] += 1
    return out
