"""The epoch-boundary CLOCK refill of the dynamic feature cache, as one
op over the state's tensors (the body of the reference's `_refill_jit`,
`repro/featcache/dynamic.py:184-247`): pick the candidates, walk the
hand (`kernel.clock_refill`: the CUDA kernel on the card, the plain
loop on the CPU), copy the admitted rows.

The candidates are the missed non-resident nodes, hottest first, ties to
the lower node id: `torch.sort(-cand_freq, stable=True)` over ids in
ascending order, the reference's `lexsort((arange(N), -cand_freq))`.
The rows come from the same `feats` matrix the uncached path reads, so
the cache keeps exact copies. The one host read is the admitted count,
which sizes the row copy (the "refill" window of
`analysis.sync_gate`); the walk's step count stays on the device.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.analysis.sync_gate import allowed_sync
from repro_torch.kernels.clock_refill.kernel import clock_refill as walk
from repro_torch.kernels.clock_refill.ref import ClockWalk


def refill_candidates(pos: torch.Tensor, freq: torch.Tensor,
                      capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cand_ids, cand_fs), int32, the first min(C, N) nodes by miss
    frequency (high to low, ties to the lower id); residents count 0."""
    cand_freq = torch.where(pos < 0, freq, 0).to(torch.int32)
    order = torch.sort(-cand_freq, stable=True).indices[:capacity]
    return order.to(torch.int32), cand_freq[order]


def clock_refill(cache: torch.Tensor, pos: torch.Tensor,
                 slot_ids: torch.Tensor, refbit: torch.Tensor,
                 slot_freq: torch.Tensor, freq: torch.Tensor,
                 hand: torch.Tensor,
                 feats: torch.Tensor) -> Tuple[torch.Tensor, ClockWalk, int]:
    """One refill: (new cache rows, the walk's `ClockWalk`, admitted). No
    input is modified; `slot_freq` in the walk is the admitted slots'
    new frequencies (the caller resets the epoch counters)."""
    cand_ids, cand_fs = refill_candidates(pos, freq, slot_ids.shape[0])
    w = walk(pos, slot_ids, refbit, slot_freq, hand, cand_ids, cand_fs)
    with allowed_sync("refill"):
        # analysis: allow[no-host-sync-in-hot-path] -- the refill's one host read, once per epoch boundary (window "refill")
        n = int(w.n_admitted)
    rows = cache.clone()
    if n:
        rows.index_copy_(0, w.adm_slots[:n].long(),
                         feats.index_select(0, w.adm_nodes[:n].long())
                         .to(rows.dtype))
    return rows, w, n
