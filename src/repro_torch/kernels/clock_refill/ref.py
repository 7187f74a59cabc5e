"""Plain PyTorch version of the epoch-boundary CLOCK walk: the loop of
`refill_np` (`repro/featcache/dynamic.py:328-376`) over CPU tensors. The
CPU path runs it, the tests hold it against the reference, and
`chip_smoke.py` holds the CUDA kernel (`csrc/clock_refill.cu`) against
it on the card; the main path on a card never runs it."""
from __future__ import annotations

from typing import NamedTuple

import torch


class ClockWalk(NamedTuple):
    """The walk's outputs: the new pos (N,), slot_ids, refbit and
    slot_freq (C,) and hand () int32; the admitted (slot, node) pairs in
    `adm_slots` / `adm_nodes` (K,) int32, of which the first `n_admitted`
    ((1,) int32) are valid; and `steps` ((1,) int64), the hand's moves."""
    pos: torch.Tensor
    slot_ids: torch.Tensor
    refbit: torch.Tensor
    slot_freq: torch.Tensor
    hand: torch.Tensor
    adm_slots: torch.Tensor
    adm_nodes: torch.Tensor
    n_admitted: torch.Tensor
    steps: torch.Tensor


def clock_refill_ref(pos, slot_ids, refbit, slot_freq, hand, cand_ids,
                     cand_fs) -> ClockWalk:
    """The frequency-gated CLOCK walk, one hand step at a time: for each
    candidate (sorted by miss frequency, high to low) the hand clears the
    bit of every slot it passes and stops at the first slot whose bit is
    clear and whose `slot_freq` is below the candidate's; a full 2C scan
    with no such slot ends the pass. The inputs are not modified."""
    pos, slot_ids, refbit, slot_freq = (
        t.detach().to("cpu", torch.int32).clone()
        for t in (pos, slot_ids, refbit, slot_freq))
    K = cand_ids.shape[0]
    adm_slots = torch.zeros(K, dtype=torch.int32)
    adm_nodes = torch.zeros(K, dtype=torch.int32)
    # numpy views of the CPU tensors: the loop indexes them in place
    p, sid, rb, sf = (t.numpy() for t in (pos, slot_ids, refbit, slot_freq))
    ids = cand_ids.detach().cpu().numpy()
    fs = cand_fs.detach().cpu().numpy()
    an, asl = adm_nodes.numpy(), adm_slots.numpy()
    C = len(sid)
    h = int(hand)
    admitted = steps = 0
    for k in range(K):
        f = int(fs[k])
        if f <= 0:
            break                       # sorted desc: no candidates left
        walked = 0
        while walked < 2 * C and (rb[h] > 0 or int(sf[h]) >= f):
            rb[h] = 0
            h = (h + 1) % C
            walked += 1
        steps += walked
        if walked >= 2 * C:
            break                       # every slot at least as hot
        cid = int(ids[k])
        old = int(sid[h])
        if old >= 0:
            p[old] = -1
        sid[h] = cid
        p[cid] = h
        sf[h] = f
        rb[h] = 0                       # insert CLEAR
        asl[admitted], an[admitted] = h, cid
        h = (h + 1) % C
        admitted += 1
    return ClockWalk(pos, slot_ids, refbit, slot_freq,
                     torch.tensor(h, dtype=torch.int32), adm_slots,
                     adm_nodes, torch.tensor([admitted], dtype=torch.int32),
                     torch.tensor([steps], dtype=torch.int64))
