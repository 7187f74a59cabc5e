"""Plain PyTorch version of the epoch-boundary CLOCK walk: the loop of
`refill_np` (`repro/featcache/dynamic.py:328-376`) over CPU tensors. The
CPU path runs it, the tests hold it against the reference, and
`chip_smoke.py` holds the CUDA kernel (`csrc/clock_refill.cu`) against
it on the card; the main path on a card never runs it. Beside it: the
kernel's decomposition in numpy (runs, the windowed walk, the apply
stage), and seeded CLOCK states (`clock_state`) for the tests and the
smoke run."""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
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


# ---------------------------------------------------------------------------
# the kernel's decomposition: runs, a windowed walk, a parallel apply
# ---------------------------------------------------------------------------
def clock_runs(cand_fs) -> Tuple[np.ndarray, np.ndarray]:
    """The runs of equal frequency among the candidates the walk takes
    (those before the first f <= 0): (run_f, run_end), run r holding
    candidates run_end[r - 1] (0 for r = 0) to run_end[r] - 1. Raises
    ValueError when the frequencies are not sorted high to low."""
    fs = np.asarray(cand_fs, np.int64)
    if np.any(np.diff(fs) > 0):
        raise ValueError("candidate frequencies are not sorted high to low")
    fs = fs[fs > 0]                     # sorted: the positive prefix
    if not len(fs):
        return fs, np.zeros(0, np.int64)
    starts = np.flatnonzero(np.r_[True, fs[1:] != fs[:-1]])
    return fs[starts], np.r_[starts[1:], len(fs)].astype(np.int64)


class WalkPlan(NamedTuple):
    """The walk stage's result: `adm_slots[k]`, the victim slot of
    candidate k (k < n, the admitted count); `visits`, the hand's moves
    (steps plus admissions); `windows`, the warp's decision rounds."""
    adm_slots: np.ndarray
    visits: int
    windows: int


def clock_walk_windows(refbit, slot_freq, hand, cand_fs,
                       window: int) -> WalkPlan:
    """The walk in the kernel's decision order. Visit p looks at slot
    (hand + p) mod C; a window decides min(window, C) visits at once (so
    it never holds a slot twice; the kernel's `window` is
    `kernel.window()`), for the current run's frequency f:

    - visit p is eligible when its slot was not admitted in this refill,
      p >= C or its original bit is clear, and its original slot_freq is
      below f (an admitted slot holds f_k >= every later f: never again);
    - the run's next candidates take the eligible visits lowest first; a
      run that ends inside the window leaves the visits after its last
      victim to be tested again at the next run's f;
    - a candidate that passes 2C visits with no victim ends the walk.

    Only the victim list and the visit count come out: `clock_apply`
    makes the state from them. The inputs are not modified."""
    bit = np.asarray(refbit) > 0
    sf = np.array(slot_freq, np.int64)
    C = len(sf)
    W = min(window, C)
    lanes = np.arange(W)
    run_f, run_end = clock_runs(cand_fs)
    hand = int(hand)
    adm = np.zeros(len(np.asarray(cand_fs)), np.int64)
    p = pk = k = windows = 0
    failed = False
    for f, end in zip(run_f, run_end):
        while k < end and not failed:
            windows += 1
            slots = (hand + p + lanes) % C
            elig = (sf[slots] < f) & ((p + lanes >= C) | ~bit[slots])
            lim = pk + 2 * C - p            # candidate k's last visit + 1
            if not elig[:lim].any():
                failed = lim <= W
                p += W
                continue
            idx = np.flatnonzero(elig)
            take = min(len(idx), end - k)
            victims = slots[idx[:take]]
            adm[k:k + take] = victims
            sf[victims] = f                 # admitted: never a victim again
            k += take
            last = int(idx[take - 1])
            pk = p + last + 1
            p += W if take == len(idx) and k < end else last + 1
        if failed:
            break
    return WalkPlan(adm[:k], pk + 2 * C if failed else pk, windows)


def clock_apply(pos, slot_ids, refbit, slot_freq, hand, cand_ids, cand_fs,
                plan: WalkPlan) -> ClockWalk:
    """The state from the victim list, each entry on its own: the first
    min(V, C) slots from the old hand lose their bit, each admission k
    evicts slot v's node and puts candidate k there (every slot is
    admitted at most once and every candidate is non-resident, so no two
    admissions write one entry), the hand moves V. The inputs are not
    modified."""
    pos, slot_ids, refbit, slot_freq = (
        t.detach().to("cpu", torch.int32).clone()
        for t in (pos, slot_ids, refbit, slot_freq))
    p, sid, rb, sf = (t.numpy() for t in (pos, slot_ids, refbit, slot_freq))
    ids = cand_ids.detach().cpu().numpy()
    fs = cand_fs.detach().cpu().numpy()
    C, K, n, h = len(sid), len(ids), len(plan.adm_slots), int(hand)
    rb[(h + np.arange(min(plan.visits, C))) % C] = 0
    v = plan.adm_slots
    old = sid[v]
    p[old[old >= 0]] = -1
    p[ids[:n]] = v
    sid[v] = ids[:n]
    sf[v] = fs[:n]
    adm_slots = torch.zeros(K, dtype=torch.int32)
    adm_nodes = torch.zeros(K, dtype=torch.int32)
    adm_slots[:n] = torch.as_tensor(v, dtype=torch.int32)
    adm_nodes[:n] = torch.as_tensor(ids[:n], dtype=torch.int32)
    return ClockWalk(pos, slot_ids, refbit, slot_freq,
                     torch.tensor((h + plan.visits) % C, dtype=torch.int32),
                     adm_slots, adm_nodes,
                     torch.tensor([n], dtype=torch.int32),
                     torch.tensor([plan.visits - n], dtype=torch.int64))


def clock_refill_windowed(pos, slot_ids, refbit, slot_freq, hand, cand_ids,
                          cand_fs, window: int) -> ClockWalk:
    """`clock_walk_windows` then `clock_apply`: the kernel's three stages
    in plain numpy. Equals `clock_refill_ref` for every window."""
    plan = clock_walk_windows(refbit.detach().cpu().numpy(),
                              slot_freq.detach().cpu().numpy(), int(hand),
                              cand_fs.detach().cpu().numpy(), window)
    return clock_apply(pos, slot_ids, refbit, slot_freq, hand, cand_ids,
                       cand_fs, plan)


# ---------------------------------------------------------------------------
# seeded CLOCK states
# ---------------------------------------------------------------------------
# ogbn-products' 2,449,029 nodes with a 0.2 cache; miss counts below 30
PRODUCTS = (2_449_029, 489_805, 30)
WALK_FIELDS = ("pos", "slot_ids", "refbit", "slot_freq", "hand")


def clock_state(n: int, c: int, max_freq: int, seed: int, device,
                kind: str = "random") -> dict:
    """A synthetic CLOCK state at an epoch's end on `device`, its counts
    drawn uniformly (no epoch's skew): random residency, reference bits,
    hit and miss counts below `max_freq` (ties plentiful), a random hand.
    `kind` "all_bits" sets every bit; "no_victim" makes every slot as hot
    as `max_freq`, above every candidate, so the first candidate walks 2C
    steps and fails."""
    rng = np.random.default_rng((seed, n))
    ids = np.sort(rng.choice(n, size=c, replace=False))
    pos = np.full(n, -1, np.int32)
    pos[ids] = np.arange(c, dtype=np.int32)
    fields = {"pos": pos, "slot_ids": ids.astype(np.int32),
              "refbit": rng.integers(0, 2, c).astype(np.int32),
              "slot_freq": rng.integers(0, max_freq, c).astype(np.int32),
              "freq": rng.integers(0, max_freq, n).astype(np.int32),
              "hand": np.asarray(int(rng.integers(0, c)), np.int32)}
    if kind == "all_bits":
        fields["refbit"][:] = 1
    elif kind == "no_victim":
        fields["slot_freq"][:] = max_freq
    elif kind != "random":
        raise ValueError(f"unknown state kind {kind!r}")
    return {k: torch.as_tensor(v).to(device) for k, v in fields.items()}


def walk_args(state: dict) -> list:
    """The walk's seven arguments: the state's and its candidates."""
    from repro_torch.kernels.clock_refill.ops import refill_candidates
    cand = refill_candidates(state["pos"], state["freq"],
                             state["slot_ids"].shape[0])
    return [state[k] for k in WALK_FIELDS] + list(cand)
